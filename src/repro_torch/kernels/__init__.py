"""Hand-written Hopper kernels of the port, each beside its plain version.

``launch_counts`` holds one plain integer per kernel wrapper; a wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels (``reset_launch_counts`` zeroes
them). Each paged-attention mode counts its int8-pool launches under its
own ``_int8`` key; ``flash_attention`` counts the training attention's
forward kernel; ``quantize_stochastic`` (B9) and ``quantize_nearest`` (B8)
count the block quantizers; ``matmul`` counts the blocked GEMM (B7).
"""
launch_counts: dict = {
    **{mode + suffix: 0
       for mode in ("paged_attention", "paged_ring", "paged_verify",
                    "paged_ring_verify")
       for suffix in ("", "_int8")},
    "flash_attention": 0, "quantize_stochastic": 0, "quantize_nearest": 0,
    "matmul": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
