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


# each TPU kernel's number (ROADMAP §B) -> the counts of its port's launches
# (B3, the int8 dequant, runs inside B1/B2/B4/B5: their `_int8` launches)
KERNEL_COUNTS = {
    "B1": ("paged_attention", "paged_attention_int8"),
    "B2": ("paged_ring", "paged_ring_int8"),
    "B4": ("paged_verify", "paged_verify_int8"),
    "B5": ("paged_ring_verify", "paged_ring_verify_int8"),
    "B6": ("flash_attention",),
    "B7": ("matmul",),
    "B8": ("quantize_nearest",),
    "B9": ("quantize_stochastic",)}


def launch_line(counts=None) -> str:
    """One line of every kernel's launches, ``kernels: B1=n ...``, from
    `counts` (another process's ``launch_counts``) or this process's."""
    counts = launch_counts if counts is None else counts
    return "kernels: " + " ".join(
        f"{b}={sum(counts[n] for n in names)}"
        for b, names in KERNEL_COUNTS.items())
