"""Hand-written Hopper kernels of the port, each beside its plain version.

``launch_counts`` holds one plain integer per kernel wrapper; a wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels (``reset_launch_counts`` zeroes
them).
"""
launch_counts: dict = {"paged_attention": 0, "paged_ring": 0,
                       "paged_verify": 0, "paged_ring_verify": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
