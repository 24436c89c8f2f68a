"""Device milliseconds a step of the operations launched under the
benchmark's "bench/optimizer" range, which wraps the ``Optimizer.update``
it hands to ``make_train_step``."""


def read(cap):
    n, s = cap.spans.get("bench/optimizer", (0, 0.0))
    return s / n * 1e3 if n and s else None
