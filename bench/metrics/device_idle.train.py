"""Share of the traced window in which no operation ran on the device:
one less the union of the device operations' intervals over the window.
The card paces a training step, so the profiler's cost on the host hides
under the device's work and the traced window stands for the others."""


def read(cap):
    if cap.window_s <= 0 or cap.busy_s <= 0:
        return None
    return (1 - cap.busy_s / cap.window_s) * 100
