"""Device milliseconds of the operations launched under the engine's
"engine/decode" span, per decode step of the traced steps."""


def read(cap):
    n, s = cap.spans.get("engine/decode", (0, 0.0))
    return s / n * 1e3 if n and s else None
