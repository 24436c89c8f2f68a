"""Device milliseconds of the operations launched under the engine's
"engine/prefill" span, per 1000 prompt tokens prefilled in the traced
steps (tokens found in the prefix cache are not prefilled)."""


def read(cap):
    n, s = cap.spans.get("engine/prefill", (0, 0.0))
    tokens = sum(k for st in cap.record["steps"] if st["traced"]
                 for _, k in st["prefill"])
    return s / tokens * 1e6 if n and s and tokens else None
