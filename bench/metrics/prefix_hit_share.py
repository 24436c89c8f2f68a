"""Share of the prompt tokens of the requests admitted in the window that
the engine found in its prefix cache (aliased blocks, or a whole prompt
copied on write) and did not prefill."""


def read(cap):
    adm = [a for st in cap.record["steps"] for a in st["admitted"]]
    asked = sum(p for p, _ in adm)
    return sum(c for _, c in adm) / asked * 100 if asked else None
