"""Share of a step in which no operation runs on the device, with the
profiler's own cost taken out: one less the device's busy time a traced
step (the union of the device operations' intervals over the traced steps)
over the mean wall time of the window's steps outside the trace. The
profiler slows the host's issue of a step, so the traced steps' own wall
time would read the idle share too high where the host paces the step."""


def read(cap):
    steps = cap.record["steps"]
    traced = sum(st["traced"] for st in steps)
    wall = [st["wall_s"] for st in steps if not st["traced"]]
    if not traced or not wall or cap.busy_s <= 0:
        return None
    return (1 - cap.busy_s / traced / (sum(wall) / len(wall))) * 100
