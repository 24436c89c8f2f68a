"""The device's peak of allocated memory over set-up and window,
``torch.cuda.max_memory_allocated()``, in GiB."""


def read(cap):
    peak = cap.record.get("peak_bytes")
    return peak / 2**30 if peak else None
