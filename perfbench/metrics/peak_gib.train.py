"""peak_gib.train: torch.cuda.max_memory_allocated over the window (its
peak statistics reset when the window opens), in GiB."""


def read(res):
    peak = res.values.get("window_peak_bytes")
    return peak / 2**30 if peak else None
