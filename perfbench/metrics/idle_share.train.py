"""idle_share.train: the share of the traced training steps' wall time in
which no operation ran on the card, in %, from the profiler's trace."""


def read(res):
    if res.trace is None or res.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - res.trace.busy_s / res.trace.window_s)
