"""engine_device_ms.route: the card's busy time per traced route (device
operations of encode and route together, from the profiler), in ms."""


def read(res):
    n = res.trace_work.get("routes")
    if res.trace is None or not n or res.trace.busy_s <= 0:
        return None
    return 1e3 * res.trace.busy_s / n
