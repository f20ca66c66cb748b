"""queue_wait_p90_ms.serve: the 90th percentile, over every request due in
the window that was admitted (in the window or in the drain after it), of
the time from when it was due to the start of the engine step that
admitted it into a slot (the benchmark's own spans), in ms."""
import numpy as np


def read(res):
    waits = res.spans.get("queue_wait")
    return 1e3 * float(np.percentile(waits, 90)) if waits else None
