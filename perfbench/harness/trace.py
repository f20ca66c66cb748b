"""The device trace of a profiled stretch of the window, reduced to numbers.

`profiled()` runs `torch.profiler` (CPU and CUDA activities) around a
block, marks it with the label ``perfbench.window`` and synchronises
before the block closes, so every device operation the block started lies
inside the label.  `DeviceTrace` keeps, from the profiler's raw events:
the device operations (kernels, copies, fills) clipped to the label, the
host labels (the program's ``netmcp.*`` and the harness's
``perfbench.*`` record_function spans), and from them

* ``busy_s``: the time in which at least one device operation ran;
* ``window_s``: the label's length;
* `device_ops`: device seconds by operation name, largest first;
* `idle_gaps`: device-idle seconds by the innermost host label running at
  each gap's middle (``host: other`` where none), largest first;
* `op_seconds`: device seconds and count of the operations whose name
  contains a given text.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

WINDOW_LABEL = "perfbench.window"
LABELS = ("netmcp.", "perfbench.")
NAME_CHARS = 160          # a kernel's demangled name is cut to this length


def _is_label(e) -> bool:
    """A record_function label (the program's or the harness's, or any the
    profiler marks as a user annotation), on the host or mirrored on the
    device timeline."""
    flag = getattr(e, "is_user_annotation", None)
    return e.name().startswith(LABELS) or bool(flag and flag())


def _on_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type() == DeviceType.CUDA


class DeviceTrace:
    def __init__(self, events, label: str = WINDOW_LABEL):
        lo = hi = None
        annots, ops = [], []
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if not _is_label(e):
                if _on_device(e):
                    ops.append((e.name(), start, end))
            elif _on_device(e):
                continue                  # a host label's mirror on the device timeline
            elif e.name() == label:
                lo, hi = start, end
            else:
                annots.append((start, end, e.name()))
        if lo is None:
            raise RuntimeError(f"perfbench: the profile holds no {label!r} span")
        self.ops = [(n, max(s, lo), min(e, hi)) for n, s, e in ops if e > lo and s < hi]
        self.window_s = (hi - lo) * 1e-9
        busy = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        self.busy_s = sum(e - s for s, e in busy) * 1e-9
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        annots.sort()
        starts = [a[0] for a in annots]
        idle = defaultdict(int)
        for s, e in gaps:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "host: other"
            while i >= 0:
                if annots[i][1] >= mid:
                    name = annots[i][2]
                    break
                i -= 1
            idle[name] += e - s
        self._idle = idle

    def device_ops(self, n: int = 10) -> list:
        by = defaultdict(int)
        for name, s, e in self.ops:
            by[name] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        top = sorted(self._idle.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def op_seconds(self, *texts: str):
        """(device seconds, count) of the operations whose name contains
        any of ``texts``."""
        sec, count = 0, 0
        for name, s, e in self.ops:
            if any(t in name for t in texts):
                sec += e - s
                count += 1
        return sec * 1e-9, count


class Profiled:
    """Holder of the `DeviceTrace` a `profiled()` block produced."""
    trace = None


@contextlib.contextmanager
def profiled(device):
    """Profile the block's CPU and CUDA activity; the trace lands in the
    yielded holder's ``trace`` once the block closes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = Profiled()
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_LABEL):
            yield holder
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    holder.trace = DeviceTrace(prof.profiler.kineto_results.events())
