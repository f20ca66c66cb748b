"""Live request sources, twin of `repro.traffic.source`: arrival processes
replayed as serving traffic.

`request_schedule` turns a named arrival process of `traffic.arrivals`
(drawn from a `torch.Generator`) or a pre-built time array into a
deterministic list of `LiveRequest`s that the micro-batch pump replays in
virtual time and the asyncio gateway in wall time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.traffic.arrivals import ARRIVAL_PROCESSES

__all__ = ["LiveRequest", "request_schedule"]


@dataclasses.dataclass
class LiveRequest:
    """One individually-arriving route request.

    ``rid`` is unique within a schedule (arrival order); ``t_ms`` the
    arrival time in **ms** on the schedule's clock; ``deadline_ms`` an
    absolute deadline on the same clock (None: never expiry-shed);
    ``region`` the client region (-1 untagged); ``session_id`` the agent
    session (None: session-less).
    """

    rid: int
    text: str
    t_ms: float
    deadline_ms: Optional[float] = None
    region: int = -1
    session_id: Optional[int] = None


def request_schedule(
    process: Union[str, np.ndarray],
    gen: Optional[torch.Generator],
    rate_rps: float,
    horizon_s: float,
    texts: Sequence[str],
    *,
    deadline_ms: Optional[float] = None,
    regions: Optional[np.ndarray] = None,
    **process_kw,
) -> list:
    """Materialize an arrival process into a list of `LiveRequest`s.

    ``process`` is a name in `ARRIVAL_PROCESSES` (drawn from ``gen`` at
    ``rate_rps`` requests/second over ``horizon_s`` seconds, extra keyword
    arguments forwarded) or a pre-built array of arrival times in seconds
    (``gen`` ignored).  ``texts`` are cycled over the arrivals;
    ``deadline_ms`` is relative to each arrival; ``regions`` are cycled
    client-region tags.  Returns requests sorted by arrival time, ``rid``
    the arrival rank.
    """
    if isinstance(process, str):
        arrivals_s = ARRIVAL_PROCESSES[process](gen, rate_rps, horizon_s, **process_kw)
    else:
        arrivals_s = np.sort(np.asarray(process, np.float64))
    if not texts:
        raise ValueError("request_schedule needs at least one query text")
    out = []
    for i, t_s in enumerate(arrivals_s):
        t_ms = 1000.0 * float(t_s)
        out.append(
            LiveRequest(
                rid=i,
                text=texts[i % len(texts)],
                t_ms=t_ms,
                deadline_ms=None if deadline_ms is None else t_ms + deadline_ms,
                region=-1 if regions is None else int(regions[i % len(regions)]),
            )
        )
    return out
