"""Session-DAG templates and the seeded session workload generator, twin of
`repro.sessions.dag`.

A session is a DAG of tool-call nodes: node ``j`` becomes routable only
once every parent in ``parents[j]`` has completed.  Four canonical agent
shapes cover the workloads in the agent-framework literature:

  chain         — plan -> act -> act -> ... (sequential tool use)
  fanout_fanin  — one planner fans out ``width`` parallel sub-queries
                  that a join node aggregates (parallel retrieval)
  retry_loop    — an unrolled act/verify loop: each step is an attempt
                  node followed by a verification node (self-correction)
  map_reduce    — split -> ``width`` mappers -> ``n_reduce`` reducers
                  (each over all mappers) -> final merge

Every template emits nodes in topological order (``parents[j] < j``
elementwise), which the simulator relies on, and `critical_path` marks
the nodes of one longest root->sink path — the only nodes DAG-aware
hedging is allowed to duplicate (off-path slack absorbs stragglers for
free, so hedging there only burns capacity).

`generate_sessions` composes with `traffic.arrivals`: session *arrival
times* come from any registered arrival process (poisson / diurnal /
mmpp / flash_crowd) and template choices, sizes, text offsets and regions
are drawn next from the same `torch.Generator`, so a workload is fully
reproducible from ``(generator seed and device, rate, horizon)``.  The
templates and `critical_path` equal the reference's; the draws are not
the reference's `jax.random` stream.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.traffic.arrivals import ARRIVAL_PROCESSES

__all__ = [
    "SessionNode",
    "SessionDAG",
    "chain",
    "fanout_fanin",
    "retry_loop",
    "map_reduce",
    "DAG_TEMPLATES",
    "critical_path",
    "generate_sessions",
]


@dataclasses.dataclass(frozen=True)
class SessionNode:
    """One tool call inside a session DAG."""

    node_id: int
    text: str                     # the routed query text
    parents: tuple                # node_ids that must complete first


@dataclasses.dataclass
class SessionDAG:
    """A session: topologically-ordered nodes plus workload metadata."""

    session_id: int
    template: str
    nodes: list                   # list[SessionNode], parents[j] < j
    t_arrival_s: float = 0.0      # session release time (root nodes)
    region: int = -1              # client region for every node

    def __post_init__(self) -> None:
        for j, node in enumerate(self.nodes):
            if node.node_id != j:
                raise ValueError("nodes must be id-ordered")
            if not all(p < j for p in node.parents):
                raise ValueError("parents must precede children (topological order)")

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def roots(self) -> list:
        return [n.node_id for n in self.nodes if not n.parents]

    def children(self) -> dict:
        """node_id -> list of child node_ids (ascending)."""
        out: dict = {n.node_id: [] for n in self.nodes}
        for n in self.nodes:
            for p in n.parents:
                out[p].append(n.node_id)
        return out


def _texts(pool: Sequence[str], offset: int, n: int) -> list:
    return [pool[(offset + i) % len(pool)] for i in range(n)]


def chain(session_id: int, texts: Sequence[str], n_steps: int = 4,
          offset: int = 0) -> SessionDAG:
    """Sequential tool use: 0 -> 1 -> ... -> n_steps-1."""
    n_steps = max(int(n_steps), 1)
    ts = _texts(texts, offset, n_steps)
    nodes = [
        SessionNode(j, ts[j], () if j == 0 else (j - 1,))
        for j in range(n_steps)
    ]
    return SessionDAG(session_id, "chain", nodes)


def fanout_fanin(session_id: int, texts: Sequence[str], width: int = 3,
                 offset: int = 0) -> SessionDAG:
    """Planner (0) fans out ``width`` parallel nodes joined by the sink."""
    width = max(int(width), 1)
    ts = _texts(texts, offset, width + 2)
    nodes = [SessionNode(0, ts[0], ())]
    nodes += [SessionNode(j, ts[j], (0,)) for j in range(1, width + 1)]
    nodes.append(
        SessionNode(width + 1, ts[width + 1], tuple(range(1, width + 1)))
    )
    return SessionDAG(session_id, "fanout_fanin", nodes)


def retry_loop(session_id: int, texts: Sequence[str], n_steps: int = 2,
               offset: int = 0) -> SessionDAG:
    """Unrolled act/verify loop: attempt_i -> verify_i -> attempt_{i+1}."""
    n_steps = max(int(n_steps), 1)
    ts = _texts(texts, offset, 2 * n_steps)
    nodes = []
    for j in range(2 * n_steps):
        nodes.append(SessionNode(j, ts[j], () if j == 0 else (j - 1,)))
    return SessionDAG(session_id, "retry_loop", nodes)


def map_reduce(session_id: int, texts: Sequence[str], width: int = 3,
               n_reduce: int = 2, offset: int = 0) -> SessionDAG:
    """Split (0) -> ``width`` mappers -> ``n_reduce`` reducers (each over
    all mappers) -> final merge."""
    width = max(int(width), 1)
    n_reduce = max(int(n_reduce), 1)
    n = 1 + width + n_reduce + 1
    ts = _texts(texts, offset, n)
    nodes = [SessionNode(0, ts[0], ())]
    mappers = tuple(range(1, width + 1))
    nodes += [SessionNode(j, ts[j], (0,)) for j in mappers]
    reducers = tuple(range(width + 1, width + 1 + n_reduce))
    nodes += [SessionNode(j, ts[j], mappers) for j in reducers]
    nodes.append(SessionNode(n - 1, ts[n - 1], reducers))
    return SessionDAG(session_id, "map_reduce", nodes)


DAG_TEMPLATES = {
    "chain": chain,
    "fanout_fanin": fanout_fanin,
    "retry_loop": retry_loop,
    "map_reduce": map_reduce,
}


def critical_path(dag: SessionDAG) -> frozenset:
    """Node ids of one longest root->sink path (unit node weights).

    Deterministic: among equally-long predecessors the lowest node id
    wins, so the marked path is a pure function of the DAG shape.  These
    are the only nodes `SessionTrafficSim` allows to hedge — a straggler
    on the critical path delays the whole task, while off-path nodes
    have slack that absorbs stragglers for free.
    """
    n = dag.n_nodes
    depth = np.zeros(n, np.int64)
    best_parent = np.full(n, -1, np.int64)
    for node in dag.nodes:                       # topological order
        for p in node.parents:
            if depth[p] + 1 > depth[node.node_id]:
                depth[node.node_id] = depth[p] + 1
                best_parent[node.node_id] = p
    j = int(np.flatnonzero(depth == depth.max())[0])
    path = set()
    while j >= 0:
        path.add(j)
        j = int(best_parent[j])
    return frozenset(path)


def _randint(gen: torch.Generator, n: int, low: int, high: int) -> np.ndarray:
    """n integers uniform on [low, high) from ``gen``, on its device."""
    x = torch.randint(low, high, (n,), generator=gen, device=gen.device)
    return x.cpu().numpy()


def generate_sessions(
    gen: torch.Generator,
    rate: float,
    horizon_s: float,
    texts: Sequence[str],
    *,
    arrival_process: str = "poisson",
    templates: Optional[Sequence[str]] = None,
    regions: Optional[np.ndarray] = None,
    min_size: int = 2,
    max_size: int = 5,
    **arrival_kw,
) -> list:
    """Sample a reproducible session workload.

    Session arrival times come from ``ARRIVAL_PROCESSES[arrival_process]``
    at ``rate`` sessions/s over ``horizon_s``; each session draws its
    template uniformly from ``templates`` and its size parameter
    (steps/width) uniformly from ``[min_size, max_size]``.  Node texts
    cycle through ``texts`` with a per-session offset so concurrent
    sessions exercise different tools.  ``regions`` (i32, one per
    region-tagged population entry) optionally tags each session with a
    uniformly-drawn client region.  ``gen`` draws, in this order, the
    arrival times, then [n] template indices, sizes, text offsets and
    (with ``regions``) region indices.
    """
    if len(texts) == 0:
        raise ValueError("generate_sessions needs at least one text")
    templates = list(templates) if templates is not None \
        else sorted(DAG_TEMPLATES)
    t_arr = ARRIVAL_PROCESSES[arrival_process](
        gen, rate, horizon_s, **arrival_kw
    )
    n = int(t_arr.size)
    if n == 0:
        return []
    tpl_i = _randint(gen, n, 0, len(templates))
    size = _randint(gen, n, min_size, max_size + 1)
    offs = _randint(gen, n, 0, len(texts))
    if regions is not None:
        regions = np.asarray(regions, np.int64)
        reg = regions[_randint(gen, n, 0, regions.size)]
    else:
        reg = np.full(n, -1, np.int64)
    sessions = []
    for i in range(n):
        name = templates[int(tpl_i[i])]
        build = DAG_TEMPLATES[name]
        if name == "chain":
            dag = build(i, texts, n_steps=int(size[i]), offset=int(offs[i]))
        elif name == "retry_loop":
            dag = build(i, texts, n_steps=max(int(size[i]) // 2, 1),
                        offset=int(offs[i]))
        elif name == "map_reduce":
            dag = build(i, texts, width=int(size[i]),
                        n_reduce=max(int(size[i]) // 2, 1),
                        offset=int(offs[i]))
        else:
            dag = build(i, texts, width=int(size[i]), offset=int(offs[i]))
        dag.t_arrival_s = float(t_arr[i])
        dag.region = int(reg[i])
        sessions.append(dag)
    return sessions
