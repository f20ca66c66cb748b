"""Shard-stacked SONAR routing engine for mega fleets, port of
`repro.core.mesh_routing`.

`BatchRoutingEngine` holds the whole fleet in one set of matrices.  This
module partitions the **server axis** (and the tool axis, grouped by host
server) into ``n_shards`` contiguous slices and runs a hierarchical
two-stage selection on shard-stacked tensors ``[J, ...]`` on one device:

  1. each shard scores its server slice (stage-1 BM25) and keeps its local
     top-``min(top_s, s_pad)`` servers;
  2. the per-shard winners are merged, and every query takes its global
     top-s candidate servers (Eq. 2);
  3. each shard scores its tool slice (stage-2 BM25), masks tools outside
     the candidate servers, computes its QoS / load / staleness / RTT /
     dead / affinity terms and keeps its local top-``min(top_k, t_pad)``
     candidate tools with their metadata;
  4. the per-shard candidate lists are merged and the softmax-expertise +
     fusion + argmax tail runs on the merged set: the hand-written
     ``fused_select`` kernel (`kernels/ops`) on the kernel path, its plain
     version `kernels/ref.fused_select_ref` otherwise.

The reference runs the per-shard stages under ``shard_map`` on a device
mesh, or on the shard-stacked arrays when it has one device.  The port has
one card and runs the shard-stacked mode only; ``mesh=None`` and
``mesh="auto"`` both emulate the shards.

Selection parity: the result is argmax-identical to the single-device
engine for every algorithm.  The global top-k is a subset of the union of
the per-shard top-ks; every top-k is a stable sort (ties toward the lower,
local == global, index), and shard blocks are concatenated in shard order,
so the first maximum over the merged axis is the lowest global index, as
over the full axis.  Shard padding scores ``PAD_NEG``, strictly below the
``NEG`` mask, so pads never perturb the merge.

Mega fleets (10^5-10^6 servers) use a `TiledFleetIndex`: servers are
instances of a few template servers, BM25 weights are stored once per
template, and per-shard scores are gathered from one small template
product.  Telemetry can stay compact too
(``telemetry_templates=(compact [M, T], template_map [n_servers])``: QoS
per template row, gathered per server).  With a tiled index, stage 2 is
candidate-compacted (`_stage2_compact`): only the <= top_s * k_slot tools
hosted on the candidate servers are gathered, so no full-tool-axis mask,
gather or sort runs anywhere; stage 1's fleet-axis sort remains.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import adaptive as _adaptive
from repro_torch.core import bm25, quantize, routing
from repro_torch.core.batch_routing import (
    BatchDecisions,
    EncodedBatch,
    check_n_real,
    encode_for_index,
)
from repro_torch.core.bm25 import topk
from repro_torch.core.dataset import Server
from repro_torch.core.qos import (
    QosParams,
    load_penalty,
    network_score,
    rtt_penalty,
    staleness_discount,
)
from repro_torch.core.routing import (  # noqa: F401  (ALGORITHMS: the reference's re-export)
    ALGORITHMS,
    BM25_STAGE_MS,
    LLM_CALL_MS,
    LLM_RERANK_MS,
    RoutingConfig,
    ToolIndex,
)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

NEG = kref.NEG
PAD_NEG = 2.0 * NEG   # pad sentinel: sorts strictly below every real score
_F32 = torch.float32

MESH_NOT_PORTED = (
    "repro_torch: the shard_map mesh path has no target on one card; "
    "pass mesh=None (or 'auto') to run the shard-stacked engine"
)


# ---------------------------------------------------------------------------
# Tiled index for mega fleets
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _DenseIndexView:
    """ToolIndex-like view over densified tiled weights (feeds the
    single-device `BatchRoutingEngine` in parity checks)."""

    server_corpus: bm25.Bm25Corpus
    tool_corpus: bm25.Bm25Corpus
    tool_server: np.ndarray
    n_tools: int


class TiledFleetIndex:
    """Template-tiled two-level BM25 index for 10^5-10^6-server fleets.

    ``templates`` are the distinct server templates; ``server_template``
    int [n_servers] maps each fleet server to its template.  Tools of
    server ``i`` are its template's tools in template order, so the global
    tool axis stays grouped by host server (ascending), as the shard plan
    requires.  ``weights_dtype`` ("float32", "bfloat16" or "int8") rounds
    the template weights once, here, before any path consumes them, so
    every path (and ``densify()``) scores identical rounded operands.

    BM25 corpus statistics are computed as if every template doc were
    replicated its multiplicity, so scoring a template row equals scoring
    any of its copies in the expanded corpus.  The arrays are byte-equal
    to the reference's.
    """

    is_tiled = True

    def __init__(
        self,
        templates: Sequence[Server],
        server_template: np.ndarray,
        weights_dtype: str = "float32",
    ):
        self.templates = list(templates)
        stpl = np.asarray(server_template, np.int64)
        if stpl.size == 0 or stpl.min() < 0 or stpl.max() >= len(self.templates):
            raise ValueError("server_template ids must index the templates")
        self.n_servers = int(stpl.size)
        self.server_doc_map = stpl.astype(np.int32)
        counts = np.bincount(stpl, minlength=len(self.templates))
        self.server_corpus = bm25.build_corpus_tiled(
            [s.description for s in self.templates], counts
        )

        tool_docs, tool_tpl = [], []
        for mi, s in enumerate(self.templates):
            for t in s.tools:
                tool_docs.append(f"{t.name.replace('_', ' ')} {t.description}")
                tool_tpl.append(mi)
        tool_tpl = np.asarray(tool_tpl, np.int64)
        tools_per_tpl = np.bincount(tool_tpl, minlength=len(self.templates))
        self.tool_corpus = bm25.build_corpus_tiled(tool_docs, counts[tool_tpl])

        n_per_server = tools_per_tpl[stpl]                     # [n_servers]
        self.n_tools = int(n_per_server.sum())
        self.tool_server = np.repeat(np.arange(self.n_servers), n_per_server).astype(np.int32)
        # doc id of each fleet tool: template's first tool doc + offset
        doc0 = np.concatenate([[0], np.cumsum(tools_per_tpl)])[:-1]
        starts = np.cumsum(n_per_server) - n_per_server
        within = np.arange(self.n_tools) - np.repeat(starts, n_per_server)
        self.tool_doc_map = (np.repeat(doc0[stpl], n_per_server) + within).astype(np.int32)

        self.weights_dtype = weights_dtype
        if weights_dtype not in ("float32", "f32"):
            for attr in ("server_corpus", "tool_corpus"):
                c = getattr(self, attr)
                setattr(self, attr, bm25.Bm25Corpus(
                    vocab=c.vocab, weights=quantize.round_weights(c.weights, weights_dtype),
                    n_docs=c.n_docs,
                ))

    def densify(self) -> _DenseIndexView:
        """Expanded-weights view (for the single-device parity engine)."""
        sc = bm25.Bm25Corpus(
            vocab=self.server_corpus.vocab,
            weights=self.server_corpus.weights[self.server_doc_map],
            n_docs=self.n_servers,
        )
        tc = bm25.Bm25Corpus(
            vocab=self.tool_corpus.vocab,
            weights=self.tool_corpus.weights[self.tool_doc_map],
            n_docs=self.n_tools,
        )
        return _DenseIndexView(
            server_corpus=sc, tool_corpus=tc, tool_server=self.tool_server, n_tools=self.n_tools,
        )


# ---------------------------------------------------------------------------
# Shard plan (host side, built once per engine)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardPlan:
    """Static partition of the server/tool axes into ``n_shards`` slices.

    Servers are split contiguously ([j*s_pad, (j+1)*s_pad)); each shard's
    tools are the (contiguous, because ``tool_server`` is non-decreasing)
    block hosted on its servers.  Both axes are padded to a common
    per-shard size; pad entries carry valid=False and score ``PAD_NEG``.
    Pad ids are clipped into range so every gather stays in bounds.
    """

    n_shards: int
    s_pad: int                    # servers per shard (padded)
    t_pad: int                    # tools per shard (padded)
    server_gid: np.ndarray        # [J, s_pad] i32 global server id (clipped)
    server_valid: np.ndarray      # [J, s_pad] bool
    tool_gid: np.ndarray          # [J, t_pad] i32 global tool id (clipped)
    tool_valid: np.ndarray        # [J, t_pad] bool
    tool_host_global: np.ndarray  # [J, t_pad] i32 host server (global)
    tool_host_local: np.ndarray   # [J, t_pad] i32 host row in shard slice


def make_shard_plan(tool_server: np.ndarray, n_servers: int, n_shards: int) -> ShardPlan:
    tool_server = np.asarray(tool_server, np.int64)
    if np.any(np.diff(tool_server) < 0):
        raise ValueError("tools must be grouped by host server (non-decreasing tool_server)")
    n_shards = max(1, min(int(n_shards), int(n_servers)))
    s_pad = -(-n_servers // n_shards)
    j = np.arange(n_shards)
    gid = j[:, None] * s_pad + np.arange(s_pad)[None, :]
    server_valid = gid < n_servers
    server_gid = np.minimum(gid, n_servers - 1).astype(np.int32)

    t_lo = np.searchsorted(tool_server, j * s_pad, side="left")
    t_hi = np.searchsorted(tool_server, np.minimum((j + 1) * s_pad, n_servers), side="left")
    t_pad = max(int((t_hi - t_lo).max()), 1)
    tg = t_lo[:, None] + np.arange(t_pad)[None, :]
    tool_valid = tg < t_hi[:, None]
    tool_gid = np.minimum(tg, len(tool_server) - 1).astype(np.int32)
    tool_host_global = tool_server[tool_gid].astype(np.int32)
    tool_host_local = np.clip(
        tool_host_global - (j * s_pad)[:, None], 0, s_pad - 1
    ).astype(np.int32)
    return ShardPlan(
        n_shards=n_shards, s_pad=int(s_pad), t_pad=int(t_pad),
        server_gid=server_gid, server_valid=server_valid,
        tool_gid=tool_gid, tool_valid=tool_valid,
        tool_host_global=tool_host_global, tool_host_local=tool_host_local,
    )


# ---------------------------------------------------------------------------
# Static pipeline configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _StaticCfg:
    top_s: int
    top_k: int
    n_servers: int
    n_tools: int
    s_keep: int                   # per-shard stage-1 candidates
    k_keep: int                   # per-shard stage-2 candidates
    alpha: float
    beta: float
    gamma: float
    load_knee: float
    load_sharp: float
    delta: float
    rtt_scale: float
    temp: float
    stale_half_life: float
    use_network: bool
    use_load: bool
    use_staleness: bool
    use_failover: bool
    use_rtt: bool
    rerank: bool
    use_kernels: bool
    qos_params: QosParams
    # candidate-compacted stage 2 (tiled mega fleets): score only the
    # <= top_s * k_slot tools hosted on candidate servers
    compact2: bool = False
    k_slot: int = 0               # max tools hosted on any one server
    use_aff: bool = False         # SONAR-SESSION sticky-affinity bonus
    eps: float = 0.0


# ---------------------------------------------------------------------------
# Per-shard stages on shard-stacked tensors [J, ...]
# ---------------------------------------------------------------------------

def _bm25_2d(q: torch.Tensor, wt: torch.Tensor, sc: _StaticCfg) -> torch.Tensor:
    """[n_q, V] x [V, n_docs] -> [n_q, n_docs]: the BM25 kernel or its
    plain version (the same ordered sums)."""
    if sc.use_kernels:
        return ops.bm25_scores(q, wt)
    return bm25.bm25_scores(wt.t(), q)


def _qos_2d(lat: torch.Tensor, sc: _StaticCfg) -> torch.Tensor:
    if sc.use_kernels:
        return ops.qos_scores(lat, sc.qos_params)
    return network_score(lat, sc.qos_params)


def _stacked_scores(q: torch.Tensor, wt: torch.Tensor, sc: _StaticCfg) -> torch.Tensor:
    """q [n_q, V] against shard-stacked weights wt [V, J, S] -> [J, n_q, S]."""
    V, J, S = wt.shape
    return _bm25_2d(q, wt.reshape(V, J * S), sc).reshape(-1, J, S).permute(1, 0, 2)


def _stage1_stacked(d: dict, sc: _StaticCfg) -> tuple:
    """Shard-local stage 1: server scores + local top-s.

    Returns (values [J, n_q, s_keep], global server ids [J, n_q, s_keep]).
    """
    s = d["s_pre"] if "s_pre" in d else _stacked_scores(d["q_server"], d["w_server"], sc)
    if sc.use_failover and "dead" in d:
        s = torch.where(d["dead"] > 0.0, NEG, s)          # [J, 1|B, s_pad] bcast
    s = torch.where(d["server_valid"][:, None, :], s, PAD_NEG)
    v, li = topk(s, sc.s_keep)                            # [J, n_q, s_keep]
    gid = torch.gather(d["server_gid"][:, None, :].expand(s.shape), -1, li)
    return v, gid


def _stage2_stacked(d: dict, cand_gids: torch.Tensor, sc: _StaticCfg) -> tuple:
    """Shard-local stage 2: tool scores masked to the global candidate
    servers, QoS/load/staleness/RTT/dead/affinity terms over the shard's
    telemetry slice, local top-k extraction with metadata.

    Returns eight [J, n_q, k_keep] tensors:
    (sel, val, qos, load, rtt, dead, aff, gid).
    """
    t = d["t_pre"] if "t_pre" in d else _stacked_scores(d["q_tool"], d["w_tool"], sc)
    J, n_q, t_pad = t.shape
    dev = t.device

    in_cand = torch.any(
        d["tool_host_global"][:, None, :, None] == cand_gids[None, :, None, :], dim=-1
    )                                                     # [J, n_q, t_pad]
    sel = torch.where(in_cand, t, NEG)
    sel = torch.where(d["tool_valid"][:, None, :], sel, PAD_NEG)

    if not sc.rerank:
        val_full = sel
    elif "val_pre" in d:
        val_full = d["val_pre"]
    else:
        val_full = _stacked_scores(d["q_rerank"], d["w_tool"], sc)

    host_l = d["tool_host_local"].long()                  # [J, t_pad]

    def per_tool(per_server):                             # [J, B, s_pad] -> [J, B, t_pad]
        B = per_server.shape[1]
        return torch.gather(per_server, -1, host_l[:, None, :].expand(J, B, t_pad))

    def zeros():
        return torch.zeros((J, 1, t_pad), dtype=_F32, device=dev)

    if sc.use_network and ("lat" in d or "qos_pre" in d):
        if "qos_pre" in d:
            n_server = d["qos_pre"]                       # [J, B, s_pad]
        elif d["lat"].ndim == 4:                          # per-query windows
            Jl, B, S, T = d["lat"].shape
            n_server = _qos_2d(d["lat"].reshape(Jl * B * S, T), sc).reshape(Jl, B, S)
        else:                                             # shared snapshot
            Jl, S, T = d["lat"].shape
            n_server = _qos_2d(d["lat"].reshape(Jl * S, T), sc).reshape(Jl, 1, S)
        if sc.use_staleness and "age" in d:
            n_server = n_server * staleness_discount(d["age"], sc.stale_half_life)
        tool_qos = per_tool(n_server)
    else:
        tool_qos = zeros()

    if sc.use_load and "load" in d:
        tool_load = per_tool(load_penalty(d["load"], sc.load_knee, sc.load_sharp))
    else:
        tool_load = zeros()

    # SONAR-GEO: an explicit RTT vector, or rows of the sharded
    # [J, n_regions, s_pad] RTT matrix gathered by the region indices
    if sc.use_rtt and ("rtt" in d or "rtt_region" in d):
        if "rtt_region" in d:
            # clamp the gather and zero untagged (region < 0) requests' rows
            ridx = d["region_idx"]
            rtt_s = d["rtt_region"][:, torch.clamp_min(ridx, 0).long(), :]  # [J, B, s_pad]
            rtt_s = torch.where((ridx >= 0)[None, :, None], rtt_s, 0.0)
        else:
            rtt_s = d["rtt"]                              # [J, 1|B, s_pad]
        tool_rtt = per_tool(rtt_penalty(rtt_s, sc.rtt_scale))
    else:
        tool_rtt = zeros()

    tool_dead = per_tool(d["dead"]) if sc.use_failover and "dead" in d else zeros()
    tool_aff = per_tool(d["aff"]) if sc.use_aff and "aff" in d else zeros()

    v, li = topk(sel, sc.k_keep)                          # [J, n_q, k_keep]

    def gather(x):                                        # [J, 1|n_q, t_pad]
        return torch.gather(x.expand(J, n_q, t_pad), -1, li)

    return (v, gather(val_full), gather(tool_qos), gather(tool_load), gather(tool_rtt),
            gather(tool_dead), gather(tool_aff), gather(d["tool_gid"][:, None, :]))


def _gflat(x: torch.Tensor) -> torch.Tensor:
    """[J, B, s_pad] -> [B, J*s_pad]; columns land in global server-id
    order because shard slices are contiguous."""
    J, B, S = x.shape
    return x.permute(1, 0, 2).reshape(B, J * S)


def _stage2_compact(d: dict, t_full, v_full, nt, cand_gids: torch.Tensor,
                    sc: _StaticCfg) -> tuple:
    """Candidate-compacted stage 2 for tiled mega fleets.

    Only the tools hosted on the <= top_s candidate servers are expanded:
    candidate server ids are sorted ascending and each expands ``k_slot``
    slots (global tool id = the server's first tool + slot; slots beyond
    the server's tool count carry NEG and tool id 0).  The compacted axis
    lists candidate tools in ascending global id, so the stable top-k
    resolves ties to the lowest global tool id, as over the full axis, and
    every value is gathered from the same template scores and per-server
    vectors the full path uses.  Requires every server to host >= 1 tool
    and ``n_servers >= top_s`` (no pad or duplicate candidates).

    Returns eight [n_q, W] tensors (sel, val, qos, load, rtt, dead, aff,
    gid), ``W = top_s * k_slot`` padded up to the final top-k width.
    """
    n_q, m_docs = t_full.shape
    dev = t_full.device
    cand = torch.sort(cand_gids, dim=-1).values.long()   # [n_q, S] ascending
    S = cand.shape[1]
    K = sc.k_slot
    start = d["tool_start_g"][cand]                       # [n_q, S]
    count = d["tool_count_g"][cand]
    doc0 = d["tool_doc0_g"][cand]
    slot = torch.arange(K, dtype=torch.int32, device=dev)
    ok3 = slot[None, None, :] < count[:, :, None]         # [n_q, S, K]
    gid3 = torch.where(ok3, start[:, :, None] + slot[None, None, :], 0)
    doc3 = torch.clamp(doc0[:, :, None] + slot[None, None, :], 0, m_docs - 1)
    W = S * K
    ok = ok3.reshape(n_q, W)
    gid = gid3.reshape(n_q, W).to(torch.int32)
    doc = doc3.reshape(n_q, W).long()

    sel = torch.where(ok, torch.gather(t_full, 1, doc), NEG)
    val = torch.where(ok, torch.gather(v_full, 1, doc), NEG) if sc.rerank else sel

    def gath(x):                                          # [J, 1|n_q, s_pad] -> [n_q, S]
        f = _gflat(x)
        return f[0][cand] if f.shape[0] == 1 else torch.gather(f, 1, cand)

    def expand(x):                                        # [n_q, S] -> [n_q, W]
        return x[:, :, None].expand(n_q, S, K).reshape(n_q, W)

    def zeros():
        return torch.zeros((n_q, W), dtype=_F32, device=dev)

    if sc.use_network and (nt is not None or "lat" in d):
        if nt is not None:                                # template QoS
            tmf = d["tel_map"].reshape(-1)                # [J*s_pad]
            qos_s = nt[tmf[cand].long()]                  # [n_q, S]
        elif d["lat"].ndim == 4:                          # per-query windows
            J, B, Sp, T = d["lat"].shape
            flat = d["lat"].permute(1, 0, 2, 3).reshape(B, J * Sp, T)
            rows = torch.gather(flat, 1, cand[:, :, None].expand(n_q, S, T))
            qos_s = _qos_2d(rows.reshape(n_q * S, T), sc).reshape(n_q, S)
        else:                                             # shared snapshot
            J, Sp, T = d["lat"].shape
            rows = d["lat"].reshape(J * Sp, T)[cand.reshape(-1)]
            qos_s = _qos_2d(rows, sc).reshape(n_q, S)
        if sc.use_staleness and "age" in d:
            qos_s = qos_s * staleness_discount(gath(d["age"]), sc.stale_half_life)
        qos = expand(qos_s)
    else:
        qos = zeros()

    if sc.use_load and "load" in d:
        load = expand(load_penalty(gath(d["load"]), sc.load_knee, sc.load_sharp))
    else:
        load = zeros()

    if sc.use_rtt and ("rtt" in d or "rtt_region" in d):
        if "rtt_region" in d:
            ridx = d["region_idx"]
            rr = d["rtt_region"].permute(1, 0, 2)         # [R, J, s_pad]
            rr = rr.reshape(rr.shape[0], -1)              # [R, J*s_pad]
            rows = rr[torch.clamp_min(ridx, 0).long()]    # [n_q, J*s_pad]
            rtt_s = torch.gather(rows, 1, cand)
            rtt_s = torch.where((ridx >= 0)[:, None], rtt_s, 0.0)
        else:
            rtt_s = gath(d["rtt"])
        rtt = expand(rtt_penalty(rtt_s, sc.rtt_scale))
    else:
        rtt = zeros()

    dead = expand(gath(d["dead"])) if sc.use_failover and "dead" in d else zeros()
    aff = expand(gath(d["aff"])) if sc.use_aff and "aff" in d else zeros()

    outs = [sel, val, qos, load, rtt, dead, aff, gid]
    k_final = min(sc.top_k, sc.n_tools)
    if W < k_final:                                       # keep the merge's k
        pad = k_final - W
        outs = [
            torch.nn.functional.pad(x, (0, pad), value=NEG if i < 2 else 0)
            for i, x in enumerate(outs)
        ]
    return tuple(outs)


def _flatten_shards(x: torch.Tensor) -> torch.Tensor:
    """[J, n_q, K] -> [n_q, J*K], shard blocks in shard (= global) order."""
    J, n_q, K = x.shape
    return x.permute(1, 0, 2).reshape(n_q, J * K)


def _route_sharded(dyn: dict, sc: _StaticCfg):
    """Hierarchical shard-stacked routing.  Key presence in ``dyn`` selects
    the input mode: dense or tiled weights and telemetry, and which
    optional vectors are supplied."""
    # -- tiled template scoring (small products + gathers).  bf16 template
    # weights [V, n_templates] go to the products as they are: both widen
    # them exactly, so scores equal scoring the rounded f32 weights --
    compact2 = sc.compact2 and "tool_doc_map" in dyn
    d = dict(dyn)
    t_full = v_full = nt = None
    if "server_doc_map" in dyn:
        s_full = _bm25_2d(dyn["q_server"], dyn["w_server_tpl"], sc)
        d["s_pre"] = s_full[:, dyn["server_doc_map"].long()].permute(1, 0, 2)
    if "tool_doc_map" in dyn:
        w_tool_tpl = dyn["w_tool_tpl"]
        t_full = _bm25_2d(dyn["q_tool"], w_tool_tpl, sc)
        if sc.rerank:
            v_full = _bm25_2d(dyn["q_rerank"], w_tool_tpl, sc)
        if not compact2:
            d["t_pre"] = t_full[:, dyn["tool_doc_map"].long()].permute(1, 0, 2)
            if sc.rerank:
                d["val_pre"] = v_full[:, dyn["tool_doc_map"].long()].permute(1, 0, 2)
    if "lat_t" in dyn:
        nt = _qos_2d(dyn["lat_t"], sc)                    # [M_t]
        if not compact2:
            d["qos_pre"] = nt[dyn["tel_map"].long()][:, None, :]   # [J, 1, s_pad]

    # -- stage 1: shard-local server top-s, then the merge (Eq. 2) --
    v_sh, gid_sh = _stage1_stacked(d, sc)
    top_s = min(sc.top_s, sc.n_servers)
    _, pos = topk(_flatten_shards(v_sh), top_s)
    cand_gids = torch.gather(_flatten_shards(gid_sh), -1, pos)

    # -- stage 2: candidate tools + telemetry terms, then the merge --
    if compact2:
        sel, val, qos, load, rtt, dead, aff, gid = _stage2_compact(
            d, t_full, v_full, nt, cand_gids, sc
        )
    else:
        outs = _stage2_stacked(d, cand_gids, sc)
        sel, val, qos, load, rtt, dead, aff, gid = (_flatten_shards(x) for x in outs)

    # -- the fused tail.  SONAR-ADAPT's live weight vector replaces the
    # static floats on its active terms; inactive terms keep the structural
    # literals so the reduction identities survive adaptation --
    aw = dyn.get("adapt_w")
    if sc.use_network and ("lat" in dyn or "lat_t" in dyn):
        eff_alpha, eff_beta = (aw[0], aw[1]) if aw is not None else (sc.alpha, sc.beta)
    else:
        eff_alpha, eff_beta = 1.0, 0.0
    if sc.use_load and "load" in dyn:
        eff_gamma = aw[2] if aw is not None else sc.gamma
    else:
        eff_gamma = 0.0
    if sc.use_rtt and ("rtt" in dyn or "rtt_region" in dyn):
        eff_delta = aw[3] if aw is not None else sc.delta
    else:
        eff_delta = 0.0
    dead_arg = dead if (sc.use_failover and "dead" in dyn) else None
    aff_active = sc.use_aff and "aff" in dyn
    k_final = min(sc.top_k, sc.n_tools)
    tail = ops.fused_select if sc.use_kernels else kref.fused_select_ref
    pos, c, n, s = tail(
        sel, val, qos, load, dead_arg,
        k=k_final, alpha=eff_alpha, beta=eff_beta, gamma=eff_gamma,
        tool_rtt=rtt, delta=eff_delta, tool_aff=aff if aff_active else None,
        eps=sc.eps if aff_active else 0.0, temp=sc.temp,
    )
    tool_idx = torch.gather(gid, -1, pos[:, None].long())[:, 0]
    server_idx = dyn["tool_server"][tool_idx.long()]
    return server_idx, tool_idx, c, n, s


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class ShardedRoutingEngine:
    """Shard-stacked drop-in for `BatchRoutingEngine` at mega-fleet scale.

    ``servers`` is the fleet (ignored when ``index`` is given); ``algo``
    one of the nine registered algorithms; ``n_shards`` the server-axis
    partitions, clamped to ``n_servers``.  ``index`` may be a prebuilt
    `ToolIndex` or a `TiledFleetIndex` (template-gathered scoring, no
    fleet-sized weight matrix anywhere).  ``mesh`` None or "auto" emulates
    the shards on ``device`` (None: the CUDA card, raising without one;
    "cpu" runs the plain versions); a device mesh raises
    NotImplementedError.  ``use_kernels`` defaults to True on the card.
    A tiled fleet takes the candidate-compacted stage 2 when every server
    hosts a tool and ``n_servers >= cfg.top_s`` (``self.compact_stage2``).
    ``adapt`` (implied by ``algo="sonar_adapt"``) turns on the SONAR-ADAPT
    learner: one replicated state, updated once per route.
    """

    def __init__(
        self,
        servers: Optional[Sequence[Server]] = None,
        cfg: RoutingConfig = RoutingConfig(),
        algo: str = "sonar",
        n_shards: int = 1,
        mesh=None,
        use_kernels: Optional[bool] = None,
        index=None,
        adapt: Optional[_adaptive.AdaptConfig] = None,
        device=None,
    ):
        if mesh is not None and not (isinstance(mesh, str) and mesh == "auto"):
            raise NotImplementedError(MESH_NOT_PORTED)
        self.mesh = None
        self.device = resolve_device(device)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        self.cfg = cfg
        self.algo = algo.lower().replace("-", "_")
        router_cls = routing.algorithm(self.algo)
        self.uses_prediction = router_cls.uses_prediction
        self.uses_network = router_cls.uses_network
        self.uses_load = router_cls.uses_load
        self.uses_staleness = router_cls.uses_staleness
        self.uses_failover = router_cls.uses_failover
        self.uses_rtt = router_cls.uses_rtt
        self.uses_affinity = router_cls.uses_affinity
        self.rerank = router_cls.rerank
        self.use_kernels = use_kernels
        if index is None:
            index = ToolIndex(servers)
        self.index = index
        self.tiled = bool(getattr(index, "is_tiled", False))
        self.n_servers = index.n_servers if self.tiled else len(index.servers)
        self.plan = make_shard_plan(np.asarray(index.tool_server), self.n_servers, n_shards)

        # device-resident static tensors
        plan = self.plan
        self._tool_server = self._to(index.tool_server, torch.int32)
        self._server_gid = self._to(plan.server_gid, torch.int32)
        self._server_valid = self._to(plan.server_valid, torch.bool)
        self._tool_gid = self._to(plan.tool_gid, torch.int32)
        self._tool_valid = self._to(plan.tool_valid, torch.bool)
        self._tool_host_g = self._to(plan.tool_host_global, torch.int32)
        self._tool_host_l = self._to(plan.tool_host_local, torch.int32)
        self._gid_long = self._server_gid.long()
        self.compact_stage2 = False
        k_slot = 0
        if self.tiled:
            # template weights, transposed [V, n_templates] as the BM25
            # kernel reads them; bf16-rounded ones stay bf16 on the card
            # (both BM25 paths widen them exactly)
            w_dtype = (torch.bfloat16 if getattr(index, "weights_dtype", "float32")
                       in ("bfloat16", "bf16") else torch.float32)
            self._w_server_tpl = self._to(index.server_corpus.weights.T, w_dtype)
            self._w_tool_tpl = self._to(index.tool_corpus.weights.T, w_dtype)
            self._server_doc_sh = self._to(index.server_doc_map[plan.server_gid], torch.int32)
            self._tool_doc_sh = self._to(index.tool_doc_map[plan.tool_gid], torch.int32)
            # candidate-compacted stage-2 tables: first global tool id, tool
            # count and first tool-doc id per server
            ts = np.asarray(index.tool_server, np.int64)
            counts = np.bincount(ts, minlength=self.n_servers)
            self.compact_stage2 = int(counts.min()) >= 1 and self.n_servers >= cfg.top_s
            if self.compact_stage2:
                starts = np.cumsum(counts) - counts
                self._tool_start_g = self._to(starts, torch.int32)
                self._tool_count_g = self._to(counts, torch.int32)
                self._tool_doc0_g = self._to(np.asarray(index.tool_doc_map)[starts], torch.int32)
                k_slot = int(counts.max())
        else:
            # shard-stacked weights, transposed [V, J, S] as the BM25
            # kernel reads them
            ws = np.asarray(index.server_corpus.weights, np.float32)
            wt = np.asarray(index.tool_corpus.weights, np.float32)
            self._w_server_sh = self._to(ws[plan.server_gid].transpose(2, 0, 1), torch.float32)
            self._w_tool_sh = self._to(wt[plan.tool_gid].transpose(2, 0, 1), torch.float32)

        self._sc = _StaticCfg(
            top_s=cfg.top_s, top_k=cfg.top_k,
            n_servers=self.n_servers, n_tools=int(index.n_tools),
            s_keep=min(cfg.top_s, plan.s_pad), k_keep=min(cfg.top_k, plan.t_pad),
            alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma,
            load_knee=cfg.load_knee, load_sharp=cfg.load_sharp,
            delta=cfg.delta, rtt_scale=cfg.rtt_scale_ms, temp=cfg.expertise_temp,
            stale_half_life=cfg.stale_half_life_s,
            use_network=self.uses_network, use_load=self.uses_load,
            use_staleness=self.uses_staleness, use_failover=self.uses_failover,
            use_rtt=self.uses_rtt, rerank=self.rerank, use_kernels=use_kernels,
            qos_params=cfg.qos, compact2=self.compact_stage2, k_slot=k_slot,
            use_aff=self.uses_affinity, eps=cfg.eps,
        )

        # SONAR-ADAPT learner: one state on the device, updated once per
        # route; every shard fuses with the same weight tensor
        self.learner = _adaptive.FeedbackLearner.for_engine(self.algo, cfg, adapt, self.device)

    def _to(self, x, dtype) -> torch.Tensor:
        """Host array (or tensor) -> this engine's device, cast to ``dtype``."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(device=self.device, dtype=dtype).contiguous()

    # -- host side ----------------------------------------------------------
    def encode(self, queries: Sequence[str]) -> EncodedBatch:
        """Strings -> term-count matrices (see `BatchRoutingEngine.encode`)."""
        return encode_for_index(self.index, self.uses_prediction, self.rerank, queries)

    def select_latency_ms(self) -> float:
        sl = LLM_CALL_MS + 2 * BM25_STAGE_MS
        if self.rerank:
            sl += LLM_RERANK_MS
        return sl

    # -- SONAR-ADAPT feedback (mirrors BatchRoutingEngine) -------------------
    @property
    def adapt_weights(self) -> Optional[np.ndarray]:
        return None if self.learner is None else self.learner.weights

    def observe_feedback(self, latency_ms: float, ok: bool = True, feats=None) -> None:
        if self.learner is not None:
            self.learner.observe(latency_ms, ok, feats)

    # -- sharding helpers ---------------------------------------------------
    def _shard_vec(self, x) -> torch.Tensor:
        """[n_servers] or [n_q, n_servers] -> [J, 1|n_q, s_pad]."""
        x = self._to(x, _F32)
        if x.ndim == 1:
            x = x[None]
        return x[:, self._gid_long].permute(1, 0, 2)

    def _shard_hist(self, lat) -> torch.Tensor:
        """[n_servers, T] -> [J, s_pad, T]; [n_q, n_servers, T] ->
        [J, n_q, s_pad, T]."""
        lat = self._to(lat, _F32)
        if lat.ndim == 2:
            return lat[self._gid_long]
        return lat[:, self._gid_long].permute(1, 0, 2, 3)

    # -- device side --------------------------------------------------------
    def route(
        self,
        batch: EncodedBatch,
        latency_hist=None,
        server_load=None,
        telemetry_age_s=None,
        failed_mask=None,
        client_rtt_ms=None,
        client_region=None,
        region_rtt_ms=None,
        affinity=None,
        *,
        telemetry_templates: Optional[tuple] = None,
        route_stats=None,
        n_real=None,
    ) -> BatchDecisions:
        """Route an encoded batch across the sharded fleet.

        Parameters mirror `BatchRoutingEngine.route`; additionally
        ``telemetry_templates=(compact [M, T], template_map [n_servers])``
        supplies telemetry in template-compact form (QoS per template row,
        gathered per server, no [n_servers, T] window anywhere).  For
        SONAR-GEO, ``(client_region [n_q], region_rtt_ms [n_regions,
        n_servers])`` keeps the RTT input compact the same way.
        ``route_stats`` and ``n_real`` as `BatchRoutingEngine.route`.
        """
        check_n_real(batch, n_real)
        if batch.n == 0:
            z = np.zeros((0,), np.float32)
            return BatchDecisions(
                server_idx=z.astype(np.int32), tool_idx=z.astype(np.int32),
                expertise=z, network=z, fused=z, select_latency_ms=self.select_latency_ms(),
            )
        dyn: dict = {
            "tool_server": self._tool_server,
            "server_gid": self._server_gid,
            "server_valid": self._server_valid,
            "tool_gid": self._tool_gid,
            "tool_valid": self._tool_valid,
            "tool_host_global": self._tool_host_g,
            "tool_host_local": self._tool_host_l,
            "q_server": self._to(batch.q_server, _F32),
            "q_tool": self._to(batch.q_tool, _F32),
        }
        if self.rerank:
            dyn["q_rerank"] = self._to(batch.q_rerank, _F32)
        if self.tiled:
            dyn["w_server_tpl"] = self._w_server_tpl
            dyn["w_tool_tpl"] = self._w_tool_tpl
            dyn["server_doc_map"] = self._server_doc_sh
            dyn["tool_doc_map"] = self._tool_doc_sh
            if self.compact_stage2:
                dyn["tool_start_g"] = self._tool_start_g
                dyn["tool_count_g"] = self._tool_count_g
                dyn["tool_doc0_g"] = self._tool_doc0_g
        else:
            dyn["w_server"] = self._w_server_sh
            dyn["w_tool"] = self._w_tool_sh
        if self.uses_network:
            if telemetry_templates is not None:
                compact, tmap = telemetry_templates
                dyn["lat_t"] = self._to(compact, _F32)
                dyn["tel_map"] = self._to(
                    np.asarray(tmap, np.int32)[self.plan.server_gid], torch.int32)
            elif latency_hist is not None:
                dyn["lat"] = self._shard_hist(latency_hist)
        if self.uses_load and server_load is not None and self.cfg.gamma != 0.0:
            dyn["load"] = self._shard_vec(server_load)
        if self.uses_staleness and telemetry_age_s is not None:
            dyn["age"] = self._shard_vec(telemetry_age_s)
        if self.uses_rtt and self.cfg.delta != 0.0:
            if client_rtt_ms is not None:
                dyn["rtt"] = self._shard_vec(client_rtt_ms)
            elif client_region is not None and region_rtt_ms is not None:
                rr = self._to(region_rtt_ms, _F32)
                dyn["rtt_region"] = rr[:, self._gid_long].permute(1, 0, 2)  # [J, R, s_pad]
                dyn["region_idx"] = self._to(client_region, torch.int32)
        if self.uses_failover and failed_mask is not None:
            dyn["dead"] = self._shard_vec(np.asarray(failed_mask, np.float32))
        if self.uses_affinity and affinity is not None and self.cfg.eps != 0.0:
            dyn["aff"] = self._shard_vec(affinity)
        adapt_w = None if self.learner is None else self.learner.pending_weights()
        if adapt_w is not None:
            dyn["adapt_w"] = adapt_w
        with torch.profiler.record_function("netmcp.route_sharded"):
            server_idx, tool_idx, c, n, s = _route_sharded(dyn, self._sc)
        if route_stats is not None:
            # this call's device outputs, before any host conversion
            route_stats.accumulate(server_idx, c, n, s, n_real=n_real)
        return BatchDecisions(
            server_idx=server_idx.cpu().numpy().astype(np.int32),
            tool_idx=tool_idx.cpu().numpy().astype(np.int32),
            expertise=c.cpu().numpy(), network=n.cpu().numpy(), fused=s.cpu().numpy(),
            select_latency_ms=self.select_latency_ms(),
        )

    def route_texts(
        self,
        queries: Sequence[str],
        latency_hist=None,
        server_load=None,
        telemetry_age_s=None,
        failed_mask=None,
        client_rtt_ms=None,
        client_region=None,
        region_rtt_ms=None,
        affinity=None,
        *,
        telemetry_templates: Optional[tuple] = None,
    ) -> BatchDecisions:
        return self.route(
            self.encode(queries), latency_hist, server_load, telemetry_age_s, failed_mask,
            client_rtt_ms, client_region, region_rtt_ms, affinity,
            telemetry_templates=telemetry_templates,
        )


def make_sharded_engine(
    algo: str,
    servers: Optional[Sequence[Server]] = None,
    cfg: RoutingConfig = RoutingConfig(),
    n_shards: int = 1,
    **kw,
) -> ShardedRoutingEngine:
    return ShardedRoutingEngine(servers, cfg, algo=algo, n_shards=n_shards, **kw)
