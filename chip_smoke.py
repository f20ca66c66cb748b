"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py              # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse   # the same control flow on the CPU,
                                       # tiny fleet, no kernels; exits 3

Drives the port's two paths through the entry points a user calls, and
holds them to account.  The single-device path,
``make_engine(algo, fleet).route_texts(...)``, runs the eight hand-tuned
algorithms at a 10,005-server mock cluster (20,010 tools) and 256-query
batches.  The mega-fleet path,
``make_sharded_engine(algo, index=mega_fleet_index(1_000_000)).route_texts(...)``,
runs all nine algorithms (SONAR-ADAPT included) over 4 emulated shards of a
template-tiled million-server fleet with bf16 weights and compact telemetry
(the ``--max`` point of ``benchmarks/mega_fleet.py``).  The serving path,
``ServeEngine(get_model(cfg), params, n_slots=8, cap=2048).drain()``, serves
16 requests through internlm2-1.8b at full width and depth (24 layers,
d_model 2048, 16/8 heads, vocab 92672, bf16, random weights drawn on the
card from a seed) with ``attn_impl="pallas"``: the flash-attention kernel
in every prefill, the flash-decode kernel in every decode step.  Above the
engines, the paper harness (``BatchAgent(NetMCPPlatform(...), engine)
.run_benchmark(...)``) and the serving gateway (``MicroBatchPump(
SonarGateway(...)).replay(...)``) run at the 10,005-server fleet's size,
and so do the scenario axes: chaos (``NetMCPPlatform(..., chaos=
build_schedule(standard_fault_mix(1.0, ...)))``) and the WAN layer
(``build_topology`` / ``GeoPlacement``), with the reference benchmarks'
gates run through ``FleetTrafficSim`` and ``SessionTrafficSim``.  The
serving launcher (``repro_torch.launch.serve``: ``serve_sync`` and
``serve_online``) drives the replicas and the gateway end to end, with the
audit tap and the device route statistics on.  The MoE decoders
(deepseek-moe-16b, llama4-scout) and the recurrent families (the Mamba-2
hybrid jamba-1.5-large-398b at full width, xlstm-125m at full width and
depth) are served through the same ``ServeEngine``.

1. set-up: TF32 off, the card's name and power limit, both fleets, the
   queries and seeded telemetry;
2. each CUDA kernel (built from ``src/repro_torch/csrc`` on first use)
   against its plain PyTorch version at its paths' shapes: ``bm25_scores``
   and ``fused_score_select`` bit for bit (``torch.equal``) on the fleet,
   a fully dense query batch and bf16 weights, the fused stage 2 also with
   rerank and live weights, through the engine's server -> tools map and
   through the one the wrapper builds when given none; ``fused_select``
   bit for bit at the mega tail's [256, 16], a dense-shard merge
   [256, 4 x 16] and the full tool axis [256, 20010], and on edge rows
   (-0/+0 ties, all equal, all -inf, all NEG) at widths 16, 257 and 20010;
   ``qos_scores`` on the shared and per-query windows, a [n, 63] window and
   a view that is not 16-byte aligned; the attention kernels at the serving
   shapes (flash prefill [1, 16, S, 128] against 8 kv heads in the model's
   strided layout, S 2048, 1000 and the launcher's 16; flash decode of 8
   slots against [8, 2048, 8, 128] caches with lengths 1 to 2048, and the
   launcher's 4 slots against [4, 256, 8, 128] at lengths 17 to 23) and at
   phase 3h's head layouts (deepseek-moe-16b's G = 1: flash [1, 16, S,
   128] against 16 kv heads at S 2048 and 1000, decode of 8 slots against
   [8, 2048, 16, 128]; llama4-scout's G = 5: flash [1, 40, S, 128] against
   8 kv heads, decode of 4 slots against [4, 1024, 8, 128]) and phase 3i's
   (Jamba's G = 8: flash [1, 64, S, 128] against 8 kv heads at S 1100 and
   257, decode of 4 slots against [4, 1280, 8, 128]), bf16 and f32;
3. the single-device path with the launch counters set to 0: every
   kernel-path decision equal to the plain path's on the same card, every
   counter risen by exactly one launch per route, a per-query telemetry
   step, a failover loop, and a sample of decisions against the scalar
   router;
3b. the mega-fleet path with the counters set to 0 again: nine algorithms
   on the kernel path equal to the plain path, ``fused_select`` launched
   once per sharded route; then the sharded engine against the densified
   single engine at 100,000 servers, and SONAR-ADAPT feedback rounds
   (lr > 0) on both engines, kernel path against plain path;
3c. the serving path with the counters set to 0 again: 16 requests
   (seeded prompts of 64 to 1536 tokens, 32 new tokens each) through 8
   slots to ``drain``; every request must finish, ``flash_attention`` must
   launch 24 times per admitted request and ``decode_attention`` 24 times
   per decode step; then the same requests teacher-forced through a
   plain-path engine (``attn_impl="chunked"``, no kernel) on the same
   weights: every first token equal, every prefill and decode row of logits
   within ``SERVE_TOL``, and every argmax that differs within it too;
3d. the paper harness with the counters set to 0 before each part: (a)
   the paper's pool (15 servers, 120 queries, 60 ticks a query, platform
   seed 1, traces drawn on the card), Table II's grid (PRAG, SONAR,
   hybrid) and Fig. 7's four algorithms (ideal) through ``BatchAgent``,
   Table II's headline and Fig. 7's ranking checked; (b) PRAG, SONAR and
   SONAR-FT episodes of 256 tasks over the 10,005-server fleet on 24 h
   hybrid traces, per-query ``[256, 10005, 64]`` windows; every turn's
   decisions and every record of the kernel path equal to the plain
   path's, the launches one BM25, one fused stage 2 and (network-aware)
   one per-query QoS per turn;
3e. the gateway with the counters set to 0: a seeded Poisson schedule
   through the ``MicroBatchPump`` (padded flushes, a fixed service time)
   over a ``SonarGateway`` of 10,005 replicas, SONAR and SONAR-LB, with
   ``shards=None`` and ``shards=4`` (the device ring, the fused
   selection); picks, results and end state equal to the plain path's;
3f. the scenario axes with the counters set to 0 before each engine part:
   (a) ``standard_fault_mix(1.0, 10005, 86400)`` compiled by
   ``build_schedule`` on the card (timed, and its crash recurrence alone),
   then PRAG, SONAR, SONAR-LB and SONAR-FT ``BatchAgent`` episodes of 256
   tasks (2 turns at most, a share starting inside the partition and the
   blackout) on the chaos platform; every turn's decisions and every record
   equal to the plain path's, one BM25, one fused stage 2 and (network-aware)
   one per-query QoS launch per turn; (b) ``build_topology(6, seed=2024)``
   with its overlays drawn on the card and ``place_servers(10005, 6)``,
   SONAR-GEO routes of 256 queries from client regions drawn from
   ``client_populations(6, skew=1.0)`` at three ticks, equal to the plain
   path's and to the scalar ``SonarGeoRouter`` on the first 16 queries;
   (c) the gates of ``benchmarks/offered_load.py``, ``chaos_recovery.py``,
   ``geo_routing.py`` and ``session_routing.py`` at their non-smoke sizes
   (the smoke sizes in the rehearsal), every generator on the card, with
   their conservation checks;
3g. the serving launcher (``repro_torch.launch.serve``) and the device-side
   observability, with the counters set to 0 before each part: (a)
   ``serve_sync`` over 4 internlm2-1.8b replicas at full width sharing one
   set of weights (4 slots, cap 256, 24 requests of 8 new tokens, hybrid
   profiles, ``attn_impl="pallas"``) with ``Observability(trace=True,
   audit=True)``: flash launches 24 per admitted request, decode 24 per
   decode step, every audit record recomposing its decision bit for bit,
   copies of the inputs of six of its own attention calls (prefill and
   decode, first and last layers) held to the plain versions, and picks,
   latencies, outcomes and ``report()`` equal to a second run on the plain
   attention (the executor's latency is the network trace's, so these do
   not depend on the attention's output); (b) ``serve_online`` at its
   defaults (4 replicas, SONAR-LB, Poisson 200 rps over 1 s, max_batch 16,
   max_wait_ms 5) and at 10,005 replicas, with ``--trace``, ``--metrics-json`` (a temporary
   directory) and ``--dashboard`` (a buffer): offered = routed + shed +
   expired, the registry's and the folded device route stats' counts equal
   the results', picks per replica exact, the BM25, QoS and fused stage-2
   kernels launched and the fused selection not; (c) phase 3e's sharded
   pump replay with ``Observability(trace=True, jit_stats=True)``: the fold
   equal to the results' tally, the drain under
   ``set_sync_debug_mode("error")``; (d) ``benchmarks/obs_overhead.py``'s
   A/B (3 interleaved trials a side, flash crowd at 0.75x the batch-oracle
   rate, 4 replicas): both p99s and the overhead, printed, not gated;
3h. the MoE serving path, with the counters set to 0 before each serving
   run: (a) deepseek-moe-16b at full width and depth (28 layers: the dense
   prelude of d_ff 10944, then 27 MoE layers of 64 routed experts top-6 +
   2 shared, 16/16 heads, bf16, weights drawn on the card from a seed, the
   parameter count held to ``param_counts()``), 16 requests (prompts of 64
   to 1536 tokens, 32 new each) through 8 slots of cap 2048 to ``drain``,
   as in 3c, with both paths' expert choices logged: every request
   finishes, ``flash_attention`` launches 28 times per admitted request and
   ``decode_attention`` 28 times per decode step; the teacher-forced plain
   path runs twice, once routing by itself (the (token, layer) pairs whose
   expert sets differ counted, and ``SERVE_TOL``, the first tokens and the
   argmax check held on the rows of logits where none differs) and once
   with the kernel path's expert choices (its own still counted; every row
   within ``SERVE_TOL``, every first token equal); (d) one of its MoE
   layers ([2, 256, 2048]) run twice
   on the card, bit for bit, and against its CPU run: slot, token_of and
   the kept mask equal given the same router logits (and on the CPU's own
   when they give the same expert sets), y within bf16 tolerance; (b) the same
   model cut to 4 layers (the prelude + 3 MoE) in f32, 6 requests, every
   expert choice equal on the two paths and the logits within
   ``F32_SERVE_TOL``; (c) llama4-scout-17b-a16e at full width over 4 of
   its 48 layers (16 experts top-1 + 1 shared, 40/8 heads), 8 requests
   through 4 slots of cap 1024, the gates of (a).  Each model is freed
   before the next is drawn;
3i. the recurrent families, with the counters set to 0 before each serving
   run: (a) jamba-1.5-large-398b at full width (d_model 8192, 64/8 heads,
   d_ff 24576, Mamba-2 d_state 16, 256 heads of 64, chunk 256, vocab 65536,
   bf16) cut to one period of its block pattern (8 of 72 layers: attention
   + 7 Mamba, MoE at layers 1/3/5/7) and 8 of its 16 experts (top-2), the
   cut logged; 8 requests with prompts of 3, 255, 256, 257, 511, 700, 1024
   and 1100 tokens, 16 new each, through 4 slots of cap 1280, with 3h's
   gates: one ``flash_attention`` launch per admitted request and one
   ``decode_attention`` launch per decode step, the plain path routing by
   itself and with the kernel path's expert choices; (b) one Mamba block at
   Jamba's full width in f32: ``ssd_chunked`` against ``ssd_scan_ref`` on
   600 tokens (rtol = atol = 1e-4) and ``mamba_apply`` over 600 tokens plus
   8 ``mamba_decode`` steps against ``mamba_apply`` over 608 (2e-3), the
   reference's bounds; (c) xlstm-125m at full width and depth (12 layers,
   mLSTM and sLSTM alternating), bf16, 16 requests (prompts of 64 to 512
   tokens, 32 new each) through 8 slots, no kernel launched; (d) the same
   in f32 twice, mLSTM's prefill chunked and through ``mlstm_scan_ref``:
   every first row of logits within ``F32_SERVE_TOL``, the greedy tokens
   equal;
4. times: each kernel's median over CUDA-event-timed launches beside its
   plain version, one library call where there is one, and its bound; the
   end-to-end ``route_texts`` time per batch on both paths; a profile of one
   route of each path; the attention kernels at the serving shapes beside
   their plain versions and ``scaled_dot_product_attention``; BM25 (with
   the columns its queries use and their non-zero terms), QoS (both
   windows), the fused stage 2, the selection (mega tail and full axis) and
   the attention kernels each also as device time per call from a profile
   (the kernel alone, without the wrapper's host work), beside the library
   call's where there is one, an empty launch's, and that of one
   ``torch.sum`` over the per-query window (a plain read of the same
   bytes); the count of HGMMA (wgmma) instructions in the
   flash library's SASS, which must not be 0; a profile of one 1536-token
   prefill and one 8-slot decode step of internlm2-1.8b; one
   ``BatchAgent`` turn at 10,005 servers (the host's ``latency_windows``,
   its copy and the route apart), the same turn under phase 3f's chaos
   schedule (SONAR-FT with per-query telemetry ages) and one pump flush of
   32 requests on each gateway, with profiles, and replays with the flush
   time measured; one flush of 16 requests of phase 3g (b)'s online
   gateway at 10,005 replicas, with a profile; a profile of one 1536-token
   prefill and one 8-slot decode step of deepseek-moe-16b (device busy
   share, the attention kernels' and the expert products' shares) and the
   decode step against its byte bound; the same for phase 3i's Jamba (a
   1024-token prefill and a 4-slot decode step) and xlstm-125m (a 512-token
   prefill and an 8-slot decode step), with the shares of the port's
   profiler labels (the SSD chunk loop, the Mamba, mLSTM and sLSTM mixers,
   the expert products).

The line before the last is the ``kernels`` JSON object; the last is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

RTOL, ATOL = 2e-6, 2e-7          # the port's parity tolerance for C, N, S
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM, f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM, bf16 dense tensor cores
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # rtol = atol, tests/test_kernels.py's
# Teacher-forced serving: max |logit difference| between the kernel path
# (P kept in f32) and the plain path (P rounded to bf16 before PV, sums in
# other orders) over every prefill and decode row, on logits of std ~1.
# bf16 activations round differently on the two paths, and the difference
# grows over 24 layers and 32 decode steps (on an H100 this run reads about
# 0.09 in prefill and 0.23 in decode; PERF.md).  This holds the whole
# serving path to the plain path; the kernels themselves are held to their
# plain versions at rtol = atol = 2e-2 (bf16) in phase 2 and in
# tests/test_torch_cuda.py.
SERVE_TOL = 0.5
# Phase 3h holds the MoE models to SERVE_TOL too.  In bf16 the router's
# logits are bf16 values, and near the top-k boundary of 64 experts two of
# them lie within a bf16 ulp about a fifth of the time, so the rounding
# differences between the two paths pick other experts for many (token,
# layer) pairs (on an H100 deepseek-moe-16b read 26 % of pairs when the
# plain path routes by itself, 9.6 % of its own choices when it is given the
# kernel path's, and logits within 0.31 on every row then; PERF.md).  So the
# plain path is also run with the kernel path's expert choices (routing
# teacher-forced like the tokens), where every row is held.
# Phase 3h (b)'s f32 comparison (deepseek-moe-16b at 4 layers): the paths
# differ only in the attention's summation order, so every expert choice is
# the same, and the logits agree to f32 rounding carried through 4 layers
# (1.3e-5 on an H100).
F32_SERVE_TOL = 1e-3
ALGOS = ("rag", "rerank_rag", "prag", "sonar", "sonar_lb", "sonar_ft",
         "sonar_geo", "sonar_session")
MEGA_ALGOS = ALGOS + ("sonar_adapt",)
REPLACES = {
    "bm25_scores": "src/repro/kernels/bm25_score.py:31",
    "qos_scores": "src/repro/kernels/qos_score.py:32",
    "fused_score_select": "src/repro/kernels/score_fuse.py:53",
    "fused_select": "src/repro/kernels/select_fuse.py:66",
    "flash_attention": "src/repro/kernels/flash_attention.py:34",
    "decode_attention": "src/repro/kernels/decode_attention.py:28",
}
SOURCES = {
    "bm25_scores": "src/repro_torch/csrc/bm25_score.cu",
    "qos_scores": "src/repro_torch/csrc/qos_score.cu",
    "fused_score_select": "src/repro_torch/csrc/score_fuse.cu",
    "fused_select": "src/repro_torch/csrc/select_fuse.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
}


# the paper's (#filter_server, #filter_tool) grid of Table II
# (benchmarks/common.py: FILTER_GRID)
FILTER_GRID = ((3, 6), (4, 8), (5, 10), (6, 12))
# the gateway's replica mix: one family per serving architecture
REPLICA_ARCHS = (
    ("internlm2-1.8b", "dense"), ("qwen2-7b", "dense"), ("yi-6b", "dense"),
    ("minitron-4b", "dense"), ("deepseek-moe-16b", "moe"), ("llama4-scout-17b-a16e", "moe"),
    ("jamba-1.5-large", "hybrid"), ("xlstm-125m", "ssm"), ("whisper-tiny", "audio"),
    ("internvl2-1b", "vlm"),
)
GATEWAY_TEXTS = (
    "generate a chat reply about weekend travel plans",
    "transcribe this meeting recording and translate the speech",
    "summarize this long contract document",
    "answer a question about the chart in this image",
    "stream a low latency completion for the editor",
    "high throughput text generation for a batch of prompts",
    "general purpose chat completion for a customer question",
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def setup_imports():
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"the port's sources are missing: no {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))


def record_routes(engine) -> list:
    """Keep every `BatchDecisions` an engine's `route` returns, in order
    (one entry per route call: per episode turn, per gateway engine call)."""
    calls = []
    route = engine.route

    def recorded(*a, **k):
        d = route(*a, **k)
        calls.append(d)
        return d

    engine.route = recorded
    return calls


class ExpertLog:
    """While active, every MoE layer call (`repro_torch.models.mlp._route`)
    goes through ``route``: the calls' expert choices (``sel`` [B, S, K])
    are kept in call order (``calls``), and `take` hands over those made
    since the last take as [n_calls, B, S, K] with each token's experts
    sorted (a set), on the host.

    With ``forced`` (the calls of another run of the same schedule) the
    layers take that run's choices instead of their own, call by call, with
    their own router probabilities at those experts as weights (teacher
    forcing of the routing, as the tokens are teacher-forced); their own
    choices are still what ``calls`` keeps."""

    def __init__(self, forced=None):
        self.forced = forced

    def __enter__(self):
        from repro_torch.models import mlp

        import torch

        self._mlp, self._route, self.calls, self._taken = mlp, mlp._route, [], 0

        def route(p, cfg, x):
            probs, gate_w, sel = self._route(p, cfg, x)
            self.calls.append(sel)
            if self.forced is not None:
                sel = self.forced[len(self.calls) - 1]
                if sel.shape != self.calls[-1].shape:
                    raise RuntimeError("ExpertLog: the forced run took another schedule")
                gate_w = torch.gather(probs, -1, sel)
                gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
            return probs, gate_w, sel

        mlp._route = route
        return self

    def __exit__(self, *exc):
        self._mlp._route = self._route

    def take(self):
        import torch

        calls, self._taken = self.calls[self._taken:], len(self.calls)
        return torch.sort(torch.stack(calls), dim=-1).values.cpu() if calls else None


def serve_requests(cfg, plain_cfg, params, dev, n_slots, cap, prompts, max_new, tol,
                   experts=(), failures=None):
    """The serving path: ``prompts`` through a `ServeEngine` of ``cfg``
    (the kernel path) to `drain`, with the kernels' launch counters set to 0
    just before and read just after; then the same requests, teacher-forced
    with the kernel path's tokens, through an engine of ``plain_cfg`` (the
    plain PyTorch attention) on the same weights.  Every prefill and decode
    row of logits is compared: the max abs difference must stay within
    ``tol``, every first token must be equal, and wherever the plain path's
    argmax differs from the kernel path's token, the plain logit of that
    token must be within ``tol`` of the plain maximum (so the top-2 margin
    is too).

    ``experts`` (a MoE model) names the plain runs to make, each logging
    both paths' expert choices (`ExpertLog`): each row of logits is paired
    with the choices made for its tokens (a prefill row: every prompt token
    at every MoE layer; a decode row: the new token at every MoE layer), and
    the (token, layer) pairs whose expert sets differ are counted.  In the
    ``"own"`` run the plain path routes by itself: a near-tie of two router
    probabilities can pick another expert when the paths' activations differ
    by rounding, so the checks hold on the rows where no choice differs.
    In the ``"forced"`` run the plain path takes the kernel path's choices
    (its own are still counted), and the checks hold on every row.
    ``failures`` (a list) collects the breaches instead of failing at once.
    Returns a dict of what was seen, ``by_run`` holding each plain run's."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import Request, ServeEngine

    def breach(msg):
        fail(msg) if failures is None else failures.append(msg)

    kernel_rows = {}                     # (rid, position) -> kernel logits row
    kernel_sets = {}                     # (rid, position) -> [layers, tokens, K] expert sets
    klog = ExpertLog()

    def row_sets(log_, reqs):
        """Each request row's expert sets of the last forward, by row."""
        sets = log_.take() if experts else None
        return {} if sets is None else \
            {i: sets[:, i] for i, r in enumerate(reqs) if r is not None}

    class Recording(ServeEngine):
        def _next_tokens(self, logits, reqs):
            sets = row_sets(klog, reqs)
            for i, r in enumerate(reqs):
                if r is not None:
                    kernel_rows[r.rid, len(r.generated)] = logits[i].clone()
                    if experts:
                        kernel_sets[r.rid, len(r.generated)] = sets[i]
            return super()._next_tokens(logits, reqs)

    class TeacherForced(ServeEngine):
        def _next_tokens(self, logits, reqs):
            sets = row_sets(plog, reqs)
            out = []
            for i, r in enumerate(reqs):
                if r is None:
                    out.append(0)
                    continue
                pos = len(r.generated)
                want = kernel_rows[r.rid, pos]
                tok = kreqs[r.rid].generated[pos]
                row = logits[i]
                d = float((row - want).abs().max())
                stats["all_rows_max_abs"] = max(stats["all_rows_max_abs"], d)
                n_diff = 0
                if experts:
                    differ = (sets[i] != kernel_sets[r.rid, pos]).any(-1)   # [layers, tokens]
                    n_diff = int(differ.sum())
                    stats["expert_pairs"] += differ.numel()
                    stats["expert_pair_diffs"] += n_diff
                    stats["rows_expert_diff"] += int(n_diff > 0)
                held = run != "own" or n_diff == 0
                top = int(torch.argmax(row))
                if top != tok and pos == 0:
                    stats["first_token_diffs"].append(
                        (r.rid, round(float(row[top] - row[tok]), 4), n_diff, round(d, 4), held))
                if held:
                    key = "prefill_max_abs" if pos == 0 else "decode_max_abs"
                    stats[key] = max(stats[key], d)
                    stats["rows"] += 1
                    if top != tok:
                        stats["argmax_diffs"].append((r.rid, pos, float(row[top] - row[tok])))
                out.append(tok)
            return out

    def requests():
        return [Request(rid=i, tokens=t, max_new_tokens=max_new) for i, t in enumerate(prompts)]

    obs = Observability()
    keng = Recording(get_model(cfg), params, n_slots=n_slots, cap=cap, device=dev, obs=obs)
    kreqs = requests()
    for r in kreqs:
        keng.submit(r)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    with klog:
        ops.reset_launches()                   # the serving path's count starts here
        t0 = time.perf_counter()
        steps = keng.drain()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()         # ... and is read here
    del keng
    reg = obs.registry
    if not all(r.done and len(r.generated) == max_new for r in kreqs):
        fail(f"serving: {sum(not r.done for r in kreqs)} requests did not finish")
    by_run = {}
    for run in experts or (None,):
        stats = {"prefill_max_abs": 0.0, "decode_max_abs": 0.0, "rows": 0, "argmax_diffs": [],
                 "first_token_diffs": [], "expert_pairs": 0, "expert_pair_diffs": 0,
                 "rows_expert_diff": 0, "all_rows_max_abs": 0.0}
        before = ops.launch_counts()
        peng = TeacherForced(get_model(plain_cfg), params, n_slots=n_slots, cap=cap, device=dev)
        preqs = requests()
        for r in preqs:
            peng.submit(r)
        plog = ExpertLog(forced=klog.calls if run == "forced" else None)
        t0 = time.perf_counter()
        with plog:
            psteps = peng.drain()
        stats["wall_s"] = time.perf_counter() - t0
        del peng, plog
        what = f"serving ({run} routing)" if run else "serving"
        if ops.launch_counts() != before:
            fail(f"{what}: the plain path launched an attention kernel")
        if psteps != steps or [r.generated for r in preqs] != [r.generated for r in kreqs]:
            fail(f"{what}: the teacher-forced plain engine took another schedule")
        first = [f for f in stats["first_token_diffs"] if f[4]]
        if first:
            breach(f"{what}: {len(first)} first tokens differ between the kernel and plain "
                   f"paths (rid, plain-logit gap, differing expert pairs, max abs, held): "
                   f"{first}")
        worst = max(stats["prefill_max_abs"], stats["decode_max_abs"])
        if not worst <= tol:
            breach(f"{what}: logits differ by {worst} between the kernel and plain paths "
                   f"(tolerance {tol})")
        bad = [d for d in stats["argmax_diffs"] if d[2] > tol]
        if bad:
            breach(f"{what}: argmax differs beyond the tolerance at {bad[:5]}")
        by_run[run] = stats
    return dict(by_run[(experts or (None,))[0]], by_run=by_run, steps=steps, wall_s=wall,
                launches=launches, admitted=int(reg.value("engine_admitted_total")),
                tokens=int(reg.value("engine_tokens_total")), requests=kreqs)


# the reference benchmarks' query texts (benchmarks/offered_load.py,
# geo_routing.py, session_routing.py; chaos_recovery.py has its own)
BENCH_TEXTS = (
    "what is the latest news about the stock market today",
    "search the web for current weather information",
    "find recent articles about machine learning research",
    "look up live election results online",
)
CHAOS_TEXTS = (
    "search the web for current news about the economy",
    "look up live information online about the election",
    "find real-time facts on the internet about the weather",
    "web search for fresh articles about machine learning",
)


def conserved(rep, what):
    """A `TrafficReport`'s conservation: every offered request completed or
    failed."""
    if rep.n_completed + rep.n_failed != rep.n_offered:
        fail(f"{what}: offered {rep.n_offered} != completed {rep.n_completed} + failed "
             f"{rep.n_failed}")


def gate_offered_load(dev, smoke):
    """`benchmarks/offered_load.py` on the port's streams: SONAR vs SONAR-LB
    over identical replicas; SONAR-LB must win goodput and p99 at two load
    points past single-server saturation (one at the smoke size)."""
    import torch

    from repro_torch.core.routing import RoutingConfig, make_router
    from repro_torch.traffic import (FleetTrafficSim, QueueConfig, ideal_platform,
                                     poisson_arrivals, replica_fleet)

    qc = QueueConfig(capacity=2, queue_limit=8, base_service_ms=500.0, inflation=1.0)
    n, rates, horizon = (4, (2.0, 8.0), 45.0) if smoke else (6, (2.0, 6.0, 8.0, 12.0), 120.0)
    cfg = RoutingConfig(gamma=0.35, top_s=n, top_k=n)
    sat = qc.capacity * 1000.0 / qc.base_service_ms
    pts, rows = {}, []
    for rate in rates:
        for algo in ("sonar", "sonar_lb"):
            servers = replica_fleet(n)
            plat = ideal_platform(servers, seed=0, horizon_s=4.0 * horizon, device=dev)
            arr = poisson_arrivals(torch.Generator(device=dev).manual_seed(0), rate, horizon)
            rep = FleetTrafficSim(plat, make_router(algo, servers, cfg), qc, retry_budget=2,
                                  seed=0, device=dev).run(arr, BENCH_TEXTS)
            conserved(rep, f"offered_load {algo} {rate}")
            pts[rate, algo] = rep
            rows.append(f"{rate:.1f} rps {rep.row(algo)}")
    won = [r for r in rates if r > sat
           and pts[r, "sonar_lb"].goodput_rps > pts[r, "sonar"].goodput_rps
           and pts[r, "sonar_lb"].p99_ms < pts[r, "sonar"].p99_ms]
    if len(won) < (1 if smoke else 2):
        fail(f"offered_load: SONAR-LB won at only {len(won)} post-saturation load points: {rows}")
    return rows, f"SONAR-LB wins goodput and p99 past saturation ({sat:.0f} rps) at {won} rps"


def gate_chaos_recovery(dev, smoke):
    """`benchmarks/chaos_recovery.py` on the port's streams, through the
    scalar `Agent`: SONAR-FT >= SONAR, SONAR-LB and PRAG on success and
    failures at every intensity, strictly (and no longer degraded) at the
    highest."""
    import numpy as np

    from repro_torch.chaos import build_schedule, standard_fault_mix
    from repro_torch.core import latency as L
    from repro_torch.core.agent import Agent, spread_start_ticks
    from repro_torch.core.dataset import Query
    from repro_torch.core.platform import NetMCPPlatform
    from repro_torch.core.routing import RoutingConfig, make_router
    from repro_torch.traffic import replica_fleet

    n, horizon, n_q, max_turns = (6, 600.0, 60, 4) if smoke else (6, 900.0, 160, 4)
    xs = (0.0, 0.5, 1.0) if smoke else (0.0, 0.3, 0.6, 1.0)
    queries = [Query(text=CHAOS_TEXTS[i % 4], intent="websearch", answer="ok") for i in range(n_q)]
    pts, rows = {}, []
    for x in xs:
        faults = standard_fault_mix(x, n, horizon)
        n_steps = L.trace_horizon_steps(horizon, 1.0)
        chaos = build_schedule(faults, n, n_steps, 1.0, seed=0, device=dev) if faults else None
        for algo in ("prag", "sonar", "sonar_lb", "sonar_ft"):
            servers = replica_fleet(n)
            plat = NetMCPPlatform(servers, profiles=[L.ideal_profile() for _ in servers],
                                  scenario="ideal", seed=0, horizon_s=horizon, dt_s=1.0,
                                  chaos=chaos, device=dev)
            agent = Agent(plat, make_router(algo, servers, RoutingConfig(top_s=n, top_k=n)),
                          max_turns=max_turns)
            ticks = spread_start_ticks(n_q, plat.n_steps, max_turns, agent.ticks_per_turn,
                                       ticks_per_query=max((plat.n_steps - max_turns - 1) // n_q,
                                                           1))
            recs = [agent.run_task(q, int(t)) for q, t in zip(queries, ticks)]
            # degraded seconds: 24 bins of the horizon from the first fault on
            # whose success rate is below 95 %
            onset = min(f.start_s for f in faults) if faults else horizon
            edges = np.linspace(0.0, horizon, 25)
            degraded = 0.0
            for lo, hi in zip(edges[:-1], edges[1:]):
                sel = (ticks >= lo) & (ticks < hi)
                if hi > onset and sel.any() and np.mean([recs[i].success for i in
                                                         np.flatnonzero(sel)]) < 0.95:
                    degraded += hi - lo
            p = dict(ssr=100.0 * float(np.mean([r.success for r in recs])),
                     failures=int(sum(r.n_failures for r in recs)), recovery_s=degraded)
            pts[x, algo] = p
            rows.append(f"x={x:.1f} {algo} ssr={p['ssr']:.1f}% failures={p['failures']} "
                        f"recovery={p['recovery_s']:.0f}s")
    for x in xs:
        ft = pts[x, "sonar_ft"]
        for base in ("sonar", "sonar_lb", "prag"):
            b = pts[x, base]
            if not (ft["ssr"] >= b["ssr"] and ft["failures"] <= b["failures"]):
                fail(f"chaos_recovery x={x}: SONAR-FT {ft} loses to {base} {b}")
            if x == xs[-1] and not (ft["ssr"] > b["ssr"] and ft["failures"] < b["failures"]
                                    and ft["recovery_s"] <= b["recovery_s"]):
                fail(f"chaos_recovery x={x}: SONAR-FT {ft} does not strictly beat {base} {b}")
    return rows, (f"SONAR-FT >= SONAR, SONAR-LB, PRAG on success and failures at x in {xs}, "
                  f"strictly at x={xs[-1]}")


def gate_geo_routing(dev, smoke):
    """`benchmarks/geo_routing.py` on the port's streams: SONAR-GEO's p99 <=
    SONAR-LB's and its local share >= at every RTT-dominant point, p99
    strictly better at the most RTT-dominated point of each region count."""
    import numpy as np
    import torch

    from repro_torch.core.routing import RoutingConfig, make_router
    from repro_torch.geo import (GeoPlacement, build_topology, client_populations,
                                 place_servers, regional_arrivals)
    from repro_torch.traffic import FleetTrafficSim, QueueConfig, ideal_platform, replica_fleet

    qc = QueueConfig(capacity=2, queue_limit=8, base_service_ms=150.0, inflation=1.0)
    counts, scales = ((3,), (0.0, 3.0, 6.0)) if smoke else ((2, 4), (0.0, 1.0, 3.0, 6.0))
    per_region, rate, horizon = 3, 6.0, (40.0 if smoke else 90.0)
    pts, rows = {}, []
    for n_regions in counts:
        for scale in scales:
            for algo in ("sonar_lb", "sonar_geo"):
                n = n_regions * per_region
                topo = build_topology(n_regions, seed=0, horizon_s=4.0 * horizon, dt_s=1.0,
                                      rtt_scale=scale, device=dev)
                place = GeoPlacement(topo, place_servers(n, n_regions),
                                     client_populations(n_regions, skew=1.5))
                servers = replica_fleet(n)
                plat = ideal_platform(servers, seed=0, horizon_s=4.0 * horizon, geo=place,
                                      device=dev)
                arr, regs = regional_arrivals(torch.Generator(device=dev).manual_seed(0), place,
                                              rate, horizon)
                rep = FleetTrafficSim(plat, make_router(algo, servers, RoutingConfig(
                    top_s=n, top_k=n)), qc, retry_budget=2, seed=0, device=dev).run(
                    arr, BENCH_TEXTS, regions=regs)
                conserved(rep, f"geo_routing R={n_regions} x={scale} {algo}")
                done = [r for r in rep.requests if r.done]
                local = sum(place.server_region[r.server_idx] == r.region for r in done)
                rtt = topo.rtt_matrix(None)
                cross = float(rtt[~np.eye(n_regions, dtype=bool)].mean())
                pts[n_regions, scale, algo] = (rep, local / max(len(done), 1), cross)
                rows.append(f"R={n_regions} x={scale:.1f} {rep.row(algo)} local="
                            f"{local / max(len(done), 1):.2f} cross_rtt={cross:.0f}ms")
    dominant = [(r, s) for r in counts for s in scales
                if pts[r, s, "sonar_geo"][2] >= qc.base_service_ms]
    if not dominant:
        fail("geo_routing: no RTT-dominant point")
    for r, s in dominant:
        (g, gl, _), (b, bl, _) = pts[r, s, "sonar_geo"], pts[r, s, "sonar_lb"]
        if not (g.p99_ms <= b.p99_ms and gl >= bl):
            fail(f"geo_routing R={r} x={s}: SONAR-GEO p99 {g.p99_ms:.0f} / local {gl:.2f} vs "
                 f"SONAR-LB {b.p99_ms:.0f} / {bl:.2f}")
    for r in {r for r, _ in dominant}:
        s = max(s for rr, s in dominant if rr == r)
        if not pts[r, s, "sonar_geo"][0].p99_ms < pts[r, s, "sonar_lb"][0].p99_ms:
            fail(f"geo_routing R={r} x={s}: SONAR-GEO does not strictly beat SONAR-LB on p99")
    return rows, f"SONAR-GEO p99 <= SONAR-LB and local share >= at RTT-dominant {dominant}"


def gate_session_routing(dev, smoke):
    """`benchmarks/session_routing.py` on the port's streams: SONAR-SESSION
    above semantic-only SONAR on task success and task p99 at every point
    where SONAR fails tasks; node conservation everywhere."""
    import torch

    from repro_torch.core.routing import RoutingConfig, make_router
    from repro_torch.sessions import SessionTrafficSim, generate_sessions
    from repro_torch.traffic import QueueConfig, ideal_platform, replica_fleet

    qc = QueueConfig(capacity=4, queue_limit=16, base_service_ms=200.0, inflation=1.0)
    n, rates, horizon = 6, ((6.0, 9.0) if smoke else (4.0, 6.0, 8.0, 9.0)), 60.0
    cfg = RoutingConfig(gamma=0.35, top_s=n, top_k=n)
    pts, rows = {}, []
    for rate in rates:
        for algo in ("sonar", "sonar_session"):
            servers = replica_fleet(n)
            plat = ideal_platform(servers, seed=0, horizon_s=4.0 * horizon, device=dev)
            sessions = generate_sessions(torch.Generator(device=dev).manual_seed(3), rate,
                                         horizon, list(BENCH_TEXTS))
            rep = SessionTrafficSim(plat, make_router(algo, servers, cfg), qc, hedge_ms=150.0,
                                    retry_budget=2, seed=0, device=dev).run_sessions(sessions)
            rep.check_accounting()
            if rep.n_nodes_offered != rep.n_nodes_completed + rep.n_nodes_failed:
                fail(f"session_routing {algo} {rate}: node conservation leak")
            pts[rate, algo] = rep
            rows.append(f"{rate:.1f} sessions/s {rep.row(algo)} p50={rep.task_p50_ms:.0f}ms "
                        f"hedges={rep.n_hedges}")
    # the benchmark's post-saturation points: SONAR fails tasks there; both
    # terms of the gate are strict at each
    post = [r for r in rates if pts[r, "sonar"].n_tasks_failed > 0]
    for r in post:
        s, b = pts[r, "sonar_session"], pts[r, "sonar"]
        if not (s.task_success_rate > b.task_success_rate and s.task_p99_ms < b.task_p99_ms):
            fail(f"session_routing {r}: SONAR-SESSION {s.row('session')} does not beat "
                 f"{b.row('sonar')}")
    # past one replica's node capacity (capacity / service, over the mean
    # DAG of ~4.3 nodes: ~4.6 sessions/s, the benchmark's docstring) the
    # sticky router's task p99 must be the lower at every rate
    sat = qc.capacity * 1000.0 / qc.base_service_ms / 4.3
    for r in rates:
        if r > sat and not pts[r, "sonar_session"].task_p99_ms < pts[r, "sonar"].task_p99_ms:
            fail(f"session_routing {r}: SONAR-SESSION's task p99 is not below SONAR's")
    if not post:
        return rows, (f"SONAR fails no task at any rate on this stream, so the benchmark's "
                      f"success gate (strict, where SONAR fails tasks) is NOT EXERCISED; "
                      f"SONAR-SESSION's task p99 is below SONAR's at every rate past "
                      f"{sat:.1f} sessions/s")
    return rows, f"SONAR-SESSION beats SONAR on task success and p99 at {post} sessions/s"


def main(rehearse: bool) -> None:
    setup_imports()
    import numpy as np
    import torch

    from repro_torch.core import dataset
    from repro_torch.core.adaptive import AdaptConfig, decision_feats
    from repro_torch.core.batch_routing import make_engine
    from repro_torch.core.mesh_routing import make_sharded_engine
    from repro_torch.core.quantize import quantize_bf16
    from repro_torch.traffic import mega_fleet_index
    from repro_torch.core.qos import network_score
    from repro_torch.core.routing import RoutingConfig, ToolIndex, make_router
    from repro_torch.core.bm25 import bm25_scores as bm25_plain, topk
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as kref

    if rehearse:
        dev = torch.device("cpu")
        n_per_template, n_q, n_q_perq, reps = 2, 24, 8, 3
        n_mega, n_par = 2_000, 1_000
        S_att = 256
    else:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is False: this script needs a CUDA card")
        dev = torch.device("cuda")
        n_per_template, n_q, n_q_perq, reps = 667, 256, 64, 25
        n_mega, n_par = 1_000_000, 100_000
        S_att = 2048

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------------ 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"setup: torch {torch.__version__} cuda {torch.version.cuda} "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    if not rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        log(f"card: {smi}")
        log(f"device: {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    servers = dataset.mock_cluster(dataset.build_server_pool(0), n_per_template=n_per_template)
    t0 = time.perf_counter()
    index = ToolIndex(servers)
    n_s, n_t = len(servers), index.n_tools
    log(f"fleet: {n_s} servers, {n_t} tools, V_s {index.server_corpus.weights.shape[1]}, "
        f"V_t {index.tool_corpus.weights.shape[1]}, index built in "
        f"{time.perf_counter() - t0:.3f} s")
    cfg = RoutingConfig(top_s=8, top_k=8)
    batches = [[q.text for q in dataset.build_query_dataset(n=n_q, seed=s)] for s in (1, 2)]
    rng = np.random.default_rng(0)
    T = 64
    lat = rng.uniform(20.0, 300.0, (n_s, T)).astype(np.float32)
    lat[rng.random(n_s) < 0.05, -1] = 1200.0                       # offline
    spikes = rng.random(n_s) < 0.10
    lat[spikes, -8:] += rng.uniform(800.0, 1500.0, (int(spikes.sum()), 8))  # outage risk
    lat[spikes, -1] = np.minimum(lat[spikes, -1], 990.0)
    load = (rng.random(n_s) * 1.5).astype(np.float32)
    age = (rng.random(n_s) * 600.0).astype(np.float32)
    failed = rng.random(n_s) < 0.05
    rtt_rows = (rng.random((n_q, n_s)) * 300.0).astype(np.float32)
    region_rtt = (rng.random((6, n_s)) * 300.0).astype(np.float32)
    regions = rng.integers(-1, 6, n_q).astype(np.int32)
    affinity = (rng.random(n_s) * (rng.random(n_s) < 0.1)).astype(np.float32)
    alive = rng.random(n_s) < 0.7
    gen = torch.Generator(device=dev).manual_seed(3)
    lat_perq = torch.rand((n_q_perq, n_s, T), generator=gen, device=dev) * 280.0 + 20.0
    lat_perq[:, ::17, -1] = 1500.0
    lat_perq[:, ::11, -6:] = 900.0

    # the mega fleet: template-tiled, bf16 weights rounded once, 4 shards;
    # compact telemetry, a seeded [16, 32] window rounded to bf16 once and
    # mapped to servers by a Knuth stride (traffic/fleet.py's tel_map)
    t0 = time.perf_counter()
    mindex = mega_fleet_index(n_mega, weights_dtype="bfloat16")
    mcfg = RoutingConfig(top_s=8, top_k=16)
    mrng = np.random.default_rng(1)
    compact = mrng.uniform(20.0, 300.0, (16, 32)).astype(np.float32)
    compact[::5, -1] = 1200.0                                       # offline templates
    compact[1::4, -6:] = 900.0                                      # outage risk
    compact = quantize_bf16(compact)
    tel_map = (np.arange(n_mega, dtype=np.int64) * 2654435761) % 16
    m_load = (mrng.random(n_mega) * 1.5).astype(np.float32)
    m_age = (mrng.random(n_mega) * 400.0).astype(np.float32)
    m_failed = mrng.random(n_mega) < 0.05
    m_region_rtt = (mrng.random((6, n_mega)) * 300.0).astype(np.float32)
    m_regions = mrng.integers(-1, 6, n_q).astype(np.int32)
    m_aff = (mrng.random(n_mega) * (mrng.random(n_mega) < 0.1)).astype(np.float32)
    log(f"mega fleet: {mindex.n_servers} servers, {mindex.n_tools} tools, "
        f"{len(mindex.templates)} templates, V_s {mindex.server_corpus.weights.shape[1]}, "
        f"V_t {mindex.tool_corpus.weights.shape[1]}, bf16 weights, 4 shards, "
        f"top_s 8, top_k 16, built in {time.perf_counter() - t0:.3f} s")

    def mextras(algo, n=n_mega):
        """The mega path's operands of each algorithm at the first n servers."""
        load_, age_, failed_ = m_load[:n], m_age[:n], m_failed[:n]
        geo = dict(client_region=m_regions, region_rtt_ms=m_region_rtt[:, :n])
        ex = {
            "sonar_lb": dict(server_load=load_),
            "sonar_ft": dict(server_load=load_, telemetry_age_s=age_, failed_mask=failed_),
            "sonar_geo": dict(server_load=load_, **geo),
            "sonar_session": dict(server_load=load_, affinity=m_aff[:n], **geo),
            "sonar_adapt": dict(server_load=load_, telemetry_age_s=age_, failed_mask=failed_,
                                **geo),
        }.get(algo, {})
        return dict(ex, telemetry_templates=(compact, tel_map[:n]))

    def attn_close(a, b, tol, what):
        a, b = a.float().cpu(), b.float().cpu()
        if a.shape != b.shape or not torch.allclose(a, b, rtol=tol, atol=tol):
            fail(f"{what}: kernel and plain version disagree beyond rtol = atol = {tol} "
                 f"(max abs {float((a - b).abs().max()) if a.shape == b.shape else 'shape'})")
        return float((a - b).abs().max())

    def close(a, b, what):
        a, b = a.float().cpu(), b.float().cpu()
        if a.shape != b.shape or not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
            fail(f"{what}: kernel and plain version disagree "
                 f"(max abs {float((a - b).abs().max()) if a.shape == b.shape else 'shape'})")
        return float((a - b).abs().max()) if a.numel() else 0.0

    # ------------------------------------------------------------------ 2
    eng0 = make_engine("sonar", servers, cfg, device=dev, index=index)
    enc = eng0.encode(batches[0])
    q_s = torch.as_tensor(enc.q_server, device=dev)
    q_t = torch.as_tensor(enc.q_tool, device=dev)
    q_r = torch.as_tensor(
        make_engine("rerank_rag", servers, cfg, device=dev, index=index)
        .encode(batches[0]).q_rerank, device=dev)
    # the engine's static operands: server weights transposed [V_s, n_s]
    # (w_s is its [n_s, V_s] view), tool weights, tool -> server, and the
    # server -> tools map
    w_st, w_t, ts, csr = eng0._w_server_t, eng0._w_tool, eng0._tool_server, eng0._tool_csr
    w_s = w_st.t()
    lat_t = torch.as_tensor(lat, device=dev)
    flat = lat_perq.reshape(-1, T)

    def equal(a, b, what):
        """The redesigned routing kernels are held to their plain versions bit for bit."""
        if a.shape != b.shape or not torch.equal(a, b):
            fail(f"{what}: kernel and plain version differ (max abs "
                 f"{float((a.float() - b.float()).abs().max()) if a.shape == b.shape else 'shape'})")

    max_err = {}
    ops.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        k_s = ops.bm25_scores(q_s, w_st)
        if not rehearse:
            log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.2f} s")
            for name, text in _build.build_logs().items():
                for line in text.splitlines():
                    if "Used" in line or "spill" in line or "Performance Loss" in line:
                        log(f"phase 2: ptxas {name}: {line.strip()}")
        # bm25: the fleet, a fully dense query batch, and bf16 weights, all
        # in the engine's transposed layout; torch.equal against the plain
        # ordered sum
        q_dense = torch.randint(1, 4, q_s.shape, generator=gen, device=dev).float()
        bm25_cases = {
            "fleet": (k_s, bm25_plain(w_s, q_s)),
            "fully dense queries": (ops.bm25_scores(q_dense, w_st), bm25_plain(w_s, q_dense)),
            "bf16 weights": (ops.bm25_scores(q_s, w_st.bfloat16()),
                             bm25_plain(w_s.bfloat16(), q_s)),
        }
        for name, (got, want) in bm25_cases.items():
            equal(got, want, f"bm25_scores [{name}]")
        sync()
        max_err["bm25_scores"] = 0.0
        log(f"phase 2: bm25_scores [{q_s.shape[0]}, {q_s.shape[1]}] x [{w_s.shape[0]}, "
            f"{w_s.shape[1]}] bit-equal to the plain version: {', '.join(bm25_cases)}")
        e1 = close(ops.qos_scores(lat_t), network_score(lat_t), "qos_scores shared window")
        e2 = close(ops.qos_scores(flat), network_score(flat), "qos_scores per-query window")
        # edge windows: T % 4 != 0 (scalar loads), and a view one element
        # into its storage (not 16-byte aligned: scalar loads)
        lat63 = lat_t[:, 1:].contiguous()
        e3 = close(ops.qos_scores(lat63), network_score(lat63), "qos_scores [n, 63] window")
        shifted = torch.empty(lat_t.numel() + 1, device=dev)[1:].view(lat_t.shape)
        shifted.copy_(lat_t)
        e4 = close(ops.qos_scores(shifted), network_score(lat_t), "qos_scores offset view")
        max_err["qos_scores"] = max(e1, e2, e3, e4)
        log(f"phase 2: qos_scores within rtol {RTOL} / atol {ATOL}: shared {list(lat_t.shape)} "
            f"{e1:.3g}, per-query {list(flat.shape)} {e2:.3g}, {list(lat63.shape)} {e3:.3g}, "
            f"offset view {e4:.3g}")
        sync()
        _, cand_route = topk(k_s, cfg.top_s)    # i64, a slice: the form the route passes
        cand = cand_route.to(torch.int32)
        n_srv = ops.qos_scores(lat_t)
        tool_qos = n_srv[ts.long()]
        tool_load = torch.as_tensor(load, device=dev)[ts.long()]
        tool_rtt = torch.rand((n_t,), generator=gen, device=dev)
        tool_dead = torch.as_tensor(failed.astype(np.float32), device=dev)[ts.long()]

        def per_q(x):             # a per-query copy of a broadcast row, perturbed
            return x[None, :] + 0.01 * torch.rand((n_q, n_t), generator=gen, device=dev)

        live = torch.tensor([0.45, 0.55, 0.3, 0.2], device=dev)
        q_t_dense = torch.randint(1, 4, q_t.shape, generator=gen, device=dev).float()
        variants = {
            "broadcast rows": dict(args=(q_t, w_t, tool_qos, tool_load, tool_dead, None),
                                   kw=dict(alpha=0.5, beta=0.5, gamma=0.35, delta=0.4,
                                           tool_rtt=tool_rtt)),
            "fully dense queries": dict(args=(q_t_dense, w_t, tool_qos, tool_load, tool_dead,
                                              q_t_dense.flip(0)),
                                        kw=dict(alpha=0.5, beta=0.5, gamma=0.35, delta=0.4,
                                                tool_rtt=tool_rtt)),
            "per-query rows": dict(args=(q_t, w_t, per_q(tool_qos), per_q(tool_load),
                                         (per_q(tool_dead) > 0.5).float(), None),
                                   kw=dict(alpha=0.5, beta=0.5, gamma=0.35, delta=0.4,
                                           tool_rtt=per_q(tool_rtt))),
            "bf16 operands": dict(args=(q_t.bfloat16(), w_t.bfloat16(), tool_qos, tool_load,
                                        tool_dead, None),
                                  kw=dict(alpha=0.5, beta=0.5, gamma=0.35)),
            "rerank+live weights+affinity": dict(
                args=(q_t, w_t, tool_qos, tool_load, tool_dead, q_r),
                kw=dict(alpha=live[0], beta=live[1], gamma=live[2], delta=live[3],
                        tool_rtt=tool_rtt, tool_aff=per_q(tool_rtt) * 0.5, eps=0.25)),
        }
        # each variant with the engine's server -> tools map and the route's
        # candidates, and with the map the wrapper builds when given none;
        # every output torch.equal to the plain masked product and top-k
        for name, v in variants.items():
            q_, w_, qos_, load_, dead_, qr_ = v["args"]
            kw = dict(k=cfg.top_k, temp=1.0, **v["kw"])
            want = kref.fused_score_select_ref(q_, w_, ts, cand, qos_, load_, dead_, qr_, **kw)
            for form, c_, extra in (("engine CSR", cand_route, dict(tool_csr=csr)),
                                    ("wrapper's CSR", cand, {})):
                got = ops.fused_score_select(q_, w_, ts, c_, qos_, load_, dead_, qr_, **kw,
                                             **extra)
                sync()
                for g, w, out in zip(got, want, ("tool", "C", "N", "S")):
                    equal(g, w, f"fused_score_select [{name}, {form}] {out}")
            log(f"phase 2: fused_score_select [{name}] bit-equal to the plain version "
                "(engine CSR, wrapper's CSR)")
        max_err["fused_score_select"] = 0.0

        # fused_select at the shapes its paths give it.  The operands of the
        # mega tail [256, 16] and of a dense-shard merge [256, 4 x 16] are
        # captured from sharded routes; the full tool axis [256, 20010] is
        # the single engine's materialised stage-2 matrix.
        captured = {}

        def capture(label, eng, **kw):
            real = ops.fused_select

            def grab(*a, **k):
                captured[label] = (a, k)
                return real(*a, **k)

            ops.fused_select = grab
            try:
                return eng.route_texts(batches[0], **kw)
            finally:
                ops.fused_select = real

        ad = make_sharded_engine("sonar_adapt", cfg=mcfg, n_shards=4, index=mindex, device=dev,
                                 use_kernels=True, adapt=AdaptConfig(lr=0.5))
        for i in range(8):
            ad.observe_feedback(100.0 + 150.0 * i, ok=i % 3 != 0,
                                feats=decision_feats(0.3, 0.5 - 0.1 * i, 0.2, 0.1))
        capture("mega sonar_adapt: per-query rows, dead, rtt, live weights", ad,
                **mextras("sonar_adapt"))
        capture("mega sonar_session: per-query rows, rtt, affinity",
                make_sharded_engine("sonar_session", cfg=mcfg, n_shards=4, index=mindex,
                                    device=dev, use_kernels=True), **mextras("sonar_session"))
        ft_kw = dict(latency_hist=lat, server_load=load, telemetry_age_s=age, failed_mask=failed)
        d_sh = capture("dense-shard merge sonar_ft: per-query rows, dead",
                       make_sharded_engine("sonar_ft", servers, mcfg, n_shards=4, index=index,
                                           device=dev, use_kernels=True), **ft_kw)
        mega_a, mega_k = captured["mega sonar_adapt: per-query rows, dead, rtt, live weights"]
        w_tt = w_t.t().contiguous()
        sel_full = torch.where(kref.candidate_mask(ts, cand), ops.bm25_scores(q_t, w_tt), kref.NEG)
        val_full = ops.bm25_scores(q_r, w_tt)
        cases = dict(captured)
        cases["mega sonar_adapt, bf16 operands"] = (
            (mega_a[0].bfloat16(), mega_a[1].bfloat16(), *mega_a[2:]), mega_k)
        cases["full axis: broadcast rows, dead, rtt, k 16"] = (
            (sel_full, sel_full, tool_qos, tool_load, tool_dead),
            dict(k=16, alpha=0.5, beta=0.5, gamma=0.35, delta=0.4, tool_rtt=tool_rtt, temp=1.0))
        cases["full axis: per-query rows, rerank, affinity, live weights, k 128"] = (
            (sel_full, val_full, per_q(tool_qos), per_q(tool_load),
             (per_q(tool_dead) > 0.5).float()),
            dict(k=128, alpha=live[0], beta=live[1], gamma=live[2], delta=live[3],
                 tool_rtt=per_q(tool_rtt), tool_aff=per_q(tool_rtt) * 0.5, eps=0.25, temp=1.0))
        cases["full axis: bf16 operands, k 128"] = (
            (sel_full.bfloat16(), val_full.bfloat16(), tool_qos, tool_load, tool_dead),
            dict(k=128, alpha=0.5, beta=0.5, gamma=0.35, temp=1.0))
        # edge rows at the narrow tail's width, one past the narrow/wide
        # boundary (257) and the full axis: -0/+0 ties, an all-equal row,
        # an all -inf row, an all-NEG row; the rest tie-heavy integers
        for n_e, k_e in ((16, 16), (257, 128), (n_t, 128)):
            e_sel = torch.randint(0, 6, (n_q, n_e), generator=gen, device=dev).float()
            e_sel[torch.rand((n_q, n_e), generator=gen, device=dev) < 0.3] = -float("inf")
            pm0 = torch.where(torch.rand((n_e,), generator=gen, device=dev) < 0.5,
                              torch.tensor(-0.0, device=dev), torch.tensor(0.0, device=dev))
            e_sel[0] = torch.where(torch.arange(n_e, device=dev) % 3 == 0, pm0, -1.0)
            e_sel[1], e_sel[2], e_sel[3], e_sel[4] = 2.5, -float("inf"), kref.NEG, pm0
            cases[f"edge rows at width {n_e}: -0/+0 ties, all equal, all -inf, all NEG"] = (
                (e_sel, e_sel, torch.rand((n_e,), generator=gen, device=dev),
                 torch.rand((n_q, n_e), generator=gen, device=dev),
                 (torch.rand((n_e,), generator=gen, device=dev) < 0.2).float()),
                dict(k=k_e, alpha=0.5, beta=0.5, gamma=0.35, temp=1.0))
        for name, (a, k) in cases.items():
            got = ops.fused_select(*a, **k)
            want = kref.fused_select_ref(*a, **k)
            sync()
            if not torch.equal(got[0].cpu(), want[0].cpu()):
                fail(f"fused_select {name}: decisions differ from the plain version")
            for g, w, out in zip(got[1:], want[1:], ("C", "N", "S")):
                equal(g, w, f"fused_select [{name}] {out}")
            log(f"phase 2: fused_select [{name}] {list(a[0].shape)} k {k['k']}: decisions "
                "equal, C, N, S bit-equal to the plain version")
        max_err["fused_select"] = 0.0

        # the attention kernels at the serving paths' shapes: flash prefill of
        # 16 query heads against 8 kv heads, head_dim 128, causal, in the
        # model's [B, S, H, D] layout as strided views (phase 3c's S_att and a
        # ragged S_att/2 - 24, phase 3g (a)'s 16-token prompts); flash decode
        # against caches as strided views: phase 3c's 8 slots of cap S_att
        # with lengths 1 .. S_att, phase 3g (a)'s 4 slots of cap 256 with
        # lengths 17 .. 23
        ga = torch.Generator(device=dev).manual_seed(11)

        def attn_rand(shape, dt):
            return torch.randn(shape, generator=ga, device=dev).to(dt)

        # phase 3h's head layouts: deepseek-moe-16b's MHA (16 / 16 heads, G = 1:
        # S_att, the ragged S, 8 slots of cap S_att) and llama4-scout's G = 5
        # (40 / 8 heads: S_att, the ragged S, 4 slots of cap S_att / 2); phase
        # 3i's Jamba layout, G = 8 (64 / 8 heads: prompts of 1100 and 257
        # tokens, 4 slots of cap 1280)
        att_err = {}
        half = S_att // 2
        cap_j = S_att * 5 // 8
        flash_cases = [(S, 16, 8) for S in (S_att, half - 24, 16)] \
            + [(S, hq, hkv) for hq, hkv in ((16, 16), (40, 8)) for S in (S_att, half - 24)] \
            + [(S, 64, 8) for S in (half + 76, 257)]
        dec_lens = [1, S_att, 63, 64, 65, half - 24, S_att - 1, 200]
        decode_cases = [(S_att, dec_lens, 16, 8), (256, [17, 19, 21, 23], 16, 8),
                        (S_att, dec_lens, 16, 16), (half, [1, half, 513, half - 24], 40, 8),
                        (cap_j, [4, min(257, cap_j), cap_j - 256, cap_j], 64, 8)]
        for dt in (torch.bfloat16, torch.float32):
            tol = ATTN_TOL[str(dt).split(".")[1]]
            for S, hq, hkv in flash_cases:
                q = attn_rand((1, S, hq, 128), dt)
                k, v = attn_rand((1, S, hkv, 128), dt), attn_rand((1, S, hkv, 128), dt)
                got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
                want = kref.mha_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    sm_scale=1 / math.sqrt(128), causal=True)
                sync()
                att_err["flash_attention", dt, hq, hkv, S] = attn_close(
                    got, want, tol, f"flash {dt} {hq}/{hkv} heads S {S}")
            for cap_, lens, hq, hkv in decode_cases:
                nb = len(lens)
                qd = attn_rand((nb, hq, 128), dt)
                kc, vc = attn_rand((nb, cap_, hkv, 128), dt), attn_rand((nb, cap_, hkv, 128), dt)
                lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
                got = ops.decode_attention(qd, kc.transpose(1, 2), vc.transpose(1, 2), lens_d)
                want = kref.decode_ref(qd.reshape(nb, hkv, hq // hkv, 128), kc.transpose(1, 2),
                                       vc.transpose(1, 2), lens_d.reshape(nb, 1),
                                       sm_scale=1 / math.sqrt(128)).reshape(nb, hq, 128)
                sync()
                att_err["decode_attention", dt, hq, hkv, cap_, nb] = attn_close(
                    got, want, tol, f"decode {dt} {hq}/{hkv} heads {nb} slots cap {cap_}")
        for name in ("flash_attention", "decode_attention"):
            # the JSON's error is the serving path's dtype's (bf16)
            max_err[name] = max(e for (n, dt, *_), e in att_err.items()
                                if n == name and dt == torch.bfloat16)
        log("phase 2: attention kernels vs plain versions, max abs err (tolerance rtol = atol = "
            f"{ATTN_TOL}): " + "; ".join(
                f"{n} {str(dt).split('.')[1]} {shape[0]}/{shape[1]} heads "
                + (f"S {shape[2]}" if n == "flash_attention"
                   else f"{shape[3]} slots cap {shape[2]}") + f": {e:.3g}"
                for (n, dt, *shape), e in att_err.items()))
        d_single = make_engine("sonar_ft", servers, mcfg, device=dev, index=index).route_texts(
            batches[0], **ft_kw)
    log(f"phase 2: kernels agree with their plain versions: {max_err}")

    # ------------------------------------------------------------------ 3
    engines = {
        algo: (make_engine(algo, servers, cfg, device=dev, index=index),
               make_engine(algo, servers, cfg, device=dev, index=index, use_kernels=False))
        for algo in ALGOS
    }
    if not all(ek.use_kernels for ek, _ in engines.values()) and not rehearse:
        fail("use_kernels does not default to True on the card")

    def extras(algo, i):
        if algo == "sonar_lb":
            return dict(server_load=load)
        if algo == "sonar_ft":
            return dict(server_load=load, telemetry_age_s=age, failed_mask=failed)
        if algo == "sonar_geo":
            return (dict(server_load=load, client_rtt_ms=rtt_rows) if i == 0 else
                    dict(server_load=load, client_region=regions, region_rtt_ms=region_rtt))
        if algo == "sonar_session":
            return dict(server_load=load, client_rtt_ms=rtt_rows, affinity=affinity)
        return {}

    def same(dk, dp, what, n_servers=n_s):
        if not (np.array_equal(dk.server_idx, dp.server_idx)
                and np.array_equal(dk.tool_idx, dp.tool_idx)):
            bad = int(np.sum(dk.tool_idx != dp.tool_idx))
            fail(f"{what}: {bad} kernel-path decisions differ from the plain path")
        for a, b, nm in ((dk.expertise, dp.expertise, "C"), (dk.network, dp.network, "N"),
                         (dk.fused, dp.fused, "S")):
            if not np.allclose(a, b, rtol=RTOL, atol=ATOL):
                fail(f"{what}: {nm} differs beyond tolerance")
            if not np.all(np.isfinite(a)):
                fail(f"{what}: non-finite {nm}")
        if dk.server_idx.shape != (len(dk),) or dk.server_idx.min() < 0 \
                or dk.server_idx.max() >= n_servers:
            fail(f"{what}: bad decision shape or range")

    routes = {"bm25_scores": 0, "qos_scores": 0, "fused_score_select": 0}
    kernel_decisions = {}
    plain_decisions = {}
    ops.reset_launches()                       # the main path's count starts here
    t_main = time.perf_counter()
    for algo, (ek, _) in engines.items():
        for i, texts in enumerate(batches):
            kernel_decisions[algo, i] = ek.route_texts(texts, lat, **extras(algo, i))
            routes["bm25_scores"] += 1
            routes["fused_score_select"] += 1
            routes["qos_scores"] += int(ek.uses_network)
    ek = engines["sonar"][0]
    kernel_decisions["perq"] = ek.route_texts(batches[0][:n_q_perq], lat_perq)
    ek_ft = engines["sonar_ft"][0]
    kernel_decisions["failover"] = ek_ft.route_failover(
        ek_ft.encode(batches[0]), lat, load, age, alive=alive)
    n_fo_routes = 1 + int(np.max(kernel_decisions["failover"][1], initial=0))
    for name in routes:
        routes[name] += 1 + n_fo_routes
    sync()
    launches = ops.launch_counts()             # ... and is read here
    log(f"phase 3: main path ran {sum(v for v in routes.values())} kernel calls in "
        f"{time.perf_counter() - t_main:.3f} s; launches {launches}")
    if not rehearse:
        for name in routes:
            n = launches[name]
            if n == 0:
                fail(f"{name}: the main path never launched its kernel")
            if n != routes[name]:
                fail(f"{name}: {n} launches for {routes[name]} kernel calls")
        if launches["fused_select"] != 0:
            fail("the single-engine path launched the sharded merge's fused_select")

    for algo, (_, ep) in engines.items():
        for i, texts in enumerate(batches):
            plain_decisions[algo, i] = ep.route_texts(texts, lat, **extras(algo, i))
            same(kernel_decisions[algo, i], plain_decisions[algo, i], f"{algo} batch {i}")
    same(kernel_decisions["perq"],
         engines["sonar"][1].route_texts(batches[0][:n_q_perq], lat_perq), "per-query telemetry")
    ep_ft = engines["sonar_ft"][1]
    dec_p, fo_p = ep_ft.route_failover(ep_ft.encode(batches[0]), lat, load, age, alive=alive)
    same(kernel_decisions["failover"][0], dec_p, "route_failover")
    if not np.array_equal(kernel_decisions["failover"][1], fo_p):
        fail("route_failover: failover counts differ")
    log("phase 3: every kernel-path decision equals the plain path's "
        f"({len(ALGOS)} algorithms x {len(batches)} batches, per-query step, failover)")

    n_scalar = 4
    for algo in ALGOS:
        router = make_router(algo, servers[:1], cfg)
        router.index = index
        dk = kernel_decisions[algo, 0]
        for i, text in enumerate(batches[0][:n_scalar]):
            ex = extras(algo, 0)
            if "client_rtt_ms" in ex:
                ex = dict(ex, client_rtt_ms=ex["client_rtt_ms"][i])
            d = router.select(text, lat, **ex)
            if (d.server_idx, d.tool_idx) != (int(dk.server_idx[i]), int(dk.tool_idx[i])):
                fail(f"{algo} query {i}: scalar router picks {(d.server_idx, d.tool_idx)}, "
                     f"engine {(int(dk.server_idx[i]), int(dk.tool_idx[i]))}")
            if not np.isclose(d.fused, dk.fused[i], rtol=RTOL, atol=ATOL) \
                    and not (d.fused == -np.inf and dk.fused[i] <= kref.NEG / 2):
                fail(f"{algo} query {i}: fused score {dk.fused[i]} vs scalar {d.fused}")
    log(f"phase 3: the scalar router agrees on the first {n_scalar} queries of every algorithm")

    # ----------------------------------------------------------------- 3b
    same(d_sh, d_single, "dense-shard engine (4 shards, 10,005 servers) vs single engine")
    t0 = time.perf_counter()
    mengines = {
        algo: (make_sharded_engine(algo, cfg=mcfg, n_shards=4, index=mindex, device=dev),
               make_sharded_engine(algo, cfg=mcfg, n_shards=4, index=mindex, device=dev,
                                   use_kernels=False))
        for algo in MEGA_ALGOS
    }
    ek0 = mengines["sonar"][0]
    if not rehearse and not all(ek.use_kernels for ek, _ in mengines.values()):
        fail("the sharded engine's use_kernels does not default to True on the card")
    if not ek0.compact_stage2:
        fail("the mega fleet did not take the candidate-compacted stage 2")
    log(f"phase 3b: {2 * len(mengines)} sharded engines built in "
        f"{time.perf_counter() - t0:.3f} s: {ek0.plan.n_shards} shards of s_pad "
        f"{ek0.plan.s_pad}, t_pad {ek0.plan.t_pad}, k_slot {ek0._sc.k_slot}")
    mroutes = {"bm25_scores": 0, "qos_scores": 0, "fused_select": 0}
    mdec = {}
    ops.reset_launches()                       # the mega path's count starts here
    t_main = time.perf_counter()
    for algo, (ek, _) in mengines.items():
        mdec[algo] = ek.route_texts(batches[0], **mextras(algo))
        mroutes["fused_select"] += 1
        mroutes["bm25_scores"] += 2 + int(ek.rerank)
        mroutes["qos_scores"] += int(ek.uses_network)
    sync()
    mlaunches = ops.launch_counts()            # ... and is read here
    log(f"phase 3b: mega path ran {len(mengines)} sharded routes in "
        f"{time.perf_counter() - t_main:.3f} s; launches {mlaunches}")
    if not rehearse:
        for name, n in mroutes.items():
            if mlaunches[name] == 0:
                fail(f"{name}: the mega path never launched its kernel")
            if mlaunches[name] != n:
                fail(f"{name}: {mlaunches[name]} launches for {n} kernel calls on the mega path")
        if mlaunches["fused_score_select"] != 0:
            fail("the mega path launched the single engine's fused stage 2")
    for algo, (_, ep) in mengines.items():
        same(mdec[algo], ep.route_texts(batches[0], **mextras(algo)), f"mega {algo}", n_mega)
    picked = {a: int(np.unique(d.server_idx).size) for a, d in mdec.items()}
    log(f"phase 3b (a): all {len(mengines)} algorithms route {n_mega} servers with every "
        f"kernel-path decision equal to the plain path's; distinct servers picked {picked}")

    # (c) the sharded engine against the densified single engine
    t0 = time.perf_counter()
    pindex = mega_fleet_index(n_par, weights_dtype="bfloat16")
    dense_view = pindex.densify()
    hist_par = compact[tel_map[:n_par]]
    ds = {}
    for algo in MEGA_ALGOS:
        ex = mextras(algo, n_par)
        tel = ex.pop("telemetry_templates")
        d_sh = make_sharded_engine(algo, cfg=mcfg, n_shards=4, index=pindex, device=dev) \
            .route_texts(batches[0], telemetry_templates=tel, **ex)
        d_bk = make_engine(algo, [], mcfg, index=dense_view, device=dev) \
            .route_texts(batches[0], hist_par, **ex)
        same(d_sh, d_bk, f"{n_par}-server parity {algo}: sharded vs densified single engine",
             n_par)
        ds[algo] = float(np.max(np.abs(d_sh.fused - d_bk.fused)))
    log(f"phase 3b (c): at {n_par} servers the sharded kernel path equals the densified "
        f"single engine's kernel path for all {len(MEGA_ALGOS)} algorithms "
        f"({time.perf_counter() - t0:.2f} s); max |S difference| {ds}")

    # (d) SONAR-ADAPT learning (lr > 0): kernel path against plain path on
    # both engines over feedback rounds fed identical outcomes
    acfg = AdaptConfig(lr=0.5)
    frng = np.random.default_rng(5)
    adapt_pairs = {
        f"sharded {n_mega}": (
            make_sharded_engine("sonar_adapt", cfg=mcfg, n_shards=4, index=mindex, device=dev,
                                adapt=acfg),
            make_sharded_engine("sonar_adapt", cfg=mcfg, n_shards=4, index=mindex, device=dev,
                                adapt=acfg, use_kernels=False),
            lambda e: e.route_texts(batches[1], **mextras("sonar_adapt"))),
        f"batched {n_s}": (
            make_engine("sonar_adapt", servers, cfg, device=dev, index=index, adapt=acfg),
            make_engine("sonar_adapt", servers, cfg, device=dev, index=index, adapt=acfg,
                        use_kernels=False),
            lambda e: e.route_texts(batches[1], lat, load, age, failed, rtt_rows)),
    }
    for label, (ek, ep, run) in adapt_pairs.items():
        w0 = ek.adapt_weights.copy()
        for rnd in range(3):
            dk, dp = run(ek), run(ep)
            same(dk, dp, f"SONAR-ADAPT {label} round {rnd}", max(n_mega, n_s))
            if not np.allclose(ek.adapt_weights, ep.adapt_weights, rtol=RTOL, atol=ATOL):
                fail(f"SONAR-ADAPT {label}: weights {ek.adapt_weights} vs {ep.adapt_weights}")
            for i in range(0, len(dk), 4):
                lat_ms, ok = float(frng.uniform(50.0, 1500.0)), bool(frng.random() < 0.8)
                f = decision_feats(dk.expertise[i], dk.network[i], 0.1, 0.05)
                ek.observe_feedback(lat_ms, ok, feats=f)
                ep.observe_feedback(lat_ms, ok, feats=f)
        if np.array_equal(ek.adapt_weights, w0):
            fail(f"SONAR-ADAPT {label}: the weights never moved")
        log(f"phase 3b (d): SONAR-ADAPT {label}: 3 feedback rounds, decisions equal, weights "
            f"{w0.tolist()} -> {ek.adapt_weights.tolist()} (plain {ep.adapt_weights.tolist()})")

    # ----------------------------------------------------------------- 3c
    # internlm2-1.8b at full width and depth (the reduced config's width at 2
    # layers in the rehearsal), weights drawn on the card from a seed
    from repro_torch import configs as lm_configs
    from repro_torch.models.api import get_model

    if rehearse:
        lm_cfg = dataclasses.replace(lm_configs.get_reduced("internlm2-1.8b"), dtype="bfloat16")
    else:
        lm_cfg = lm_configs.get_config("internlm2-1.8b")
    lm_cfg = dataclasses.replace(lm_cfg, attn_impl="pallas")
    plain_cfg = dataclasses.replace(lm_cfg, attn_impl="chunked")
    lm = get_model(lm_cfg)
    t0 = time.perf_counter()
    lm_params = lm.init_params(seed=0, device=dev)
    sync()
    n_params = sum(t.numel() for t in _leaves(lm_params))
    log(f"phase 3c: {lm_cfg.name}: {lm_cfg.n_layers} layers, d_model {lm_cfg.d_model}, "
        f"{lm_cfg.n_heads}/{lm_cfg.n_kv_heads} heads of {lm_cfg.resolved_head_dim}, d_ff "
        f"{lm_cfg.d_ff}, vocab {lm_cfg.padded_vocab}, {lm_cfg.dtype}: {n_params:,} parameters "
        f"drawn on {dev} in {time.perf_counter() - t0:.2f} s")
    srng = np.random.default_rng(7)
    prompt_lens = srng.integers(64, 1537, 16)
    prompts = [srng.integers(0, lm_cfg.vocab_size, int(n)).astype(np.int32) for n in prompt_lens]
    sv = serve_requests(lm_cfg, plain_cfg, lm_params, dev, n_slots=8, cap=2048, prompts=prompts,
                        max_new=32, tol=SERVE_TOL)
    slaunches = sv["launches"]
    want_launches = {"flash_attention": lm_cfg.n_layers * sv["admitted"],
                     "decode_attention": lm_cfg.n_layers * sv["steps"]}
    log(f"phase 3c: served {len(prompts)} requests (prompts {sorted(prompt_lens.tolist())} "
        f"tokens, 32 new each) through 8 slots in {sv['steps']} decode steps, "
        f"{sv['wall_s']:.3f} s wall, {sv['tokens']} tokens generated "
        f"({sv['tokens'] / sv['wall_s']:.1f} tokens/s, host clock); launches {slaunches}")
    if not rehearse:
        for name, n in want_launches.items():
            if slaunches[name] == 0:
                fail(f"{name}: the serving path never launched its kernel")
            if slaunches[name] != n:
                fail(f"{name}: {slaunches[name]} launches, expected {n} "
                     f"({lm_cfg.n_layers} layers x {n // lm_cfg.n_layers})")
        others = {k: v for k, v in slaunches.items() if k not in want_launches and v}
        if others:
            fail(f"the serving path launched routing kernels: {others}")
    gaps = [g for _, _, g in sv["argmax_diffs"]]
    log(f"phase 3c: teacher-forced plain path (attn_impl='chunked') over {sv['rows']} rows of "
        f"logits: max abs difference prefill {sv['prefill_max_abs']:.4f}, decode "
        f"{sv['decode_max_abs']:.4f} (tolerance {SERVE_TOL}); first tokens all equal; "
        f"{len(gaps)} argmax differences, largest plain-logit gap "
        f"{max(gaps, default=0.0):.4f}")
    del lm_params             # phase 4 measures the routing paths' memory without them

    # ----------------------------------------------------------------- 3d
    # the paper harness: BatchAgent episodes on NetMCPPlatform traces drawn
    # on the card, the kernel path against the plain path on the same
    # platform state (a fresh platform each; the traces are memoized per
    # seed and device type, so both start equal)
    from repro_torch.core import agent as agentlib
    from repro_torch.core import metrics as metricslib
    from repro_torch.core import routing as routinglib
    from repro_torch.core.platform import NetMCPPlatform

    smi_tag = smi if not rehearse else "CPU rehearsal"

    def episodes(pool, pool_index, scenario, algo, cfg_, queries, use_kernels, tpq):
        """One BatchAgent benchmark on a fresh platform: its records, the
        decisions of every turn, the platform."""
        plat = NetMCPPlatform(pool, scenario=scenario, seed=1, device=dev)
        eng = make_engine(algo, pool, cfg_, device=dev, index=pool_index, use_kernels=use_kernels)
        turns = record_routes(eng)
        recs = agentlib.BatchAgent(plat, eng).run_benchmark(queries, ticks_per_query=tpq)
        return recs, turns, plat

    def same_episodes(kern, plain, what, n_servers):
        (rk, tk, pk), (rp, tp, pp) = kern, plain
        if len(tk) != len(tp):
            fail(f"{what}: {len(tk)} turns on the kernel path, {len(tp)} on the plain path")
        for i, (dk, dp) in enumerate(zip(tk, tp)):
            same(dk, dp, f"{what} turn {i}", n_servers)
        for i, (a, b) in enumerate(zip(rk, rp)):
            if (a.query.text, a.success, a.n_calls, a.n_failures, a.call_latencies_ms,
                    a.select_latency_ms, a.completion_ms, a.final_server_idx) != (
                    b.query.text, b.success, b.n_calls, b.n_failures, b.call_latencies_ms,
                    b.select_latency_ms, b.completion_ms, b.final_server_idx) \
                    or [(d.server_idx, d.tool_idx) for d in a.decisions] != [
                        (d.server_idx, d.tool_idx) for d in b.decisions] \
                    or not np.isclose(a.final_expertise, b.final_expertise, rtol=RTOL, atol=ATOL):
                fail(f"{what}: task {i}'s record differs between the kernel and plain paths")
        if not np.array_equal(pk.observed, pp.observed):
            fail(f"{what}: the feed-forward histories differ between the kernel and plain paths")

    def episode_launches(algo, n_routes):
        net = routinglib.algorithm(algo).uses_network
        return {"bm25_scores": n_routes, "fused_score_select": n_routes,
                "qos_scores": n_routes * int(net)}

    def check_launches(got, want, what):
        if rehearse:
            return
        for name in ops.launch_counts():
            if want.get(name, 0) and got[name] == 0:
                fail(f"{name}: {what} never launched its kernel")
            if got[name] != want.get(name, 0):
                fail(f"{name}: {got[name]} launches on {what}, expected {want.get(name, 0)}")

    # (a) the paper's own pool (benchmarks/common.py): 15 servers, 120
    # queries, 60 ticks a query, platform seed 1; Table II's grid on the
    # hybrid scenario, Fig. 7's four algorithms on the ideal one
    pool = dataset.build_server_pool(seed=0)
    pool_index = ToolIndex(pool)
    pq = dataset.build_query_dataset(n=120, seed=0)
    paper_runs = [("hybrid", a, RoutingConfig(top_s=ts, top_k=tk, alpha=0.5, beta=0.5))
                  for ts, tk in FILTER_GRID for a in ("prag", "sonar")]
    paper_runs += [("ideal", a, RoutingConfig()) for a in ("rag", "rerank_rag", "prag", "sonar")]
    t0 = time.perf_counter()
    ops.reset_launches()                       # phase 3d (a)'s count starts here
    kern = [episodes(pool, pool_index, sc_, a, c_, pq, True, 60) for sc_, a, c_ in paper_runs]
    sync()
    got = ops.launch_counts()                  # ... and is read here
    want = {}
    for (_, a, _), (_, turns, _) in zip(paper_runs, kern):
        for k, v in episode_launches(a, len(turns)).items():
            want[k] = want.get(k, 0) + v
    check_launches(got, want, "the paper harness (3d a)")
    plain = [episodes(pool, pool_index, sc_, a, c_, pq, False, 60) for sc_, a, c_ in paper_runs]
    if ops.launch_counts() != got:
        fail("phase 3d (a): the plain path launched a kernel")
    reports = {}
    for (sc_, a, c_), k, p in zip(paper_runs, kern, plain):
        what = f"paper pool {sc_} {a} s{c_.top_s}t{c_.top_k}"
        same_episodes(k, p, what, len(pool))
        reports[sc_, a, c_.top_s, c_.top_k] = metricslib.evaluate(k[0], pool)
    log(f"phase 3d (a): {len(paper_runs)} BatchAgent benchmarks of 120 tasks on the paper pool "
        f"({len(pool)} servers, traces drawn on {dev}) in {time.perf_counter() - t0:.2f} s, every "
        f"turn's decisions and every record equal on the kernel and plain paths; launches {got}")
    log(f"phase 3d (a): {metricslib.Report.HEADER}")
    for (sc_, a, s_f, t_f), r in reports.items():
        log(f"phase 3d (a): {r.row(f'{sc_}_s{s_f}t{t_f}_{a}')}")
        if sc_ == "hybrid" and a == "sonar" and r.fr != 0.0:
            fail(f"Table II: SONAR's failure rate is {r.fr} % at s{s_f}t{t_f}, not 0")
        if sc_ == "hybrid" and a == "prag" and not r.fr > 50.0:
            fail(f"Table II: PRAG's failure rate is {r.fr} % at s{s_f}t{t_f}, not above 50 %")
    fig7 = {a: r for (sc_, a, _, _), r in reports.items() if sc_ == "ideal"}
    if not (fig7["rag"].ssr < 40.0 < fig7["prag"].ssr and fig7["rerank_rag"].sl_ms > 20_000
            and fig7["prag"].sl_ms < 1_000 and fig7["sonar"].sl_ms < 1_000):
        fail(f"Fig. 7: the ranking does not hold: { {a: r.row(a) for a, r in fig7.items()} }")
    log("phase 3d (a): Table II holds (SONAR FR 0 %, PRAG FR > 50 % at every grid point) and "
        "Fig. 7's ranking holds (RAG SSR < 40 < PRAG SSR, RerankRAG SL > 20 s, PRAG and SONAR "
        "SL < 1 s)")
    del kern, plain

    # (b) the single engine's fleet: the hybrid scenario over 10,005
    # servers at the 24 h horizon ([n, 8640] f32 traces drawn on the card),
    # 256 tasks spread over the day (32 ticks apart), 8 turns at most,
    # per-query windows [256, n, 64] every turn
    fq = dataset.build_query_dataset(n=n_q, seed=1)
    t0 = time.perf_counter()
    NetMCPPlatform(servers, scenario="hybrid", seed=1, device=dev)
    sync()
    log(f"phase 3d (b): hybrid traces [{n_s}, 8640] f32 drawn on {dev} in "
        f"{time.perf_counter() - t0:.2f} s [{smi_tag}]")
    ops.reset_launches()                       # phase 3d (b)'s count starts here
    want, seen = {}, ops.launch_counts()
    for algo in ("prag", "sonar", "sonar_ft"):
        t0 = time.perf_counter()
        k = episodes(servers, index, "hybrid", algo, cfg, fq, True, 32)
        sync()
        t_k = time.perf_counter() - t0
        for name, v in episode_launches(algo, len(k[1])).items():
            want[name] = want.get(name, 0) + v
        seen = ops.launch_counts()
        t0 = time.perf_counter()
        p = episodes(servers, index, "hybrid", algo, cfg, fq, False, 32)
        t_p = time.perf_counter() - t0
        if ops.launch_counts() != seen:
            fail("phase 3d (b): the plain path launched a kernel")
        same_episodes(k, p, f"fleet {algo}", n_s)
        r = metricslib.evaluate(k[0], servers)
        log(f"phase 3d (b): {algo}: {len(k[1])} turns over {n_q} tasks, kernel path "
            f"{t_k:.2f} s, plain path {t_p:.2f} s (host clock) [{smi_tag}]; "
            f"{r.row(f'fleet_hybrid_{algo}')}")
        del k, p
    check_launches(seen, want, "the 10,005-server episodes (3d b)")
    log(f"phase 3d (b): every turn's decisions and every record equal on the kernel and plain "
        f"paths; launches {seen}")

    # ----------------------------------------------------------------- 3e
    # the gateway: SonarGateway over 10,005 replicas (network profiles from
    # a 16-template palette, Knuth-strided), a seeded Poisson schedule
    # replayed by the MicroBatchPump with padded flushes; the service time
    # on the virtual clock is fixed, so the kernel and plain paths see the
    # same flush partitions
    from repro_torch.core.batch_routing import BatchRoutingEngine
    from repro_torch.core.mesh_routing import ShardedRoutingEngine
    from repro_torch.serving import BatchingPolicy, MicroBatchPump, SonarGateway, replica_pool
    from repro_torch.traffic import request_schedule, telemetry_palette

    replicas = replica_pool([REPLICA_ARCHS[i % len(REPLICA_ARCHS)] for i in range(n_s)])
    palette = telemetry_palette(16, seed=0)
    rep_profiles = [palette[j] for j in (np.arange(n_s, dtype=np.int64) * 2654435761) % 16]
    sched = request_schedule("poisson", torch.Generator(device=dev).manual_seed(5),
                             2500.0, 0.2 if not rehearse else 0.02, list(GATEWAY_TEXTS),
                             deadline_ms=20.0)
    policy = BatchingPolicy(max_batch=32, max_wait_ms=2.0, slack_ms=0.5, pad_batches=True)

    def gateway(algo, shards, use_kernels):
        gw = SonarGateway(replicas, profiles=rep_profiles, algo=algo, seed=0, use_kernels=True,
                          shards=shards, device=dev)
        if not use_kernels:       # the same engine on the plain path
            idx_ = gw.router.index
            gw._engine = (
                ShardedRoutingEngine(replicas, gw.router.cfg, algo=gw.algo, n_shards=shards,
                                     index=idx_, device=dev, use_kernels=False)
                if shards else
                BatchRoutingEngine(replicas, gw.router.cfg, algo=gw.algo, index=idx_, device=dev,
                                   use_kernels=False))
        return gw, record_routes(gw.engine())

    def replay(algo, shards, use_kernels):
        gw, calls = gateway(algo, shards, use_kernels)
        pump = MicroBatchPump(gw, policy, service_ms=lambda texts: 1.0)
        return gw, calls, pump, pump.replay(sched)

    t0 = time.perf_counter()
    gateway("sonar", None, True)
    sync()
    log(f"phase 3e: {n_s} replicas, traces [{n_s}, 8640] f32 drawn on {dev}, gateway built in "
        f"{time.perf_counter() - t0:.2f} s; schedule of {len(sched)} requests [{smi_tag}]")
    ops.reset_launches()                       # phase 3e's count starts here
    want, seen = {}, ops.launch_counts()
    for algo in ("sonar", "sonar_lb"):
        for shards in (None, 4):
            t0 = time.perf_counter()
            gk, ck, pk, rk = replay(algo, shards, True)
            sync()
            t_k = time.perf_counter() - t0
            n_calls = len(ck)
            per = ({"bm25_scores": 2 * n_calls, "qos_scores": n_calls, "fused_select": n_calls}
                   if shards else
                   {"bm25_scores": n_calls, "qos_scores": n_calls, "fused_score_select": n_calls})
            for name, v in per.items():
                want[name] = want.get(name, 0) + v
            seen = ops.launch_counts()
            gp, cp, pp, rp = replay(algo, shards, False)
            if ops.launch_counts() != seen:
                fail("phase 3e: the plain path launched a kernel")
            what = f"gateway {algo} shards={shards}"
            if [[r.rid for r in b] for b in pk.flush_log] != [[r.rid for r in b]
                                                              for b in pp.flush_log]:
                fail(f"{what}: the flush partitions differ")
            if len(ck) != len(cp):
                fail(f"{what}: {len(ck)} engine calls against {len(cp)}")
            for i, (dk, dp) in enumerate(zip(ck, cp)):
                same(dk, dp, f"{what} engine call {i}", n_s)
            if [dataclasses.asdict(r) for r in rk.results] != [dataclasses.asdict(r)
                                                                 for r in rp.results]:
                fail(f"{what}: the served results differ between the kernel and plain paths")
            for f in ("in_flight", "fail_streak", "ejected", "telemetry"):
                if not np.array_equal(getattr(gk, f), getattr(gp, f)):
                    fail(f"{what}: the gateway's {f} differs between the kernel and plain paths")
            if gk.t != gp.t or gk.report() != gp.report():
                fail(f"{what}: the gateway's report differs: {gk.report()} vs {gp.report()}")
            if rk.n_routed == 0 or not np.all(np.isfinite(gk.telemetry)):
                fail(f"{what}: nothing routed, or non-finite telemetry")
            rpt = gk.report()
            log(f"phase 3e: {what}: {rk.n_offered} offered, {rk.n_routed} routed, {rk.n_shed} "
                f"shed, {rk.n_expired} expired in {rk.n_flushes} flushes ({n_calls} engine "
                f"calls, mean batch {rk.mean_batch:.2f}); failure rate "
                f"{rpt['failure_rate']:.4f}, AL {rpt['al_ms']:.2f} ms, ejections "
                f"{rpt['ejections']:.0f}; kernel-path replay {t_k:.2f} s (host clock) "
                f"[{smi_tag}]; picks and end state equal to the plain path's")
    check_launches(seen, want, "the gateway (3e)")
    log(f"phase 3e: launches {seen}")

    # ----------------------------------------------------------------- 3f
    # the scenario axes: (a) chaos on the engine at the fleet's full width,
    # BatchAgent episodes under standard_fault_mix(1.0) compiled on the card;
    # (b) SONAR-GEO routes over a 6-region WAN drawn on the card; (c) the
    # reference benchmarks' gates through the ported simulators on the
    # port's own streams
    from repro_torch.chaos import CrashRestartFault, build_schedule, standard_fault_mix
    from repro_torch.chaos.faults import crash_restart_masks
    from repro_torch.chaos.schedule import fault_generator
    from repro_torch.geo import GeoPlacement, build_topology, client_populations, place_servers

    t_3f = time.perf_counter()
    horizon_s, n_steps_day = 86400.0, 8640
    faults = standard_fault_mix(1.0, n_s, horizon_s)
    crash = [f for f in faults if isinstance(f, CrashRestartFault)]
    sync()
    t0 = time.perf_counter()
    chaos = build_schedule(faults, n_s, n_steps_day, 10.0, seed=0, device=dev)
    t_sched = time.perf_counter() - t0
    fi = faults.index(crash[0])
    sync()
    t0 = time.perf_counter()
    crash_restart_masks(fault_generator(0, fi, dev), crash[0], n_steps_day, 10.0)
    t_crash = time.perf_counter() - t0
    log(f"phase 3f (a): standard_fault_mix(1.0, {n_s}, 86400): {len(faults)} faults, crash/"
        f"restart over {len(crash[0].servers)} rows x {n_steps_day} ticks; build_schedule "
        f"{t_sched:.2f} s on {dev} (the crash recurrence alone {t_crash:.2f} s) [{smi_tag}]; "
        f"down share {chaos.down.mean():.4f}, stale share {chaos.stale.mean():.4f}, "
        f"degraded share {(chaos.degrade > 1.0).mean():.4f}")
    part = faults[0]
    ticks_3f = agentlib.spread_start_ticks(n_q, n_steps_day, 2, 1, 0, 32, 0)
    in_part = int(np.sum((ticks_3f * 10.0 >= part.start_s)
                         & (ticks_3f * 10.0 < part.start_s + part.duration_s)))
    in_stale = int(np.sum(chaos.stale[0, np.clip(ticks_3f, 0, n_steps_day - 1)]))

    def chaos_episodes(algo, use_kernels):
        plat = NetMCPPlatform(servers, scenario="hybrid", seed=1, chaos=chaos, device=dev)
        eng = make_engine(algo, servers, cfg, device=dev, index=index, use_kernels=use_kernels)
        turns = record_routes(eng)
        t = time.perf_counter()
        recs = agentlib.BatchAgent(plat, eng, max_turns=2).run_benchmark(fq, ticks_per_query=32)
        sync()
        return (recs, turns, plat), time.perf_counter() - t

    ops.reset_launches()                       # phase 3f (a)'s count starts here
    want, seen = {}, ops.launch_counts()
    for algo in ("prag", "sonar", "sonar_lb", "sonar_ft"):
        k, t_k = chaos_episodes(algo, True)
        for name, v in episode_launches(algo, len(k[1])).items():
            want[name] = want.get(name, 0) + v
        seen = ops.launch_counts()
        p, t_p = chaos_episodes(algo, False)
        if ops.launch_counts() != seen:
            fail("phase 3f (a): the plain path launched a kernel")
        same_episodes(k, p, f"chaos {algo}", n_s)
        r = metricslib.evaluate(k[0], servers)
        log(f"phase 3f (a): {algo}: {len(k[1])} turns over {n_q} tasks ({in_part} start inside "
            f"the partition, {in_stale} inside the group's blackout), kernel path {t_k:.2f} s "
            f"({1e3 * t_k / len(k[1]):.1f} ms a turn), plain path {t_p:.2f} s (host clock) "
            f"[{smi_tag}]; {r.row(f'chaos_{algo}')}")
        del k, p
    check_launches(seen, want, "the chaos episodes (3f a)")
    log(f"phase 3f (a): every turn's decisions and every record equal on the kernel and plain "
        f"paths under chaos; launches {seen}; part (a) in {time.perf_counter() - t_3f:.1f} s")

    # (b) SONAR-GEO on the single engine: a 6-region WAN (overlays drawn on
    # the card), the fleet placed round-robin, 256 client regions drawn from
    # a Zipf(1.0) population, routes at three ticks
    t_3fb = t0 = time.perf_counter()
    topo = build_topology(6, seed=2024, device=dev)
    place = GeoPlacement(topo, place_servers(n_s, 6), client_populations(6, skew=1.0))
    sync()
    t_topo = time.perf_counter() - t0
    ggen = torch.Generator(device=dev).manual_seed(4)
    c_region = torch.multinomial(torch.as_tensor(place.client_weights, device=dev), n_q,
                                 replacement=True, generator=ggen).cpu().numpy().astype(np.int32)
    plat_g = NetMCPPlatform(servers, scenario="hybrid", seed=1, geo=place, device=dev)
    ek_g, ep_g = engines["sonar_geo"]
    g_ticks = (1000, 4321, 7777)
    ops.reset_launches()                       # phase 3f (b)'s count starts here
    g_dec = [ek_g.route_texts(batches[0], plat_g.latency_window(t), client_region=c_region,
                              region_rtt_ms=place.region_server_rtt(t)) for t in g_ticks]
    sync()
    seen = ops.launch_counts()
    check_launches(seen, {"bm25_scores": 3, "qos_scores": 3, "fused_score_select": 3},
                   "the SONAR-GEO routes (3f b)")
    for t, dk in zip(g_ticks, g_dec):
        dp = ep_g.route_texts(batches[0], plat_g.latency_window(t), client_region=c_region,
                              region_rtt_ms=place.region_server_rtt(t))
        same(dk, dp, f"SONAR-GEO at tick {t}")
    if ops.launch_counts() != seen:
        fail("phase 3f (b): the plain path launched a kernel")
    georouter = make_router("sonar_geo", servers[:1], cfg)
    georouter.index = index
    n_geo_scalar = 16
    for t, dk in zip(g_ticks, g_dec):
        win = plat_g.latency_window(t)
        for i in range(n_geo_scalar):
            d = georouter.select(batches[0][i], win,
                                 client_rtt_ms=place.client_rtt_ms(int(c_region[i]), t))
            if (d.server_idx, d.tool_idx) != (int(dk.server_idx[i]), int(dk.tool_idx[i])) \
                    or not np.isclose(d.fused, dk.fused[i], rtol=RTOL, atol=ATOL):
                fail(f"SONAR-GEO tick {t} query {i}: scalar router {(d.server_idx, d.fused)}, "
                     f"engine {(int(dk.server_idx[i]), float(dk.fused[i]))}")
    local = [float(np.mean(place.server_region[dk.server_idx] == c_region)) for dk in g_dec]
    rtt_static = topo.rtt_matrix(None)
    log(f"phase 3f (b): build_topology(6, seed=2024) overlays {list(topo._overlays.shape)} drawn on "
        f"{dev} + place_servers({n_s}, 6) in {t_topo:.2f} s; mean cross-region RTT "
        f"{rtt_static[~np.eye(6, dtype=bool)].mean():.1f} ms (static); client regions "
        f"{np.bincount(c_region, minlength=6).tolist()}; SONAR-GEO routes of {n_q} queries at "
        f"ticks {g_ticks}: kernel path equal to the plain path, local share {local}, the scalar "
        f"router agrees on the first {n_geo_scalar} queries at each tick; launches {seen}; "
        f"part (b) in {time.perf_counter() - t_3fb:.1f} s")
    del plat_g

    # (c) the reference benchmarks' gates on the port's own streams (every
    # generator on the card), at their non-smoke sizes (the smoke sizes in
    # the rehearsal)
    for gate in (gate_offered_load, gate_chaos_recovery, gate_geo_routing,
                 gate_session_routing):
        t0 = time.perf_counter()
        rows_, verdict = gate(dev, smoke=rehearse)
        name = gate.__name__[len("gate_"):]
        for row in rows_:
            log(f"phase 3f (c): {name}: {row}")
        log(f"phase 3f (c): {name} in {time.perf_counter() - t0:.2f} s (host clock) "
            f"[{smi_tag}]: {verdict}")
    log(f"phase 3f: {time.perf_counter() - t_3f:.1f} s in all")

    # ----------------------------------------------------------------- 3g
    # the serving launcher and the device-side observability: (a) the sync
    # launcher over internlm2-1.8b replicas at full width (the attention
    # kernels), with the audit tap; (b) the online launcher at 4 and at the
    # fleet's 10,005 replicas (the routing kernels) with the device route
    # stats, trace, metrics JSON and dashboard; (c) phase 3e's sharded pump
    # replay with the device route stats (the fused selection); (d) what the
    # instrumentation costs at the serving knee (benchmarks/obs_overhead.py's
    # method)
    import io
    import tempfile

    from repro_torch.core import latency as latlib
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs import Observability

    t_3g = time.perf_counter()

    # (a) the sync launcher: 4 replicas sharing one set of weights, 4 slots,
    # cap 256, 24 requests of 8 new tokens, hybrid profiles; the same run
    # with the plain attention (attn_impl="chunked") for the picks.  The
    # launcher's executor returns the network trace's latency and drops the
    # engine's output, so equal picks say nothing of the attention: the
    # kernel run keeps copies of the inputs of a few of its own attention
    # calls (request 0's prefill at the first and last layer, the last
    # request's at the last; the first decode step, request 0's last, the
    # run's last), held to the plain versions after the counts are read
    sargs = launch_serve.build_parser().parse_args([
        "--n-replicas", "4", "--n-slots", "4", "--n-requests", "24", "--max-new-tokens", "8",
        "--scenario", "hybrid", "--quiet"])
    L_ = lm_cfg.n_layers
    keep_calls = {"flash_attention": {0, L_ - 1, 24 * L_ - 1},
                  "decode_attention": {0, 7 * L_ - 1, 24 * 7 * L_ - 1}}
    att_calls = {}

    def keep_attention_inputs():
        real = {name: getattr(ops, name) for name in keep_calls}

        def grab(name):
            seen = [0]

            def call(*a, **k):
                if seen[0] in keep_calls[name]:
                    att_calls[name, seen[0]] = ([x.clone() for x in a], k)
                seen[0] += 1
                return real[name](*a, **k)
            return call

        for name in keep_calls:
            setattr(ops, name, grab(name))
        return real

    sync_runs = {}
    for impl, cfg_ in (("pallas", lm_cfg), ("chunked", plain_cfg)):
        obs_a = Observability(trace=True, audit=True)
        real_attn = keep_attention_inputs() if impl == "pallas" else {}
        sync()
        ops.reset_launches()                   # phase 3g (a)'s count starts here
        t0 = time.perf_counter()
        try:
            gw_a = launch_serve.serve_sync(sargs, cfg=cfg_, obs=obs_a, device=dev)
            sync()
        finally:
            for name, fn in real_attn.items():
                setattr(ops, name, fn)
        wall = time.perf_counter() - t0
        la = ops.launch_counts()                # ... and is read here
        spans = [e for e in obs_a.tracer.events if e.get("cat") == "engine" and e["ph"] == "X"]
        loop_s = (max(e["ts"] + e["dur"] for e in spans) - min(e["ts"] for e in spans)) / 1e6
        reg = obs_a.registry
        sync_runs[impl] = dict(
            picks=[(r.replica_idx, r.latency_ms, r.ok, r.expertise, r.network)
                   for r in gw_a.stats],
            report=gw_a.report(), audits=list(obs_a.audit_tap.records), launches=la,
            wall=wall, loop_s=loop_s, admitted=int(reg.value("engine_admitted_total")),
            steps=int(reg.value("engine_steps_total")),
            tokens=int(reg.value("engine_tokens_total")))
        del gw_a, obs_a
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    ka, pa = sync_runs["pallas"], sync_runs["chunked"]
    want_a = {"flash_attention": lm_cfg.n_layers * ka["admitted"],
              "decode_attention": lm_cfg.n_layers * ka["steps"]}
    if ka["admitted"] != 24 or ka["tokens"] != 24 * 8:
        fail(f"phase 3g (a): {ka['admitted']} requests admitted, {ka['tokens']} tokens")
    check_launches(ka["launches"], want_a, "the sync launcher (3g a)")
    if any(pa["launches"].values()):
        fail(f"phase 3g (a): the plain path launched a kernel: {pa['launches']}")
    if ka["picks"] != pa["picks"] or ka["report"] != pa["report"]:
        fail("phase 3g (a): the picks, latencies, outcomes or report differ between the "
             "kernel and plain attention")
    if sorted(att_calls) != sorted((n, i) for n, idx in keep_calls.items() for i in idx):
        fail(f"phase 3g (a): kept the inputs of attention calls {sorted(att_calls)}")
    att_a = {}
    with torch.no_grad():
        for (name, i), (a, k) in sorted(att_calls.items()):
            if name == "flash_attention":
                want = kref.mha_ref(*a, sm_scale=1 / math.sqrt(a[0].shape[-1]), causal=True)
                what = f"B {a[0].shape[0]}, S {a[0].shape[2]}"
            else:
                q_, k_, v_, lens_ = a
                nb, hq, hd = q_.shape
                want = kref.decode_ref(q_.reshape(nb, k_.shape[1], hq // k_.shape[1], hd), k_, v_,
                                       lens_.reshape(nb, 1),
                                       sm_scale=1 / math.sqrt(hd)).reshape(nb, hq, hd)
                what = f"{nb} slots, cap {k_.shape[2]}, lengths {lens_.tolist()}"
            got = getattr(ops, name)(*a, **k)
            sync()
            att_a[name, i] = (what, attn_close(got, want, ATTN_TOL["bfloat16"],
                                               f"phase 3g (a): {name} call {i} ({what})"))
            max_err[name] = max(max_err[name], att_a[name, i][1])
    del att_calls
    if len(ka["audits"]) != 24:
        fail(f"phase 3g (a): {len(ka['audits'])} audit records for 24 requests")
    for i, (a, (idx, _, _, c_, n_)) in enumerate(zip(ka["audits"], ka["picks"])):
        if not np.array_equal(a.recompose(), a.fused) or a.winning_score() != float(
                a.fused[a.best]) or a.server_idx != idx or (
                float(a.expertise[a.best]), float(a.network[a.best])) != (c_, n_):
            fail(f"phase 3g (a): the audit of request {i} does not recompose its decision")
    log(f"phase 3g (a): sync launcher, {lm_cfg.name} ({lm_cfg.n_layers} layers, d_model "
        f"{lm_cfg.d_model}, {lm_cfg.dtype}) x 4 replicas: 24 requests, {ka['steps']} decode "
        f"steps; serve_sync {ka['wall']:.2f} s wall (weights drawn, engines built), request "
        f"loop {ka['loop_s']:.3f} s from the engine spans = {1e3 * ka['loop_s'] / 24:.1f} ms "
        f"per request, {ka['tokens'] / ka['loop_s']:.1f} tokens/s (host clock) [{smi_tag}]; "
        f"plain attention: loop {pa['loop_s']:.3f} s; launches {ka['launches']}; picks, "
        f"latencies, outcomes and report equal (network latencies, not the engines' output); "
        f"24 audits recompose bit for bit; the path's own attention calls against the plain "
        f"versions (bf16, rtol = atol = {ATTN_TOL['bfloat16']}), max abs err: "
        + "; ".join(f"{n} call {i} ({w}) {e:.3g}" for (n, i), (w, e) in att_a.items()))

    # (b) the online launcher at its defaults (4 replicas, sonar_lb, Poisson
    # 200 rps over 1 s, max_batch 16, max_wait_ms 5; the whole second's
    # schedule) and at the fleet's 10,005 replicas
    tmp_3g = tempfile.TemporaryDirectory(prefix="chip_smoke_3g_")
    online = {}
    for n_rep in (4, n_s):
        trace_p = f"{tmp_3g.name}/trace_{n_rep}.json"
        metrics_p = f"{tmp_3g.name}/metrics_{n_rep}.json"
        oargs = launch_serve.build_parser().parse_args([
            "--mode", "online", "--n-replicas", str(n_rep), "--n-requests", "0", "--quiet",
            "--trace", trace_p, "--metrics-json", metrics_p, "--dashboard"]
            + (["--horizon-s", "0.2"] if rehearse else []))
        buf = io.StringIO()
        sync()
        ops.reset_launches()                   # phase 3g (b)'s count starts here
        t0 = time.perf_counter()
        summary, results, gw_b = launch_serve.serve_online(oargs, device=dev,
                                                           dashboard_stream=buf)
        sync()
        wall = time.perf_counter() - t0
        lb = ops.launch_counts()                # ... and is read here
        what = f"phase 3g (b): online launcher at {n_rep} replicas"
        routed = [r for r in results if not (r.shed or r.expired)]
        stats = gw_b.obs.fold_route_stats()
        if summary["offered"] != summary["routed"] + summary["shed"] + summary["expired"] \
                or summary["offered"] != len(results) or summary["routed"] != len(routed):
            fail(f"{what}: offered != routed + shed + expired: {summary}")
        if summary["registry_routed"] != summary["routed"] or not routed:
            fail(f"{what}: the registry counts {summary['registry_routed']} routed, the results "
                 f"{summary['routed']}")
        tally = np.bincount([r.replica_idx for r in routed], minlength=n_rep)
        if stats["n_routed"] != summary["routed"] or not np.array_equal(stats["picks"], tally):
            fail(f"{what}: the device route stats ({stats['n_routed']:.0f} routed) differ from "
                 f"the results' tally ({summary['routed']})")
        with open(trace_p) as f:
            n_events = len(json.load(f)["traceEvents"])
        with open(metrics_p) as f:
            saved = json.load(f)
        if n_events == 0 or saved.get("route_stats", {}).get("n_routed") != stats["n_routed"]:
            fail(f"{what}: {n_events} trace events; metrics JSON route_stats "
                 f"{saved.get('route_stats', {}).get('n_routed')}")
        if "mean C / N / S" not in buf.getvalue():
            fail(f"{what}: the dashboard has no 'mean C / N / S' row")
        if not rehearse and (not all(lb[k] for k in ("bm25_scores", "qos_scores",
                                                     "fused_score_select"))
                             or lb["fused_select"]):
            fail(f"{what}: launches {lb}")
        online[n_rep] = gw_b
        log(f"{what}: {summary['offered']} offered, {summary['routed']} routed, "
            f"{summary['shed']} shed, {summary['expired']} expired in {summary['flushes']} "
            f"flushes; serve p50 {summary['p50_ms']} ms, p99 {summary['p99_ms']} ms (host "
            f"clock), {wall:.2f} s wall with the gateway's build [{smi_tag}]; device route stats "
            f"equal the results' tally (mean C / N / S {stats['mean_expertise']:.4f} / "
            f"{stats['mean_network']:.4f} / {stats['mean_fused']:.4f}); {n_events} trace "
            f"events; launches {lb}")
    tmp_3g.cleanup()
    gw_online = online.pop(n_s)                 # phase 4 profiles one of its flushes
    del online

    # (c) phase 3e's sharded pump replay (SONAR, 10,005 replicas, shards=4)
    # with the device route stats on: the fold equals the results' tally,
    # and the drain makes no host sync
    obs_c = Observability(trace=True, jit_stats=True)
    gw_c = SonarGateway(replicas, profiles=rep_profiles, algo="sonar", seed=0, use_kernels=True,
                        shards=4, device=dev, obs=obs_c)
    sync()
    ops.reset_launches()                       # phase 3g (c)'s count starts here
    pump_c = MicroBatchPump(gw_c, policy, service_ms=lambda texts: 1.0)
    rep_c = pump_c.replay(sched)
    texts20 = [GATEWAY_TEXTS[i % len(GATEWAY_TEXTS)] for i in range(20)]
    extra = gw_c.route_batch(texts20, pad_to=32)      # one padded call left pending
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")      # any host sync raises
    try:
        obs_c.drain_route_stats()
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    lc = ops.launch_counts()                    # ... and is read here
    stats_c = obs_c.fold_route_stats()
    tally_c = np.bincount([r.replica_idx for r in pump_c.results.values()
                           if not (r.shed or r.expired)] + [r.replica_idx for r in extra],
                          minlength=n_s)
    n_c = rep_c.n_routed + len(extra)
    if stats_c["n_routed"] != n_c or not np.array_equal(stats_c["picks"], tally_c):
        fail(f"phase 3g (c): the device route stats ({stats_c['n_routed']:.0f} routed) differ "
             f"from the pump's tally ({n_c})")
    host_c = np.mean([r.expertise for r in gw_c.stats])
    if not np.isclose(stats_c["mean_expertise"], host_c, rtol=1e-6, atol=1e-6):
        fail(f"phase 3g (c): mean C {stats_c['mean_expertise']} against the host's {host_c}")
    if not rehearse and not lc["fused_select"]:
        fail(f"phase 3g (c): fused_select never launched: {lc}")
    log(f"phase 3g (c): sharded pump replay (sonar, {n_s} replicas, shards=4) with device route "
        f"stats: {rep_c.n_routed} routed in {rep_c.n_flushes} flushes + 20 in one padded call; "
        f"the fold equals the tally, picks exact, mean C {stats_c['mean_expertise']:.6f} "
        f"(host {host_c:.6f}); "
        + ("drain under set_sync_debug_mode('error'); " if dev.type == "cuda" else "")
        + f"{len(obs_c.tracer.events)} trace events; launches {lc}")
    del gw_c, pump_c, obs_c

    # (d) the instrumentation's cost: benchmarks/obs_overhead.py's method.
    # The batch-oracle QPS of 4 replicas (512 requests in padded batches of
    # 16), then 3 interleaved trials a side of a flash-crowd MicroBatchPump
    # replay at 0.75x that rate (flush times measured): the default
    # Observability() against Observability(trace=True, jit_stats=True)
    def oh_gateway(obs=None):
        return SonarGateway(replica_pool([("yi-6b", "dense")] * 4),
                            profiles=[latlib.ideal_profile() for _ in range(4)],
                            algo="sonar_lb", seed=0, use_kernels=True, device_telemetry=True,
                            obs=obs, device=dev)

    oh_texts = [BENCH_TEXTS[i % len(BENCH_TEXTS)] for i in range(512)]
    gw_d = oh_gateway()
    gw_d.route_batch(oh_texts[:16], pad_to=16)
    gw_d.route_batch(oh_texts[:8], pad_to=16)
    sync()
    t0 = time.perf_counter()
    for lo in range(0, 512, 16):
        gw_d.route_batch(oh_texts[lo:lo + 16], pad_to=16)
    sync()
    oracle_qps = 512 / (time.perf_counter() - t0)
    oh_rate = 0.75 * oracle_qps
    oh_policy = BatchingPolicy(max_batch=16, max_wait_ms=2.0, slack_ms=0.0, queue_limit=4096,
                               pad_batches=True)
    oh_horizon = 0.1 if rehearse else 1.0
    arm_obs = {"default": dict(), "trace + stats": dict(trace=True, jit_stats=True)}

    def oh_trial(seed, kw):
        pump_d = MicroBatchPump(oh_gateway(Observability(**kw)), oh_policy)
        pump_d.replay(request_schedule(
            "flash_crowd", torch.Generator(device=dev).manual_seed(seed), oh_rate,
            oh_horizon, list(BENCH_TEXTS), spike_factor=3.0))
        return [r.t_done_ms - r.t_arrival_ms for r in pump_d.results.values()
                if not (r.shed or r.expired)]

    lat_d = {k: [] for k in arm_obs}
    for t in range(3):
        for name in (list(arm_obs) if t % 2 == 0 else list(arm_obs)[::-1]):
            lat_d[name] += oh_trial(t, arm_obs[name])
    p99_d = {k: float(np.percentile(np.asarray(v, np.float64), 99)) for k, v in lat_d.items()}
    log(f"phase 3g (d): instrumentation cost (obs_overhead's method, sonar_lb, 4 replicas, "
        f"device ring): batch-oracle {oracle_qps:.0f} req/s, flash crowd at {oh_rate:.0f} "
        f"req/s over {oh_horizon} s, 3 interleaved trials a side: p99 default "
        f"{p99_d['default']:.3f} ms, trace + device route stats {p99_d['trace + stats']:.3f} "
        f"ms, overhead {100.0 * (p99_d['trace + stats'] / p99_d['default'] - 1.0):+.2f} % "
        f"(pump virtual clock of measured flushes; not gated) [{smi_tag}]")
    del gw_d
    log(f"phase 3g: {time.perf_counter() - t_3g:.1f} s in all")

    # ----------------------------------------------------------------- 3h
    # the MoE serving path (the reduced configs in the rehearsal): (a)
    # deepseek-moe-16b at full width and depth, bf16; (d) one of its MoE
    # layers on the card against its CPU run; (b) deepseek-moe-16b at 4
    # layers in f32; (c) llama4-scout-17b-a16e at full width over 4 of its
    # 48 layers.  Each model is freed before the next is drawn.
    from repro_torch.models import mlp as moe_mlp
    from repro_torch.nn import core as lm_nn

    t_3h = time.perf_counter()

    def free_card():
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def draw_model(arch, tag, dtype="bfloat16", **cut):
        """The config at full width (reduced in the rehearsal), cut as
        ``cut`` says (n_layers, n_experts), and its weights drawn on the card
        from seed 0 (a stacked weight one layer at a time)."""
        full = lm_configs.get_reduced(arch) if rehearse else lm_configs.get_config(arch)
        cut = {k: min(v, getattr(full, k)) for k, v in cut.items() if v is not None}
        cfg_ = dataclasses.replace(full, dtype=dtype, attn_impl="pallas", **cut)
        free_card()
        t0 = time.perf_counter()
        params_ = get_model(cfg_).init_params(seed=0, device=dev)
        sync()
        n_ = sum(t.numel() for t in _leaves(params_))
        # the tensors span the padded vocabulary; param_counts counts vocab_size
        want = cfg_.param_counts()["total"] + (1 + (not cfg_.tie_embeddings)) * \
            (cfg_.padded_vocab - cfg_.vocab_size) * cfg_.d_model
        if n_ != want:
            fail(f"phase {tag}: {n_:,} parameters drawn, param_counts() says {want:,}")
        mem = (f", peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
               if dev.type == "cuda" else "")
        kinds = cfg_.layer_kinds()
        blocks = ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
        cuts = ", ".join(f"{k} {v} of {getattr(full, k)}" for k, v in cut.items())
        ffn = (f"{cfg_.first_k_dense} dense prelude, d_ff {cfg_.ffn_hidden(0)}; "
               if cfg_.d_ff or cfg_.first_k_dense else "")
        moe = (f", {cfg_.n_experts} routed experts top-{cfg_.experts_per_token} + "
               f"{cfg_.n_shared_experts} shared of d_ff {cfg_.moe_d_ff} every "
               f"{cfg_.moe_every}" if cfg_.n_experts else "")
        log(f"phase {tag}: {cfg_.name}: {cfg_.n_layers} of {full.n_layers} layers ({blocks}; "
            f"{ffn}cut: {cuts or 'nothing'}), d_model {cfg_.d_model}, {cfg_.n_heads}/"
            f"{cfg_.n_kv_heads} heads of {cfg_.resolved_head_dim}{moe}, vocab "
            f"{cfg_.padded_vocab}, {dtype}: {n_:,} parameters "
            f"({n_ * cfg_.torch_dtype.itemsize / 1e9:.2f} GB) drawn on {dev} in "
            f"{time.perf_counter() - t0:.2f} s{mem}")
        return cfg_, params_

    failures_3h = []

    def moe_serve(tag, cfg_, params_, seed, n_req, lens, n_slots, cap, max_new, tol, runs,
                  failures=failures_3h, phase="3h"):
        """``n_req`` seeded prompts of ``lens`` tokens (a (low, high) range,
        or the lengths themselves) through `serve_requests` with the expert
        log and the plain ``runs``; the launch gates (one flash launch per
        attention layer per admitted request, one decode launch per attention
        layer per decode step).  Breaches are collected in ``failures``."""
        srng_ = np.random.default_rng(seed)
        plens = srng_.integers(lens[0], lens[1] + 1, n_req) if len(lens) == 2 \
            else np.asarray(lens)
        prompts_ = [srng_.integers(0, cfg_.vocab_size, int(n)).astype(np.int32) for n in plens]
        sv_ = serve_requests(cfg_, dataclasses.replace(cfg_, attn_impl="chunked"), params_, dev,
                             n_slots=n_slots, cap=cap, prompts=prompts_, max_new=max_new,
                             tol=tol, experts=runs, failures=failures)
        sl = sv_["launches"]
        n_att = cfg_.layer_kinds().count("attn")
        want_ = {"flash_attention": n_att * sv_["admitted"],
                 "decode_attention": n_att * sv_["steps"]}
        if not rehearse:
            for name, n in want_.items():
                if sl[name] != n:
                    fail(f"phase {phase} ({tag}): {name}: {sl[name]} launches, expected {n} "
                         f"({n_att} attention layers x {n // n_att})")
            others = {k: v for k, v in sl.items() if k not in want_ and v}
            if others:
                fail(f"phase {phase} ({tag}): the serving path launched routing kernels: "
                     f"{others}")
        mem = (f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
               if dev.type == "cuda" else "")
        log(f"phase {phase} ({tag}): served {n_req} requests (prompts {sorted(plens.tolist())} "
            f"tokens, {max_new} new each) through {n_slots} slots of cap {cap} in "
            f"{sv_['steps']} decode steps, {sv_['wall_s']:.3f} s wall (expert choices logged; "
            f"{1e3 * sv_['wall_s'] / sv_['steps']:.1f} ms an engine step, its prefills "
            f"included), {sv_['tokens']} tokens ({sv_['tokens'] / sv_['wall_s']:.1f} tokens/s, "
            f"host clock); launches {sl}{mem} [{smi_tag}]")
        for run, st in sv_["by_run"].items():
            gaps = [g for _, _, g in st["argmax_diffs"]]
            where = "on the rows where none differs" if run == "own" else "on every row"
            log(f"phase {phase} ({tag}): teacher-forced plain path (attn_impl='chunked', {run} "
                f"routing, {st['wall_s']:.3f} s): {st['expert_pair_diffs']} of "
                f"{st['expert_pairs']} (token, MoE layer) pairs choose other experts, in "
                f"{st['rows_expert_diff']} of {len(prompts_) * max_new} rows of logits; "
                f"{where} ({st['rows']}) max abs difference prefill "
                f"{st['prefill_max_abs']:.4g}, decode {st['decode_max_abs']:.4g} (tolerance "
                f"{tol}); over every row {st['all_rows_max_abs']:.4g}; first tokens that "
                f"differ (rid, plain-logit gap, differing pairs, max abs, held): "
                f"{st['first_token_diffs']}; {len(gaps)} argmax differences held, largest "
                f"plain-logit gap {max(gaps, default=0.0):.4g}")
        return sv_

    # (a) deepseek-moe-16b at full width and depth
    ds_cfg, ds_params = draw_model("deepseek-moe-16b", "3h (a)")
    sv_a = moe_serve("a", ds_cfg, ds_params, 7, 16, (64, 1536), 8, 2048, 32, SERVE_TOL,
                     ("own", "forced"))
    h_launches = sv_a["launches"]

    # (d) one MoE layer (group layer 0, full width) on the card against its
    # CPU run on the same inputs: 2 rows of 256 tokens; run twice on the
    # card, bit for bit
    lay = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
           for k, v in ds_params["groups"]["l0"]["ffn"]["moe"].items()}
    gx = torch.Generator(device=dev).manual_seed(21)
    xm = torch.randn((2, 256, ds_cfg.d_model), generator=gx, device=dev).to(torch.bfloat16)
    K_, E_ = ds_cfg.experts_per_token, ds_cfg.n_experts
    C_ = moe_mlp._capacity(256, K_, E_, ds_cfg.capacity_factor)
    y1, aux1 = moe_mlp.moe_ffn_apply(lay, ds_cfg, xm)
    y2, aux2 = moe_mlp.moe_ffn_apply(lay, ds_cfg, xm)
    if not (torch.equal(y1, y2) and torch.equal(aux1, aux2)):
        fail("phase 3h (d): two runs of the MoE layer on the card differ")
    card_d = [t.cpu() for t in moe_mlp._moe_dispatch(lay, ds_cfg, xm, C_)]
    logits_card = lm_nn.dense(xm, lay["router"]).to(torch.float32).cpu()
    lay_h = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
             for k, v in lay.items()}
    xm_h = xm.cpu()
    logits_host = lm_nn.dense(xm_h, lay_h["router"]).to(torch.float32)
    n_logit_diff = int((logits_card != logits_host).sum())
    sets_c = torch.sort(moe_mlp._gates(logits_card, K_)[2], dim=-1).values
    sets_h = torch.sort(moe_mlp._gates(logits_host, K_)[2], dim=-1).values
    n_set_diff = int((sets_c != sets_h).any(-1).sum())
    own = moe_mlp._moe_dispatch(lay_h, ds_cfg, xm_h, C_)

    def dispatch_equal(a, b):
        return torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]) and \
            torch.equal(a[3] != 0, b[3] != 0)

    # slot, token_of and the kept mask depend on the logits only through
    # each token's expert set
    if n_set_diff == 0 and not dispatch_equal(card_d, own):
        failures_3h.append("phase 3h (d): equal expert sets, yet the dispatch differs from "
                           "the CPU's")
    real_route = moe_mlp._route
    moe_mlp._route = lambda p_, cfg_, x_: moe_mlp._gates(logits_card, cfg_.experts_per_token)
    try:
        forced = moe_mlp._moe_dispatch(lay_h, ds_cfg, xm_h, C_)
        y_h, aux_h = moe_mlp.moe_ffn_apply(lay_h, ds_cfg, xm_h)
    finally:
        moe_mlp._route = real_route
    if not dispatch_equal(card_d, forced):
        failures_3h.append("phase 3h (d): slot, token_of or the kept mask differ between the "
                           "card and the CPU on the same router logits")
    err_d = attn_close(y1, y_h, ATTN_TOL["bfloat16"], "phase 3h (d): the MoE layer's y")
    n_kept = int((card_d[3] != 0).sum())
    log(f"phase 3h (d): one MoE layer [2, 256, {ds_cfg.d_model}] (C {C_}): two card runs bit "
        f"for bit; router logits differ from the CPU's at {n_logit_diff} of "
        f"{logits_card.numel()} entries ({n_set_diff} tokens' expert sets differ); given the "
        f"card's logits, slot, token_of and the kept mask ({n_kept} of {card_d[3].numel()} "
        f"entries kept) equal the CPU's"
        + (", and so they do on the CPU's own logits" if n_set_diff == 0 else "")
        + f"; y within {ATTN_TOL['bfloat16']} (max abs {err_d:.3g}), aux "
        f"{float(aux1):.6f} against {float(aux_h):.6f}")
    del ds_params, lay, lay_h, xm, y1, y2, card_d, own, forced, y_h

    # (b) deepseek-moe-16b at 4 layers (the prelude + 3 MoE layers) in f32
    f32_cfg, f32_params = draw_model("deepseek-moe-16b", "3h (b)", "float32", n_layers=4)
    sv_b = moe_serve("b", f32_cfg, f32_params, 8, 6, (64, 1024), 4, 2048, 8, F32_SERVE_TOL,
                     ("own",))
    if sv_b["expert_pair_diffs"]:
        failures_3h.append(f"phase 3h (b): {sv_b['expert_pair_diffs']} (token, layer) pairs "
                           "choose other experts on the two f32 paths")
    del f32_params

    # (c) llama4-scout-17b-a16e at full width over 4 of its 48 layers
    sc_cfg, sc_params = draw_model("llama4-scout-17b-a16e", "3h (c)", n_layers=4)
    moe_serve("c", sc_cfg, sc_params, 9, 8, (64, 960), 4, 1024, 32, SERVE_TOL,
              ("own", "forced"))
    del sc_params
    free_card()
    log(f"phase 3h: {time.perf_counter() - t_3h:.1f} s in all")
    if failures_3h:
        fail("phase 3h: " + " | ".join(failures_3h))

    # ----------------------------------------------------------------- 3i
    # the recurrent families (the reduced configs in the rehearsal): (a)
    # jamba-1.5-large-398b at full width, cut to 8 of its 72 layers (one
    # period of its block pattern) and 8 of its 16 experts, bf16, served
    # through both attention kernels against the plain path; (b) one of its
    # Mamba blocks at full width in f32: the chunked SSD against the
    # sequential oracle, decode against the full forward; (c) xlstm-125m at
    # full width and depth, bf16; (d) the same in f32, its mLSTM prefill
    # through the chunked form and through the sequential oracle.
    from repro_torch.models import mamba as lm_mamba
    from repro_torch.models import xlstm as lm_xlstm
    from repro_torch.serving.engine import Request, ServeEngine

    t_3i = time.perf_counter()
    failures_3i = []

    # (a) Jamba at full width: prompts that straddle its SSD chunk of 256.
    # The rehearsal's reduced Jamba (d_model 64, vocab 512) runs in f32: in
    # bf16 its logits near 3 are multiples of 1/64, and the top two of a
    # prompt tie within that step as often as not
    jb_cfg, jb_params = draw_model("jamba-1.5-large-398b", "3i (a)",
                                   "float32" if rehearse else "bfloat16",
                                   n_layers=8, n_experts=8)
    jb_lens = (3, 255, 256, 257, 511, 700, 1024, 1100)
    sv_i = moe_serve("a", jb_cfg, jb_params, 11, len(jb_lens), jb_lens, 4, 1280, 16, SERVE_TOL,
                     ("own", "forced"), failures=failures_3i, phase="3i")
    i_launches = sv_i["launches"]
    del jb_params
    free_card()

    # (b) one Mamba block at Jamba's full width in f32, on 608 tokens (two
    # full chunks and a ragged one at 600)
    mcfg = dataclasses.replace(jb_cfg, dtype="float32")
    gm = torch.Generator(device=dev).manual_seed(5)
    mp = {k: v[0] for k, v in lm_mamba.mamba_init(lm_nn.InitCtx(gen=gm, dtype=torch.float32),
                                                  mcfg, 1).items()}
    xb = torch.randn((1, 608, mcfg.d_model), generator=gm, device=dev)
    with torch.no_grad():
        xh_, dt_, Bm_, Cm_, _, _ = lm_mamba._project(mp, mcfg, xb[:, :600])
        y_c, h_c = lm_mamba.ssd_chunked(xh_, dt_, Bm_, Cm_, mp["a_log"], mcfg.mamba_chunk)
        y_s, h_s = lm_mamba.ssd_scan_ref(xh_, dt_, Bm_, Cm_, mp["a_log"])
        ssd_err = [float((a - b).abs().max()) for a, b in ((y_c, y_s), (h_c, h_s))]
        if not (torch.allclose(y_c, y_s, rtol=1e-4, atol=1e-4)
                and torch.allclose(h_c, h_s, rtol=1e-4, atol=1e-4)):
            failures_3i.append(f"phase 3i (b): ssd_chunked and ssd_scan_ref differ beyond "
                               f"rtol = atol = 1e-4 (max abs y {ssd_err[0]:.3g}, h "
                               f"{ssd_err[1]:.3g})")
        y_full, _ = lm_mamba.mamba_apply(mp, mcfg, xb)
        y0, st_b = lm_mamba.mamba_apply(mp, mcfg, xb[:, :600], return_state=True)
        ys_b = [y0]
        for t in range(600, 608):
            y_t, st_b = lm_mamba.mamba_decode(mp, mcfg, xb[:, t:t + 1], st_b)
            ys_b.append(y_t)
        dec_err = float((torch.cat(ys_b, dim=1) - y_full).abs().max())
        if not torch.allclose(torch.cat(ys_b, dim=1), y_full, rtol=2e-3, atol=2e-3):
            failures_3i.append(f"phase 3i (b): mamba_apply + mamba_decode differ from "
                               f"mamba_apply over 608 tokens by {dec_err:.3g} (bound 2e-3)")
    log(f"phase 3i (b): one Mamba block at d_model {mcfg.d_model} (d_inner {mcfg.d_inner}, "
        f"{mcfg.mamba_heads} heads of {mcfg.mamba_head_dim}, d_state {mcfg.mamba_d_state}, "
        f"chunk {mcfg.mamba_chunk}), f32 on {dev}: ssd_chunked against ssd_scan_ref on 600 "
        f"tokens, max abs y {ssd_err[0]:.3g} (|y| up to {float(y_s.abs().max()):.3g}), h "
        f"{ssd_err[1]:.3g} (|h| up to {float(h_s.abs().max()):.3g}), bound rtol = atol = 1e-4; "
        f"mamba_apply over 600 + 8 mamba_decode steps against mamba_apply over 608: max abs "
        f"{dec_err:.3g} (|y| up to {float(y_full.abs().max()):.3g}), bound 2e-3 [{smi_tag}]")
    del mp, xb, xh_, dt_, Bm_, Cm_, y_c, y_s, h_c, h_s, y_full, ys_b, st_b

    # (c) xlstm-125m at full width and depth, bf16: 16 requests through 8 slots
    xrng = np.random.default_rng(12)
    x_lens = xrng.integers(64, 513, 16)
    x_prompts = [xrng.integers(0, 50304, int(n)).astype(np.int32) for n in x_lens]

    def xlstm_serve(cfg_, params_, scan_prefill=False):
        """The prompts through a `ServeEngine` of 8 slots to `drain`, with
        the launch counters set to 0 just before and read just after;
        returns (requests, each request's first row of logits, steps, wall
        s).  ``scan_prefill`` runs mLSTM's prefill through
        `mlstm_scan_ref` in place of `mlstm_chunked`."""
        rows = {}

        class FirstRows(ServeEngine):
            def _next_tokens(self, logits, reqs):
                for i, r in enumerate(reqs):
                    if r is not None and not r.generated:
                        rows[r.rid] = logits[i].clone()
                return super()._next_tokens(logits, reqs)

        eng = FirstRows(get_model(cfg_), params_, n_slots=8, cap=1024, device=dev)
        reqs = [Request(rid=i, tokens=t % cfg_.vocab_size, max_new_tokens=32)
                for i, t in enumerate(x_prompts)]
        for r in reqs:
            eng.submit(r)
        chunked = lm_xlstm.mlstm_chunked
        if scan_prefill:
            lm_xlstm.mlstm_chunked = lambda q, k, v, lf, li, chunk, state=None: \
                lm_xlstm.mlstm_scan_ref(q, k, v, lf, li, state)
        try:
            sync()
            ops.reset_launches()               # the xLSTM path's count starts here
            t0 = time.perf_counter()
            steps_ = eng.drain()
            sync()
            wall_ = time.perf_counter() - t0
            launches_ = ops.launch_counts()    # ... and is read here
        finally:
            lm_xlstm.mlstm_chunked = chunked
        if not all(r.done and len(r.generated) == 32 for r in reqs):
            fail("phase 3i: an xlstm-125m request did not finish")
        if any(launches_.values()):
            fail(f"phase 3i: the xLSTM path (no attention layer) launched kernels: {launches_}")
        return reqs, rows, steps_, wall_

    xl_cfg, xl_params = draw_model("xlstm-125m", "3i (c)")
    xreqs, _, xsteps, xwall = xlstm_serve(xl_cfg, xl_params)
    xtok = sum(len(r.generated) for r in xreqs)
    log(f"phase 3i (c): served {len(xreqs)} requests (prompts {sorted(x_lens.tolist())} tokens, "
        f"32 new each) through 8 slots in {xsteps} decode steps, {xwall:.3f} s wall "
        f"({1e3 * xwall / xsteps:.1f} ms an engine step, its prefills included), {xtok} tokens "
        f"({xtok / xwall:.1f} tokens/s, host clock); no kernel launched (no attention layer) "
        f"[{smi_tag}]")
    del xl_params

    # (d) the same in f32, mLSTM's prefill chunked and through its oracle
    xf_cfg, xf_params = draw_model("xlstm-125m", "3i (d)", dtype="float32")
    fa, rows_a, _, wall_a = xlstm_serve(xf_cfg, xf_params)
    fb, rows_b, _, wall_b = xlstm_serve(xf_cfg, xf_params, scan_prefill=True)
    pre_err = max(float((rows_a[i] - rows_b[i]).abs().max()) for i in rows_a)
    same = [r.generated for r in fa] == [r.generated for r in fb]
    if not pre_err <= F32_SERVE_TOL:
        failures_3i.append(f"phase 3i (d): prefill logits of the chunked and sequential mLSTM "
                           f"differ by {pre_err} (tolerance {F32_SERVE_TOL})")
    if not same:
        n_diff = sum(a.generated != b.generated for a, b in zip(fa, fb))
        failures_3i.append(f"phase 3i (d): {n_diff} requests' greedy tokens differ between "
                           "the chunked and sequential mLSTM prefill")
    log(f"phase 3i (d): {xf_cfg.name} in f32, the same 16 requests: mLSTM prefill chunked "
        f"({wall_a:.3f} s) and through mlstm_scan_ref ({wall_b:.3f} s, host clock): every "
        f"prefill row within {pre_err:.3g} (tolerance {F32_SERVE_TOL}), greedy tokens "
        f"{'equal' if same else 'DIFFERENT'} [{smi_tag}]")
    del xf_params
    free_card()
    log(f"phase 3i: {time.perf_counter() - t_3i:.1f} s in all")
    if failures_3i:
        fail("phase 3i: " + " | ".join(failures_3i))

    # ------------------------------------------------------------------ 4
    def timed(fn, n=reps):
        """Median ms of ``n`` calls after two warm-up calls (CUDA events on the card)."""
        fn()
        fn()
        sync()
        out = []
        for _ in range(n):
            if dev.type == "cuda":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                out.append(a.elapsed_time(b))
            else:
                t = time.perf_counter()
                fn()
                out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)

    def device_us(fn, n):
        """Wall ms of ``n`` calls of ``fn`` (after a warm-up) under the
        profiler, and the device time per call by kernel name (us);
        annotations are left out.  The tracer now and then returns no
        device activity at all (about one profile in five on the H100), or
        only part of it; a profile in which some kernel's count of records
        is not a multiple of ``n`` (so some calls' records are missing) is
        taken again, as an empty one is, up to three times, and then means
        "not measured" (empty), never zero or a share of the calls."""
        fn()
        sync()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for _ in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                t = time.perf_counter()
                for _ in range(n):
                    fn()
                sync()
                wall = (time.perf_counter() - t) * 1e3 / n
            per, whole, counts = {}, True, {}
            for ev in prof.key_averages():
                if ev.device_type != torch.autograd.DeviceType.CUDA \
                        or getattr(ev, "is_user_annotation", False) \
                        or ev.key.startswith("netmcp."):
                    continue      # host-side ops, and labels whose device range spans kernels
                d = getattr(ev, "self_device_time_total", 0) \
                    or getattr(ev, "self_cuda_time_total", 0)
                if d:
                    per[ev.key] = d / n
                    counts[ev.key[:40]] = ev.count
                    whole = whole and ev.count % n == 0
            if per and whole:
                break
            per = {}
        device_us.refused = counts      # the last attempt's records per entry, for the log
        return wall, per

    def bound(n_bytes, n_ops, ops_per_s=FP32_OPS_PER_S):
        tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / ops_per_s * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    rows = []
    with torch.no_grad():
        # bm25: a sparse-query product; count the vocabulary columns the
        # queries use and their non-zero terms, and the full output
        nnz = int((q_s != 0).sum())
        used_cols = int((q_s != 0).any(0).sum())
        log(f"phase 4: bm25_scores queries use {used_cols} of {q_s.shape[1]} columns, "
            f"{nnz / q_s.shape[0]:.2f} non-zero terms per query on average "
            f"(at most {int((q_s != 0).sum(1).max())})")
        b_bm25 = bound(4 * (q_s.numel() + used_cols * w_s.shape[0] + k_s.numel()),
                       2 * nnz * w_s.shape[0])
        rows.append(dict(
            name="bm25_scores", ms=timed(lambda: ops.bm25_scores(q_s, w_st)),
            plain_ms=timed(lambda: bm25_plain(w_s, q_s), n=max(3, reps // 5)),
            library_ms=timed(lambda: torch.matmul(q_s, w_st)),
            bound=b_bm25, dense_bound_ms=bound(4 * (q_s.numel() + w_s.numel() + k_s.numel()),
                                               2 * k_s.numel() * q_s.shape[1])[0],
            shape=f"[{q_s.shape[0]}, {q_s.shape[1]}] x [{w_s.shape[0]}, {w_s.shape[1]}]"))
        qos_ops = 12 * lat_t.numel()
        rows.append(dict(
            name="qos_scores", ms=timed(lambda: ops.qos_scores(lat_t)),
            plain_ms=timed(lambda: network_score(lat_t)), library_ms=None,
            bound=bound(4 * (lat_t.numel() + lat_t.shape[0]), qos_ops),
            shape=f"[{lat_t.shape[0]}, {T}]"))
        perq = dict(ms=timed(lambda: ops.qos_scores(flat)),
                    plain_ms=timed(lambda: network_score(flat)),
                    bound=bound(4 * (flat.numel() + flat.shape[0]), 12 * flat.numel()))
        in_cand = kref.candidate_mask(ts, cand)
        n_pairs = int(in_cand.sum())
        uniq = int(in_cand.any(0).sum())
        V_t = q_t.shape[1]
        b_fused = bound(4 * (q_t.numel() + cand.numel() + ts.numel() + uniq * (V_t + 3)
                             + 4 * q_t.shape[0]), 2 * n_pairs * V_t)
        fk = dict(k=cfg.top_k, alpha=0.5, beta=0.5, gamma=0.35, delta=0.4, temp=1.0,
                  tool_rtt=tool_rtt)
        def fused_call():         # as the route calls it: its top-s slice and the engine's map
            return ops.fused_score_select(q_t, w_t, ts, cand_route, tool_qos, tool_load,
                                          tool_dead, tool_csr=csr, **fk)

        rows.append(dict(
            name="fused_score_select", ms=timed(fused_call),
            plain_ms=timed(lambda: kref.fused_score_select_ref(
                q_t, w_t, ts, cand, tool_qos, tool_load, tool_dead, **fk), n=max(3, reps // 5)),
            library_ms=None, bound=b_fused,
            shape=f"[{q_t.shape[0]}, {V_t}] x [{w_t.shape[0]}, {V_t}], top_s {cand.shape[1]}, "
                  f"{n_pairs} candidate (query, tool) pairs, {uniq} distinct tools"))
        # fused_select on the mega tail's own operands: each input tensor
        # read once (sel, val when it is another tensor, the per-query rows,
        # the live weights) plus 16 bytes out per query; operations: k
        # selection rounds over the row and the finale
        sa, sk = mega_a, mega_k
        ins = {x.data_ptr(): x for x in (*sa, *sk.values()) if isinstance(x, torch.Tensor)}
        n_qs, n_ts = sa[0].shape
        b_sel = bound(sum(x.numel() * x.element_size() for x in ins.values()) + 16 * n_qs,
                      n_qs * (sk["k"] * n_ts + 12 * sk["k"]))
        rows.append(dict(
            name="fused_select", ms=timed(lambda: ops.fused_select(*sa, **sk)),
            plain_ms=timed(lambda: kref.fused_select_ref(*sa, **sk)), library_ms=None,
            bound=b_sel, shape=f"[{n_qs}, {n_ts}] mega tail (sonar_adapt: per-query rows, "
                               f"dead, rtt, live weights), k {sk['k']}"))
        # ... and at its widest shape, the full tool axis with k 128, where
        # every round reads the whole row from global memory (L2)
        wa, wk = cases["full axis: per-query rows, rerank, affinity, live weights, k 128"]
        wide_sel = dict(ms=timed(lambda: ops.fused_select(*wa, **wk)),
                        plain_ms=timed(lambda: kref.fused_select_ref(*wa, **wk),
                                       n=max(3, reps // 5)))
        # the attention kernels at the serving shapes, bf16: flash prefill
        # [1, 16, S_att, 128] against 8 kv heads, causal (operations: 4 Hq
        # S^2 D / 2 at the bf16 tensor-core peak; bytes: q, k, v read and the
        # output written once); flash decode of 8 slots against full
        # [8, 8, S_att, 128] caches (bytes: every K and V row read once)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        bf = torch.bfloat16
        qf, kf, vf = attn_rand((1, 16, S_att, 128), bf), attn_rand((1, 8, S_att, 128), bf), \
            attn_rand((1, 8, S_att, 128), bf)
        rows.append(dict(
            name="flash_attention", ms=timed(lambda: ops.flash_attention(qf, kf, vf)),
            plain_ms=timed(lambda: kref.mha_ref(qf, kf, vf, sm_scale=1 / math.sqrt(128))),
            library_ms=timed(lambda: sdpa(qf, kf, vf, is_causal=True, enable_gqa=True)),
            bound=bound(2 * (2 * qf.numel() + kf.numel() + vf.numel()),
                        4 * 16 * S_att * S_att * 128 / 2, BF16_OPS_PER_S),
            shape=f"[1, 16, {S_att}, 128] x 8 kv heads, causal, bf16"))
        qd, kd, vd = attn_rand((8, 16, 128), bf), attn_rand((8, S_att, 8, 128), bf), attn_rand((8, S_att, 8, 128), bf)
        full = torch.full((8,), S_att, dtype=torch.int32, device=dev)
        kt, vt = kd.transpose(1, 2), vd.transpose(1, 2)
        rows.append(dict(
            name="decode_attention",
            ms=timed(lambda: ops.decode_attention(qd, kt, vt, full)),
            plain_ms=timed(lambda: kref.decode_ref(qd.reshape(8, 8, 2, 128), kt, vt,
                                                   full.reshape(8, 1), sm_scale=1 / math.sqrt(128))),
            library_ms=timed(lambda: sdpa(qd[:, :, None], kt, vt, enable_gqa=True)),
            bound=bound(2 * (2 * kd.numel() + 2 * qd.numel()), 4 * 8 * 16 * S_att * 128,
                        BF16_OPS_PER_S),
            shape=f"8 slots x 16 heads against [8, {S_att}, 8, 128] caches, bf16"))
        # the attention kernels at phase 3h's and 3i's head layouts, bf16:
        # G = 1 (deepseek-moe-16b: 16 / 16 heads; flash at S_att, decode of 8
        # slots of cap S_att), G = 5 (llama4-scout: 40 / 8 heads; flash at
        # S_att, decode of 4 slots of cap S_att / 2) and G = 8 (Jamba: 64 / 8
        # heads; flash at S_att / 2, decode of 4 slots of cap 5 S_att / 8),
        # each as a CUDA-event window and, on the card, as device time alone,
        # beside the plain version, SDPA and the bound
        for hq, hkv, S_f, nb, cap_ in ((16, 16, S_att, 8, S_att), (40, 8, S_att, 4, S_att // 2),
                                       (64, 8, S_att // 2, 4, S_att * 5 // 8)):
            qg, kg, vg = attn_rand((1, hq, S_f, 128), bf), attn_rand((1, hkv, S_f, 128), bf), \
                attn_rand((1, hkv, S_f, 128), bf)
            qn, kn, vn = attn_rand((nb, hq, 128), bf), attn_rand((nb, cap_, hkv, 128), bf), \
                attn_rand((nb, cap_, hkv, 128), bf)
            kn_t, vn_t = kn.transpose(1, 2), vn.transpose(1, 2)
            lens_n = torch.full((nb,), cap_, dtype=torch.int32, device=dev)
            cases = (
                (f"flash_attention [1, {hq}, {S_f}, 128] x {hkv} kv heads, causal",
                 lambda: ops.flash_attention(qg, kg, vg),
                 lambda: kref.mha_ref(qg, kg, vg, sm_scale=1 / math.sqrt(128)),
                 lambda: sdpa(qg, kg, vg, is_causal=True, enable_gqa=True),
                 bound(2 * (2 * qg.numel() + kg.numel() + vg.numel()),
                       4 * hq * S_f * S_f * 128 / 2, BF16_OPS_PER_S)),
                (f"decode_attention {nb} slots x {hq} heads against [{nb}, {cap_}, {hkv}, 128] "
                 "caches", lambda: ops.decode_attention(qn, kn_t, vn_t, lens_n),
                 lambda: kref.decode_ref(qn.reshape(nb, hkv, hq // hkv, 128), kn_t, vn_t,
                                         lens_n.reshape(nb, 1), sm_scale=1 / math.sqrt(128)),
                 lambda: sdpa(qn[:, :, None], kn_t, vn_t, enable_gqa=True),
                 bound(2 * (2 * kn.numel() + 2 * qn.numel()), 4 * nb * hq * cap_ * 128,
                       BF16_OPS_PER_S)),
            )
            for what, kern, plain, lib, bnd in cases:
                alone = lib_alone = "not measured"
                if dev.type == "cuda":
                    _, per = device_us(kern, 20)
                    _, per_lib = device_us(lib, 20)
                    alone = f"{sum(per.values()) / 1e3:.4f} ms" if per else alone
                    lib_alone = f"{sum(per_lib.values()) / 1e3:.4f} ms" if per_lib else lib_alone
                log(f"phase 4: {what}, bf16 (G = {hq // hkv}): kernel {timed(kern):.4f} ms window, "
                    f"{alone} alone; plain {timed(plain):.4f} ms; SDPA {timed(lib):.4f} ms "
                    f"window, {lib_alone} alone; bound {bnd[0]:.5f} ms by {bnd[1]} [{smi_tag}]")
        # the kernels' own device time per call (the split and merge
        # kernels of decode together), apart from the wrapper's host work
        # that the CUDA-event window includes when the host is the slower
        # side; the same for the library call beside each, where there is one
        if dev.type == "cuda":
            by_name = {r["name"]: r for r in rows}
            calls = [     # (name, shape, window ms, the kernel's call, the library call or None)
                ("bm25_scores", by_name["bm25_scores"]["shape"], by_name["bm25_scores"]["ms"],
                 lambda: ops.bm25_scores(q_s, w_st), lambda: torch.matmul(q_s, w_st)),
                ("qos_scores", by_name["qos_scores"]["shape"], by_name["qos_scores"]["ms"],
                 lambda: ops.qos_scores(lat_t), None),
                ("qos_scores", f"per-query [{flat.shape[0]}, {T}]", perq["ms"],
                 lambda: ops.qos_scores(flat), None),
                ("fused_score_select", by_name["fused_score_select"]["shape"],
                 by_name["fused_score_select"]["ms"], fused_call, None),
                ("fused_select", by_name["fused_select"]["shape"], by_name["fused_select"]["ms"],
                 lambda: ops.fused_select(*sa, **sk), None),
                ("fused_select", f"full axis {list(wa[0].shape)} k {wk['k']}", wide_sel["ms"],
                 lambda: ops.fused_select(*wa, **wk), None),
                ("flash_attention", by_name["flash_attention"]["shape"],
                 by_name["flash_attention"]["ms"], lambda: ops.flash_attention(qf, kf, vf),
                 lambda: sdpa(qf, kf, vf, is_causal=True, enable_gqa=True)),
                ("decode_attention", by_name["decode_attention"]["shape"],
                 by_name["decode_attention"]["ms"], lambda: ops.decode_attention(qd, kt, vt, full),
                 lambda: sdpa(qd[:, :, None], kt, vt, enable_gqa=True)),
            ]

            def per_call(d):
                return f"{sum(d.values()) / 1e3:.4f} ms" if d else "not measured"

            for name, shape, window, kernel_fn, lib_fn in calls:
                _, per = device_us(kernel_fn, 20)
                lib = ""
                if lib_fn is not None:
                    _, per_lib = device_us(lib_fn, 20)
                    lib = (f"; library device time per call {per_call(per_lib)} against its "
                           f"window {by_name[name]['library_ms']:.4f} ms")
                log(f"phase 4: {name} {shape}: device time per call {per_call(per)} "
                    "(profile of 20 calls: " + "; ".join(f"{k[:40]} {v:.1f} us"
                                                          for k, v in per.items())
                    + f") against the CUDA-event window {window:.4f} ms" + lib)
            one = torch.zeros(1, device=dev)
            _, per_empty = device_us(one.zero_, 20)
            log(f"phase 4: an empty launch (a one-element fill): device time per call "
                f"{per_call(per_empty)} (profile of 20 calls)")
            # what one PyTorch reduction takes to read the per-query window:
            # the practical floor of a kernel that reads it once
            _, per_read = device_us(flat.sum, 20)
            log(f"phase 4: torch.sum over the per-query window {list(flat.shape)}: device time "
                f"per call {per_call(per_read)} (profile of 20 calls: "
                + "; ".join(f"{k[:40]} {v:.1f} us" for k, v in per_read.items()) + ")")
            lib = _build.build_dir() / "libflash_attention.so"
            sass = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
                                   str(lib)], capture_output=True, text=True, check=True,
                                  timeout=300).stdout
            hgmma = sum("HGMMA" in line for line in sass.splitlines())
            log(f"phase 4: {lib.name}: {hgmma} HGMMA instructions in its SASS (cuobjdump -sass)")
            if hgmma == 0:
                fail("the flash-attention library has no HGMMA instruction: the bf16 body "
                     "does not run on the tensor cores")
    per_route = {n: launches[n] / max(routes[n], 1) for n in routes}
    per_route["fused_select"] = mlaunches["fused_select"] / max(mroutes["fused_select"], 1)
    per_route["flash_attention"] = slaunches["flash_attention"] / max(sv["admitted"], 1)
    per_route["decode_attention"] = slaunches["decode_attention"] / max(sv["steps"], 1)
    for r in rows:
        log(f"phase 4: {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library "
            f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
            f"bound {r['bound'][0]:.5f} ms by {r['bound'][1]}, "
            f"launches per route call (per request, per decode step for attention) "
            f"{per_route[r['name']]:.2f}")
    log(f"phase 4: bm25_scores dense-product bound {rows[0]['dense_bound_ms']:.5f} ms")
    log(f"phase 4: qos_scores per-query [{flat.shape[0]}, {T}]: kernel {perq['ms']:.4f} ms, "
        f"plain {perq['plain_ms']:.4f} ms, bound {perq['bound'][0]:.5f} ms by {perq['bound'][1]}")
    log(f"phase 4: fused_select full axis {list(wa[0].shape)} k {wk['k']} (per-query rows, "
        f"live weights, affinity): kernel {wide_sel['ms']:.4f} ms, plain "
        f"{wide_sel['plain_ms']:.4f} ms")

    e2e = {}
    for algo in ("sonar", "sonar_ft"):
        for label, eng in (("kernels", engines[algo][0]), ("plain", engines[algo][1])):
            times = []
            for _ in range(5 if not rehearse else 2):
                sync()
                t = time.perf_counter()
                eng.route_texts(batches[0], lat, **extras(algo, 0))
                sync()
                times.append((time.perf_counter() - t) * 1e3)
            e2e[algo, label] = statistics.median(times)
            log(f"phase 4: route_texts {algo} [{label}] {n_q} queries, shared window: "
                f"median {e2e[algo, label]:.3f} ms per batch (host clock, {len(times)} runs)")
    for algo in ("sonar", "sonar_ft"):
        for label, eng in zip(("kernels", "plain"), mengines[algo]):
            times = []
            for _ in range(5 if not rehearse else 2):
                sync()
                t = time.perf_counter()
                eng.route_texts(batches[0], **mextras(algo))
                sync()
                times.append((time.perf_counter() - t) * 1e3)
            log(f"phase 4: sharded route_texts {algo} [{label}] {n_q} queries, {n_mega} "
                f"servers, 4 shards: median {statistics.median(times):.3f} ms per batch "
                f"(host clock, {len(times)} runs)")

    def profile(what, fn, kernels=(), calls=3):
        """Wall ms, device busy ms and the top device entries of one call
        (mean of ``calls``, after a warm-up), and the entries whose names
        hold one of ``kernels``.  With ``calls=1`` a profile missing some
        records cannot be told from a whole one."""
        wall, dev_us = device_us(fn, calls)
        if not dev_us:
            log(f"phase 4: profile of {what}: not measured (wall {wall:.3f} ms; the tracer's "
                f"records per entry in its last attempt: {device_us.refused})")
            return wall, None
        busy = sum(dev_us.values()) / 1e3
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        named = [(k, v) for k, v in dev_us.items() if any(s in k for s in kernels)]
        log(f"phase 4: profile of {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f} %), top kernels (us): "
            + "; ".join(f"{k[:48]} {v:.1f}" for k, v in top)
            + ("; the repo's kernels (us): " + "; ".join(f"{k[:48]} {v:.1f}" for k, v in named)
               if named else ""))
        return wall, busy

    if dev.type == "cuda":
        eng = engines["sonar"][0]
        enc0 = eng.encode(batches[0])
        routing = ("bm25_sparse", "qos_", "score_fuse", "select_")
        profile(f"route (sonar, encoded, {n_q} queries)", lambda: eng.route(enc0, lat), routing)
        meng = mengines["sonar_ft"][0]
        menc = meng.encode(batches[0])
        mkw = mextras("sonar_ft")
        torch.cuda.reset_peak_memory_stats()
        meng.route(menc, **mkw)
        sync()
        log(f"phase 4: peak device memory of one sharded route (sonar_ft, {n_mega} servers): "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        profile(f"sharded route (sonar_ft, encoded, {n_q} queries, {n_mega} servers, "
                f"4 shards)", lambda: meng.route(menc, **mkw), routing)
        # the select kernel's own device time, apart from its wrapper's
        # host-side dispatch that the CUDA-event window above includes
        profile(f"fused_select call {list(sa[0].shape)} k {sk['k']}",
                lambda: ops.fused_select(*sa, **sk))

    # the paper harness and the gateway on the card: one BatchAgent turn at
    # the fleet's size (per-query windows gathered on the host, copied to
    # the card, routed) and one pump flush, with the host's share of each
    def host_ms(fn, n):
        """Median host-clock ms of ``n`` calls, each ended by a synchronise."""
        out = []
        for _ in range(n):
            sync()
            t = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)

    n4 = 5 if not rehearse else 2
    plat4 = NetMCPPlatform(servers, scenario="hybrid", seed=1, device=dev)
    eng4 = engines["sonar"][0]
    batch4 = eng4.encode([q.text for q in fq])
    t_vec = agentlib.spread_start_ticks(n_q, plat4.n_steps, 8, 1, 0, 32, 0)
    w4 = plat4.latency_windows(t_vec)
    win_ms = host_ms(lambda: plat4.latency_windows(t_vec), n4)
    copy_ms = host_ms(lambda: torch.as_tensor(w4).to(dev), n4)
    route_ms = host_ms(lambda: eng4.route(batch4, w4), n4)
    turn_ms = host_ms(lambda: eng4.route(batch4, plat4.latency_windows(t_vec)), n4)
    log(f"phase 4: BatchAgent turn (sonar, {n_q} tasks, per-query windows [{n_q}, {n_s}, 64] "
        f"f32, {w4.nbytes / 1e6:.0f} MB): latency_windows + route {turn_ms:.3f} ms wall "
        f"(median of {n4}, host clock); latency_windows alone {win_ms:.3f} ms "
        f"({100 * win_ms / turn_ms:.1f} % of the turn, host), its copy to {dev} "
        f"{copy_ms:.3f} ms, route of the built windows {route_ms:.3f} ms [{smi_tag}]")
    if dev.type == "cuda":
        profile(f"BatchAgent turn (sonar, {n_q} tasks, latency_windows + route, per-query "
                f"[{n_q}, {n_s}, 64]) [{smi_tag}]",
                lambda: eng4.route(batch4, plat4.latency_windows(t_vec)), routing)
    del plat4, w4
    # the same turn under phase 3f's chaos schedule: SONAR-FT with the
    # per-query telemetry ages (a first turn: no failed mask yet)
    plat_c = NetMCPPlatform(servers, scenario="hybrid", seed=1, chaos=chaos, device=dev)
    eng_c = engines["sonar_ft"][0]
    batch_c = eng_c.encode([q.text for q in fq])

    def chaos_turn():
        return eng_c.route(batch_c, plat_c.latency_windows(ticks_3f),
                           telemetry_age_s=plat_c.telemetry_ages_s(ticks_3f))

    ages_ms = host_ms(lambda: plat_c.telemetry_ages_s(ticks_3f), n4)
    chaos_ms = host_ms(chaos_turn, n4)
    log(f"phase 4: BatchAgent turn under chaos (sonar_ft, {n_q} tasks, latency_windows + "
        f"telemetry_ages_s + route): {chaos_ms:.3f} ms wall (median of {n4}, host clock), of "
        f"which telemetry_ages_s {ages_ms:.3f} ms (host) [{smi_tag}]")
    if dev.type == "cuda":
        profile(f"BatchAgent turn under chaos (sonar_ft, {n_q} tasks, per-query "
                f"[{n_q}, {n_s}, 64] and ages [{n_q}, {n_s}]) [{smi_tag}]", chaos_turn, routing)
    del plat_c
    texts32 = [GATEWAY_TEXTS[i % len(GATEWAY_TEXTS)] for i in range(32)]
    for algo, shards in (("sonar_lb", None), ("sonar", 4)):
        gw4, _ = gateway(algo, shards, True)
        pump4 = MicroBatchPump(gw4, policy)    # the service time measured per flush
        rep4 = pump4.replay(sched)
        busy = sorted(b for _, b in pump4.flush_times)
        ph = np.mean([[d for _, d in f] for f in pump4.flush_phases], axis=0)
        log(f"phase 4: pump replay (gateway {algo} shards={shards}, flush time measured): "
            f"{rep4.n_routed} routed in {rep4.n_flushes} flushes, mean batch "
            f"{rep4.mean_batch:.2f}; flush wall median {statistics.median(busy):.3f} ms, max "
            f"{busy[-1]:.3f} ms (host clock), mean encode / dispatch / merge {ph[0]:.3f} / "
            f"{ph[1]:.3f} / {ph[2]:.3f} ms; on the virtual clock {rep4.sustained_qps:.1f} "
            f"req/s, serve p50 {rep4.p50_ms:.3f} ms, p99 {rep4.p99_ms:.3f} ms [{smi_tag}]")
        flush_ms = host_ms(lambda: gw4.route_batch(texts32, pad_to=32), n4)
        ph = dict(gw4.last_flush_phases)
        log(f"phase 4: one flush of 32 requests (gateway {algo} shards={shards}): "
            f"{flush_ms:.3f} ms wall (median of {n4}, host clock); last one's encode / dispatch "
            f"/ merge {ph['encode']:.3f} / {ph['dispatch']:.3f} / {ph['merge']:.3f} ms "
            f"[{smi_tag}]")
        if dev.type == "cuda":
            # one flush a profile: profiles of three flushes never held a
            # whole multiple of three records per entry (PERF.md §7)
            profile(f"one pump flush of 32 requests (gateway {algo} shards={shards}) "
                    f"[{smi_tag}]", lambda: gw4.route_batch(texts32, pad_to=32), routing,
                    calls=1)

    # one flush of the online launcher's gateway at 10,005 replicas (phase
    # 3g (b)): 16 requests padded to max_batch, SONAR-LB in chunks of 8 on
    # the device ring, the device route stats on
    q16 = launch_serve.QUERIES * 4
    oflush_ms = host_ms(lambda: gw_online.route_batch(q16, pad_to=16), n4)
    ph = dict(gw_online.last_flush_phases)
    log(f"phase 4: one online-launcher flush of 16 requests (sonar_lb, {n_s} replicas, device "
        f"ring, device route stats): {oflush_ms:.3f} ms wall (median of {n4}, host clock); "
        f"last one's encode / dispatch / merge {ph['encode']:.3f} / {ph['dispatch']:.3f} / "
        f"{ph['merge']:.3f} ms [{smi_tag}]")
    if dev.type == "cuda":
        profile(f"one online-launcher flush of 16 requests ({n_s} replicas) [{smi_tag}]",
                lambda: gw_online.route_batch(q16, pad_to=16), routing, calls=1)
    del gw_online

    # device time by part of a model call: the attention kernels (by kernel
    # name), aten::bmm (the expert products, and the SSD's and mLSTM's chunk
    # products), and the port's profiler labels (each the device time of the
    # kernels launched under it): the expert products, the Mamba, mLSTM and
    # sLSTM mixers, and the SSD chunk loop within the Mamba mixer.  The raw
    # tracer records are read directly: building the profiler's event tree
    # takes ~17 s per 250,000 host records (an xLSTM prefill's sLSTM token
    # loop), this pass about a tenth of that.
    LABELS = ("netmcp.experts", "netmcp.mamba", "netmcp.ssd_chunks", "netmcp.mlstm",
              "netmcp.slstm")

    def breakdown(what, fn, calls=2):
        """Wall, device busy and the parts' device ms per call of ``fn``
        from a profile (taken again, up to three times, when the tracer
        returns no device activity); returns (wall, busy or None, parts).
        A device record is attributed to the host op it is linked to (its
        ``linked_correlation_id``), and to a label when that op started
        inside the label's host range."""
        import bisect

        fn()
        sync()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for _ in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                t = time.perf_counter()
                for _ in range(calls):
                    fn()
                sync()
                wall = (time.perf_counter() - t) * 1e3 / calls
            ops_, ranges, device = {}, {k: [] for k in LABELS}, []
            for e in prof.profiler.kineto_results.events():
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    if not e.is_user_annotation() and not e.name().startswith("netmcp."):
                        device.append((e.name(), e.duration_ns(), e.linked_correlation_id()))
                elif e.linked_correlation_id() == 0:           # a host op or label
                    ops_[e.correlation_id()] = (e.name(), e.start_ns())
                    if e.name() in ranges:
                        ranges[e.name()].append((e.start_ns(), e.end_ns()))
            for r in ranges.values():
                r.sort()
            starts = {k: [a for a, _ in r] for k, r in ranges.items()}
            busy = 0.0
            parts = dict.fromkeys(("attention kernels", "aten::bmm") + LABELS, 0.0)
            for name, dur, link in device:
                busy += dur
                if any(k in name for k in ("flash_", "decode_split", "decode_merge")):
                    parts["attention kernels"] += dur
                op = ops_.get(link)
                if op is None:
                    continue
                if op[0] == "aten::bmm":
                    parts["aten::bmm"] += dur
                for k, r in ranges.items():
                    i = bisect.bisect_right(starts[k], op[1]) - 1
                    if i >= 0 and op[1] <= r[i][1]:
                        parts[k] += dur
            if busy:
                break
        if not busy:
            log(f"phase 4: profile of {what}: not measured (wall {wall:.3f} ms; no device "
                "activity traced)")
            return wall, None, {}
        busy = busy / calls / 1e6
        parts = {k: v / calls / 1e6 for k, v in parts.items() if v}
        log(f"phase 4: profile of {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f} %); " + ", ".join(
                f"{k} {v:.3f} ms ({100 * v / busy:.1f} % of busy)" for k, v in parts.items())
            + f" [{smi_tag}]")
        return wall, busy, parts

    # the serving path's two calls at internlm2-1.8b's full width: one
    # prefill of 1536 tokens, one decode step of 8 slots at cache_len 1536
    # (the weights drawn again from the same seed)
    lm_params = lm.init_params(seed=0, device=dev)
    t1536 = torch.as_tensor(np.random.default_rng(8).integers(0, lm_cfg.vocab_size, (1, 1536)),
                            device=dev)
    cache8 = lm.init_cache(8, 2048, device=dev)
    tok8 = torch.as_tensor(np.arange(8)[:, None], device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        pre_wall, pre_busy, _ = breakdown("prefill of 1536 tokens (internlm2-1.8b, bf16)",
                                          lambda: lm.prefill(lm_params, {"tokens": t1536}))
        dec_wall, dec_busy, _ = breakdown(
            "decode step of 8 slots at cache_len 1536 (internlm2-1.8b)",
            lambda: lm.decode_step(lm_params, cache8, tok8, 1536))
        def ms(x):
            return "not measured" if x is None else f"{x:.3f} ms"

        log(f"phase 4: serving: prefill 1536 tokens {pre_wall:.3f} ms wall "
            f"({ms(pre_busy)} device); decode step of 8 slots {dec_wall:.3f} ms wall "
            f"({ms(dec_busy)} device, {8e3 / dec_wall:.1f} tokens/s at 8 slots); peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # phase 3h (a)'s model at its two calls: one prefill of 1536 tokens, one
    # decode step of 8 slots at cache_len 1536 (the weights drawn again from
    # the same seed); the device time of the attention kernels and of the
    # expert products (aten::bmm: on the kernel path the MoE layers' only
    # batched products) within each, and the decode step against its byte
    # bound (every weight read once but the embedding's 8 rows, since at C =
    # 8 every expert runs its slots; the caches' 1537 rows of 8 slots; the
    # logits written)
    del lm_params, cache8
    ds_cfg, ds_params = draw_model("deepseek-moe-16b", "4")
    ds = get_model(ds_cfg)
    t1536 = torch.as_tensor(np.random.default_rng(8).integers(0, ds_cfg.vocab_size, (1, 1536)),
                            device=dev)
    cache8 = ds.init_cache(8, 2048, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        breakdown(f"prefill of 1536 tokens ({ds_cfg.name}, bf16)",
                  lambda: ds.prefill(ds_params, {"tokens": t1536}))
        dwall, dbusy, _ = breakdown(
            f"decode step of 8 slots at cache_len 1536 ({ds_cfg.name})",
            lambda: ds.decode_step(ds_params, cache8, tok8, 1536))
        isz = ds_cfg.torch_dtype.itemsize
        w_bytes = sum(t.numel() for t in _leaves(ds_params)) * isz \
            - (ds_cfg.padded_vocab - 8) * ds_cfg.d_model * isz
        kv_bytes = ds_cfg.n_layers * 2 * 8 * 1537 * ds_cfg.n_kv_heads \
            * ds_cfg.resolved_head_dim * isz
        dbound = (w_bytes + kv_bytes + 8 * ds_cfg.padded_vocab * 4) / HBM_BYTES_PER_S * 1e3
        log(f"phase 4: {ds_cfg.name} decode step of 8 slots: byte bound {dbound:.3f} ms "
            f"({w_bytes / 1e9:.2f} GB of weights, {kv_bytes / 1e9:.2f} GB of cache at 3.35 TB/s) "
            f"against {'not measured' if dbusy is None else f'{dbusy:.3f} ms'} device, "
            f"{dwall:.3f} ms wall; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{smi_tag}]")
    del ds_params, cache8

    # phase 3i's models at their calls (the weights drawn again from the same
    # seed): Jamba (8 layers, 8 experts) one prefill of 1024 tokens and one
    # decode step of 4 slots at cache_len 1024; xlstm-125m one prefill of 512
    # tokens and one decode step of 8 slots.  Each decode step against its
    # byte bound: every weight read once but the embedding's rows of the
    # step's tokens (at C = 8 every expert runs its slots), each state read
    # and written once, the attention cache's rows read, the logits written.
    def decode_bound(cfg_, params_, cache_, n_slots, kv_rows):
        isz = cfg_.torch_dtype.itemsize
        w = sum(t.numel() * t.element_size() for t in _leaves(params_)) \
            - (cfg_.padded_vocab - n_slots) * cfg_.d_model * isz
        kv = cfg_.layer_kinds().count("attn") * 2 * n_slots * kv_rows * cfg_.n_kv_heads \
            * cfg_.resolved_head_dim * isz
        st = 2 * sum(t.numel() * t.element_size() for name, g in cache_["groups"].items()
                     if isinstance(g, dict) for t in g.values())
        return (w + kv + st + n_slots * cfg_.padded_vocab * 4) / HBM_BYTES_PER_S * 1e3, w, kv, st

    for arch, tag_, cut_, n_pre, n_sl, pos in (
            ("jamba-1.5-large-398b", "Jamba", dict(n_layers=8, n_experts=8), 1024, 4, 1024),
            ("xlstm-125m", "xLSTM", {}, 512, 8, 512)):
        p_cfg, p_params = draw_model(arch, "4", **cut_)
        pm = get_model(p_cfg)
        t_pre = torch.as_tensor(np.random.default_rng(8).integers(0, p_cfg.vocab_size,
                                                                  (1, n_pre)), device=dev)
        p_cache = pm.init_cache(n_sl, 1280, device=dev)
        tok_n = torch.as_tensor(np.arange(n_sl)[:, None], device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            # one call: xLSTM's prefill is ~50,000 launches (sLSTM's token loop)
            breakdown(f"prefill of {n_pre} tokens ({p_cfg.name}, {p_cfg.n_layers} layers, bf16)",
                      lambda: pm.prefill(p_params, {"tokens": t_pre}), calls=1)
            dwall, dbusy, _ = breakdown(
                f"decode step of {n_sl} slots at cache_len {pos} ({p_cfg.name})",
                lambda: pm.decode_step(p_params, p_cache, tok_n, pos))
            dbound, w_b, kv_b, st_b = decode_bound(p_cfg, p_params, p_cache, n_sl, pos + 1)
            log(f"phase 4: {tag_} ({p_cfg.name}) decode step of {n_sl} slots: byte bound "
                f"{dbound:.3f} ms ({w_b / 1e9:.3f} GB of weights, {kv_b / 1e9:.4f} GB of "
                f"attention cache, {st_b / 1e9:.4f} GB of recurrent state read and written, at "
                f"3.35 TB/s) against "
                f"{'not measured' if dbusy is None else f'{dbusy:.3f} ms'} device, {dwall:.3f} "
                f"ms wall; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
                f"GiB [{smi_tag}]")
        del p_params, p_cache
        free_card()

    kernels = [
        dict(name=r["name"], route="cuda", source=SOURCES[r["name"]],
             replaces=REPLACES[r["name"]],
             launches=(mlaunches if r["name"] == "fused_select" else
                       slaunches if r["name"] in ("flash_attention", "decode_attention")
                       else launches)[r["name"]],
             max_abs_err=max_err[r["name"]], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound"][0], bound_by=r["bound"][1], library_ms=r["library_ms"])
        for r in rows
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if rehearse:
        log("rehearsal on the CPU finished: no kernel ran, no result")
        sys.exit(3)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main(rehearse="--rehearse" in sys.argv[1:])
