"""Routing driver: one client routes batches of agent queries back to back.

Set-up builds the program's template-tiled fleet index
(`repro_torch.core.mesh_routing.TiledFleetIndex`, weights rounded once to
the configuration's dtype) and its sharded engine
(`ShardedRoutingEngine`, the configuration's algorithm and shards, on the
card), makes the traffic (`perfbench.traffic.fleet`) and routes the first
batch once to warm up.  The window calls ``route_texts`` on batch i with
the fleet state of window i (cycling over the mix's windows), closed
loop, for ``--seconds``; every decision comes back to the host.

After the window, batches sampled from the seed among those routed are
routed again by the plain reference (`perfbench.reference.routing`) and
compared decision by decision: the count of (server, tool) picks that
differ and the largest gap of the fused score S of the picks that agree.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import core
from perfbench.harness.trace import profiled
from perfbench.reference import routing as ref
from perfbench.traffic import fleet as traffic


def program_engine(ctx, pool: dict):
    """The program's index and engine for the configuration."""
    from repro_torch.core.dataset import Server, Tool
    from repro_torch.core.mesh_routing import ShardedRoutingEngine, TiledFleetIndex
    from repro_torch.core.qos import QosParams
    from repro_torch.core.routing import RoutingConfig

    fc, rc = ctx.config["fleet"], ctx.config["routing"]
    templates = [Server(s["name"], s["domain"], s["description"],
                        [Tool(t["name"], t["description"]) for t in s["tools"]])
                 for s in pool["templates"]]
    tmap = np.arange(fc["n_servers"]) % len(templates)
    dtype = ctx.spec["program"].get("weights_dtype", fc["weights_dtype"])
    index = TiledFleetIndex(templates, tmap, weights_dtype=dtype)
    cfg = RoutingConfig(
        top_s=rc["top_s"], top_k=rc["top_k"], alpha=rc["alpha"], beta=rc["beta"],
        gamma=rc["gamma"], load_knee=rc["load_knee"], load_sharp=rc["load_sharp"],
        stale_half_life_s=rc["stale_half_life_s"], expertise_temp=rc["expertise_temp"],
        qos=QosParams(**rc["qos"]))
    return ShardedRoutingEngine(cfg=cfg, algo=rc["algorithm"], n_shards=fc["n_shards"],
                                index=index, device=ctx.device)


def fleet_state(tr: traffic.FleetTraffic, w: int) -> dict:
    return dict(server_load=tr.load[w], telemetry_age_s=tr.age_s[w], failed_mask=tr.failed[w],
                telemetry_templates=(tr.telemetry[w], tr.tel_map))


def compare(got: list, want: dict, limits: dict) -> list:
    """``got``: (window, decisions) pairs; ``want``: window -> the
    reference's (server, tool, C, N, S)."""
    mismatched, gap = 0, 0.0
    for w, d in got:
        server, tool, _, _, s, _ = want[w]
        same = (d.server_idx == server) & (d.tool_idx == tool)
        mismatched += int((~same).sum())
        if same.any():
            gap = max(gap, float(np.abs(d.fused[same].astype(np.float64) - s[same]).max()))
    return [core.Check("mismatched_decisions", mismatched, limits["mismatched_decisions"]),
            core.Check("fused_gap", gap, limits["fused_gap"])]


def control(ctx, name: str) -> dict:
    """The numbers compared, read from the program with its own
    lower-precision path on: ``int8`` rounds the BM25 weights to int8
    (`repro_torch.core.quantize`) in place of the configuration's
    bfloat16."""
    if name != "int8":
        raise ValueError(f"unknown control {name!r}")
    ctx.spec["program"]["weights_dtype"] = name
    return {c.name: c.value for c in run(ctx).checks}


def run(ctx) -> core.Result:
    t = ctx.spec["mix"]
    pool = core.load_json(ctx.root / ctx.config["pool"])
    engine = program_engine(ctx, pool)
    tr = traffic.make(ctx.seed, t, ctx.config["fleet"], pool["tasks"])
    nw = t["n_windows"]
    engine.route_texts(tr.texts[0], **fleet_state(tr, 0))       # warm-up: the one shape
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)

    setup_s = ctx.setup_s()
    outs, enc_s, t_start = [], [], time.monotonic()
    while time.monotonic() - t_start < ctx.seconds:
        w = len(outs) % nw
        if ctx.trace:       # route_texts' own two calls, with a span around the encoding
            t0 = time.monotonic()
            enc = engine.encode(tr.texts[w])
            enc_s.append(time.monotonic() - t0)
            outs.append(engine.route(enc, **fleet_state(tr, w)))
        else:
            outs.append(engine.route_texts(tr.texts[w], **fleet_state(tr, w)))
    window_s = time.monotonic() - t_start
    routed = len(outs)

    trace, traced = None, int(t["traced_batches"])
    if ctx.trace:
        with profiled(ctx.device) as holder:
            for i in range(traced):
                w = (routed + i) % nw
                with record_function("perfbench.encode"):
                    enc = engine.encode(tr.texts[w])
                with record_function("perfbench.route"):
                    engine.route(enc, **fleet_state(tr, w))
        trace = holder.trace
    memory_peak = core.peak_bytes(ctx.device)
    del engine
    core.release(ctx.device)

    t_ref = time.monotonic()
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed, 11]))
    picks = sorted(rng.choice(routed, size=min(int(t["sample_batches"]), routed), replace=False))
    rc, fc = ctx.config["routing"], ctx.config["fleet"]
    fleet = ref.Fleet(pool, fc["n_servers"], getattr(torch, fc["weights_dtype"]), ctx.device)
    want = {}
    for i in picks:
        w = int(i) % nw
        if w not in want:
            want[w] = ref.route(fleet, tr.texts[w], tr.telemetry[w], tr.tel_map, tr.load[w],
                                tr.age_s[w], tr.failed[w], rc)
    checks = compare([(int(i) % nw, outs[i]) for i in picks], want, ctx.spec["limits"])
    n_dec = routed * t["batch"]
    return core.Result(
        e2e={"decisions_per_s": n_dec / window_s, "setup_s": setup_s},
        attempted=n_dec, failed=0, checks=checks, memory_peak_bytes=memory_peak,
        values={"window_s": window_s, "routes": routed},
        spans={"encode": enc_s}, trace=trace,
        trace_work={"routes": traced if ctx.trace else 0},
        notes=[f"{routed} batches routed; {len(picks)} sampled, {len(want)} distinct, "
               f"reference {time.monotonic() - t_ref:.1f} s; smallest margin of the "
               f"reference's best S over its runner-up {min(float(v[5].min()) for v in want.values()):.3g}"])
