"""Serving driver: SONAR gateway in front of a replica fleet, twin of
`repro.launch.serve`.

Each replica is a `ServeEngine` (continuous batching) hosting a dense GQA
decoder; the gateway routes requests with SONAR (capability BM25 x live
QoS from per-replica latency telemetry) and records feed-forward
latencies.  This is the paper's technique running as the admission layer
of a serving stack.

Two modes:

``--mode sync`` (default)
    The closed loop: requests routed one at a time through the scalar
    gateway, each executed on its replica's `ServeEngine` (on the card the
    flash-attention kernel in every prefill, the flash-decode kernel in
    every decode step when the config asks for ``attn_impl="pallas"``).

``--mode online``
    The online front end: requests arrive individually from a named
    arrival process, `AsyncServingGateway` coalesces them into
    deadline-aware micro-batches, and every flush runs the batched routing
    engine (on the card the BM25, QoS and fused stage-2 kernels) with the
    device route statistics on.

Observability: per-request lines go through structured logging (suppress
with ``--quiet``; the summary line always prints), ``--metrics-json PATH``
writes the `MetricsRegistry` snapshot (with the folded route stats),
``--trace PATH`` a Chrome trace of every request's lifecycle spans (in
``--mode online`` on `torch.profiler`'s axis, ms on the Unix epoch, so it
lines up in Perfetto with a `torch.profiler` export of the same run), and
``--dashboard`` repaints a live text panel while the online run
progresses.  ``--device`` picks where everything runs: the CUDA card by
default (it raises without one), ``cpu`` for the plain PyTorch versions of
the kernels.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --n-replicas 4 --n-requests 24 --scenario hybrid
  PYTHONPATH=src python -m repro_torch.launch.serve --mode online \\
      --algo sonar_lb --arrivals flash_crowd --rate 300 --horizon-s 1.0 \\
      --max-batch 16 --max-wait-ms 5 --deadline-ms 100 \\
      --trace serve-trace.json --metrics-json serve-metrics.json
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --quiet
"""
from __future__ import annotations

import argparse
import asyncio
import logging
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import latency as latlib
from repro_torch.models.api import get_model
from repro_torch.obs import LiveDashboard, Observability
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.frontend import AsyncServingGateway
from repro_torch.serving.gateway import SonarGateway, replica_pool
from repro_torch.serving.microbatch import BatchingPolicy
from repro_torch.traffic.source import request_schedule

log = logging.getLogger("repro_torch.serve")


def _setup_logging(quiet: bool) -> None:
    logging.basicConfig(
        level=logging.WARNING if quiet else logging.INFO,
        format="%(message)s",
    )


def _build_obs(args) -> Observability:
    """One bundle for the whole stack: tracing only when a trace path is
    requested (spans cost allocations), device route stats whenever the
    batched path runs (accumulated on the device, folded at exit)."""
    return Observability(trace=bool(args.trace), jit_stats=(args.mode == "online"))


def _device(args, device):
    return resolve_device(device if device is not None else getattr(args, "device", None))


def _emit_artifacts(args, obs: Observability, summary: dict) -> None:
    """Write the --trace / --metrics-json artifacts, if requested."""
    if args.trace:
        obs.tracer.write(args.trace)
        log.info("wrote trace: %s (%d events)", args.trace, len(obs.tracer.events))
    if args.metrics_json:
        extra = {"summary": summary}
        stats = obs.fold_route_stats()
        if stats is not None:
            extra["route_stats"] = {
                k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in stats.items()
            }
        obs.registry.to_json(args.metrics_json, extra=extra)
        log.info("wrote metrics: %s", args.metrics_json)


def scenario_profiles(name: str, n: int):
    if name == "ideal":
        return [latlib.ideal_profile() for _ in range(n)]
    if name == "hybrid":
        states = [
            latlib.outage_profile(probability=0.6),
            latlib.fluctuating_profile(),
            latlib.high_latency_profile(),
            latlib.high_jitter_profile(),
            latlib.ideal_profile(),
        ]
        return [states[i % len(states)] for i in range(n)]
    if name == "fluctuating":
        return [latlib.fluctuating_profile(phase=2 * np.pi * i / n) for i in range(n)]
    raise ValueError(name)


QUERIES = [
    "summarize the latest research news on reinforcement learning",
    "generate a short story about a lighthouse keeper",
    "answer a question about current stock markets",
    "chat about travel plans for next month",
]


def serve_online(args, obs=None, device=None, dashboard_stream=None):
    """Run the asyncio micro-batch front end over a live arrival stream.

    Requests from ``--arrivals`` at ``--rate`` rps are submitted to an
    `AsyncServingGateway` at their scheduled times (scaled by
    ``--time-scale``; >1 slows the replay down).  ``obs`` replaces the
    bundle `_build_obs` makes, ``device`` the ``--device`` flag, and
    ``dashboard_stream`` the dashboard's stdout.  Prints the summary and
    returns it with the per-request `ServeResult`s and the gateway.
    """
    dev = _device(args, device)
    obs = _build_obs(args) if obs is None else obs
    replicas = replica_pool([("yi-6b", "dense")] * args.n_replicas)
    profiles = scenario_profiles(args.scenario, args.n_replicas)
    gw = SonarGateway(
        replicas, profiles=profiles, algo=args.algo, seed=args.seed,
        use_kernels=True, device_telemetry=True, obs=obs, device=dev,
    )
    policy = BatchingPolicy(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        slack_ms=args.slack_ms, queue_limit=args.queue_limit,
        pad_batches=True,
    )
    gw.route_batch(QUERIES * args.max_batch, pad_to=args.max_batch)  # warm-up (kernel builds)
    obs.fold_route_stats(reset=True)   # drop the warm-up picks
    schedule = request_schedule(
        args.arrivals, torch.Generator(device=dev).manual_seed(args.seed), args.rate,
        args.horizon_s, QUERIES,
    )
    if args.n_requests > 0:
        schedule = schedule[: args.n_requests]

    dash = (
        LiveDashboard(obs.registry, route_stats_fn=obs.fold_route_stats,
                      stream=dashboard_stream, title=f"netmcp online ({args.algo})")
        if args.dashboard else None
    )

    async def run():
        srv = AsyncServingGateway(gw, policy)
        await srv.start()
        t0 = srv.now_ms()

        async def one(req):
            wait_s = (t0 + req.t_ms * args.time_scale - srv.now_ms()) / 1000.0
            if wait_s > 0:
                await asyncio.sleep(wait_s)
            res = await srv.submit(req.text, deadline_ms=args.deadline_ms)
            if dash is not None:
                dash.update()
            return res

        results = await asyncio.gather(*[one(r) for r in schedule])
        await srv.close(drain=True)
        return results, srv

    results, srv = asyncio.run(run())
    if dash is not None:
        dash.update(force=True)
    routed = [r for r in results if not r.shed and not r.expired]
    lat = np.asarray([r.serve_ms for r in routed], np.float64)
    summary = {
        "offered": len(results),
        "routed": len(routed),
        "shed": sum(r.shed for r in results),
        "expired": sum(r.expired for r in results),
        "flushes": srv.n_flushes,
        "p50_ms": round(float(np.percentile(lat, 50)), 2) if lat.size else 0.0,
        "p99_ms": round(float(np.percentile(lat, 99)), 2) if lat.size else 0.0,
    }
    for r in results[: min(len(results), 12)]:
        state = "shed" if r.shed else ("expired" if r.expired else "routed")
        log.info(
            "req %3d -> replica %2d [%s] wait=%6.1fms batch=%d",
            r.rid, r.replica_idx, state, r.wait_ms, r.batch_size,
        )
    # registry cross-check: the batcher/front-end counters are the same
    # events the result list tallies (one source of truth)
    reg = obs.registry
    summary["registry_routed"] = int(reg.value("serving_routed_total"))
    summary["gateway_p99_ms"] = round(reg.get("gateway_latency_ms").p99, 2)
    _emit_artifacts(args, obs, summary)
    print("online serving summary:", summary)
    return summary, list(results), gw


def serve_sync(args, cfg=None, obs=None, device=None) -> SonarGateway:
    """The closed loop of ``--mode sync``: ``--n-requests`` requests routed
    one at a time through the scalar gateway, each executed on its
    replica's `ServeEngine`.  ``cfg`` replaces ``--arch``'s reduced config,
    ``obs`` the bundle `_build_obs` makes, ``device`` the ``--device``
    flag.  Returns the gateway: its ``stats`` hold each request's
    `RouteResult`, its `report()` the summary."""
    dev = _device(args, device)
    cfg = configs.get_reduced(args.arch) if cfg is None else cfg
    model = get_model(cfg)
    params = model.init_params(seed=args.seed, device=dev)
    obs = _build_obs(args) if obs is None else obs

    # one engine per replica (same weights; independent network profiles)
    engines = [
        ServeEngine(model, params, n_slots=args.n_slots, cap=256, obs=obs, device=dev)
        for _ in range(args.n_replicas)
    ]
    replicas = replica_pool([(cfg.name, "dense")] * args.n_replicas)
    profiles = scenario_profiles(args.scenario, args.n_replicas)

    def executor(idx: int, request_text: str) -> float:
        """Execute on replica idx: network latency (simulated trace) plus
        real engine compute time for one request."""
        eng = engines[idx]
        rng = np.random.default_rng(hash(request_text) % 2**31)
        prompt = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
        req = Request(rid=0, tokens=prompt, max_new_tokens=args.max_new_tokens)
        eng.submit(req)
        t0 = time.monotonic()
        eng.run()
        compute_ms = (time.monotonic() - t0) * 1000.0
        net_ms = float(gateway.traces[idx, min(gateway.t, gateway.traces.shape[1] - 1)])
        return net_ms + 0.0 * compute_ms  # network latency dominates routing

    gateway = SonarGateway(
        replicas, profiles=profiles, seed=args.seed, executor=executor,
        obs=obs, device=dev,
    )

    for i in range(args.n_requests):
        res = gateway.route(QUERIES[i % len(QUERIES)])
        log.info(
            "req %3d -> replica %d lat=%7.1fms ok=%s C=%.2f N=%.2f",
            i, res.replica_idx, res.latency_ms, res.ok,
            res.expertise, res.network,
        )
    _emit_artifacts(args, obs, gateway.report())
    return gateway


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="internlm2-1.8b")
    ap.add_argument("--n-replicas", type=int, default=4)
    ap.add_argument("--n-requests", type=int, default=24)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--scenario", type=str, default="hybrid")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default; raises without a card) or cpu")
    # --mode online: the micro-batch front end
    ap.add_argument("--mode", choices=["sync", "online"], default="sync")
    ap.add_argument("--algo", type=str, default="sonar_lb")
    ap.add_argument("--arrivals", type=str, default="poisson",
                    help="poisson | diurnal | mmpp | flash_crowd")
    ap.add_argument("--rate", type=float, default=200.0, help="mean rps")
    ap.add_argument("--horizon-s", type=float, default=1.0)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="relative per-request deadline (default none)")
    ap.add_argument("--slack-ms", type=float, default=1.0)
    ap.add_argument("--queue-limit", type=int, default=256)
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="wall-clock seconds per virtual second (>1 = slower)")
    # observability
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-request lines (summary still prints)")
    ap.add_argument("--metrics-json", type=str, default=None,
                    help="write the metrics-registry snapshot to PATH")
    ap.add_argument("--trace", type=str, default=None,
                    help="write a Chrome trace (Perfetto-loadable) to PATH; in --mode "
                         "online on torch.profiler's clock, so it lines up with a "
                         "torch.profiler export of the same run")
    ap.add_argument("--dashboard", action="store_true",
                    help="live text dashboard during --mode online")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _setup_logging(args.quiet)
    if args.mode == "online":
        serve_online(args)
        return
    gateway = serve_sync(args)
    print("gateway report:", gateway.report())


if __name__ == "__main__":
    main()
