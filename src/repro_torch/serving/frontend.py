"""Asyncio serving front-end, twin of `repro.serving.frontend`: the
micro-batch policy on the wall clock.

`MicroBatchPump` replays a schedule in virtual time for reproducible
benchmarks; this module is the *live* counterpart — an event-loop
gateway where callers `submit` requests as they arrive and await a
future per request.  Both share the same `MicroBatcher` state machine,
so the batching policy (size / age / deadline triggers, bounded queue
with load-shedding) has exactly one implementation.

Concurrency model: one pump coroutine owns the batcher and the
`SonarGateway`.  Each flush's blocking `route_batch` call runs
synchronously inside the flush, on the event loop's thread: the CUDA
work of a flush is short and ends in the sync that brings its decisions
back, and keeping it on one thread keeps every call into the gateway and
its device tensors on that thread.  Arrivals that land while a flush
runs wait for the loop and join the next micro-batch.  The gateway is
only ever touched by one flush at a time, so no locking is needed around
its feed-forward state.
"""
from __future__ import annotations

import asyncio
import time
from typing import Optional

from repro_torch.serving.microbatch import (
    BatchingPolicy,
    MicroBatcher,
    ServeResult,
    _emit_flush_trace,
)
from repro_torch.traffic.source import LiveRequest

__all__ = ["AsyncServingGateway"]


class AsyncServingGateway:
    """Event-loop gateway coalescing live submissions into micro-batches.

    Parameters
    ----------
    gateway : SonarGateway
        The batch routing back-end; must have ``use_kernels=True``.
    policy : BatchingPolicy, optional
        Flush triggers, queue bound, and padding knob.

    Examples
    --------
    ::

        srv = AsyncServingGateway(gw, BatchingPolicy(max_batch=8))
        await srv.start()
        res = await srv.submit("train the classifier", deadline_ms=50.0)
        await srv.close()          # drains in-flight + pending batches
    """

    def __init__(self, gateway, policy: BatchingPolicy = BatchingPolicy()):
        if not getattr(gateway, "use_kernels", False):
            raise ValueError("AsyncServingGateway requires use_kernels=True")
        self.gw = gateway
        self.policy = policy
        self.obs = gateway.obs
        self.batcher = MicroBatcher(policy, registry=self.obs.registry)
        self._m_flushes = self.obs.registry.counter(
            "serving_flushes_total", "flushes"
        )
        self._m_serve = self.obs.registry.histogram("serving_latency_ms", "ms")
        if self.obs.tracer.enabled:
            # wall-clock timeline: ms since this front-end started
            self.obs.tracer.clock_ms = self.now_ms
        self._futures: dict = {}          # rid -> asyncio.Future[ServeResult]
        self._next_rid = 0
        self._wake: Optional[asyncio.Event] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._closing = False
        self._drain = True
        self._t0 = time.monotonic()
        self.n_flushes = 0

    def now_ms(self) -> float:
        """Wall-clock ms since the gateway was constructed."""
        return 1000.0 * (time.monotonic() - self._t0)

    async def start(self) -> None:
        """Start the pump coroutine (idempotent)."""
        if self._pump_task is None:
            self._wake = asyncio.Event()
            self._pump_task = asyncio.ensure_future(self._pump())

    async def submit(self, text: str, *, deadline_ms: Optional[float] = None,
                     region: int = -1, session_id: Optional[int] = None):
        """Submit one request; awaits its `ServeResult`.

        ``deadline_ms`` is *relative* (budget from now); a request shed
        at admission (queue full) or expired in queue resolves
        immediately with ``shed``/``expired`` set instead of raising.
        """
        if self._pump_task is None:
            await self.start()
        if self._closing:
            raise RuntimeError("gateway is closing")
        now = self.now_ms()
        rid = self._next_rid
        self._next_rid += 1
        req = LiveRequest(
            rid=rid, text=text, t_ms=now,
            deadline_ms=None if deadline_ms is None else now + deadline_ms,
            region=region, session_id=session_id,
        )
        fut = asyncio.get_running_loop().create_future()
        if self.batcher.offer(req, now):
            self._futures[rid] = fut
            self._wake.set()
        else:
            self.obs.tracer.instant("shed", now, args={"rid": rid})
            fut.set_result(ServeResult(
                rid=rid, shed=True, t_arrival_ms=now,
                t_routed_ms=now, t_done_ms=now,
            ))
        return await fut

    async def close(self, drain: bool = True) -> None:
        """Stop the pump.  ``drain=True`` routes every pending request
        first (back-to-back flushes); ``drain=False`` sheds them — their
        futures resolve with ``shed=True``."""
        self._closing = True
        self._drain = drain
        if self._pump_task is not None:
            self._wake.set()
            await self._pump_task
            self._pump_task = None
        self.batcher.check_accounting()

    # -- pump ----------------------------------------------------------------
    async def _pump(self) -> None:
        while True:
            now = self.now_ms()
            trig = self.batcher.next_trigger_ms(now)
            if trig is None:
                if self._closing:
                    return
                await self._wait_wake(None)
                continue
            if self._closing and not self._drain:
                for req in self.batcher.drop_pending():
                    self._resolve_dropped(req, shed=True)
                return
            if not self._closing and trig > now:
                await self._wait_wake((trig - now) / 1000.0)
                continue
            self._flush()

    async def _wait_wake(self, timeout: Optional[float]) -> None:
        self._wake.clear()
        try:
            await asyncio.wait_for(self._wake.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    def _flush(self) -> None:
        now = self.now_ms()
        batch = self.batcher.take(now)
        for req in self.batcher.take_expired():
            self._resolve_dropped(req, shed=False, now=now)
        if not batch:
            return
        texts = [r.text for r in batch]
        regions = (
            [r.region for r in batch]
            if any(r.region >= 0 for r in batch) else None
        )
        sids = (
            [r.session_id for r in batch]
            if any(r.session_id is not None for r in batch) else None
        )
        pad = self.policy.max_batch if self.policy.pad_batches else None
        routed = self.gw.route_batch(
            texts, client_regions=regions, pad_to=pad, session_ids=sids
        )
        done = self.now_ms()
        # flush boundary: dispatch deferred device-stat updates outside
        # the per-request latency window
        self.obs.drain_route_stats()
        fidx = self.n_flushes
        self.n_flushes += 1
        self._m_flushes.inc()
        tracer = self.obs.tracer
        if tracer.enabled:
            _emit_flush_trace(
                tracer, fidx, batch, routed, now, done - now,
                list(self.gw.last_flush_phases),
            )
        for req, res in zip(batch, routed):
            self._m_serve.observe(done - req.t_ms)
            fut = self._futures.pop(req.rid, None)
            if fut is not None and not fut.done():
                fut.set_result(ServeResult(
                    rid=req.rid, replica_idx=res.replica_idx, ok=res.ok,
                    latency_ms=res.latency_ms, t_arrival_ms=req.t_ms,
                    t_routed_ms=now, t_done_ms=done, batch_size=len(batch),
                ))

    def _resolve_dropped(self, req, *, shed: bool,
                         now: Optional[float] = None) -> None:
        now = self.now_ms() if now is None else now
        self.obs.tracer.instant(
            "shed" if shed else "expired", now, args={"rid": req.rid}
        )
        fut = self._futures.pop(req.rid, None)
        if fut is not None and not fut.done():
            fut.set_result(ServeResult(
                rid=req.rid, shed=shed, expired=not shed,
                t_arrival_ms=req.t_ms, t_routed_ms=now, t_done_ms=now,
            ))
