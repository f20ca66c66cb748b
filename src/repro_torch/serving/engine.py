"""Serving engine, twin of `repro.serving.engine`: prefill + decode with
slot-based continuous batching.

The engine owns a batched cache with ``n_slots`` sequences of ``cap``
tokens.  Requests are prefilled one at a time ([1, S]), padded to ``cap``
with zeros and written into a free slot whole, so a reused slot keeps
nothing of its previous request; all active slots then decode one token per
engine step, and finished requests free their slots.

A request of an encoder-decoder (whisper) brings its audio frames and a
VLM's request its patches as ``extras`` (``{"frames": [F, d]}`` or
``{"patches": [V, d]}``, numpy, cast to float32 here); they go into the
prefill batch as [1, ...] tensors on the engine's device.

Differences from the reference, by design:
  * the cache is updated in place (`insert_slot`, the decode step's K/V
    write) instead of being returned anew;
  * a prompt whose prefill positions (a VLM's V patches plus its tokens)
    reach ``cap`` is refused at `submit` (the reference would decode at a
    clamped position);
  * a VLM slot's length after admission is its prefill's positions, V +
    len(tokens); the reference counts the tokens only, so its decode writes
    and attends V positions too early (`ROADMAP.md` queue 3);
  * an encoder-decoder engine with ``cap`` above ``n_audio_frames`` is
    refused: the reference pads the cross-attention cache (also a
    'cache_seq' axis) to ``cap`` and then fails to insert it into the
    batched cache of ``n_audio_frames`` rows;
  * a missing, unexpected or misshapen extra raises `ValueError`;
  * the engine runs on ``device`` (None: the CUDA card) and refuses
    parameters that lie elsewhere.

As in the reference, every decode step runs at the *largest* active
length: a shorter slot writes its new K/V at that position and attends
over the zeros between its own length and it (`ROADMAP.md` queue 3).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.api import Model
from repro_torch.obs import Observability


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None))) for i in x)


def _map(fn, axes, *trees):
    """fn(names, *leaves) over trees shaped like the ``axes`` tree."""
    if _is_axes(axes):
        return fn(axes, *trees)
    if isinstance(axes, dict):
        return {k: _map(fn, a, *(t[k] for t in trees)) for k, a in axes.items()}
    return tuple(_map(fn, a, *(t[i] for t in trees)) for i, a in enumerate(axes))


def pad_cache_to_capacity(cache, axes, cap: int):
    """Pad every 'cache_seq' dim (prefill emits length-S caches) to ``cap``
    with zeros; a leaf already at capacity comes back as it is."""

    def one(names, leaf):
        if "cache_seq" not in names:
            return leaf
        d = names.index("cache_seq")
        pad = cap - leaf.shape[d]
        if pad <= 0:
            return leaf
        return F.pad(leaf, [0, 0] * (leaf.ndim - d - 1) + [0, pad])

    return _map(one, axes, cache)


def insert_slot(batched_cache, axes, single_cache, slot: int):
    """Write a single-sequence cache into slot ``slot`` of the batched cache,
    in place; returns the batched cache."""

    def one(names, big, small):
        b = names.index("cache_batch" if "cache_batch" in names else "batch")
        big.select(b, slot).copy_(small.select(b, 0))
        return big

    return _map(one, axes, batched_cache, single_cache)


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray             # prompt [S]
    max_new_tokens: int = 16
    extras: Optional[dict] = None  # frames [F, d] / patches [V, d] for audio / vlm
    # filled by the engine:
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_ms: Optional[float] = None   # on the tracer's clock, when it is on


class ServeEngine:
    """Slot-based continuous-batching execution engine for one replica.

    Parameters
    ----------
    model : Model
        A `repro_torch.models.api.Model` (prefill / decode_step).
    params : dict
        Model parameters on ``device``, shared by all slots.
    n_slots : int
        Concurrent sequences in the batched cache.
    cap : int
        Cache capacity in tokens per slot.
    obs : repro_torch.obs.Observability, optional
        Shared registry and tracer: the engine counts admissions,
        completions, steps and tokens and keeps active-slot and
        queue-depth gauges under the reference's names.  Its tracer's
        spans (profiler labels always, events when the tracer is on):
        ``netmcp.admit`` per request (popped from the queue to its first
        token on the host; args rid, slot, prompt_len and wait_ms, the
        time since `submit`) holding ``netmcp.prefill`` and
        ``netmcp.slot_insert`` (pad to ``cap``, copy into the slot); per
        step ``netmcp.decode_step`` (the host issuing the decode) then
        ``netmcp.decode_read`` (the tokens' host read, the slots' update,
        eviction).
    device : None, str or torch.device
        Where the engine runs; None is the CUDA card and raises without one.
    """

    def __init__(self, model: Model, params, n_slots: int, cap: int,
                 obs: Optional[Observability] = None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        bad = {t.device for t in _leaves(params)} - {self.device}
        if bad:
            raise ValueError(f"ServeEngine: parameters on {sorted(map(str, bad))}, "
                             f"engine on {self.device}")
        cfg = model.cfg
        if cfg.is_encoder_decoder and cap > cfg.n_audio_frames:
            raise ValueError(f"ServeEngine: cap {cap} above {cfg.name}'s n_audio_frames "
                             f"{cfg.n_audio_frames}: the cross-attention cache holds "
                             f"{cfg.n_audio_frames} rows and is not padded to cap")
        # the extras a request of this model brings, with their shapes
        self.extra_shapes = {}
        if cfg.is_encoder_decoder:
            self.extra_shapes["frames"] = (cfg.n_audio_frames, cfg.d_model)
        if cfg.n_vision_tokens:
            self.extra_shapes["patches"] = (cfg.n_vision_tokens, cfg.d_model)
        self.n_prefix = cfg.n_vision_tokens      # prefill positions before the tokens
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.cap = cap
        self.cache = model.init_cache(n_slots, cap, device=self.device)
        self.axes = model.cache_axes()
        self.slot_req: list = [None] * n_slots
        self.slot_len = np.zeros(n_slots, np.int32)
        self.last_token = np.zeros((n_slots, 1), np.int32)
        self.queue: collections.deque = collections.deque()
        self.obs = obs if obs is not None else Observability()
        reg = self.obs.registry
        self._m_admitted = reg.counter("engine_admitted_total", "req")
        self._m_completed = reg.counter("engine_completed_total", "req")
        self._m_steps = reg.counter("engine_steps_total", "steps")
        self._m_tokens = reg.counter("engine_tokens_total", "tokens")
        self._m_active = reg.gauge("engine_active_slots", "slots")
        self._m_queue = reg.gauge("engine_queue_depth", "req")

    # -- request lifecycle --------------------------------------------------
    @property
    def pending(self) -> int:
        """Requests not yet finished: queued plus in-slot."""
        return len(self.queue) + sum(1 for r in self.slot_req if r is not None)

    def _extras(self, req: Request) -> dict:
        """The request's extras as float32 arrays, checked against the
        model's `extra_shapes`."""
        got = dict(req.extras or {})
        if set(got) != set(self.extra_shapes):
            raise ValueError(f"ServeEngine: request {req.rid} brings extras {sorted(got)}; "
                             f"{self.model.cfg.name} takes {sorted(self.extra_shapes)}")
        out = {}
        for name, shape in self.extra_shapes.items():
            a = np.asarray(got[name], dtype=np.float32)
            if a.shape != shape:
                raise ValueError(f"ServeEngine: request {req.rid}: {name} of shape {a.shape}, "
                                 f"expected {shape}")
            out[name] = a
        return out

    def submit(self, req: Request):
        """Enqueue one request; the next `step` with a free slot admits it."""
        self._extras(req)
        n = self.n_prefix + len(req.tokens)
        if not (len(req.tokens) >= 1 and n < self.cap):
            raise ValueError(f"ServeEngine: prompt of {len(req.tokens)} tokens "
                             f"({n} prefill positions); 1 to {self.cap - 1 - self.n_prefix} "
                             f"tokens fit a slot of {self.cap}")
        if self.obs.tracer.enabled:
            req.submitted_ms = self.obs.tracer.clock_ms()
        self.queue.append(req)
        self._m_queue.set(len(self.queue))

    def _next_tokens(self, logits: torch.Tensor, reqs: list) -> list:
        """Greedy choice: the first maximum of each row of ``logits`` [n, V]
        (row i belongs to ``reqs[i]``, None for a free slot)."""
        return torch.argmax(logits, dim=-1).tolist()

    def _admit(self):
        tracer = self.obs.tracer
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue[0]
                with tracer.span("netmcp.admit", cat="engine", args={
                    "rid": req.rid, "slot": slot, "prompt_len": len(req.tokens),
                }) as admit:
                    self.queue.popleft()
                    if tracer.enabled and req.submitted_ms is not None:
                        admit.args["wait_ms"] = admit.t0 - req.submitted_ms
                    batch = {k: torch.as_tensor(v[None], device=self.device)
                             for k, v in self._extras(req).items()}
                    batch["tokens"] = torch.as_tensor(
                        np.asarray(req.tokens, np.int64)[None, :], device=self.device)
                    with tracer.span("netmcp.prefill", cat="engine", args={"rid": req.rid}):
                        logits, cache1 = self.model.prefill(self.params, batch)
                    with tracer.span("netmcp.slot_insert", cat="engine"):
                        cache1 = pad_cache_to_capacity(cache1, self.axes, self.cap)
                        insert_slot(self.cache, self.axes, cache1, slot)
                    tok = self._next_tokens(logits[:, -1], [req])[0]
                    req.generated.append(tok)
                self.slot_req[slot] = req
                self.slot_len[slot] = self.n_prefix + len(req.tokens)
                self.last_token[slot, 0] = tok
                self._m_admitted.inc()
                self._m_tokens.inc()
        self._m_queue.set(len(self.queue))
        self._m_active.set(sum(1 for r in self.slot_req if r is not None))

    def _evict(self):
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            if len(req.generated) >= req.max_new_tokens or self.slot_len[slot] + 1 >= self.cap:
                req.done = True
                self.slot_req[slot] = None
                self._m_completed.inc()
        self._m_active.set(sum(1 for r in self.slot_req if r is not None))

    def step(self):
        """One continuous-batching engine step."""
        self._admit()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        # cache_len is uniform per decode call, as in the reference: every
        # slot decodes at the largest active length
        cache_len = int(self.slot_len[active].max())
        tracer = self.obs.tracer
        with tracer.span("netmcp.decode_step", cat="engine", args={"active": len(active)}):
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, torch.as_tensor(self.last_token, device=self.device),
                cache_len,
            )
        with tracer.span("netmcp.decode_read", cat="engine"):
            toks = self._next_tokens(logits[:, -1], self.slot_req)
            for slot in active:
                req = self.slot_req[slot]
                req.generated.append(int(toks[slot]))
                self.slot_len[slot] += 1
                self.last_token[slot, 0] = int(toks[slot])
            self._m_steps.inc()
            self._m_tokens.inc(len(active))
            self._evict()
        return True

    def run(self, max_steps: int = 10_000):
        """Step until every submitted request is done (or ``max_steps``);
        returns the number of engine steps taken."""
        steps = 0
        while self.pending and steps < max_steps:
            if not self.step() and not self.queue:
                break
            steps += 1
        return steps

    def drain(self, max_steps: int = 10_000) -> int:
        """Finish all in-flight and queued requests, then check that the
        engine is empty.  Returns steps taken."""
        steps = self.run(max_steps)
        if self.pending:
            raise RuntimeError(
                f"drain incomplete: {self.pending} requests still "
                f"in flight after {steps} steps"
            )
        return steps


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
