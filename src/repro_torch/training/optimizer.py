"""Optimizers, twin of `repro.training.optimizer`: AdamW and Adafactor.

The reference's formulas, in its order, and its state layout: an int32
0-d ``step`` and f32 moments shaped like each parameter (Adafactor's
factored row and column moments for tensors of 2 or more dims), so an
optimizer state crosses between the two through `repro_torch.ft.checkpoint`.
`torch.optim` is not used: its layout and update order differ.

`update(grads, state, params)` returns (params, state, pre-clip grad norm)
as the reference does, but writes the new parameters and moments into the
given tensors in place (under `torch.no_grad()`), one parameter at a time:
at full width a second f32 copy of every parameter would not fit beside
the moments.  Temporaries are one parameter's size.  Only ``step`` is a
new tensor.

`quantize_grads` models int8 block-quantized gradient all-reduce
(quantize -> dequantize, per-tensor absmax scale); `torch.round` rounds
half to even, as `jnp.round`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _zeros_f32(x: torch.Tensor, shape=None, device=None) -> torch.Tensor:
    return torch.zeros(tuple(x.shape) if shape is None else shape, dtype=F32,
                       device=x.device if device is None else device)


def _step0(params, device=None) -> torch.Tensor:
    first = tree.leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device if device is None else device)


def _clip_scale(gnorm: torch.Tensor, clip: float):
    """min(1, clip / max(gnorm, 1e-9)); None without clipping.  A true f32
    division (``float / tensor`` would multiply by the reciprocal)."""
    if not clip:
        return None
    return torch.clamp(gnorm.new_tensor(clip) / torch.clamp(gnorm, min=1e-9), max=1.0)


def _g32(g: torch.Tensor, scale) -> torch.Tensor:
    """The gradient in f32, clipped: the reference multiplies a bf16
    gradient by its f32 scale, which promotes it to f32 first."""
    g32 = g.to(F32)
    return g32 if scale is None else g32 * scale


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def init(self, params) -> AdamWState:
        """Zero f32 moments on each parameter's device, step 0 (int32)."""
        return AdamWState(step=_step0(params), m=tree.map(_zeros_f32, params),
                          v=tree.map(_zeros_f32, params))

    def init_abstract(self, params) -> AdamWState:
        """The state's shapes and dtypes on the ``meta`` device (no memory)."""
        meta = torch.device("meta")
        zeros = lambda x: _zeros_f32(x, device=meta)    # noqa: E731
        return AdamWState(step=_step0(params, meta), m=tree.map(zeros, params),
                          v=tree.map(zeros, params))

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup to ``lr`` over ``warmup_steps`` (f32)."""
        warm = torch.clamp(step.to(F32) / max(self.warmup_steps, 1), max=1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        lr = self.schedule(step)
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, self.grad_clip)
        b1c = 1.0 - torch.pow(self.b1, step.to(F32))
        b2c = 1.0 - torch.pow(self.b2, step.to(F32))
        for g, m, v, p in zip(tree.leaves(grads), tree.leaves(state.m), tree.leaves(state.v),
                              tree.leaves(params)):
            g32 = _g32(g, scale)
            m.mul_(self.b1).add_(g32 * (1 - self.b1))
            v.mul_(self.b2).add_((g32 * (1 - self.b2)).mul_(g32))
            del g32
            p32 = p.to(F32)
            denom = (v / b2c).sqrt_().add_(self.eps)
            delta = (m / b1c).div_(denom).add_(self.weight_decay * p32)
            del denom
            p.copy_(p32 - delta.mul_(lr))          # rounded to p's dtype, as astype
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any     # row second-moment (or full v for <2D params)
    vc: Any


def _rows(x: torch.Tensor) -> torch.Tensor:
    return _zeros_f32(x, tuple(x.shape) if x.ndim < 2 else tuple(x.shape[:-1]))


def _cols(x: torch.Tensor) -> torch.Tensor:
    return _zeros_f32(x, () if x.ndim < 2 else tuple(x.shape[:-2]) + tuple(x.shape[-1:]))


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second moments: O(n+m) optimizer memory for [n, m] params."""

    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    grad_clip: float = 1.0

    def init(self, params) -> AdafactorState:
        return AdafactorState(step=_step0(params), vr=tree.map(_rows, params),
                              vc=tree.map(_cols, params))

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params):
        step = state.step + 1
        beta = 1.0 - torch.pow(step.to(F32) + 1.0, -self.decay)
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, self.grad_clip)
        for g, vr, vc, p in zip(tree.leaves(grads), tree.leaves(state.vr), tree.leaves(state.vc),
                                tree.leaves(params)):
            g32 = _g32(g, scale)
            g2 = g32 * g32 + self.eps
            if g.ndim < 2:
                vr.copy_(beta * vr + (1 - beta) * g2)
                update = g32 / (torch.sqrt(vr) + 1e-12)
            else:
                vr.copy_(beta * vr + (1 - beta) * torch.mean(g2, dim=-1))
                vc.copy_(beta * vc + (1 - beta) * torch.mean(g2, dim=-2))
                r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=self.eps)
                approx = r[..., None] * vc[..., None, :]
                update = g32 / (torch.sqrt(approx) + 1e-12)
            p.copy_(p.to(F32) - self.lr * update)
        return params, AdafactorState(step=step, vr=state.vr, vc=state.vc), gnorm


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(g.to(F32) ** 2) for g in tree.leaves(grads)))


def quantize_grads(grads, bits: int = 8):
    """Block-quantize/dequantize gradients (per-tensor absmax scaling):
    the numeric effect of compressed gradient all-reduce.  A new tree."""
    qmax = 2.0 ** (bits - 1) - 1

    def q(g):
        g32 = g.to(F32)
        scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / qmax
        return (torch.round(g32 / scale) * scale).to(g.dtype)

    return tree.map(q, grads)
