"""Layer math and initialisers, twin of `repro.nn.core`.

Parameters are plain nested dicts of tensors, as the reference's are
nested dicts of arrays.  The reference's logical axis names exist for its
mesh sharding (`repro.nn.sharding`); one card needs none, so the port's
initialisers return bare tensors, and `fsdp_gather` / `maybe_constrain`,
which are no-ops outside a mesh, have no twin.

The initialisers draw from the `torch.Generator` of an `InitCtx`, on its
device, in the reference's distributions (f32 normal draws scaled, then
cast to the model dtype).  A generator cannot reproduce a `jax.random`
stream, so parity tests carry the reference's weights across with
`repro_torch.convert.lm_params_from_arrays` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass
class InitCtx:
    """Where and how to draw parameters: a seeded generator (its device is
    where the tensors are made) and the model dtype."""
    gen: torch.Generator
    dtype: torch.dtype = torch.bfloat16

    @property
    def device(self) -> torch.device:
        return self.gen.device


def normal(ctx: InitCtx, shape, stddev: float = 0.02) -> torch.Tensor:
    """f32 normal draws times ``stddev``, cast to the model dtype.  A
    layer-stacked weight (three or more dims) is made in the model dtype and
    drawn one slice of its leading axis at a time, so the f32 draws never
    take more than one layer's room (stacked experts at full width would
    otherwise need 4 bytes an element at once)."""
    shape = tuple(shape)
    if len(shape) < 3:
        v = torch.randn(shape, generator=ctx.gen, device=ctx.device, dtype=torch.float32)
        return v.mul_(stddev).to(ctx.dtype)
    out = torch.empty(shape, dtype=ctx.dtype, device=ctx.device)
    for layer in out:
        v = torch.randn(shape[1:], generator=ctx.gen, device=ctx.device, dtype=torch.float32)
        layer.copy_(v.mul_(stddev))
    return out


def fan_in_normal(ctx: InitCtx, shape, fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal with stddev 1/sqrt(fan_in); ``fan_in`` defaults to the first
    dim of ``shape`` (a layer-stacked weight names its own)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return normal(ctx, shape, stddev=1.0 / math.sqrt(max(fan_in, 1)))


def zeros(ctx: InitCtx, shape) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=ctx.dtype, device=ctx.device)


def ones(ctx: InitCtx, shape) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=ctx.dtype, device=ctx.device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 math, cast back to the input's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., d] @ w [d, f] (+ b [f])."""
    out = x @ w
    if b is not None:
        out = out + b
    return out


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each step in x's dtype: the reference's
    `jax.nn.sigmoid` arithmetic, so bf16 activations round where the
    reference's do (`torch.sigmoid` rounds once and differs in about a third
    of bf16 outputs)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), each step in x's dtype: the reference's `jax.nn.silu`
    arithmetic (`F.silu` rounds once and differs in about a third of bf16
    outputs)."""
    return x * sigmoid(x)


def swiglu(x, w_gate, w_up, w_down):
    return dense(silu(dense(x, w_gate)) * dense(x, w_up), w_down)
