"""Layer math and initialisers, twin of `repro.nn.core`.

Parameters are plain nested dicts of tensors, as the reference's are
nested dicts of arrays.  Every initialiser names the logical axes of its
parameter, as the reference's do ("embed_fsdp", "mlp", "layers", ...), but
returns a bare tensor: the reference's `Annotated` pairs have no twin.  The
names come out on their own when the `InitCtx` asks for ``axes`` (then each
initialiser returns its names instead of a tensor, `Model.param_axes`), and
`repro_torch.nn.sharding` maps them onto a logical mesh for the dry-run.
`softmax_cross_entropy` is the training loss, differentiable by autograd.

The initialisers draw from the `torch.Generator` of an `InitCtx`, on its
device, in the reference's distributions (f32 normal draws scaled, then
cast to the model dtype).  A generator cannot reproduce a `jax.random`
stream, so parity tests carry the reference's weights across with
`repro_torch.convert.lm_params_from_arrays` instead.  An ``abstract``
context draws nothing: each initialiser returns an empty tensor on the
``meta`` device (the reference's `ShapeDtypeStruct` leaves), so a 398 B
parameter tree costs no memory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass
class InitCtx:
    """Where and how to make parameters: a seeded generator (its device is
    where the tensors are made) and the model dtype.  ``abstract``: draw
    nothing and make empty ``meta`` tensors (no generator needed).
    ``axes``: each initialiser returns its parameter's logical axis names,
    a tuple, in place of the tensor."""
    gen: Optional[torch.Generator] = None
    dtype: torch.dtype = torch.bfloat16
    abstract: bool = False
    axes: bool = False

    @property
    def device(self) -> torch.device:
        if self.abstract or self.axes:
            return torch.device("meta")
        return self.gen.device


def is_axes(x) -> bool:
    """A tuple of logical axis names (str or None): a leaf of an axes tree."""
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None))) for i in x)


def _undrawn(ctx: InitCtx, shape, names, dtype=None):
    """What an initialiser returns without drawing: its names under
    ``ctx.axes``, an empty meta tensor under ``ctx.abstract``, else None."""
    shape, names = tuple(shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"shape {shape} and axis names {names} differ in length")
    if ctx.axes:
        return names
    if ctx.abstract:
        return torch.empty(shape, dtype=dtype or ctx.dtype, device="meta")
    return None


def normal(ctx: InitCtx, shape, names, stddev: float = 0.02) -> torch.Tensor:
    """f32 normal draws times ``stddev``, cast to the model dtype.  A
    layer-stacked weight (three or more dims) is made in the model dtype and
    drawn one slice of its leading axis at a time, so the f32 draws never
    take more than one layer's room (stacked experts at full width would
    otherwise need 4 bytes an element at once)."""
    shape = tuple(shape)
    made = _undrawn(ctx, shape, names)
    if made is not None:
        return made
    if len(shape) < 3:
        v = torch.randn(shape, generator=ctx.gen, device=ctx.device, dtype=torch.float32)
        return v.mul_(stddev).to(ctx.dtype)
    out = torch.empty(shape, dtype=ctx.dtype, device=ctx.device)
    for layer in out:
        v = torch.randn(shape[1:], generator=ctx.gen, device=ctx.device, dtype=torch.float32)
        layer.copy_(v.mul_(stddev))
    return out


def fan_in_normal(ctx: InitCtx, shape, names, fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal with stddev 1/sqrt(fan_in); ``fan_in`` defaults to the first
    dim of ``shape`` (a layer-stacked weight names its own)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return normal(ctx, shape, names, stddev=1.0 / math.sqrt(max(fan_in, 1)))


def zeros(ctx: InitCtx, shape, names) -> torch.Tensor:
    made = _undrawn(ctx, shape, names)
    return made if made is not None else torch.zeros(tuple(shape), dtype=ctx.dtype,
                                                     device=ctx.device)


def ones(ctx: InitCtx, shape, names) -> torch.Tensor:
    made = _undrawn(ctx, shape, names)
    return made if made is not None else torch.ones(tuple(shape), dtype=ctx.dtype,
                                                    device=ctx.device)


def derived(ctx: InitCtx, shape, names, dtype: torch.dtype, make) -> torch.Tensor:
    """A parameter computed, not drawn (Mamba's ``a_log``): ``make()`` on a
    concrete context, else what `_undrawn` gives, in ``dtype``."""
    made = _undrawn(ctx, shape, names, dtype)
    return made if made is not None else make()


# ---------------------------------------------------------------------------
# Loops cut short on meta tensors.  The dry-run (`repro_torch.launch.dryrun`)
# runs a step on meta tensors, where each op costs host time and nothing
# else; the sequence loops of the recurrent blocks ("ssd": Mamba-2's chunks,
# "mlstm": the mLSTM's chunks, "slstm": the sLSTM's tokens) repeat the same
# ops every iteration, so it runs a few and scales them.
# ---------------------------------------------------------------------------

_LOOP_CUTS: dict = {}
_LOOP_SEEN: dict = {}


@contextlib.contextmanager
def loop_cuts(cuts: dict):
    """Within the block, a loop named in ``cuts`` runs on meta tensors only
    its first ``cuts[name]`` iterations (the outputs of the others stay
    empty).  Yields {name: the most iterations such a loop was asked for}.
    Tensors that hold data are never cut."""
    prev, prev_seen = dict(_LOOP_CUTS), dict(_LOOP_SEEN)
    _LOOP_CUTS.clear()
    _LOOP_CUTS.update(cuts)
    _LOOP_SEEN.clear()
    seen: dict = {}
    try:
        yield seen
    finally:
        seen.update(_LOOP_SEEN)
        _LOOP_CUTS.clear()
        _LOOP_CUTS.update(prev)
        _LOOP_SEEN.clear()
        _LOOP_SEEN.update(prev_seen)


def meta_iterations(name: str, n: int, like: torch.Tensor) -> int:
    """Iterations to run of the loop ``name`` of ``n``: ``n``, or its cut
    when ``like`` is a meta tensor under `loop_cuts`."""
    if like.device.type != "meta" or name not in _LOOP_CUTS:
        return n
    _LOOP_SEEN[name] = max(_LOOP_SEEN.get(name, 0), n)
    return min(n, _LOOP_CUTS[name])


def fill_cut(outs: list, n: int) -> list:
    """``outs`` of a loop that `meta_iterations` may have cut, padded to
    ``n`` with empty tensors like its last (unchanged when nothing was cut)."""
    if len(outs) < n:
        outs += [outs[-1].new_empty(outs[-1].shape)] * (n - len(outs))
    return outs


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


def softmax_cross_entropy(
    logits: torch.Tensor,      # [..., V] (any float dtype; upcast inside)
    labels: torch.Tensor,      # [...] integer, -100 = ignore
    z_loss: float = 0.0,
) -> tuple:
    """Mean CE over non-ignored positions, f32 logsumexp; returns (loss,
    n_valid) with n_valid = max(#valid, 1), so an all-ignored batch gives
    0 rather than NaN.  ``z_loss`` adds z_loss * lse**2 per position."""
    labels = torch.as_tensor(labels, device=logits.device)
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros((), dtype=labels.dtype,
                                                  device=labels.device)).long()
    logits32 = logits.to(torch.float32)
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, safe[..., None])[..., 0]
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse ** 2
    n = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, ce, torch.zeros((), dtype=ce.dtype, device=ce.device)).sum() / n, n
