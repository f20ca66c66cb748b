"""Train-step factory, twin of `repro.training.train_step`: loss -> grads
-> (optional compression) -> update.

The gradients are `torch.autograd.grad` of `Model.loss` over the parameter
leaves: the step turns ``requires_grad`` on for the leaves while it
records, and restores each leaf's flag afterwards, so the caller's tree
stays plain tensors.  The optimizer then updates the parameters and its
moments in place (`repro_torch.training.optimizer`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree
from repro_torch.models.api import Model
from repro_torch.obs import Observability
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.training.optimizer import AdamW, quantize_grads


def _grads(model: Model, params, batch):
    """(loss, metrics, grads): grads a tree like ``params``, a parameter the
    loss does not reach getting zeros."""
    leaves = tree.leaves(params)
    flags = [t.requires_grad for t in leaves]
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t, flag in zip(leaves, flags):
                t.requires_grad_(flag)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
    return loss.detach(), metrics, tree.unflatten(params, grads)


def make_train_step(model: Model, opt: AdamW, grad_compression_bits: Optional[int] = None,
                    obs: Optional[Observability] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", **metrics}); ``params`` and the moments are
    updated in place and returned.  The step runs under the span
    ``netmcp.train_step`` of ``obs``'s tracer (a disabled one by default:
    the profiler labels alone), the optimizer's update under
    ``netmcp.optimizer`` inside it."""
    tracer = obs.tracer if obs is not None else NULL_TRACER

    def train_step(params, opt_state, batch):
        with tracer.span("netmcp.train_step", cat="training"):
            loss, metrics, grads = _grads(model, params, batch)
            if grad_compression_bits:
                grads = quantize_grads(grads, grad_compression_bits)
            with tracer.span("netmcp.optimizer", cat="training"):
                params, opt_state, gnorm = opt.update(grads, opt_state, params)
        out = {"loss": loss, "grad_norm": gnorm, **metrics}
        return params, opt_state, out

    return train_step


def make_eval_step(model: Model):
    """Returns eval_step(params, batch) -> {"loss", **metrics}, under
    `torch.no_grad()` (so ``attn_impl="pallas"`` runs the flash kernel)."""

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step
