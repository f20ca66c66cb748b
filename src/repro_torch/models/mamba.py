"""Mamba block as Mamba-2 / SSD, twin of `repro.models.mamba`.

The recurrence, per head h (A_h < 0):

    H_t = a_t * H_{t-1} + dt_t * (B_t ⊗ x_t),   y_t = C_t · H_t + D * x_t
    a_t = exp(dt_t * A_h)

`ssd_chunked` evaluates it chunk by chunk, as the reference does: inside a
chunk of Q tokens a masked [Q, Q] product per head, across chunks the state
H [B, nH, N, P] carried by a Python loop (the reference's `lax.scan`).
`ssd_scan_ref` is the sequential oracle, one step per token.  Both are
plain PyTorch products: the reference computes them with `jnp.einsum`
outside any Pallas kernel.

Every weight carries the port's leading layer axis (the reference's
stacked scan groups); `lm_forward` hands each layer its own slice.  The
serving state is ``{"h": [B, nH, N, P] f32, "conv": [B, d_conv - 1, d_inner]}``:
the carried SSM state and the last ``d_conv - 1`` rows of the conv input.

Difference from the reference, by design: a prompt shorter than
``d_conv - 1`` tokens leaves a conv tail left-padded with zeros to
``d_conv - 1`` rows, which is what `_causal_conv`'s own padding means (the
reference keeps the short tail, and its serving engine then writes it over
the first rows of the slot's tail; `ROADMAP.md` queue 3).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.nn import core as nn

NEG_INF = -1e30


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (``F.softplus`` switches to x
    above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_init(ctx: nn.InitCtx, cfg: ModelConfig, n_layers: int) -> dict:
    """The reference's Mamba weights of ``n_layers`` layers, stacked on a
    leading axis.  ``a_log`` = log(linspace(1, 16, nH)) is f32 whatever the
    model dtype, as in the reference."""
    d, di, n = cfg.d_model, cfg.d_inner, n_layers
    nH, N, dc = cfg.mamba_heads, cfg.mamba_d_state, cfg.mamba_d_conv
    def a_log():
        a = torch.linspace(1.0, 16.0, nH, dtype=torch.float32, device=ctx.device)
        return torch.log(a).expand(n, nH).clone()

    return {
        "w_in": nn.fan_in_normal(ctx, (n, d, 2 * di), ("layers", "embed_fsdp", "mlp"), fan_in=d),
        "conv_w": nn.normal(ctx, (n, dc, di), ("layers", "conv", "mlp"), stddev=0.1),
        "conv_b": nn.zeros(ctx, (n, di), ("layers", "mlp")),
        "w_bc": nn.fan_in_normal(ctx, (n, di, 2 * N), ("layers", "mlp", "state"), fan_in=di),
        "w_dt": nn.normal(ctx, (n, di, nH), ("layers", "mlp", "heads"), stddev=0.02),
        "dt_bias": nn.zeros(ctx, (n, nH), ("layers", "heads")),
        "a_log": nn.derived(ctx, (n, nH), ("layers", "heads"), torch.float32, a_log),
        "d_skip": nn.ones(ctx, (n, nH), ("layers", "heads")),
        "w_out": nn.fan_in_normal(ctx, (n, di, d), ("layers", "mlp", "embed_fsdp"), fan_in=di),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x [B, L, di], w [dc, di]; the taps summed in
    index order, as the reference (not `F.conv1d`, whose order differs)."""
    dc = w.shape[0]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    L = x.shape[1]
    out = xp[:, 0:L] * w[0][None, None, :]
    for j in range(1, dc):
        out = out + xp[:, j:j + L] * w[j][None, None, :]
    return out + b


def _project(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Shared pre-SSM projections.  x [B, L, d] ->
    (xh [B,L,nH,P], dt [B,L,nH] f32, Bm/Cm [B,L,N] f32, z [B,L,di], conv_tail
    [B, dc-1, di])."""
    nH, P, dc = cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_d_conv
    xz = nn.dense(x, p["w_in"])
    x_ssm, z = torch.chunk(xz, 2, dim=-1)
    conv_tail = x_ssm[:, -(dc - 1):]                       # decode carry-over
    if conv_tail.shape[1] < dc - 1:                        # a prompt shorter than the tail
        conv_tail = F.pad(conv_tail, (0, 0, dc - 1 - conv_tail.shape[1], 0))
    x_conv = nn.silu(_causal_conv(x_ssm, p["conv_w"], p["conv_b"]))
    bc = nn.dense(x_conv, p["w_bc"]).to(torch.float32)
    Bm, Cm = torch.chunk(bc, 2, dim=-1)
    dt = softplus(nn.dense(x_conv, p["w_dt"]).to(torch.float32) + p["dt_bias"])
    B_, L = x.shape[0], x.shape[1]
    xh = x_conv.reshape(B_, L, nH, P)
    return xh, dt, Bm, Cm, z, conv_tail


def _chunk_major(t: torch.Tensor, B: int, nC: int, Q: int) -> torch.Tensor:
    """[B, nC * Q, ...] -> [nC, B, Q, ...]."""
    return t.reshape((B, nC, Q) + tuple(t.shape[2:])).transpose(0, 1)


def ssd_chunked(
    xh: torch.Tensor,      # [B, L, nH, P]
    dt: torch.Tensor,      # [B, L, nH] f32
    Bm: torch.Tensor,      # [B, L, N]  f32
    Cm: torch.Tensor,      # [B, L, N]  f32
    a_log: torch.Tensor,   # [nH] f32 (A = -exp(a_log))
    chunk: int,
    h0: Optional[torch.Tensor] = None,   # [B, nH, N, P] f32
    out_dtype: torch.dtype = torch.float32,
):
    """Chunked SSD.  Returns (y [B, L, nH, P] in ``out_dtype``, h_final f32).
    The last chunk is padded with dt = 0 (decay 1, input 0), which leaves
    the final state as it is; sums are f32 whatever ``out_dtype``.  The
    chunk loop runs under the profiler label ``netmcp.ssd_chunks``; under
    `nn.loop_cuts` on meta tensors ("ssd"), only its first chunks run."""
    B, L, nH, P = xh.shape
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
    nC = (L + pad) // Q
    A = -torch.exp(a_log)                                  # [nH]
    log_a = dt * A[None, None, :]                          # [B, Lp, nH] (<= 0)
    xc, dc, lc, Bc, Cc = (_chunk_major(t, B, nC, Q) for t in (xh, dt, log_a, Bm, Cm))
    h = torch.zeros((B, nH, Bm.shape[-1], P), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0.to(torch.float32)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    ys = []
    n_run = nn.meta_iterations("ssd", nC, xh)
    with torch.profiler.record_function("netmcp.ssd_chunks"):
        for i in range(n_run):
            xq = xc[i].to(torch.float32) * dc[i][..., None]   # dt-weighted input (f32)
            Bq, Cq = Bc[i], Cc[i]
            cum = torch.cumsum(lc[i], dim=1)                   # [B, Q, nH]
            # intra-chunk: decay(t, s) = cum_t - cum_s for s <= t
            dec = cum[:, :, None, :] - cum[:, None, :, :]      # [B, t, s, nH]
            dec = torch.where(tri[None, :, :, None], dec, NEG_INF)
            CB = torch.einsum("btn,bsn->bts", Cq, Bq)          # [B, t, s]
            scores = CB[:, :, :, None] * torch.exp(dec)        # [B, t, s, nH]
            y = torch.einsum("btsh,bshp->bthp", scores, xq)
            # inter-chunk: y += (C_t . h) * exp(cum_t)
            y = y + torch.einsum("btn,bhnp->bthp", Cq, h) * torch.exp(cum)[..., None]
            # state update
            total = cum[:, -1]                                 # [B, nH]
            w = torch.exp(total[:, None, :] - cum)             # [B, Q, nH]
            h = h * torch.exp(total)[:, :, None, None] + torch.einsum(
                "bsn,bshp->bhnp", Bq, xq * w[..., None])
            ys.append(y.to(out_dtype))
    y = torch.stack(nn.fill_cut(ys, nC)).transpose(0, 1).reshape(B, nC * Q, nH, P)[:, :L]
    return y, h


def ssd_scan_ref(xh, dt, Bm, Cm, a_log, h0=None):
    """Sequential oracle: one step per token.  Returns (y [B, L, nH, P] f32,
    h_final)."""
    B, L, nH, P = xh.shape
    A = -torch.exp(a_log)
    h = torch.zeros((B, nH, Bm.shape[-1], P), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0.to(torch.float32)
    xf = xh.to(torch.float32)
    ys = []
    for t in range(L):
        x_t, dt_t, B_t, C_t = xf[:, t], dt[:, t], Bm[:, t], Cm[:, t]
        a_t = torch.exp(dt_t * A[None, :])                 # [B, nH]
        upd = torch.einsum("bn,bhp->bhnp", B_t, x_t * dt_t[..., None])
        h = h * a_t[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", C_t, h))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((B, 0, nH, P))
    return y, h


def mamba_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, state: Optional[dict] = None,
                return_state: bool = False):
    """Full-sequence forward.  x [B, L, d] -> (y, state or None)."""
    B, L, _ = x.shape
    xh, dt, Bm, Cm, z, conv_tail = _project(p, cfg, x)
    h0 = state["h"] if state is not None else None
    y, h_fin = ssd_chunked(xh, dt, Bm, Cm, p["a_log"].to(torch.float32), cfg.mamba_chunk, h0,
                           out_dtype=x.dtype)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, L, cfg.d_inner) * nn.silu(z)
    out = nn.dense(y, p["w_out"])
    new_state = {"h": h_fin, "conv": conv_tail} if return_state else None
    return out, new_state


def mamba_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """Single-token step.  x [B, 1, d]; state = {h [B,nH,N,P], conv
    [B,dc-1,di]}.  Returns (y [B, 1, d], the new state)."""
    B = x.shape[0]
    di, nH, P = cfg.d_inner, cfg.mamba_heads, cfg.mamba_head_dim
    xz = nn.dense(x, p["w_in"])                            # [B, 1, 2di]
    x_ssm, z = torch.chunk(xz, 2, dim=-1)
    window = torch.cat([state["conv"], x_ssm], dim=1)      # [B, dc, di]
    # the reference's einsum: exact products summed in f32, rounded once
    conv_out = (window.to(torch.float32) * p["conv_w"].to(torch.float32)).sum(1) \
        .to(x.dtype) + p["conv_b"]
    xc = nn.silu(conv_out)[:, None, :]                     # [B, 1, di]
    bc = nn.dense(xc, p["w_bc"]).to(torch.float32)
    Bm, Cm = torch.chunk(bc[:, 0], 2, dim=-1)              # [B, N]
    dt = softplus(nn.dense(xc, p["w_dt"]).to(torch.float32)[:, 0] + p["dt_bias"])  # [B, nH]
    xh = xc.reshape(B, nH, P).to(torch.float32)
    A = -torch.exp(p["a_log"].to(torch.float32))
    a_t = torch.exp(dt * A[None, :])
    h = state["h"] * a_t[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", Bm, xh * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", Cm, h)
    y = y + xh * p["d_skip"].to(torch.float32)[None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype) * nn.silu(z)
    return nn.dense(y, p["w_out"]), {"h": h, "conv": window[:, 1:]}


def init_mamba_state(cfg: ModelConfig, batch: int, device, n_layers: Optional[int] = None):
    """Zeroed state of ``batch`` sequences; with ``n_layers``, stacked on a
    leading layer axis."""
    lead = () if n_layers is None else (n_layers,)
    nH, N, P = cfg.mamba_heads, cfg.mamba_d_state, cfg.mamba_head_dim
    return {
        "h": torch.zeros(lead + (batch, nH, N, P), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.mamba_d_conv - 1, cfg.d_inner),
                            dtype=cfg.torch_dtype, device=device),
    }


MAMBA_STATE_AXES = {
    "h": ("cache_batch", "heads", "state", "head_dim"),
    "conv": ("cache_batch", "conv", "mlp"),
}
