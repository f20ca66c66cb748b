"""xLSTM blocks, twin of `repro.models.xlstm`: mLSTM (matrix memory,
chunked-parallel) and sLSTM (scalar memory, sequential recurrence with
exponential gating).

mLSTM's matrix-memory recurrence

    C_t = f_t * C_{t-1} + i_t * (k_t v_t^T),    n_t = f_t * n_{t-1} + i_t k_t
    h_t = o_t * (C_t q_t) / max(|n_t^T q_t|, 1)

is evaluated in log-stabilised chunked form, as the reference does: inside
a chunk masked [Q, Q] products, across chunks the state {C, n, m} carried
by a Python loop (the reference's `lax.scan`).  `mlstm_scan_ref` is the
sequential oracle with the same stabilisation; decode takes one of its
steps.  The stabiliser m starts at `NEG_INF` and is clamped at -30.

sLSTM's recurrent weights make each step depend on h_{t-1}, so
`slstm_cell` is a Python loop over the tokens (the reference's `lax.scan`);
its stabiliser starts at -30.  All of it is plain PyTorch: the reference
computes these products with `jnp.einsum` outside any Pallas kernel.  On
``meta`` tensors the dry-run may cut both loops short (`nn.loop_cuts`) and
scale what a few iterations cost to the whole sequence.

Every weight carries the port's leading layer axis (the reference's
stacked scan groups); `lm_forward` hands each layer its own slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import _chunk_major, softplus
from repro_torch.nn import core as nn

NEG_INF = -1e30


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_init(ctx: nn.InitCtx, cfg: ModelConfig, n_layers: int) -> dict:
    """The reference's mLSTM weights of ``n_layers`` layers, stacked on a
    leading axis (forget-gate bias 1)."""
    d, n, nH = cfg.d_model, n_layers, cfg.n_heads
    di = int(cfg.mlstm_proj_factor * d)
    return {
        "w_up": nn.fan_in_normal(ctx, (n, d, 2 * di), ("layers", "embed_fsdp", "mlp"), fan_in=d),
        "w_q": nn.fan_in_normal(ctx, (n, di, di), ("layers", "mlp", "qkv"), fan_in=di),
        "w_k": nn.fan_in_normal(ctx, (n, di, di), ("layers", "mlp", "qkv"), fan_in=di),
        "w_v": nn.fan_in_normal(ctx, (n, di, di), ("layers", "mlp", "qkv"), fan_in=di),
        "w_i": nn.normal(ctx, (n, di, nH), ("layers", "mlp", "heads"), stddev=0.02),
        "w_f": nn.normal(ctx, (n, di, nH), ("layers", "mlp", "heads"), stddev=0.02),
        "b_i": nn.zeros(ctx, (n, nH), ("layers", "heads")),
        "b_f": nn.ones(ctx, (n, nH), ("layers", "heads")),
        "w_o": nn.fan_in_normal(ctx, (n, di, di), ("layers", "mlp", "qkv"), fan_in=di),
        "norm": nn.ones(ctx, (n, di), ("layers", "mlp")),
        "w_down": nn.fan_in_normal(ctx, (n, di, d), ("layers", "mlp", "embed_fsdp"), fan_in=di),
    }


def _init_mlstm_carry(B, nH, dh, device):
    return (torch.zeros((B, nH, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((B, nH, dh), dtype=torch.float32, device=device),
            torch.full((B, nH), NEG_INF, dtype=torch.float32, device=device))


def mlstm_chunked(q, k, v, log_f, log_i, chunk: int, state: Optional[dict] = None):
    """q/k/v [B, L, nH, dh]; log_f/log_i [B, L, nH].  Returns (h [B, L, nH,
    dh] f32, state {C, n, m}).  The last chunk is padded with log f = 0 and
    log i = `NEG_INF` (f = 1, i = 0), which leaves the state as it is.
    Under `nn.loop_cuts` on meta tensors ("mlstm"), only the first chunks
    run."""
    B, L, nH, dh = q.shape
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad))                          # f = 1
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG_INF)           # i = 0
    nC = (L + pad) // Q
    scale = 1.0 / math.sqrt(dh)
    qc = _chunk_major(q.to(torch.float32) * scale, B, nC, Q)
    kc, vc, fc, ic = (_chunk_major(t.to(torch.float32), B, nC, Q) for t in (k, v, log_f, log_i))
    if state is None:
        C, n, m = _init_mlstm_carry(B, nH, dh, q.device)
    else:
        C, n, m = state["C"], state["n"], state["m"]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    hs = []
    n_run = nn.meta_iterations("mlstm", nC, q)
    for i in range(n_run):
        qq, kk, vv, lf, li = qc[i], kc[i], vc[i], fc[i], ic[i]
        b = torch.cumsum(lf, dim=1)                                   # [B, Q, nH]
        # log decay(t, s) = b_t - b_s + li_s  (s <= t)
        dec = b[:, :, None, :] - b[:, None, :, :] + li[:, None, :, :]
        dec = torch.where(tri[None, :, :, None], dec, NEG_INF)
        m_intra = dec.amax(dim=2)                                     # [B, Q, nH]
        m_inter = b + m[:, None, :]                                   # [B, Q, nH]
        m_t = torch.clamp(torch.maximum(m_intra, m_inter), min=-30.0)  # keep denom representable

        D = torch.exp(dec - m_t[:, :, None, :])                       # [B, t, s, nH]
        scores = torch.einsum("bthd,bshd->btsh", qq, kk) * D
        num = torch.einsum("btsh,bshd->bthd", scores, vv)
        carry = torch.exp(m_inter - m_t)[..., None]
        num = num + torch.einsum("bthd,bhde->bthe", qq, C) * carry
        nvec = torch.einsum("btsh,bshd->bthd", D, kk) + n[:, None] * carry
        qn = torch.einsum("bthd,bthd->bth", qq, nvec)
        denom = torch.maximum(torch.abs(qn), torch.exp(-m_t))
        hs.append(num / denom[..., None])

        # end-of-chunk state
        btot = b[:, -1]                                               # [B, nH]
        m_cand = (btot[:, None, :] - b + li).amax(dim=1)              # [B, nH]
        m_new = torch.clamp(torch.maximum(btot + m, m_cand), min=-30.0)
        w = torch.exp(btot[:, None, :] - b + li - m_new[:, None, :])  # [B, Q, nH]
        decay = torch.exp(btot + m - m_new)
        C = C * decay[..., None, None] + torch.einsum("bshd,bshe->bhde", kk * w[..., None], vv)
        n = n * decay[..., None] + (kk * w[..., None]).sum(dim=1)
        m = m_new
    h = torch.stack(nn.fill_cut(hs, nC)).transpose(0, 1).reshape(B, nC * Q, nH, dh)[:, :L]
    return h, {"C": C, "n": n, "m": m}


def mlstm_scan_ref(q, k, v, log_f, log_i, state: Optional[dict] = None):
    """Sequential oracle, the same stabilisation.  Returns (h [B, L, nH, dh]
    f32, state {C, n, m})."""
    B, L, nH, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    if state is None:
        C, n, m = _init_mlstm_carry(B, nH, dh, q.device)
    else:
        C, n, m = state["C"], state["n"], state["m"]
    qf, kf, vf, ff, if_ = (t.to(torch.float32) for t in (q, k, v, log_f, log_i))
    hs = []
    for t in range(L):
        q_t, k_t, v_t, lf_t, li_t = qf[:, t], kf[:, t], vf[:, t], ff[:, t], if_[:, t]
        m_new = torch.clamp(torch.maximum(lf_t + m, li_t), min=-30.0)
        fw = torch.exp(lf_t + m - m_new)
        iw = torch.exp(li_t - m_new)
        C = C * fw[..., None, None] + iw[..., None, None] * torch.einsum("bhd,bhe->bhde", k_t, v_t)
        n = n * fw[..., None] + iw[..., None] * k_t
        qs = q_t * scale
        num = torch.einsum("bhd,bhde->bhe", qs, C)
        qn = torch.einsum("bhd,bhd->bh", qs, n)
        denom = torch.maximum(torch.abs(qn), torch.exp(-m_new))
        hs.append(num / denom[..., None])
        m = m_new
    h = torch.stack(hs, dim=1) if hs else qf.new_zeros((B, 0, nH, dh))
    return h, {"C": C, "n": n, "m": m}


def _mlstm_qkv(p, cfg, x_in):
    B, L, _ = x_in.shape
    di = p["w_q"].shape[0]
    nH = cfg.n_heads
    dh = di // nH
    q = nn.dense(x_in, p["w_q"]).reshape(B, L, nH, dh)
    k = nn.dense(x_in, p["w_k"]).reshape(B, L, nH, dh)
    v = nn.dense(x_in, p["w_v"]).reshape(B, L, nH, dh)
    log_i = nn.dense(x_in, p["w_i"]).to(torch.float32) + p["b_i"]
    log_f = log_sigmoid(nn.dense(x_in, p["w_f"]).to(torch.float32) + p["b_f"])
    return q, k, v, log_f, log_i


def _mlstm_out(p, cfg, x, x_in, z, h):
    """The output gate, norm, z gate and down projection of h [B, L, di]."""
    o = nn.sigmoid(nn.dense(x_in, p["w_o"]))
    # The norm reads the gated product before it is rounded to the model
    # dtype, as the reference's compiled block does (XLA keeps the bf16
    # product in f32 where it feeds the norm's f32 convert).  In f32 the
    # two are the same.
    g = h.to(x.dtype).to(torch.float32) * o.to(torch.float32)
    y = nn.rms_norm(g, p["norm"], cfg.norm_eps).to(x.dtype) * nn.silu(z)
    return nn.dense(y, p["w_down"])


def mlstm_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, state=None, return_state=False):
    B, L, _ = x.shape
    x_in, z = torch.chunk(nn.dense(x, p["w_up"]), 2, dim=-1)
    q, k, v, log_f, log_i = _mlstm_qkv(p, cfg, x_in)
    h, new_state = mlstm_chunked(q, k, v, log_f, log_i, cfg.mlstm_chunk, state)
    out = _mlstm_out(p, cfg, x, x_in, z, h.reshape(B, L, x_in.shape[-1]))
    return out, (new_state if return_state else None)


def mlstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """x [B, 1, d]; one step of the sequential oracle."""
    x_in, z = torch.chunk(nn.dense(x, p["w_up"]), 2, dim=-1)
    q, k, v, log_f, log_i = _mlstm_qkv(p, cfg, x_in)
    h, new_state = mlstm_scan_ref(q, k, v, log_f, log_i, state)
    return _mlstm_out(p, cfg, x, x_in, z, h.reshape(x.shape[0], 1, x_in.shape[-1])), new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, device, n_layers: Optional[int] = None):
    """The empty state of ``batch`` sequences (m at `NEG_INF`); with
    ``n_layers``, stacked on a leading layer axis."""
    lead = () if n_layers is None else (n_layers,)
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    nH = cfg.n_heads
    dh = di // nH
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros(lead + (batch, nH, dh, dh), **f32),
        "n": torch.zeros(lead + (batch, nH, dh), **f32),
        "m": torch.full(lead + (batch, nH), NEG_INF, **f32),
    }


MLSTM_STATE_AXES = {
    "C": ("cache_batch", "heads", "head_dim", "head_dim"),
    "n": ("cache_batch", "heads", "head_dim"),
    "m": ("cache_batch", "heads"),
}


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_init(ctx: nn.InitCtx, cfg: ModelConfig, n_layers: int) -> dict:
    """The reference's sLSTM weights of ``n_layers`` layers, stacked on a
    leading axis: input and recurrent gate weights, bias, and the GLU."""
    d, n, nH = cfg.d_model, n_layers, cfg.n_heads
    dh = d // nH
    dff = int(cfg.slstm_proj_factor * d)
    return {
        "w": nn.fan_in_normal(ctx, (n, d, 4 * d), ("layers", "embed_fsdp", "mlp"), fan_in=d),
        "r": nn.normal(ctx, (n, nH, dh, 4 * dh), ("layers", "heads", "head_dim", "mlp"),
                       stddev=0.02),
        "b": nn.zeros(ctx, (n, 4 * d), ("layers", "mlp")),
        "up": {
            "w_gate": nn.fan_in_normal(ctx, (n, d, dff), ("layers", "embed_fsdp", "mlp"),
                                       fan_in=d),
            "w_up": nn.fan_in_normal(ctx, (n, d, dff), ("layers", "embed_fsdp", "mlp"), fan_in=d),
            "w_down": nn.fan_in_normal(ctx, (n, dff, d), ("layers", "mlp", "embed_fsdp"),
                                       fan_in=dff),
        },
    }


def slstm_cell(p: dict, cfg: ModelConfig, x_seq: torch.Tensor, state: dict):
    """x_seq [B, L, d]; the recurrence over L, one token at a time.  Returns
    (h [B, L, d] in x's dtype, state {c, n, m, h}).  Under `nn.loop_cuts`
    on meta tensors ("slstm"), only the first tokens run."""
    B, L, d = x_seq.shape
    nH = cfg.n_heads
    dh = d // nH
    wx = nn.dense(x_seq, p["w"]).to(torch.float32)                   # [B, L, 4d]
    r = p["r"].to(torch.float32)
    bias = p["b"].to(torch.float32)
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    hs = []
    n_run = nn.meta_iterations("slstm", L, x_seq)
    for t in range(n_run):
        rec = torch.einsum("bhd,hdf->bhf", h.reshape(B, nH, dh), r)
        gates = wx[:, t] + rec.reshape(B, 4 * d) + bias
        i_r, f_r, z_r, o_r = torch.chunk(gates, 4, dim=-1)
        m_new = torch.clamp(torch.maximum(f_r + m, i_r), min=-30.0)
        fw = torch.exp(f_r + m - m_new)
        iw = torch.exp(i_r - m_new)
        c = fw * c + iw * torch.tanh(z_r)
        n = fw * n + iw
        h = nn.sigmoid(o_r) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    out = torch.stack(nn.fill_cut(hs, L), dim=1) if hs else wx.new_zeros((B, 0, d))
    return out.to(x_seq.dtype), {"c": c, "n": n, "m": m, "h": h}


def slstm_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, state=None, return_state=False):
    if state is None:
        state = init_slstm_state(cfg, x.shape[0], x.device)
    h, new_state = slstm_cell(p, cfg, x, state)
    up = p["up"]
    y = h + nn.swiglu(h, up["w_gate"], up["w_up"], up["w_down"])
    return y, (new_state if return_state else None)


def slstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, state: dict):
    return slstm_apply(p, cfg, x, state, return_state=True)


def init_slstm_state(cfg: ModelConfig, batch: int, device, n_layers: Optional[int] = None):
    """The empty state of ``batch`` sequences (m at -30); with ``n_layers``,
    stacked on a leading layer axis."""
    shape = (() if n_layers is None else (n_layers,)) + (batch, cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "m": torch.full(shape, -30.0, **f32), "h": torch.zeros(shape, **f32)}


SLSTM_STATE_AXES = {k: ("cache_batch", "embed") for k in ("c", "n", "m", "h")}
