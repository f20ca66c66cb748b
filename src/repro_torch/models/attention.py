"""GQA attention layer, twin of `repro.models.attention`: init, prefill
forward and single-token decode, for self-attention (causal, or not as in
the whisper encoder) and for cross-attention to a memory (whisper's
decoder against the encoder's output).

Three interchangeable prefill paths (``cfg.attn_impl``):
  naive   — full [Sq, Sk] scores, grouped products (no KV expansion)
  chunked — the naive path over q-chunks of ``cfg.attn_chunk`` rows (a
            Python loop); under autograd each chunk is checkpointed, so
            the backward keeps one chunk's [B, H, chunk, Sk] scores at a
            time, as the reference's `nothing_saveable` chunks
  pallas  — `kernels.ops.flash_attention`: the hand-written CUDA kernel
            on the card (its plain version, `mha_ref`, for CPU tensors).
            Forward only: like the reference's Pallas kernel it has no
            backward, so a call whose operands require grad raises on
            either device (train with ``naive`` or ``chunked``)

Decode appends the new token's K/V to the cache **in place** (the
reference returns a new cache) and attends over ``cache_len + 1`` rows;
cross-attention decode writes nothing and attends over ``cache_len`` rows
of its static cache.  Under ``"pallas"`` both go through
`kernels.ops.decode_attention` (the CUDA flash decode kernel, reading the
cache through its strides), otherwise through grouped products, as the
reference.

Where P is rounded: the naive/chunked paths and the grouped decode round
the softmax P to the model dtype before the PV product, as the reference
(`attention.py:107`, `:251`); the kernels and their plain versions keep P
in f32.  In f32 the two agree to rounding; in bf16 within bf16 tolerance.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.nn import core as nn

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D]; positions [B, S] or [S].  f32 math, cast back."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                       # [D/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs         # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def attn_init(ctx: nn.InitCtx, cfg: ModelConfig, n_layers: int, cross: bool = False) -> dict:
    """wq/wk/wv/wo (and bq/bk/bv under ``qkv_bias``, unless ``cross``) of
    ``n_layers`` layers, stacked on a leading axis."""
    d, hd, n = cfg.d_model, cfg.resolved_head_dim, n_layers
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": nn.fan_in_normal(ctx, (n, d, nq * hd), ("layers", "embed_fsdp", "qkv"), fan_in=d),
        "wk": nn.fan_in_normal(ctx, (n, d, nkv * hd), ("layers", "embed_fsdp", "qkv"), fan_in=d),
        "wv": nn.fan_in_normal(ctx, (n, d, nkv * hd), ("layers", "embed_fsdp", "qkv"), fan_in=d),
        "wo": nn.fan_in_normal(ctx, (n, nq * hd, d), ("layers", "qkv", "embed_fsdp"),
                               fan_in=nq * hd),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = nn.zeros(ctx, (n, nq * hd), ("layers", "qkv"))
        p["bk"] = nn.zeros(ctx, (n, nkv * hd), ("layers", "qkv"))
        p["bv"] = nn.zeros(ctx, (n, nkv * hd), ("layers", "qkv"))
    return p


# ---------------------------------------------------------------------------
# Score paths
# ---------------------------------------------------------------------------

def _naive_attn(q, k, v, causal: bool, q_offset: int = 0):
    """q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]: grouped products (no KV
    expansion), model-dtype operands with f32 sums, P rounded to the model
    dtype for the PV product, as the reference."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4).to(torch.float32)  # [B,Hkv,G,Sq,D]
    kf = k.permute(0, 2, 1, 3).to(torch.float32)[:, :, None]                  # [B,Hkv,1,Sk,D]
    vf = v.permute(0, 2, 1, 3)[:, :, None]
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale                       # [B,Hkv,G,Sq,Sk]
    col = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        row = torch.arange(Sq, device=q.device)[:, None] + q_offset
        mask = mask & (col[None, :] <= row)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)                                  # P in model dtype
    o = torch.matmul(p.to(torch.float32), vf.to(torch.float32))               # [B,Hkv,G,Sq,D]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def _chunked_attn(q, k, v, causal: bool, chunk: int):
    """The naive path over q-chunks of ``chunk`` rows: peak live memory
    [B, H, chunk, Sk] instead of [B, H, Sq, Sk].  When autograd records
    (grad on and an operand requiring grad) each chunk is checkpointed:
    otherwise the backward would keep every chunk's scores, the full
    [B, H, Sq, Sk] the chunking exists to avoid.  Values do not change."""
    Sq = q.shape[1]
    chunk = min(chunk, Sq)
    records = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))

    def one(i):
        return _naive_attn(q[:, i:i + chunk], k, v, causal=causal, q_offset=i)

    if records:
        outs = [checkpoint(one, i, use_reentrant=False) for i in range(0, Sq, chunk)]
    else:
        outs = [one(i) for i in range(0, Sq, chunk)]
    return torch.cat(outs, dim=1)


def _pallas_attn(q, k, v, causal: bool):
    """[B, S, H, D] activations through the flash kernel as transposed
    views (the kernel takes strides): no copies in or out.  Forward only:
    `ops.flash_attention` raises when autograd would record the call."""
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
    )
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Layer forward
# ---------------------------------------------------------------------------

def attn_apply(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                   # [B, S, d]
    positions: torch.Tensor,           # [S] or [B, S]
    causal: bool = True,
    kv: Optional[torch.Tensor] = None, # cross-attention memory [B, Sk, d]
):
    """Full-sequence forward (prefill).  Self-attention (``kv`` None) puts
    RoPE on q and k; cross-attention takes k and v from ``kv`` and no RoPE.
    Returns (y, cache) where cache = (k, v) laid out [B, Sk, Hkv, hd]."""
    B, S, _ = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    src = x if kv is None else kv
    Sk = src.shape[1]
    q = nn.dense(x, p["wq"], p.get("bq")).reshape(B, S, nq, hd)
    k = nn.dense(src, p["wk"], p.get("bk")).reshape(B, Sk, nkv, hd)
    v = nn.dense(src, p["wv"], p.get("bv")).reshape(B, Sk, nkv, hd)
    if kv is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cfg.attn_impl == "pallas":
        o = _pallas_attn(q, k, v, causal)
    elif cfg.attn_impl == "chunked" and S > cfg.attn_chunk:
        o = _chunked_attn(q, k, v, causal, cfg.attn_chunk)
    else:
        o = _naive_attn(q, k, v, causal)

    y = nn.dense(o.reshape(B, S, nq * hd), p["wo"])
    return y, (k, v)


def attn_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                   # [B, 1, d]: one new token
    cache: tuple,                      # (k, v) [B, S_cap, Hkv, hd], updated in place
    cache_len: int,                    # valid entries, the same for every row
    cross: bool = False,
):
    """Single-token decode.  Self-attention writes (k, v) at ``cache_len``
    in place (RoPE at position ``cache_len``) and attends over
    ``cache_len + 1`` entries; cross-attention (``cross``) writes nothing,
    puts no RoPE on q and attends over ``cache_len`` entries of its static
    cache.  Returns (y [B, 1, d], cache)."""
    B = x.shape[0]
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    kc, vc = cache
    S_cap = kc.shape[1]
    cache_len = int(cache_len)
    if not (0 < cache_len <= S_cap if cross else 0 <= cache_len < S_cap):
        raise ValueError(f"attn_decode: cache_len {cache_len} outside the cache of {S_cap} "
                         f"({'cross' if cross else 'self'}-attention)")

    q = nn.dense(x, p["wq"], p.get("bq")).reshape(B, 1, nq, hd)
    if cross:
        valid = cache_len
    else:
        k_new = nn.dense(x, p["wk"], p.get("bk")).reshape(B, 1, nkv, hd)
        v_new = nn.dense(x, p["wv"], p.get("bv")).reshape(B, 1, nkv, hd)
        pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
        kc[:, cache_len] = k_new[:, 0].to(kc.dtype)
        vc[:, cache_len] = v_new[:, 0].to(vc.dtype)
        valid = cache_len + 1

    if cfg.attn_impl == "pallas":
        lengths = torch.full((B,), valid, dtype=torch.int32, device=x.device)
        o = ops.decode_attention(q.reshape(B, nq, hd), kc.transpose(1, 2), vc.transpose(1, 2),
                                 lengths)                                  # [B, nq, hd]
    else:
        group = nq // nkv
        scale = 1.0 / math.sqrt(hd)
        qg = q.reshape(B, nkv, group, hd).to(torch.float32)
        kf = kc.permute(0, 2, 3, 1).to(torch.float32)                      # [B, Hkv, hd, S]
        s = torch.matmul(qg, kf) * scale                                   # [B, Hkv, G, S]
        mask = torch.arange(S_cap, device=x.device) < valid
        s = torch.where(mask, s, NEG_INF)
        pr = torch.softmax(s, dim=-1).to(x.dtype)                          # P in model dtype
        o = torch.matmul(pr.to(torch.float32), vc.transpose(1, 2).to(torch.float32))
    y = nn.dense(o.reshape(B, 1, nq * hd).to(x.dtype), p["wo"])
    return y, (kc, vc)


def init_cache(cfg: ModelConfig, n_layers: int, batch: int, cap: int, device) -> tuple:
    """Zeroed (k, v) caches [n_layers, batch, cap, Hkv, hd] on ``device``:
    each layer's [batch, cap, Hkv, hd] cache, stacked."""
    shape = (n_layers, batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            torch.zeros(shape, dtype=cfg.torch_dtype, device=device))


CACHE_AXES = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
