"""Plain PyTorch reference of a dense GQA decoder (InternLM2's layer).

Imports torch only: nothing of the program under test.  One layer is
rms_norm -> q, k, v projections -> RoPE on the two halves of each head ->
grouped causal softmax attention -> wo, then rms_norm -> SwiGLU; a final
rms_norm and an untied head over the padded vocabulary (``padded_vocab``
rows, the width the measured model computes).  Every product runs in
float32 with TF32 off; ``cast`` is applied to both operands of every
product, so the control (`fp8_cast`) runs the same code in a lower
precision.

The weights are made here, from the seed, on the device, one generator
draw per leaf (`make_params`), in the dtype the configuration serves them
in; the benchmark hands the same tensors to the program and to this
reference.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32

# the model's leaves in the order their seeds are numbered (`leaf_seed`)
LEAVES = ("embed", "final_norm", "head", "norm1", "wq", "wk", "wv", "wo", "norm2",
          "w_gate", "w_up", "w_down")


def dims(cfg: dict) -> dict:
    """The sizes a forward needs, from a configuration file's ``model``."""
    m = cfg["model"]
    d, H, Hkv = m["hidden_size"], m["num_attention_heads"], m["num_key_value_heads"]
    hd = m.get("head_dim") or d // H
    vocab = m["vocab_size"]
    return {
        "d": d, "H": H, "Hkv": Hkv, "hd": hd, "L": m["num_hidden_layers"],
        "ff": m["intermediate_size"], "vocab": vocab,
        "vocab_padded": -(-vocab // 256) * 256,
        "theta": float(m["rope_theta"]), "eps": float(m["rms_norm_eps"]),
    }


def leaf_shapes(dm: dict) -> dict:
    d, L, ff, H, Hkv, hd, Vp = (dm[k] for k in ("d", "L", "ff", "H", "Hkv", "hd", "vocab_padded"))
    return {
        "embed": (Vp, d), "final_norm": (d,), "head": (d, Vp),
        "norm1": (L, d), "wq": (L, d, H * hd), "wk": (L, d, Hkv * hd), "wv": (L, d, Hkv * hd),
        "wo": (L, H * hd, d), "norm2": (L, d),
        "w_gate": (L, d, ff), "w_up": (L, d, ff), "w_down": (L, ff, d),
    }


def leaf_std(name: str, shape: tuple) -> Optional[float]:
    """None for a norm scale (ones), else the normal's std."""
    if "norm" in name:
        return None
    if name == "embed":
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def leaf_seed(seed: int, index: int) -> int:
    """A 64-bit generator seed for leaf ``index`` of run ``seed`` (any
    non-negative integer, also past 32 bits)."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def make_leaf(dm: dict, name: str, seed: int, device, dtype) -> torch.Tensor:
    """One leaf, drawn on ``device`` by its own generator: f32 normal
    draws times the std, rounded once to ``dtype``."""
    shape = leaf_shapes(dm)[name]
    std = leaf_std(name, shape)
    if std is None:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, LEAVES.index(name)))
    out = torch.empty(shape, dtype=dtype, device=device)
    # one layer slice at a time keeps the f32 draws to one layer's room
    for part in (out if len(shape) == 3 else [out]):
        part.copy_(torch.randn(part.shape, generator=gen, device=device, dtype=F32).mul_(std))
    return out


def make_params(dm: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Every leaf of the model, {name: tensor}, layer leaves stacked [L, ...]."""
    return {name: make_leaf(dm, name, seed, device, dtype) for name in LEAVES}


# ---------------------------------------------------------------------------
# Precision of the products
# ---------------------------------------------------------------------------

def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with one scale per tensor (amax to 448), in the
    forward and, for the gradient flowing back, in the backward too."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g)


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, D] rotated by positions ``pos`` [S] on the two halves
    of each head (the HF ``rotate_half`` layout)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D)
    ang = pos.to(torch.float64)[:, None] * inv[None, :]
    cos = torch.cos(ang).to(F32)[:, None, :]
    sin = torch.sin(ang).to(F32)[:, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, q_pos, k_pos, cast: Callable, chunk: int = 1024):
    """Grouped softmax attention.  q [B, Sq, H, D], k/v [B, Sk, Hkv, D];
    query i sees key j where ``k_pos[j] <= q_pos[i]`` (``k_pos``
    ascending).  Queries in chunks of ``chunk`` rows, each against the
    keys its last row can see, so the scores never exceed
    [B, H, chunk, Sk]."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    kk = cast(k.repeat_interleave(G, dim=2).permute(0, 2, 3, 1))      # [B, H, D, Sk]
    vv = cast(v.repeat_interleave(G, dim=2).permute(0, 2, 1, 3))      # [B, H, Sk, D]
    outs = []
    for i in range(0, Sq, chunk):
        qp = q_pos[i:i + chunk]
        n = int(torch.searchsorted(k_pos, qp.max(), right=True))      # keys visible to the chunk
        qc = cast(q[:, i:i + chunk].permute(0, 2, 1, 3))               # [B, H, c, D]
        s = torch.matmul(qc, kk[..., :n]) / math.sqrt(D)
        s = s.masked_fill(~(k_pos[None, :n] <= qp[:, None]), float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.matmul(cast(p), vv[:, :, :n]).permute(0, 2, 1, 3))
    return torch.cat(outs, dim=1)


def layer_qkv(P: dict, i: int, h: torch.Tensor, pos: torch.Tensor, dm: dict, cast: Callable):
    """q [B, S, H, hd] and k, v [B, S, Hkv, hd] of layer ``i`` at ``pos``."""
    B, S, _ = h.shape
    q = (cast(h) @ cast(P["wq"][i].to(F32))).view(B, S, dm["H"], dm["hd"])
    k = (cast(h) @ cast(P["wk"][i].to(F32))).view(B, S, dm["Hkv"], dm["hd"])
    v = (cast(h) @ cast(P["wv"][i].to(F32))).view(B, S, dm["Hkv"], dm["hd"])
    return rope(q, pos, dm["theta"]), rope(k, pos, dm["theta"]), v


def layer_out(P: dict, i: int, x: torch.Tensor, o: torch.Tensor, dm: dict, cast: Callable):
    """The residual after wo and the SwiGLU of layer ``i``."""
    B, S = x.shape[:2]
    x = x + cast(o.reshape(B, S, -1)) @ cast(P["wo"][i].to(F32))
    h = cast(rms_norm(x, P["norm2"][i], dm["eps"]))
    a = h @ cast(P["w_gate"][i].to(F32))
    b = h @ cast(P["w_up"][i].to(F32))
    return x + cast(F.silu(a) * b) @ cast(P["w_down"][i].to(F32))


def layer(P: dict, i: int, x: torch.Tensor, pos: torch.Tensor, dm: dict, cast: Callable):
    """Layer ``i`` over a whole causal sequence: (x, k, v)."""
    q, k, v = layer_qkv(P, i, rms_norm(x, P["norm1"][i], dm["eps"]), pos, dm, cast)
    return layer_out(P, i, x, attention(q, k, v, pos, pos, cast), dm, cast), k, v


def logits(P: dict, x: torch.Tensor, dm: dict, cast: Callable) -> torch.Tensor:
    return cast(rms_norm(x, P["final_norm"], dm["eps"])) @ cast(P["head"].to(F32))


def embed(P: dict, tokens: torch.Tensor) -> torch.Tensor:
    return P["embed"][tokens.long()].to(F32)


# ---------------------------------------------------------------------------
# Training: loss, gradients, AdamW
# ---------------------------------------------------------------------------

def loss(P: dict, tokens: torch.Tensor, labels: torch.Tensor, dm: dict, cast: Callable):
    """Mean cross-entropy over labels != -100, each layer recomputed in the
    backward (`torch.utils.checkpoint`), so the reference fits beside its
    f32 moments at full width."""
    from torch.utils.checkpoint import checkpoint

    x = embed(P, tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(dm["L"]):
        x = checkpoint(lambda x, i=i: layer(P, i, x, pos, dm, cast)[0], x, use_reentrant=False)
    lg = logits(P, x, dm, cast)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1).long(),
                           ignore_index=-100)


def adamw_step(P: dict, G: dict, state: dict, opt: dict, store_dtype) -> float:
    """One AdamW step in place: global-norm clipping, linear warm-up,
    bias-corrected moments, decoupled weight decay; the parameters are
    rounded to ``store_dtype`` (the dtype they are served in) after it.
    Returns the gradients' global norm before clipping."""
    state["step"] += 1
    t = state["step"]
    lr = opt["lr"] * min(t / max(opt["warmup_steps"], 1), 1.0)
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in G.values())).item()
    scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9)) if opt["grad_clip"] else 1.0
    b1, b2 = opt["b1"], opt["b2"]
    for name, p in P.items():
        g = G[name] * scale
        m = state["m"][name].mul_(b1).add_(g, alpha=1 - b1)
        v = state["v"][name].mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + opt["eps"])
        upd = upd + opt["weight_decay"] * p
        p.sub_(lr * upd).copy_(p.to(store_dtype).to(F32))
    return gnorm


# ---------------------------------------------------------------------------
# Serving: prefill, then decode through a cache at given positions
# ---------------------------------------------------------------------------

@torch.no_grad()
def serve(P: dict, dm: dict, prompt: torch.Tensor, fed: list, positions: list, cap: int,
          cast: Callable = identity) -> torch.Tensor:
    """Logits [1 + len(fed), vocab] of a served request.

    Row 0: the prompt's last position after a causal prefill of
    ``prompt`` [S] at positions 0..S-1.  Row j (j >= 1): token ``fed[j-1]``
    written into a cache of ``cap`` rows at row ``positions[j-1]`` (its
    RoPE position too) and attending rows 0..positions[j-1] of that cache:
    the prompt's keys and values, the decoded tokens' where they were
    written, and zeros in rows nothing has written."""
    dev = prompt.device
    S = prompt.shape[0]
    x = embed(P, prompt[None])
    pos = torch.arange(S, device=dev)
    kc, vc = [], []
    for i in range(dm["L"]):
        x, k, v = layer(P, i, x, pos, dm, cast)
        kbuf = torch.zeros((1, cap, dm["Hkv"], dm["hd"]), dtype=F32, device=dev)
        vbuf = torch.zeros_like(kbuf)
        kbuf[:, :S], vbuf[:, :S] = k, v
        kc.append(kbuf)
        vc.append(vbuf)
    out = [logits(P, x[:, -1:], dm, cast)[0, 0]]
    rows = torch.arange(cap, device=dev)
    for tok, p in zip(fed, positions):
        x = embed(P, torch.tensor([[tok]], device=dev))
        at = torch.tensor([p], device=dev)
        for i in range(dm["L"]):
            q, k, v = layer_qkv(P, i, rms_norm(x, P["norm1"][i], dm["eps"]), at, dm, cast)
            kc[i][:, p], vc[i][:, p] = k[:, 0], v[:, 0]
            o = attention(q, kc[i][:, :p + 1], vc[i][:, :p + 1], at, rows[:p + 1], cast)
            x = layer_out(P, i, x, o, dm, cast)
        out.append(logits(P, x, dm, cast)[0, 0])
    return torch.stack(out)[:, : dm["vocab_padded"]]
