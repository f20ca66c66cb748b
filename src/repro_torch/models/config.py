"""Model configuration, twin of `repro.models.config`.

The same frozen dataclass, fields and defaults as the reference, so a
configuration carried across (`convert.model_config_from_dict`) means the
same thing.  The port serves decoder-only text models (attention, Mamba-2
and xLSTM blocks, dense or MoE FFNs); the other families' fields are kept
so configurations and `param_counts` agree.

``attn_impl`` keeps the reference's values.  ``"naive"`` and
``"chunked"`` are the plain PyTorch attention paths; ``"pallas"`` means
the repository's hand-written attention kernels: on the card
``csrc/flash_attention.cu`` for prefill and ``csrc/decode_attention.cu``
for decode (their plain versions for CPU tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                         # dense FFN hidden (0 => family default)
    vocab_size: int

    head_dim: Optional[int] = None    # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- block pattern ------------------------------------------------------
    # one repetition of the layer pattern, cycled over n_layers; entries in
    # {"attn", "mamba", "mlstm", "slstm"}.  Dense archs: ("attn",).
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert hidden
    moe_every: int = 1                # MoE FFN every k-th layer
    first_k_dense: int = 0            # leading layers keep dense FFN
    dense_d_ff: int = 0               # hidden of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- Mamba (SSD) ----------------------------------------------------------
    mamba_expand: int = 2
    mamba_d_state: int = 64
    mamba_head_dim: int = 64
    mamba_d_conv: int = 4
    mamba_chunk: int = 128

    # --- xLSTM -----------------------------------------------------------------
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    mlstm_chunk: int = 128

    # --- enc-dec (whisper) ------------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500        # stub frontend output length

    # --- VLM ----------------------------------------------------------------------
    n_vision_tokens: int = 0          # stub patch embeddings prefixed to text

    # --- execution knobs -------------------------------------------------------
    # remat / scan_layers / analysis_unroll are the reference's XLA knobs;
    # the port keeps them so a configuration carries across, and runs its
    # layers as a Python loop without rematerialisation whatever they say.
    dtype: str = "bfloat16"
    remat: str = "full"               # none|full|dots
    attn_impl: str = "chunked"        # naive|chunked (plain q-chunks)|pallas (the CUDA kernels)
    attn_chunk: int = 512             # q-chunk of the chunked path
    scan_layers: bool = True
    logits_f32: bool = True
    analysis_unroll: bool = False

    # ------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256, as the reference pads it; the embedding,
        the head and the logits span all of it (92544 -> 92672 for
        internlm2-1.8b)."""
        return int(-(-self.vocab_size // 256) * 256)

    @property
    def torch_dtype(self) -> torch.dtype:
        """The parameters' and activations' dtype (the reference's ``jdtype``)."""
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def d_inner(self) -> int:         # mamba inner width
        return self.mamba_expand * self.d_model

    @property
    def mamba_heads(self) -> int:
        return self.d_inner // self.mamba_head_dim

    def layer_kinds(self) -> list:
        """Per-layer mixer kind for the full stack."""
        pat = self.block_pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def layer_is_moe(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_k_dense:
            return False
        return (i % self.moe_every) == (self.moe_every - 1)

    def ffn_hidden(self, i: int) -> int:
        if self.layer_is_moe(i):
            return self.moe_d_ff
        if i < self.first_k_dense and self.dense_d_ff:
            return self.dense_d_ff
        return self.d_ff

    # --- parameter counting (for roofline MODEL_FLOPS) -------------------------
    def param_counts(self) -> dict:
        """Returns dict(total=..., active=...) — analytic, matches init."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        total = active = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
            active += self.vocab_size * d
        nH = self.n_heads
        attn_p = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
        if self.qkv_bias:
            attn_p += (nq + 2 * nkv) * hd
        for i, kind in enumerate(self.layer_kinds()):
            t = 0
            if kind == "attn":
                t += attn_p + d                      # + norm2
            elif kind == "mamba":
                di, ns = self.d_inner, self.mamba_d_state
                nHm = self.mamba_heads
                t += d * 2 * di                      # in-proj (x, z)
                t += di * self.mamba_d_conv + di     # conv w + b
                t += di * 2 * ns                     # B, C proj
                t += di * nHm + 3 * nHm              # dt proj; dt_bias/A/D
                t += di * d + d                      # out proj + norm2
            elif kind == "mlstm":
                di = int(self.mlstm_proj_factor * d)
                t += 2 * d * di                      # up (x, z)
                t += 4 * di * di                     # q, k, v, o
                t += 2 * di * nH + 2 * nH            # i/f gates + biases
                t += di + di * d                     # norm + down
            elif kind == "slstm":
                dh = d // nH
                dff = int(self.slstm_proj_factor * d)
                t += 4 * d * d + nH * dh * 4 * dh + 4 * d   # w, r, b
                t += 3 * d * dff                             # GLU ffn
            t += d                                   # norm1
            a = t
            # FFN sublayer (attn/mamba blocks only)
            if kind in ("attn", "mamba"):
                if self.layer_is_moe(i):
                    e, k, sh = self.n_experts, self.experts_per_token, self.n_shared_experts
                    per = 3 * d * self.moe_d_ff
                    t += e * per + sh * per + d * e  # experts + shared + router
                    a += (k + sh) * per + d * e
                else:
                    h = self.ffn_hidden(i)
                    if h:
                        t += 3 * d * h
                        a += 3 * d * h
            total += t
            active += a
        total += d                                   # final norm
        active += d
        if self.n_vision_tokens:
            total += d * d                           # vision_proj
            active += d * d
        if self.is_encoder_decoder:
            enc = self.n_encoder_layers * (attn_p + 3 * d * self.d_ff + 2 * d) + d
            cross = self.n_layers * (attn_p + d)
            total += enc + cross
            active += enc + cross
        return {"total": int(total), "active": int(active)}
