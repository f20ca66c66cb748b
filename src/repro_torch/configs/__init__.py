"""Architecture registry and input shapes, twin of `repro.configs`.

All ten of the reference's architectures are here (`PORTED` equals
`ARCHS`): the dense GQA decoders internlm2-1.8b, qwen2-7b, yi-6b and
minitron-4b, the MoE decoders deepseek-moe-16b and llama4-scout-17b-a16e,
the Mamba-2 hybrid jamba-1.5-large-398b, the xLSTM stack xlstm-125m, the
encoder-decoder whisper-tiny and the VLM internvl2-1b, each module
exporting ``CONFIG`` (the published shape) and ``reduced()`` (a tiny
same-family config for CPU tests), byte for byte the reference's.
`get_config` and `get_reduced` raise `KeyError` for an unknown name.
`ARCHS`, `SHAPES` and `cells` are the reference's grid, unchanged.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "jamba-1.5-large-398b",
    "internlm2-1.8b",
    "qwen2-7b",
    "minitron-4b",
    "yi-6b",
    "deepseek-moe-16b",
    "llama4-scout-17b-a16e",
    "whisper-tiny",
    "xlstm-125m",
    "internvl2-1b",
]

# the architectures this port serves: every one of the reference's
PORTED = list(ARCHS)

# archs with sub-quadratic sequence mixing (run long_500k)
SUBQUADRATIC = {"jamba-1.5-large-398b", "xlstm-125m"}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def _module(arch: str):
    if arch not in PORTED:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}"
    )


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def shape_supported(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True


def cells(include_skipped: bool = False):
    """All (arch, shape) pairs of the assignment grid."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            if include_skipped or shape_supported(a, s):
                out.append((a, s))
    return out
