"""Deterministic operand quantization for the routing hot path, port of
`repro.core.quantize`.

* ``quantize_bf16`` — round f32 values to the nearest bfloat16
  (round-to-nearest-even, through torch's bf16 cast) and return them
  widened back to f32: storing the result as bf16 and upcasting later
  reproduces the same floats bit for bit.
* ``quantize_int8_rows`` / ``dequantize_int8_rows`` — symmetric int8 with
  one f32 scale per row, ``scale = max_abs / 127``.

Quantization happens once, when the index or the telemetry is built, so
every routing path consumes identical rounded operands; all arithmetic
after it is f32.
"""
from __future__ import annotations

import numpy as np
import torch

WEIGHT_DTYPES = ("float32", "bfloat16", "int8")


def quantize_bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 -> nearest bf16 (ties-to-even), widened back to f32.

    Special values (±inf, nan) survive the round trip.
    """
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    t = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)
    return t.numpy()


def quantize_int8_rows(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8: returns ``(q, scales)`` with
    ``q in [-127, 127]`` (int8) and ``scales`` f32 of shape ``x.shape[:-1]``
    (1.0 for all-zero rows); rounding is banker's rounding via ``np.rint``.
    """
    x = np.asarray(x, np.float32)
    max_abs = np.max(np.abs(x), axis=-1)
    scales = np.where(max_abs > 0, max_abs / 127.0, 1.0).astype(np.float32)
    q = np.rint(x / scales[..., None]).astype(np.int8)
    return q, scales


def dequantize_int8_rows(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_int8_rows` (f32 output)."""
    return (q.astype(np.float32) * np.asarray(scales, np.float32)[..., None])


def round_weights(x: np.ndarray, dtype: str) -> np.ndarray:
    """Round an operand array per the storage-dtype contract
    (``dtype`` in ``WEIGHT_DTYPES``); always returns f32 values."""
    if dtype in ("float32", "f32", None):
        return np.asarray(x, np.float32)
    if dtype in ("bfloat16", "bf16"):
        return quantize_bf16(x)
    if dtype == "int8":
        return dequantize_int8_rows(*quantize_int8_rows(x))
    raise ValueError(f"unknown weights dtype {dtype!r}; use one of {WEIGHT_DTYPES}")
