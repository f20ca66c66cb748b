"""QoS scoring on the card: launcher of ``csrc/qos_score.cu``.

    lat [n, T] ms (f32 or bf16, newest sample last) -> N [n] f32 in [-1, 1]

Replaces the Pallas kernel `repro.kernels.qos_score._qos_kernel`.  The
plain version is `repro_torch.core.qos.network_score`.  Rows are not
padded in time or count; per-query windows arrive flattened to
``[n_q * n_servers, T]``.  `launch_plan` picks how the kernel reads a
window: the load width, the lanes per row and the mode.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.qos import DEFAULT_QOS, QosParams
from repro_torch.kernels import _build

RESIDENT_MAX = 256   # longest window read once (csrc/qos_score.cu)
LANE_SAMPLES = 16    # samples a lane reads of such a row
RING_MIN_ROWS = 65_536   # smallest window the ring mode takes
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("qos_score").qos_scores
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


MODES = ("stream", "registers", "ring")   # the C interface's mode numbers


@dataclasses.dataclass(frozen=True)
class QosPlan:
    """How the kernel reads an [n, T] window."""

    vec: int    # samples per load: 4 (f32) or 8 (bf16) = 16 bytes, or 1
    group: int  # lanes per row, a power of two up to 32
    mode: str   # "ring": 16-byte chunks through a per-lane cp.async ring,
                # read once; "registers": read once into registers;
                # "stream": longer rows, the trailing window read twice


def launch_plan(T: int, dtype: torch.dtype, data_ptr: int, n: int) -> QosPlan:
    """16-byte loads where the row stride and the base address allow them
    (T a multiple of 4 f32 or 8 bf16 samples, a 16-byte aligned base; an
    offset view may not be), else scalar loads; the fewest lanes per row
    (a power of two, at most 32) that read at most LANE_SAMPLES samples
    each.  Rows up to RESIDENT_MAX samples are read once: through the ring
    when the loads are 16 bytes and the window has RING_MIN_ROWS rows or
    more (enough 32-row tiles to keep every warp of the card streaming),
    else into registers, one row per lane group (a small window finishes
    sooner spread over more blocks)."""
    return _plan(T, dtype, data_ptr % 16 == 0, n >= RING_MIN_ROWS)


@functools.lru_cache(maxsize=256)
def _plan(T: int, dtype: torch.dtype, aligned: bool, large: bool) -> QosPlan:
    wide = 8 if dtype == torch.bfloat16 else 4
    vec = wide if T % wide == 0 and aligned else 1
    per_lane = -(-T // LANE_SAMPLES)
    group = min(32, 1 << (per_lane - 1).bit_length())
    if T > RESIDENT_MAX:
        mode = "stream"
    elif vec > 1 and large:
        mode = "ring"
    else:
        mode = "registers"
    return QosPlan(vec=vec, group=group, mode=mode)


@functools.lru_cache(maxsize=64)
def kernel_params(p: QosParams, T: int) -> tuple[int, "ctypes.Array"]:
    """(real window length, the 17 f32 constants the kernel reads), cached
    by (params, T): the array is shared and must not be written.

    The carry (1 - alpha)^T is a double rounded once to f32, as the
    reference's Python float is; n_w and the centred positions' sum of
    squares are exact in f32 for any window a fleet uses."""
    window = min(p.window, T)
    a = p.ewma_alpha
    centre = (window - 1) / 2.0
    sum_x2 = sum((j - (window - 1) + centre) ** 2 for j in range(window))
    vals = [
        p.ideal_low_ms, p.ideal_high_ms, p.base_scale_ms,
        a, 1.0 - a, (1.0 - a) ** T,
        p.trend_scale_ms, p.cv_low, p.cv_scale,
        p.w_high, p.w_trend, p.w_outage, p.w_instab,
        p.offline_ms, p.outage_risk_ms,
        float(window), sum_x2,
    ]
    return window, (ctypes.c_float * len(vals))(*vals)


def qos_scores_cuda(lat: torch.Tensor, p: QosParams = DEFAULT_QOS) -> torch.Tensor:
    """Launch the QoS kernel on a CUDA [n, T] window; adds one to
    ``qos_scores_cuda.launches`` per launch."""
    lat = _build.require(lat, "qos_scores lat", 2, (torch.float32, torch.bfloat16))
    n, T = lat.shape
    if T < 1:
        raise ValueError("qos_scores: the window needs at least one sample")
    out = torch.empty((n,), dtype=torch.float32, device=lat.device)
    if n == 0:
        return out
    window, params = kernel_params(p, T)
    ptr = lat.data_ptr()
    plan = launch_plan(T, lat.dtype, ptr, n)
    err = _fn()(
        ptr, int(lat.dtype == torch.bfloat16), out.data_ptr(), n, T, window, params,
        plan.vec, plan.group, MODES.index(plan.mode), _build.stream_ptr(lat.device),
    )
    _build.check(err, "qos_scores kernel")
    qos_scores_cuda.launches += 1
    return out


qos_scores_cuda.launches = 0
