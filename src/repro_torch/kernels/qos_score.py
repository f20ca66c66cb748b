"""QoS scoring on the card: launcher of ``csrc/qos_score.cu``.

    lat [n, T] ms (f32 or bf16, newest sample last) -> N [n] f32 in [-1, 1]

Replaces the Pallas kernel `repro.kernels.qos_score._qos_kernel`.  The
plain version is `repro_torch.core.qos.network_score`.  Rows are not
padded in time or count; per-query windows arrive flattened to
``[n_q * n_servers, T]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.qos import DEFAULT_QOS, QosParams
from repro_torch.kernels import _build

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("qos_score").qos_scores
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def kernel_params(p: QosParams, T: int) -> tuple[int, "ctypes.Array"]:
    """(real window length, the 17 f32 constants the kernel reads).

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
    err = _fn()(
        lat.data_ptr(), int(lat.dtype == torch.bfloat16), out.data_ptr(), n, T,
        window, ctypes.cast(params, ctypes.c_void_p), _build.stream_ptr(lat.device),
    )
    _build.check(err, "qos_scores kernel")
    qos_scores_cuda.launches += 1
    return out


qos_scores_cuda.launches = 0
