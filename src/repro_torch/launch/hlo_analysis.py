"""Roofline terms of a step counted on meta tensors, twin of
`repro.launch.hlo_analysis`.

There is no HLO here: no compiler partitions or costs a PyTorch program.
The reference reads XLA's cost analysis and collective schedule off a
compiled module (`parse_collectives`, `analyze`); the port has no twin of
either.  Instead `StepCounter`, a dispatch mode, watches one step run on
``meta`` tensors (shapes and dtypes only, no memory, no data) and counts:

  * the operations of each matrix product, by its operands' dtype, with
    `torch.utils.flop_counter`'s formulas (2 m n k for a product);
  * the bytes of every op's inputs and outputs (the twin of XLA's "bytes
    accessed"; views move nothing, a broadcast input counts its own size);
  * the peak of live tensor bytes made by the step (each storage from the
    op that makes it to its release), each divided by the devices it would
    be split over (`StepCounter`'s ``divisor``);
  * the work the port's CUDA kernels would do, as `repro_torch.kernels.ops`
    reports it for a call on meta tensors (it launches nothing).

The recompute of `torch.utils.checkpoint` (remat, the chunked attention's
chunks) runs in the backward on meta too, so it is counted as it runs on
the card.  `repro_torch.launch.dryrun` turns the counts into a `Roofline`:

    compute    = sum over dtypes of ops / (chips * peak of that dtype)
    memory     = bytes / (chips * HBM_BW)
    collective = collective bytes per device / LINK_BW

with the collective bytes from the layout and the reference's ring
weights (per-device bytes moved):

    all-gather       : result bytes  x 1
    all-reduce       : result bytes  x 2      (reduce-scatter + all-gather)
    reduce-scatter   : operand bytes x 1

Hardware constants, NVIDIA H100 SXM (data sheet): 989 TFLOP/s bf16 dense
on the tensor cores, 67 TFLOP/s f32 outside them (TF32 stays off in the
port), 3.35 TB/s HBM3, NVLink 450 GB/s each way.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops as kernel_ops

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores / card
PEAK_FLOPS_F32 = 67e12     # f32 outside the tensor cores / card
HBM_BW = 3.35e12           # bytes/s / card
LINK_BW = 450e9            # bytes/s / card, NVLink each way

_PEAK_BY_DTYPE = {
    "bfloat16": PEAK_FLOPS,
    "float16": PEAK_FLOPS,
    "float32": PEAK_FLOPS_F32,
}

# ring weights of the kinds the dry-run counts (module docstring)
_WEIGHT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0}


def peak_of(dtype) -> float:
    """Operations per second of a matrix product on operands of ``dtype``
    (a dtype or its name); f32 for any other."""
    name = str(dtype).replace("torch.", "")
    return _PEAK_BY_DTYPE.get(name, PEAK_FLOPS_F32)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def add(self, kind: str, nbytes: float) -> None:
        """One collective of ``kind`` over ``nbytes`` (its side of the ring
        weight), weighted as the reference weighs it."""
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + _WEIGHT[kind] * nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


@dataclasses.dataclass
class Roofline:
    flops: float               # per-device operations
    hbm_bytes: float           # per-device bytes accessed
    collective_bytes: float    # per-device bytes moved on NVLink
    chips: int
    collectives: CollectiveStats
    model_flops: float = 0.0   # 6*N*D (global, useful flops)
    per_device_peak_bytes: float = 0.0
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)   # per device, by name

    @property
    def t_compute(self) -> float:
        """Each dtype's operations at its peak (all at the bf16 peak when
        the split is unknown)."""
        if not self.flops_by_dtype:
            return self.flops / PEAK_FLOPS
        return sum(n / peak_of(dt) for dt, n in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time model: overlapped max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        if self.flops <= 0:
            return 0.0
        return self.model_flops / (self.flops * self.chips)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the per-card bf16 peak the *useful* model flops
        achieve at the roofline step time."""
        if self.step_time_s <= 0:
            return 0.0
        useful_per_chip = self.model_flops / self.chips
        return useful_per_chip / (self.step_time_s * PEAK_FLOPS)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_bytes_by_kind": self.collectives.bytes_by_kind,
            "collective_count_by_kind": self.collectives.count_by_kind,
            "per_device_peak_bytes": self.per_device_peak_bytes,
            "flops_by_dtype_per_device": self.flops_by_dtype,
        }


def slstm_correction(cfg, shape, chips: int) -> tuple:
    """The reference's analytic (flops, bytes) per device for the sLSTM
    time-scan bodies its cost analysis counts once: (L-1) x body, train
    ~3x (forward + remat recompute + backward).  Kept for parity; the
    port's dry-run runs every sLSTM token on meta (or counts a few and
    scales them, `repro_torch.launch.dryrun`), so it adds no correction."""
    n_slstm = sum(1 for k in cfg.layer_kinds() if k == "slstm")
    if n_slstm == 0:
        return 0.0, 0.0
    d = cfg.d_model
    nH = cfg.n_heads
    dh = d // nH
    if shape.kind == "decode":
        return 0.0, 0.0                      # single step: counted exactly
    # per-device batch under batch->(pod,data) sharding on a 16(x16) mesh:
    B_loc = max(shape.global_batch // 16, 1) if chips == 256 else max(shape.global_batch // 32, 1)
    L = shape.seq_len
    mult = 3.0 if shape.kind == "train" else 1.0
    flops_step = 2.0 * B_loc * nH * dh * 4 * dh + 25.0 * B_loc * d
    bytes_step = (8.0 * B_loc * d) * 4.0 + nH * dh * 4 * dh * 4.0
    return (
        mult * n_slstm * (L - 1) * flops_step,
        mult * n_slstm * (L - 1) * bytes_step,
    )


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode: D = batch tokens."""
    counts = cfg.param_counts()
    n = counts["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


# ---------------------------------------------------------------------------
# Counting mode
# ---------------------------------------------------------------------------

_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.new_empty.default, torch.ops.aten.new_empty_strided.default,
    torch.ops.aten.empty_like.default,
}


def dense_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor's elements take, a broadcast (stride-0) dim counted
    once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (y for y in x if isinstance(y, torch.Tensor))


class StepCounter(TorchDispatchMode):
    """Counts what the ops run under it do (see the module docstring).

    ``divisor(t)`` gives the devices a new tensor ``t`` would be split
    over, for the per-device live peak (1 by default).  ``observe(func,
    args, kwargs, out)`` is called after each op that is not a view (the
    dry-run's collective count reads matrix products there).  Tensors
    made before the mode was entered (parameters, optimizer state, inputs)
    are not in the live peak: the caller adds them.

    Results: ``ops_by_dtype`` {dtype name: operations}, ``hbm_bytes``,
    ``peak_bytes`` and ``kernels`` {name: {"calls", "ops", "bytes"}}."""

    def __init__(self, divisor: Optional[Callable] = None, observe: Optional[Callable] = None):
        super().__init__()
        self.ops_by_dtype: dict = {}
        self.hbm_bytes = 0.0
        self.kernels: dict = {}
        self.live_bytes = 0.0
        self.peak_bytes = 0.0
        self._divisor = divisor
        self._observe = observe
        self._alive: dict = {}              # id(storage) -> (bytes, weakref)

    # the kernels' work, reported by repro_torch.kernels.ops on meta
    def _kernel(self, name: str, n_ops: float, n_bytes: float, dtype) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "ops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["ops"] += n_ops
        k["bytes"] += n_bytes
        dt = str(dtype).replace("torch.", "")
        self.ops_by_dtype[dt] = self.ops_by_dtype.get(dt, 0.0) + n_ops
        self.hbm_bytes += n_bytes

    def __enter__(self):
        kernel_ops.meta_listeners.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_ops.meta_listeners.remove(self._kernel)
        return super().__exit__(*exc)

    def _release(self, key: int) -> None:
        nbytes, _ = self._alive.pop(key)
        self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in inputs or key in self._alive:
            return
        nbytes = st.nbytes() / (self._divisor(t) if self._divisor else 1)
        self._alive[key] = (nbytes, weakref.ref(st, lambda _r, k=key: self._release(k)))
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors(args)) + list(_tensors(kwargs.values()))
        outs = list(_tensors(out if isinstance(out, (list, tuple)) else (out,)))
        in_keys = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            self._track(t, in_keys)
        if func.is_view or func in _NO_TRAFFIC:
            return out
        self.hbm_bytes += sum(dense_bytes(t) for t in ins) + sum(dense_bytes(t) for t in outs)
        packet = func._overloadpacket
        if packet in flop_registry and ins:
            dt = str(ins[-1].dtype).replace("torch.", "")
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.ops_by_dtype[dt] = self.ops_by_dtype.get(dt, 0.0) + n
        if self._observe is not None:
            self._observe(func, args, kwargs, out)
        return out
