"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library under ``build/repro_torch_kernels/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and flags, at the first call
that needs one; all missing libraries are built at once, one ``nvcc``
process per source started together.  Importing this module builds
nothing and never looks for ``nvcc``.

The libraries take raw device pointers and the CUDA stream as
``ctypes.c_void_p``, launch on that stream and return
``cudaGetLastError()``; `check` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("bm25_score", "qos_score", "score_fuse", "select_fuse", "flash_attention",
           "decode_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}   # name -> loaded ctypes.CDLL, for the life of the process


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, /usr/local/cuda/bin, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    """Build directory keyed by the sources' and flags' content."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every library that is missing, in parallel; name -> path."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: out / f"lib{name}.so" for name in SOURCES}
    jobs = []
    compiler = None
    for name, so in paths.items():
        if so.exists():
            continue
        compiler = compiler or nvcc()
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        log_path = out / f"{name}.log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            )
        jobs.append((name, proc, tmp, so, log_path))
    failed = []
    for name, proc, tmp, so, log_path in jobs:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{log_path.read_text()}")
        else:
            os.replace(tmp, so)       # atomic: a concurrent process sees all or nothing
    if failed:
        raise RuntimeError("repro_torch: nvcc failed for " + "\n".join(failed))
    return paths


def build_logs() -> dict:
    """name -> nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    out = build_dir()
    return {
        name: (out / f"{name}.log").read_text()
        for name in SOURCES if (out / f"{name}.log").exists()
    }


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(paths[name]))
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error (refused launch, bad args)."""
    if err != 0:
        raise RuntimeError(f"repro_torch: {what} failed with CUDA error {err}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an address."""
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, what: str, ndim: int, dtypes: tuple) -> torch.Tensor:
    """Check an operand a kernel reads: CUDA, dtype, rank, contiguity."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    return t


ROWS = ("tool_qos", "tool_load", "tool_rtt", "tool_dead", "tool_aff")


def pack_rows(rows: dict, n_q: int, n_t: int, what: str):
    """The fused kernels' per-tool rows (``ROWS`` order; ``tool_qos``
    required, the others may be None): checked f32 CUDA tensors of shape
    [n_t] (broadcast, stride 0) or [n_q, n_t] (per query, stride n_t).
    Returns two lists, the device addresses (None when absent) and the
    strides, for the C interface."""
    ptrs, strides = [None] * len(ROWS), [0] * len(ROWS)
    for j, name in enumerate(ROWS):
        t = rows.get(name)
        if t is None:
            if name == "tool_qos":
                raise ValueError(f"{what}: tool_qos is required")
            continue
        require(t, f"{what} {name}", t.ndim, (torch.float32,))
        if t.shape[-1] != n_t or t.ndim not in (1, 2) or (t.ndim == 2 and t.shape[0] != n_q):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)}")
        ptrs[j] = t.data_ptr()
        strides[j] = n_t if t.ndim == 2 else 0
    return ptrs, strides


def live_weights_ptr(live_weights, what: str):
    """Device address of a live [alpha, beta, gamma, delta] f32 vector, or
    None for static weights."""
    if live_weights is None:
        return None
    wl = require(live_weights, f"{what} live_weights", 1, (torch.float32,))
    if wl.shape[0] != 4:
        raise ValueError(f"{what}: live weights are [alpha, beta, gamma, delta]")
    return wl.data_ptr()
