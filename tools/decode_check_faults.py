"""Shows that chip_smoke.py phase 3l (c)'s check of the decode kernel fails on
a wrong kernel.

    python3 tools/decode_check_faults.py

Builds three faulty copies of ``csrc/decode_attention.cu`` in a temporary
directory: the merge reading split 0's partial in place of split 1's
("split 0 twice"), the merge leaving the last split's partial out of the
numerator ("last split's acc lost"), and the merge giving the last split no
weight at all ("last split dropped").  Runs the kernel as built from the
sources and each copy at phase 3l (c)'s shape (8 sequences, [8, 32768, 8,
128] caches in the model's layout, 16 query heads, bf16, 8 splits; full and
ragged lengths), on the check's operands (v with block means of std 4,
``chip_smoke.decode_check_operands``) and on flat standard-normal operands
(the check's inputs before it had block means), and prints for each the
max abs error against ``decode_ref`` and whether rtol = atol = 2e-2 holds.
Exits non-zero unless the kernel passes every case and each faulty copy
fails on the check's operands.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

_NUM = "for (int s = 0; s < n_split; ++s) num = fmaf(ws[s * G + g], pp[s * stride + i], num);"
_W = "const float w = expf(pp[s * stride + G * D + g] - mx);"
FAULTS = {
    "split 0 twice": (_NUM, _NUM.replace("pp[s * stride", "pp[(s == 1 ? 0 : s) * stride")),
    "last split's acc lost": (_NUM, _NUM.replace("s < n_split;", "s < n_split - 1;")),
    "last split dropped": (_W, _W.replace("= expf", "= s == n_split - 1 ? 0.0f : expf")),
}
B, S = 8, 32768


def build_faulty(tmp: Path) -> dict:
    """fault -> its ctypes entry point, all copies compiled at once."""
    jobs = {}
    for i, (name, (old, new)) in enumerate(FAULTS.items()):
        src = tmp / f"fault{i}"
        shutil.copytree(_build.CSRC, src)
        cu = src / "decode_attention.cu"
        text = cu.read_text()
        if text.count(old) != 1:
            sys.exit(f"decode_check_faults: the kernel no longer has {old!r} once")
        cu.write_text(text.replace(old, new))
        so = src / "libdecode_attention.so"
        jobs[name] = (so, subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                            str(cu)], stdout=subprocess.DEVNULL))
    fns = {}
    for name, (so, proc) in jobs.items():
        if proc.wait() != 0:
            sys.exit(f"decode_check_faults: nvcc failed for {name!r}")
        fn = ctypes.CDLL(str(so)).decode_attention
        fn.argtypes, fn.restype = dec._fn().argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def check(q, k, v, lens, Hkv, G, D) -> tuple:
    """(max abs error, whether allclose at ATTN_TOL holds), as phase 3l (c) holds it."""
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=q.device)
    out = ops.decode_attention(q, k, v, lengths).float()
    ref = kref.decode_ref(q.reshape(B, Hkv, G, D), k, v, lengths.reshape(B, 1),
                          sm_scale=1 / math.sqrt(D)).reshape(q.shape).float()
    tol = chip_smoke.ATTN_TOL["bfloat16"]
    return float((out - ref).abs().max()), bool(torch.allclose(out, ref, rtol=tol, atol=tol))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("decode_check_faults: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    Hkv, Hq, D = 8, 16, 128
    print(f"splits of each (sequence, kv head): {dec.decode_splits(B * Hkv, S)}")
    kernels = {"kernel": dec._fn()}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        kernels.update(build_faulty(Path(tmp)))
        for mean_std in (chip_smoke.DECODE_MEAN_STD, 0.0):
            q, k, v = chip_smoke.decode_check_operands(B, S, Hkv, Hq, D, dev, seed=11,
                                                        mean_std=mean_std)
            for name, fn in kernels.items():
                dec._FN = fn
                res = [check(q, k, v, lens, Hkv, Hq // Hkv, D)
                       for lens in chip_smoke.decode_check_lengths(B, S)]
                print(f"v block means of std {mean_std}: {name}: max abs "
                      f"{[round(e, 5) for e, _ in res]} (full, ragged lengths), the check "
                      f"{'passes' if all(ok for _, ok in res) else 'fails'}")
                held = all(ok for _, ok in res)
                if (name == "kernel") != held and (name == "kernel" or mean_std):
                    bad.append(f"{name} at block means of std {mean_std}")
            del q, k, v
        dec._FN = kernels["kernel"]
    if bad:
        sys.exit(f"decode_check_faults: not as expected: {bad}")
    print("decode_check_faults: the kernel passes; every faulty copy fails the check")


if __name__ == "__main__":
    main()
