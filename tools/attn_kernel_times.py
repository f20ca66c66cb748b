"""Device time per call of the port's two attention kernels on one card.

    python3 tools/attn_kernel_times.py

Times `ops.flash_attention` (bf16, causal, [1, 16, S, 128] queries against 8
kv heads, S 2048 and 1536) and `ops.decode_attention` (bf16, 8 slots x 16
heads against [8, 2048, 8, 128] caches in the model's layout, full and
1537-row lengths) at the serving path's shapes, as the device time per call
that `torch.profiler` gives over 20 calls after a warm-up: the kernels
alone (split and merge for decode), without the wrappers' host work.  Each
flash output is also checked against `mha_ref` (max abs error printed).
Builds the kernels on first use, like any caller; needs a CUDA card.
"""
from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402


def device_us(fn, n: int = 20) -> dict:
    """Device time per call by kernel name (us), over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / n
            for e in prof.key_averages() if e.self_device_time_total}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("attn_kernel_times: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for S in (2048, 1536):
        q, k, v = rnd(1, 16, S, 128), rnd(1, 8, S, 128), rnd(1, 8, S, 128)
        err = (ops.flash_attention(q, k, v).float()
               - kref.mha_ref(q, k, v, sm_scale=1 / math.sqrt(128)).float()).abs().max()
        print(f"flash_attention S {S}: max abs err {float(err):.3g}; device us per call "
              f"{device_us(lambda: ops.flash_attention(q, k, v))}")
    qd, kc, vc = rnd(8, 16, 128), rnd(8, 2048, 8, 128), rnd(8, 2048, 8, 128)
    for n in (2048, 1537):
        lens = torch.full((8,), n, dtype=torch.int32, device=dev)
        us = device_us(lambda: ops.decode_attention(qd, kc.transpose(1, 2), vc.transpose(1, 2),
                                                    lens))
        print(f"decode_attention lengths {n}: device us per call {us}")


if __name__ == "__main__":
    main()
