"""Time of the sharded engine's stage-1 selection at the mega route's shape, on one card.

    python3 tools/stage1_kernel_times.py

Builds the mega route's fleet (`mega_fleet_index(1_000_000)`, bf16 weights,
4 shards, SONAR-FT, top_s 8, top_k 16), routes 256 queries with 5 % of the
servers failed, and keeps the operands that stage 1 hands `ops.stage1_topk`
(template scores [256, 15], doc map, dead, valid and ids, [4, 250000]
each).  It checks the kernel's results against the plain version run on CPU
copies (values bit for bit, ids equal), then prints, per call:

- the kernel alone (scan and merge): device time from `torch.profiler` over
  20 calls;
- the kernel in its window: CUDA events around the wrapper's call, median
  of 25 (the wrapper's host work counts where it is the slower side);
- the plain version on the card (`kernels/ref.stage1_topk_ref`: gather, two
  `torch.where`s, a stable `torch.sort`), window and alone;
- `torch.topk` over the gathered and masked [4, 256, 250000] scores, the
  library yardstick (it promises no order among ties), window and alone;
- the byte bound: the operands read once and the results written once at
  3.35 TB/s.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import dataset  # noqa: E402
from repro_torch.core.mesh_routing import make_sharded_engine  # noqa: E402
from repro_torch.core.routing import RoutingConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.traffic import mega_fleet_index  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def window_ms(fn, n: int = 25) -> float:
    """Median CUDA-event ms of ``n`` calls after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def alone_ms(fn, n: int = 20):
    """Device ms per call summed over the kernels ``fn`` launches, and the
    kernels by name (us per call), from the profiler over ``n`` calls.  The
    profiler now and then loses some device records; a profile in which a
    kernel's count of records is not a multiple of ``n`` is taken again, up
    to three times, and then reads as not measured (None)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total]
        if events and all(e.count % n == 0 for e in events):
            per = {e.key[:60]: e.self_device_time_total / n for e in events}
            return sum(per.values()) / 1e3, per
    return None, {}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("stage1_kernel_times: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    n = 1_000_000
    index = mega_fleet_index(n, weights_dtype="bfloat16")
    eng = make_sharded_engine("sonar_ft", cfg=RoutingConfig(top_s=8, top_k=16), n_shards=4,
                              index=index)
    texts = [q.text for q in dataset.build_query_dataset(n=256, seed=1)]
    rng = np.random.default_rng(0)
    compact = rng.uniform(20, 300, (16, 32)).astype(np.float32)
    kw = dict(server_load=(rng.random(n) * 1.5).astype(np.float32),
              telemetry_age_s=(rng.random(n) * 400).astype(np.float32),
              failed_mask=rng.random(n) < 0.05,
              telemetry_templates=(compact, (np.arange(n) * 2654435761) % 16))
    grabbed = []
    real = ops.stage1_topk

    def grab(*a, **k):
        grabbed.append((a, k))
        return real(*a, **k)

    ops.stage1_topk = grab
    try:
        eng.route_texts(texts, **kw)
    finally:
        ops.stage1_topk = real
    (scores, valid, gid, k), opt = grabbed[0]
    doc, dead = opt["doc_map"], opt["dead"]
    J, S = valid.shape
    print(f"operands: template scores {list(scores.shape)}, doc map {list(doc.shape)}, dead "
          f"{list(dead.shape)}, k {k}")

    got = [t.cpu() for t in ops.stage1_topk(scores, valid, gid, k, doc_map=doc, dead=dead)]
    want = kref.stage1_topk_ref(scores.cpu(), valid.cpu(), gid.cpu(), k, doc_map=doc.cpu(),
                                dead=dead.cpu())
    same = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]))
    print(f"kernel against the plain version on CPU copies: {'bit-equal' if same else 'DIFFERS'}")
    if not same:
        sys.exit(1)

    def kernel():
        return ops.stage1_topk(scores, valid, gid, k, doc_map=doc, dead=dead)

    def plain():
        return kref.stage1_topk_ref(scores, valid, gid, k, doc_map=doc, dead=dead)

    masked = torch.where(valid[:, None, :],
                         torch.where(dead > 0, kref.NEG, scores[:, doc.long()].permute(1, 0, 2)),
                         kref.PAD_NEG).contiguous()

    def library():
        return torch.topk(masked, k, dim=-1)

    n_bytes = sum(t.numel() * t.element_size() for t in (scores, valid, doc, dead))
    n_bytes += 12 * J * scores.shape[0] * k     # the winners' ids read, values and ids written
    print(f"bound: {n_bytes / 1e6:.3f} MB read and written once, "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s")
    for name, fn in (("stage1_topk kernel", kernel), ("plain stage1_topk_ref", plain),
                     ("torch.topk over the masked scores", library)):
        ms, per = alone_ms(fn)
        alone = "not measured" if ms is None else f"{ms:.4f} ms"
        print(f"{name}: window {window_ms(fn):.4f} ms; alone {alone} "
              + "(" + "; ".join(f"{key} {us:.1f} us" for key, us in per.items()) + ")")


if __name__ == "__main__":
    main()
