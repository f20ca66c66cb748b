"""Readings for setting a cell's limits, its rate and its bounds on the chip.

    python3 perfbench/probe.py --workload <cell> --seeds 1 2 3 --seconds 10 \\
        [--trace 1] [--set mix.rate_per_s=3.0 ...] [--control fp8]

Runs the cell once per seed in this one process, each run as
``perfbench/run.py`` would (its own set-up, window and check), with the
cell file's keys replaced by ``--set`` (dotted keys, JSON values), and
prints one JSON line per run: the seed, the metrics and the numbers
compared.  ``--control <name>`` reads the cell's lower-precision control
or a planted fault instead of the program (the driver's ``control``):
the same numbers, computed from what the control produced.  The
benchmark's own runs never run a control.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench.harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/probe.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON")
    ap.add_argument("--control", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    settings = {k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.set)}
    core.set_cache_dirs(core.ROOT)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        bench, ctx = core.make_context(core.ROOT, args.workload, seed, args.seconds,
                                       bool(args.trace), args.device, settings=settings)
        driver = core.load_driver(ctx.spec["driver"])
        out = {"seed": seed, "control": args.control}
        if args.control:
            out["readings"] = driver.control(ctx, args.control)
        else:
            res = driver.run(ctx)
            line = core.result_line(bench, ctx, res, ctx.device.type, "", 1)
            out.update(metrics={k: v["value"] for k, v in line["metrics"].items()},
                       correct=line["correct"], failed=line["failed"],
                       attempted=line["attempted"], checks=line["checks"],
                       notes=res.notes, breakdown=line.get("breakdown"),
                       busy_s=line["device"].get("busy_s"),
                       window_s=line["device"].get("window_s"),
                       peak=line["device"]["memory_peak_bytes"])
        print(json.dumps(out), flush=True)
        del ctx, driver
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
