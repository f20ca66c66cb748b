"""The harness: find a cell by name, run its driver once, print one line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name.  ``BENCHMARK.json`` at the root
of the checkout names the cell's configuration and traffic; the cell's
own file ``perfbench/workloads/<cell>.json`` names its driver
(``perfbench/drivers/<driver>.py``), its traffic parameters and the
limits of its correctness checks; the configuration's file is the one
``BENCHMARK.json`` gives.  Each per-layer metric is read by
``perfbench/metrics/<metric>.py`` (a function ``read(result)`` that
returns a number, or None when the run holds nothing to read).

A driver's ``run(ctx)`` makes its inputs from ``ctx.seed``, warms up,
measures for ``ctx.seconds``, records the device peak, frees the
program's state, checks the outputs against the plain reference and
returns a `Result`.  With ``ctx.trace`` it also profiles part of the
window (`perfbench.harness.trace`).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]

# top-level module names that must not be loaded in a measured process:
# the JAX package the program was ported from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of `FORBIDDEN`, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct while value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


@dataclasses.dataclass
class Result:
    """What a driver hands back.  ``e2e``: end-to-end metric values by
    name.  ``values``, ``spans``, ``trace``, ``trace_work``: what the
    per-layer readers read (numbers measured over the window, host-clock
    durations in seconds by span name, the profiled part's `DeviceTrace`,
    and the work done inside that part)."""
    e2e: dict
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int
    values: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    trace_work: dict = dataclasses.field(default_factory=dict)
    dims: Optional[dict] = None
    notes: list = dataclasses.field(default_factory=list)   # printed before the checks

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)


@dataclasses.dataclass
class Context:
    root: Path
    name: str
    cell: dict           # the BENCHMARK.json entry
    spec: dict           # perfbench/workloads/<cell>.json
    config: dict         # the configuration's file
    seed: int
    seconds: float
    trace: bool
    device: object       # torch.device
    t0: float            # time.monotonic() at process start

    def setup_s(self) -> float:
        return time.monotonic() - self.t0


def process_start_monotonic() -> float:
    """time.monotonic() at this process's start, from /proc (10 ms
    resolution); the call time where /proc has no such record."""
    now = time.monotonic()
    try:
        start_ticks = float(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


def peak_bytes(device) -> int:
    """The device's allocation peak so far (0 off the card)."""
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device) -> None:
    """Return what the freed program state held to the device, so the
    reference that follows has the card's memory."""
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str):
    """(BENCHMARK.json, its entry for cell ``name``, the cell's file, the
    configuration's file)."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no cell {name!r} in BENCHMARK.json "
                         f"(cells: {', '.join(sorted(cells))})")
    cell = cells[name]
    spec = load_json(root / "perfbench" / "workloads" / f"{name}.json")
    if spec.get("config") != cell["config"] or spec.get("traffic") != cell["traffic"]:
        raise SystemExit(f"perfbench: {name}: its file's config/traffic differ from BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    return bench, cell, spec, config


def load_driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def load_reader(root: Path, metric: str):
    """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The entries of ``bench[kind]`` this cell reports: those listing it
    under ``workloads``, and those without the key whose end-to-end metric
    (their own name for an end-to-end one, ``moves`` for a per-layer one)
    the cell reports."""
    e2e_here = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e_here:
            out.append(m)
    return out


def card_note() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "no nvidia-smi output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def set_cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port's nvcc
    builds already go to build/repro_torch_kernels/)."""
    base = root / "build" / "perfbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def _num(x: float):
    x = float(x)
    if not math.isfinite(x):
        raise ValueError(f"non-finite metric value {x}")
    return x


def result_line(bench: dict, ctx: Context, res: Result, platform: str, kind: str,
                count: int) -> dict:
    """The result's JSON object; ``checks`` comes last."""
    metrics = {}
    if ctx.trace:
        for m in metrics_of(bench, ctx.name, "per_layer"):
            value = load_reader(ctx.root, m["name"])(res)
            if value is not None:
                metrics[m["name"]] = {"value": _num(value), "unit": m["unit"]}
    else:
        for m in metrics_of(bench, ctx.name, "end_to_end"):
            if m["name"] in res.e2e:
                metrics[m["name"]] = {"value": _num(res.e2e[m["name"]]), "unit": m["unit"]}
    device = {"platform": platform, "kind": kind, "count": count,
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    line = {"correct": res.correct, "attempted": int(res.attempted), "failed": int(res.failed),
            "metrics": metrics, "device": device}
    if ctx.trace and res.trace is not None:
        device["busy_s"] = _num(res.trace.busy_s)
        device["window_s"] = _num(res.trace.window_s)
        line["breakdown"] = {"device_ops": res.trace.device_ops(10),
                             "idle_gaps": res.trace.idle_gaps(10)}
    line["checks"] = {c.name: {"value": float(c.value), "limit": float(c.limit)}
                      for c in res.checks}
    return line


def override(spec: dict, settings: dict) -> dict:
    """``spec`` with dotted keys set (``{"mix.rate_per_s": 3.0}``)."""
    spec = json.loads(json.dumps(spec))
    for key, value in settings.items():
        *path, last = key.split(".")
        d = spec
        for k in path:
            d = d.setdefault(k, {})
        d[last] = value
    return spec


def make_context(root: Path, name: str, seed: int, seconds: float, trace: bool, device=None,
                 t0: Optional[float] = None, settings: Optional[dict] = None):
    """(BENCHMARK.json, the `Context` of one run of cell ``name``)."""
    import torch

    bench, cell, spec, config = find_cell(root, name)
    ctx = Context(root=root, name=name, cell=cell, spec=override(spec, settings or {}),
                  config=config, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                  device=torch.device(device or "cuda"),
                  t0=time.monotonic() if t0 is None else t0)
    return bench, ctx


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device=None,
             t0: Optional[float] = None, settings: Optional[dict] = None):
    """Run cell ``name`` once on ``device`` (None: the CUDA card) and
    return (BENCHMARK.json, context, result).  No look for a chip: `main`
    makes it."""
    bench, ctx = make_context(root, name, seed, seconds, trace, device, t0, settings)
    return bench, ctx, load_driver(ctx.spec["driver"]).run(ctx)



def main(argv=None, t0: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = time.monotonic() if t0 is None else t0
    root = ROOT
    set_cache_dirs(root)
    bench, cell, _, _ = find_cell(root, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False; this benchmark runs on a CUDA "
              "card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench, ctx, res = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                               t0=t0)
    line = result_line(bench, ctx, res, "gpu", torch.cuda.get_device_name(0), int(cell["chips"]))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {', '.join(bad)} (JAX or the JAX package); "
              f"no result", file=sys.stderr)
        return 4
    print(f"perfbench: card {card_note()}", file=sys.stderr)
    for note in res.notes:
        print(f"perfbench: {note}", file=sys.stderr)
    for c in res.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
