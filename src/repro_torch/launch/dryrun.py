"""Dry-run on meta tensors, twin of `repro.launch.dryrun`.

For every (architecture x input-shape) cell, on a logical mesh of H100s
(`repro_torch.launch.mesh`): does the step build, how many bytes land on
each device, and what roofline does it have.  Nothing is allocated and
nothing is drawn: the parameters, optimizer state, inputs and cache are
``meta`` tensors at full width (`Model.init_params(abstract=True)`,
`repro_torch.launch.specs`), and the step runs on them, so a 398 B
parameter model costs no memory and no card.

A cell is ``ok`` when its arguments build at full width and depth, every
layout resolves, and its step runs on meta at depth 1 and 2 (the layer
groups of a deeper model are the same code).  Its JSON keeps the
reference's keys; in place of XLA's memory analysis it gives ``memory``,
per-device bytes of the parameters, their gradients, the optimizer state,
the cache, the batch and the peak.

  * Per-device bytes of a tensor: its bytes over the mesh axes its spec
    shards it on (`repro_torch.nn.sharding`, the reference's layouts).
    Tensors the step makes (activations, gradients, temporaries) are
    divided by the axes the batch dim maps to, or, when shaped like a
    parameter (or one layer of it), by that parameter's axes.
  * Per-device operations and HBM bytes: `hlo_analysis.StepCounter`'s
    totals over ``chips``.  A dim that fell back to replication would make
    each device repeat its work; that redundancy is not counted.
  * Collectives, from the layout with the reference's ring weights: an
    all-gather of a weight at each use in a matrix product (forward, the
    remat forward, backward) where its "embed_fsdp" dim is sharded and the
    layout gathers at use (the reference's `fsdp_gather` sites; the
    embedding lookup too), one reduce-scatter of each such gradient; in
    training, each gradient's all-reduce over the batch axes its spec does
    not shard; and an all-reduce of the output of every product whose
    contraction dim the layout shards (a row-parallel projection forward,
    a column-parallel one's input gradient backward).  Mesh axes of size 1
    move nothing.
  * Depth: the counts are taken at 1 and 2 layer groups
    (`analysis_cfg`) and extrapolated linearly, full = d1 + (nG - 1)
    (d2 - d1), as the reference does; the peak too.
  * Sequence loops: the recurrent blocks loop in Python over a sequence
    (Mamba-2's and the mLSTM's chunks, the sLSTM's tokens) and every op
    of a meta run costs host time, so each such loop is cut to
    `LOOP_CUTS` [0] iterations (`nn.loop_cuts`), then run once more with
    one iteration more, and the difference (one steady iteration, forward,
    recompute and backward) is scaled to the loop's full length: every
    iteration but the first and the last does the same ops.  This replaces
    the reference's `slstm_correction`, which is not also added.

A decode cell's ``cache_len`` is a meta tensor and holds no value, so the
step decodes at the cache's last row, ``seq_len - 1`` (the plain decode
paths do the same work at any length; the decode kernel reads every row).
The full configs keep the reference's ``attn_impl`` ("chunked", q-chunks of
512): a cell's line says which one it ran.  The module never writes
``os.environ``, and importing it touches no device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--no-roofline]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1x1   # one card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import configs
from repro_torch import tree as tree_util
from repro_torch.configs import SHAPES, Shape, get_config, shape_supported
from repro_torch.launch import hlo_analysis, specs
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh, mesh_chips
from repro_torch.models.api import get_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _n_groups
from repro_torch.nn import core as nn
from repro_torch.nn.sharding import (LAYOUTS, LayoutReport, NamedSharding, PartitionSpec,
                                     logical_to_spec, mesh_sizes, shard_factor, spec_axes,
                                     tree_shardings)
from repro_torch.training.optimizer import Adafactor, AdamW
from repro_torch.training.train_step import make_train_step

BIG_MODEL_PARAMS = 20e9     # above this, dry-run trains with Adafactor
LOOP_CUTS = (3, 4)          # iterations of a cut sequence loop: base run, one more
_LOOPS = ("ssd", "mlstm", "slstm")

_aten = torch.ops.aten
_MATMULS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
_LOOKUPS = {_aten.index, _aten.embedding}


def pick_layout(shape_name, override: Optional[str] = None) -> str:
    if override:
        return override
    shape = _shape(shape_name)
    if shape.kind == "train":
        return "train"
    if shape.name.startswith("long"):
        return "long"
    return "serve"


def _shape(shape_name) -> Shape:
    return shape_name if isinstance(shape_name, Shape) else SHAPES[shape_name]


def _batch_shardings(batch_specs: dict, mesh, rules, report):
    return {k: NamedSharding(mesh, logical_to_spec(specs.BATCH_AXES[k], v.shape, mesh, rules,
                                                   report, k))
            for k, v in batch_specs.items()}


def analysis_cfg(cfg: ModelConfig, n_periods: int) -> ModelConfig:
    """Depth-reduced variant for operation/byte/collective accounting: the
    reference's (``analysis_unroll``, ``scan_layers`` off; the port runs
    its layers as a Python loop either way), ``n_periods`` layer groups."""
    repl = dict(
        analysis_unroll=True,
        scan_layers=False,
        n_layers=cfg.first_k_dense + n_periods * len(cfg.block_pattern),
    )
    if cfg.is_encoder_decoder:
        repl["n_encoder_layers"] = n_periods
    return dataclasses.replace(cfg, **repl)


def build_lowerable(cfg: ModelConfig, shape_name, mesh, layout: str,
                    report: LayoutReport, opt_params_total: Optional[float] = None):
    """Returns (fn, args, in_shardings, donate): the step, its meta
    arguments, each argument's `NamedSharding` tree, and the arguments the
    step updates in place (the reference's donated ones).  ``shape_name``
    is a `SHAPES` key or a `Shape`."""
    shape = _shape(shape_name)
    model = get_model(cfg)
    params_abs = model.init_params(abstract=True)
    rules = LAYOUTS[layout]()
    p_shard = tree_shardings(model.param_axes(), params_abs, mesh, rules, report)
    rep = NamedSharding(mesh, PartitionSpec())

    if shape.kind == "train":
        total = opt_params_total or cfg.param_counts()["total"]
        opt = Adafactor() if total > BIG_MODEL_PARAMS else AdamW()
        if isinstance(opt, AdamW):
            opt_state = opt.init_abstract(params_abs)
            o_shard = type(opt_state)(step=rep, m=p_shard, v=p_shard)
        else:
            opt_state = opt.init(params_abs)            # on the parameters' device: meta
            # factored moments: replicate (tiny), as the reference
            o_shard = tree_util.map(lambda _: rep, opt_state)
        batch = specs.train_specs(cfg, shape)
        b_shard = _batch_shardings(batch, mesh, rules, report)
        return (make_train_step(model, opt), (params_abs, opt_state, batch),
                (p_shard, o_shard, b_shard), (0, 1))

    if shape.kind == "prefill":
        batch = specs.prefill_specs(cfg, shape)
        b_shard = _batch_shardings(batch, mesh, rules, report)
        return model.prefill, (params_abs, batch), (p_shard, b_shard), ()

    d = specs.decode_specs(cfg, shape)
    c_shard = tree_shardings(model.cache_axes(), d["cache"], mesh, rules, report)
    tok_shard = NamedSharding(mesh, logical_to_spec(("batch", None), d["tokens"].shape, mesh,
                                                    rules, report, "tokens"))
    pos = shape.seq_len - 1

    def decode(params, cache, tokens, cache_len):
        """`Model.decode_step` at the cache's last row (a meta ``cache_len``
        holds no value)."""
        return model.decode_step(params, cache, tokens, pos)

    return (decode, (params_abs, d["cache"], d["tokens"], d["cache_len"]),
            (p_shard, c_shard, tok_shard, rep), (1,))


# ---------------------------------------------------------------------------
# Per-device bytes
# ---------------------------------------------------------------------------

def _pairs(tensors, shardings):
    """(tensor, NamedSharding) leaf pairs of a tree and its sharding tree."""
    return zip(tree_util.leaves(tensors), tree_util.leaves(shardings))


def _device_bytes(tensors, shardings) -> float:
    return float(sum(t.numel() * t.element_size() / shard_factor(s.spec, s.mesh)
                     for t, s in _pairs(tensors, shardings)))


def _batch_factor(shape: Shape, mesh, rules) -> int:
    """Devices the batch dim is split over (the activations' divisor)."""
    return shard_factor(logical_to_spec(("batch",), (shape.global_batch,), mesh, rules), mesh)


def _param_table(params, axes, shardings) -> list:
    """(tensor, logical names, spec) of every parameter leaf."""
    names = []

    def walk(a):
        if isinstance(a, dict):
            for k in sorted(a):
                walk(a[k])
        else:
            names.append(a)

    walk(axes)
    return [(t, n, s.spec) for (t, s), n in zip(_pairs(params, shardings), names)]


def _divisor(table, mesh, batch_factor: int):
    """divisor(t) for `StepCounter`: a tensor shaped like a parameter, or
    like one layer of a stacked one, is split like that parameter; any
    other, like the batch."""
    by_shape: dict = {}
    for t, names, spec in table:
        f = shard_factor(spec, mesh)
        by_shape.setdefault(tuple(t.shape), f)
        if names and names[0] == "layers":
            by_shape.setdefault(tuple(t.shape[1:]), f)
    return lambda t: by_shape.get(tuple(t.shape), batch_factor)


class _Collectives:
    """The step's collectives under a layout (see the module docstring),
    read off the matrix products and lookups `StepCounter` shows it."""

    def __init__(self, table, mesh, rules, batch_factor: int):
        self.stats = hlo_analysis.CollectiveStats({}, {})
        self.sizes = mesh_sizes(mesh)
        self.gather_at_use = rules.get("__use_site_gather__", True)
        self.batch_factor = batch_factor
        self.table = table
        self.by_storage = {id(t.untyped_storage()): (t, names, spec) for t, names, spec in table}

    def _factor(self, entry) -> int:
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        return math.prod(self.sizes[a] for a in axes)

    def _gathered(self, names, spec) -> list:
        """Dims of a weight gathered at each use: its sharded "embed_fsdp"."""
        if not self.gather_at_use:
            return []
        return [i for i, n in enumerate(names) if n == "embed_fsdp" and self._factor(spec[i]) > 1]

    def _use(self, names, spec, view, contracted: Optional[int], out) -> None:
        """One use of a weight (``view`` of it) whose ``contracted`` dim the
        op sums over (None for a lookup): its gather, and the all-reduce of
        ``out`` when that dim stays sharded."""
        gathered = self._gathered(names, spec)
        if gathered:
            rest = math.prod(self._factor(e) for i, e in enumerate(spec) if i not in gathered)
            self.stats.add("all-gather", hlo_analysis.dense_bytes(view) / rest)
        if contracted is None or contracted in gathered or self._factor(spec[contracted]) == 1:
            return
        kept = math.prod(self._factor(e) for i, e in enumerate(spec)
                         if i not in gathered and i != contracted)
        self.stats.add("all-reduce", hlo_analysis.dense_bytes(out) / (self.batch_factor * kept))

    @staticmethod
    def _dim_of(param, view, vdim: int) -> Optional[int]:
        """The parameter dim a view's dim walks (the same stride and size)."""
        for i, (size, stride) in enumerate(zip(param.shape, param.stride())):
            if stride == view.stride(vdim) and size == view.shape[vdim]:
                return i
        return None

    def __call__(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in _LOOKUPS:
            hit = self.by_storage.get(id(args[0].untyped_storage()))
            if hit is not None:
                self._use(hit[1], hit[2], args[0], None, out)
            return
        if packet not in _MATMULS:
            return
        a, b = args[-2], args[-1]
        for view, vdim in ((a, a.dim() - 1), (b, b.dim() - 2)):
            hit = self.by_storage.get(id(view.untyped_storage()))
            if hit is not None:
                param, names, spec = hit
                self._use(names, spec, view, self._dim_of(param, view, vdim), out)

    def add_gradient_collectives(self, batch_axes: tuple) -> None:
        """Per train step: each gathered weight's gradient reduce-scattered,
        each gradient all-reduced over the batch axes its spec leaves."""
        for t, names, spec in self.table:
            nbytes = hlo_analysis.dense_bytes(t)
            gathered = self._gathered(names, spec)
            full = math.prod(self._factor(e) for e in spec)
            if gathered:
                self.stats.add("reduce-scatter", nbytes * math.prod(
                    self._factor(spec[i]) for i in gathered) / full)
            left = [a for a in batch_axes if a not in spec_axes(spec) and self.sizes[a] > 1]
            if left:
                self.stats.add("all-reduce", nbytes / full)


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

def _count(cfg_a: ModelConfig, shape: Shape, mesh, layout: str, opt_total: float,
           cuts: dict) -> dict:
    """One depth-reduced step on meta under `StepCounter`, its sequence
    loops cut to ``cuts``: its global operations by dtype, bytes, kernels'
    work, per-device live peak, per-device collective bytes and counts, and
    under "loops" the full length of each loop it cut."""
    rules = LAYOUTS[layout]()
    fn, args, shardings, _ = build_lowerable(cfg_a, shape, mesh, layout, LayoutReport(),
                                             opt_total)
    table = _param_table(args[0], get_model(cfg_a).param_axes(), shardings[0])
    bf = _batch_factor(shape, mesh, rules)
    coll = _Collectives(table, mesh, rules, bf)
    counter = hlo_analysis.StepCounter(_divisor(table, mesh, bf), coll)
    with nn.loop_cuts(cuts) as loops, counter:
        fn(*args)
    if shape.kind == "train":
        coll.add_gradient_collectives(spec_axes(logical_to_spec(
            ("batch",), (shape.global_batch,), mesh, rules)))
    return {
        "ops": dict(counter.ops_by_dtype),
        "bytes": counter.hbm_bytes,
        "peak": counter.peak_bytes,
        "coll_bytes": dict(coll.stats.bytes_by_kind),
        "coll_count": dict(coll.stats.count_by_kind),
        "kernels": {k: dict(v) for k, v in counter.kernels.items()},
        "loops": dict(loops),
    }


def _combine(fn, *trees):
    """``fn`` leafwise over nested dicts of numbers (a key missing from a
    tree counts 0)."""
    if any(isinstance(t, dict) for t in trees):
        keys = set().union(*(t for t in trees if isinstance(t, dict)))
        return {k: _combine(fn, *(t.get(k, 0.0) if isinstance(t, dict) else 0.0
                                  for t in trees)) for k in keys}
    return fn(*trees)


def _count_scaled(cfg_a: ModelConfig, shape: Shape, mesh, layout: str, opt_total: float):
    """`_count` with every sequence loop cut to ``LOOP_CUTS[0]`` iterations,
    plus, for each loop that was longer, its steady iteration (a run with
    that loop one iteration longer, less the base) times the iterations
    cut."""
    k1, k2 = LOOP_CUTS
    cuts = dict.fromkeys(_LOOPS, k1)
    base = _count(cfg_a, shape, mesh, layout, opt_total, cuts)
    loops = base.pop("loops")
    out = base
    for name, n in sorted(loops.items()):
        if n <= k1:
            continue
        more = _count(cfg_a, shape, mesh, layout, opt_total, dict(cuts, **{name: k2}))
        more.pop("loops")
        per = (n - k1) / (min(n, k2) - k1)
        out = _combine(lambda o, m, b: o + per * (m - b), out, more, base)
    return out


def measure(cfg: ModelConfig, shape_name, mesh, layout: str, depths=(1, 2)) -> dict:
    """Counts of the full-depth step: depth-1 and depth-2 runs extrapolated
    linearly in layer groups, each with its sequence loops scaled
    (`_count_scaled`).  With ``depths=(1,)``, only the depth-1 run (the
    build gate)."""
    shape = _shape(shape_name)
    total = cfg.param_counts()["total"]
    runs = [_count_scaled(analysis_cfg(cfg, n), shape, mesh, layout, total) for n in depths]
    if len(runs) == 1:
        return runs[0]
    nG = _n_groups(cfg)
    return _combine(lambda a, b: a + (nG - 1) * (b - a), runs[0], runs[1])


def _roofline(counts: dict, cfg: ModelConfig, shape: Shape, chips: int,
              peak_bytes: float = 0.0) -> hlo_analysis.Roofline:
    ops = {k: max(v, 0.0) / chips for k, v in counts["ops"].items()}
    stats = hlo_analysis.CollectiveStats(
        bytes_by_kind={k: max(v, 0.0) for k, v in counts["coll_bytes"].items()},
        count_by_kind={k: int(round(v)) for k, v in counts["coll_count"].items()})
    return hlo_analysis.Roofline(
        flops=sum(ops.values()),
        hbm_bytes=max(counts["bytes"], 0.0) / chips,
        collective_bytes=stats.total_bytes,
        chips=chips,
        collectives=stats,
        model_flops=hlo_analysis.model_flops(cfg, shape),
        per_device_peak_bytes=peak_bytes,
        flops_by_dtype=ops,
    )


def roofline_terms(cfg, shape_name, mesh, layout, chips):
    """Depth-1/depth-2 counts extrapolated linearly in depth (see
    `measure`), as a `hlo_analysis.Roofline` (without the peak)."""
    shape = _shape(shape_name)
    return _roofline(measure(cfg, shape, mesh, layout), cfg, shape, chips)


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.devices.shape)


def _memory(args, shardings, shape: Shape) -> dict:
    """Per-device bytes of the step's arguments, by role."""
    params, p_shard = args[0], shardings[0]
    mem = {"params": _device_bytes(params, p_shard)}
    mem["grads"] = mem["params"] if shape.kind == "train" else 0.0
    mem["opt_state"] = (_device_bytes(args[1], shardings[1]) if shape.kind == "train" else 0.0)
    mem["cache"] = _device_bytes(args[1], shardings[1]) if shape.kind == "decode" else 0.0
    if shape.kind == "decode":
        mem["batch"] = _device_bytes(args[2:], shardings[2:])
    else:
        mem["batch"] = _device_bytes(args[-1], shardings[-1])
    return mem


def run_cell(
    arch: str,
    shape_name,
    multi_pod: bool = False,
    layout: Optional[str] = None,
    cfg: Optional[ModelConfig] = None,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    with_roofline: bool = True,
    mesh=None,
) -> dict:
    """One cell: ``shape_name`` a `SHAPES` key or a `Shape`, ``mesh`` a
    logical mesh (the production mesh by default).  Without the roofline
    only the depth-1 step runs (the build gate) and the peak is not given."""
    cfg = cfg or get_config(arch)
    shape = _shape(shape_name)
    layout = pick_layout(shape, layout)
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chips(mesh)
    report = LayoutReport()
    mesh_name = _mesh_name(mesh)
    tag = f"{arch}__{shape.name}__{mesh_name}__{layout}"
    result: dict = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "layout": layout, "chips": chips, "ok": False, "attn_impl": cfg.attn_impl,
    }
    t0 = time.monotonic()
    try:
        # 1) the full-depth arguments and their layouts
        _, args, shardings, _ = build_lowerable(cfg, shape, mesh, layout, report)
        mem = _memory(args, shardings, shape)
        del args, shardings
        # 2) the step on meta: depth 1 (and 2 for the roofline), extrapolated
        counts = measure(cfg, shape, mesh, layout, (1, 2) if with_roofline else (1,))
        t_build = time.monotonic() - t0
        if with_roofline:
            mem["peak"] = sum(mem.values()) - mem["grads"] + max(counts["peak"], 0.0)
        result.update(ok=True, t_build_s=t_build, memory=mem,
                      layout_drops=report.dropped[:50], n_layout_drops=len(report.dropped),
                      kernels={k: dict(v, calls=int(round(v["calls"])))
                               for k, v in counts["kernels"].items()})
        if with_roofline:
            roof = _roofline(counts, cfg, shape, chips, mem["peak"])
            result["roofline"] = roof.to_dict()
            if verbose:
                r = roof
                print(
                    f"[OK] {tag} ({cfg.attn_impl}): peak {mem['peak'] / 2**30:.2f} GiB/device "
                    f"compute={r.t_compute*1e3:.2f}ms memory={r.t_memory*1e3:.2f}ms "
                    f"collective={r.t_collective*1e3:.2f}ms bottleneck={r.bottleneck} "
                    f"useful={r.useful_flops_ratio:.2f} roofline_frac={r.roofline_fraction:.3f} "
                    f"({time.monotonic() - t0:.1f}s)", flush=True)
        elif verbose:
            print(f"[OK] {tag} ({cfg.attn_impl}): built in {t_build:.1f}s; params "
                  f"{mem['params'] / 2**30:.2f} GiB/device, cache {mem['cache'] / 2**30:.2f} "
                  f"GiB/device", flush=True)
    except Exception as e:
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {tag}: {result['error']}", flush=True)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layout", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="experiments/dryrun_torch")
    ap.add_argument("--include-skipped", action="store_true")
    ap.add_argument("--no-roofline", action="store_true",
                    help="build gate only (used for the multi-pod pass)")
    ap.add_argument("--mesh", type=str, default=None,
                    help="DATAxMODEL: a (data, model) mesh in place of the production one, "
                         "e.g. 1x1 for one card")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        mesh = make_debug_mesh(*(int(n) for n in args.mesh.split("x")))

    if args.all:
        cells = configs.cells(include_skipped=args.include_skipped)
        results = []
        for arch, shape in cells:
            results.append(
                run_cell(arch, shape, multi_pod=args.multi_pod, layout=args.layout,
                         save_dir=args.out, with_roofline=not args.no_roofline, mesh=mesh)
            )
        n_ok = sum(r["ok"] for r in results)
        print(f"\n{n_ok}/{len(results)} cells OK")
        raise SystemExit(0 if n_ok == len(results) else 1)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    if not shape_supported(args.arch, args.shape):
        print(f"[SKIP] {args.arch} x {args.shape}: unsupported per DESIGN.md §6")
        raise SystemExit(0)
    r = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                 layout=args.layout, save_dir=args.out,
                 with_roofline=not args.no_roofline, mesh=mesh)
    raise SystemExit(0 if r["ok"] else 1)


if __name__ == "__main__":
    main()
