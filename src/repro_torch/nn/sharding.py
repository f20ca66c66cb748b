"""Logical-axis -> mesh-axis sharding rules, twin of `repro.nn.sharding`.

Every parameter, cache and batch dim carries a logical name (the names the
initialisers give, `Model.param_axes`); a layout maps logical names to mesh
axes (one axis, a tuple of axes, or None).  `logical_to_spec` resolves the
spec of one tensor on one mesh with the reference's two invariants, so one
production mesh serves archs from whisper-tiny (d=384) to jamba-398B:

  * divisibility fallback: if the mapped mesh axes do not evenly divide a
    dim, trailing axes of the mapping are dropped (replicate instead of
    crash); drops are recorded for the dry-run report;
  * single-use: a mesh axis shards at most one dim of a tensor; later
    logical dims lose the conflicting axis.

Nothing partitions a PyTorch program here: the port runs on one card, and
the mesh is the logical one of `repro_torch.launch.mesh`, whose specs the
dry-run (`repro_torch.launch.dryrun`) reads to divide each tensor's bytes
over the devices.  So `PartitionSpec` is a plain tuple of None / axis name /
tuple of names, `NamedSharding` a (mesh, spec) pair, and the reference's
trace-time helpers `constrain`, `activation_sharding`, `maybe_constrain`
and `fsdp_gather` have no twin.  The dry-run's collective term takes their
call sites from the reference's model code instead: the weight gathers of
`fsdp_gather` (`models/attention.py:172-206`, `models/mlp.py:44-46,126-129`,
`models/mamba.py:71,201,212,231`, `models/xlstm.py:200-310`,
`models/lm.py:171,228`) become an all-gather at each use of a weight whose
"embed_fsdp" dim the layout shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

from repro_torch.nn.core import is_axes

AxisMap = dict  # logical name -> mesh axis | tuple[mesh axes] | None


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of mesh axis names; the twin of `jax.sharding.PartitionSpec`."""

    def __new__(cls, *entries: Union[None, str, tuple]):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: how one tensor lies over the mesh's devices (a leaf
    of `repro_torch.tree`, unlike a tuple)."""
    mesh: object
    spec: PartitionSpec


@dataclasses.dataclass
class LayoutReport:
    """Record of fallback decisions (the dry-run report's layout drops)."""
    dropped: list = dataclasses.field(default_factory=list)

    def note(self, tensor: str, dim: int, axes, size: int):
        self.dropped.append((tensor, dim, tuple(axes), size))


def _as_tuple(v) -> tuple:
    if v is None:
        return ()
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a mesh with ``axis_names`` and ``devices.shape``."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def logical_to_spec(
    names: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: AxisMap,
    report: Optional[LayoutReport] = None,
    tensor_name: str = "?",
) -> PartitionSpec:
    sizes = mesh_sizes(mesh)
    used: set = set()
    spec = []
    for d, (name, size) in enumerate(zip(names, shape)):
        axes = [a for a in _as_tuple(rules.get(name)) if a in sizes]
        # single-use: drop axes already consumed by an earlier dim
        axes = [a for a in axes if a not in used]
        # divisibility fallback: drop trailing axes until the product divides
        while axes and size % math.prod(sizes[a] for a in axes) != 0:
            dropped = axes.pop()
            if report is not None:
                report.note(tensor_name, d, (dropped,), size)
        used.update(axes)
        if not axes:
            spec.append(None)
        elif len(axes) == 1:
            spec.append(axes[0])
        else:
            spec.append(tuple(axes))
    return PartitionSpec(*spec)


def spec_axes(spec: PartitionSpec) -> tuple:
    """Every mesh axis a spec shards on, in dim order."""
    return tuple(a for entry in spec for a in _as_tuple(entry))


def shard_factor(spec: PartitionSpec, mesh) -> int:
    """Devices a tensor under ``spec`` is split over: each device holds
    1 / shard_factor of it."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in spec_axes(spec))


def _map(fn, axes_tree, shapes_tree, path: str = ""):
    """``fn(names, leaf, path)`` over an axes tree and a tree of its shapes
    (tensors, or shape tuples), leaves matched by key and position and
    visited in `jax.tree` order (a dict's keys sorted), so drops are noted
    in the reference's order."""
    if is_axes(axes_tree):
        return fn(axes_tree, shapes_tree, path)
    if isinstance(axes_tree, dict):
        out = {k: _map(fn, axes_tree[k], shapes_tree[k], f"{path}[{k!r}]")
               for k in sorted(axes_tree)}
        return {k: out[k] for k in axes_tree}
    return type(axes_tree)(_map(fn, a, s, f"{path}[{i}]")
                           for i, (a, s) in enumerate(zip(axes_tree, shapes_tree)))


def tree_shardings(
    axes_tree,
    shapes_tree,
    mesh,
    rules: AxisMap,
    report: Optional[LayoutReport] = None,
):
    """Axes tree (tuples of logical names) + shapes tree -> NamedSharding
    tree.  Drops are noted under ``tensor_name="?"``, as the reference's."""

    def one(names, arr, _path):
        shape = arr.shape if hasattr(arr, "shape") else tuple(arr)
        return NamedSharding(mesh, logical_to_spec(names, shape, mesh, rules, report))

    return _map(one, axes_tree, shapes_tree)


# ---------------------------------------------------------------------------
# Layout presets, key for key the reference's.  Mesh axes: ("pod",) "data",
# "model".
# ---------------------------------------------------------------------------

def train_layout() -> AxisMap:
    """DP(+pod) over batch, FSDP over embed-ish param dims, TP over
    heads/mlp/vocab.  Sequence dim replicated."""
    return {
        "batch": ("pod", "data"),
        "cache_batch": ("pod", "data"),   # KV/state cache batch dim
        "seq": None,
        "embed": None,
        "embed_fsdp": ("data",),          # param embed dims: FSDP shard
        "heads": ("model",),
        "kv_heads": ("model",),
        "qkv": ("model",),
        "head_dim": None,
        "mlp": ("model",),
        "vocab": ("model",),
        # expert parallelism on the model axis: each model shard owns E/16
        # experts whole; the per-expert FSDP dim stays "embed_fsdp"->data
        "experts": ("model",),
        "expert_mlp": None,
        "layers": None,
        "conv": None,
        "state": None,
        "frames": None,
    }


def serve_layout() -> AxisMap:
    """Inference: batch over (pod,data), TP over heads/mlp/vocab; weights
    FSDP over data so big models fit; cache batch over data and cache
    sequence over model (GQA kv_heads never divide the 16-way model axis)."""
    rules = train_layout()
    rules.update({
        "batch": ("pod", "data"),
        "cache_seq": ("model",),
    })
    return rules


def serve_replicated_layout() -> AxisMap:
    """Decode for <=20B-param archs: weights replicated over the data axis
    (16-way TP over model only), so no per-step FSDP weight gather."""
    rules = serve_layout()
    rules.update({"embed_fsdp": None})
    return rules


def serve_big_layout() -> AxisMap:
    """Weight-stationary decode for >20B archs (jamba, llama4): weights keep
    their storage sharding and are not gathered at use; activations are
    replicated over data, each matmul contracts against its local weight
    shard and all-reduces its small activation.  The KV cache stays
    (cache_batch -> data, cache_seq -> model) sharded."""
    rules = serve_layout()
    rules.update({
        "batch": None,            # activations replicated across data
        "__use_site_gather__": False,
        "embed_fsdp": None,
        "expert_mlp": ("data",),
    })
    return rules


def long_layout() -> AxisMap:
    """long_500k: global_batch=1, batch unshardable; shard the KV/state
    sequence dim over data (sequence parallelism) and TP over model."""
    rules = serve_big_layout()
    rules.update({
        "cache_seq": ("data",),
        "seq": ("data",),
    })
    return rules


LAYOUTS = {
    "train": train_layout,
    "serve": serve_layout,
    "serve_replicated": serve_replicated_layout,
    "serve_big": serve_big_layout,
    "long": long_layout,
}
