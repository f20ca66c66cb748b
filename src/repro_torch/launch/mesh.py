"""Production mesh construction, twin of `repro.launch.mesh`.

A mesh here is logical: named axes over a grid of H100s that the dry-run
(`repro_torch.launch.dryrun`) divides tensors over.  It holds no process
group and partitions nothing; `make_fleet_mesh` is the one mesh whose
devices are the cards of this host.  Functions, not module-level
constants: importing this module touches no device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Named axes over a grid of devices: ``axis_names`` and ``devices`` (an
    object array of that grid's shape, device names or None), as
    `jax.sharding.Mesh` exposes them."""
    axis_names: tuple
    devices: np.ndarray


def _mesh(shape: tuple, axes: tuple) -> LogicalMesh:
    return LogicalMesh(tuple(axes), np.empty(tuple(shape), dtype=object))


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """Production mesh of H100s: 16x16 = 256 cards; 2 pods = 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_debug_mesh(n_data: int = 1, n_model: int = 1) -> LogicalMesh:
    """Small (data, model) mesh for CPU tests and one-card cuts."""
    return _mesh((n_data, n_model), ("data", "model"))


def make_fleet_mesh(n_shards: int) -> LogicalMesh:
    """1-D ``"fleet"`` mesh over the first ``n_shards`` CUDA devices of this
    host (the reference's mesh of the sharded routing engine); too few
    devices raise `ValueError`."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < n_shards:
        raise ValueError(f"fleet mesh needs {n_shards} devices, have {n}")
    devs = np.empty((n_shards,), dtype=object)
    devs[:] = [f"cuda:{i}" for i in range(n_shards)]
    return LogicalMesh(("fleet",), devs)


def mesh_chips(mesh) -> int:
    return int(mesh.devices.size)
