"""Step-scoped checkpoint/restore of trees of tensors, twin of
`repro.ft.checkpoint`, in the reference's on-disk layout:

    <dir>/step_<N>/
        manifest.json   — step, extras, and per shard its file and leaf names
        shard_<i>.npz   — the leaves as numpy arrays, ~512 MB per file

Leaf names are the reference's (`jax.tree_util.keystr` spellings, through
`repro_torch.tree.flatten_with_path`), and bf16 is stored as a uint16 view
as the reference stores it, so a checkpoint crosses between the two in
both directions.  Writes are atomic (a tmp dir, then a rename), so a write
cut short never corrupts the latest checkpoint; `latest_step` skips
directories without a manifest.  `restore` puts each leaf on its template
leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util

_SHARD_BYTES = 512 * 1024 * 1024


def _to_storable(t) -> np.ndarray:
    """A leaf as a host numpy array; bf16 (which numpy has no dtype for)
    as its uint16 bits."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_storable(arr: np.ndarray, like) -> torch.Tensor:
    """The stored array as a tensor on ``like``'s device; uint16 bits into a
    bf16 template become bf16 again."""
    arr = np.require(arr, requirements="C")         # keeps 0-d arrays 0-d
    if getattr(like, "dtype", None) == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def save(ckpt_dir: str, step: int, tree: Any, extras: Optional[dict] = None) -> str:
    """Serialize ``tree`` to <ckpt_dir>/step_<step>; returns the final path."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    shards: list = [[]]
    size = 0
    for name, leaf in tree_util.flatten_with_path(tree):
        arr = _to_storable(leaf)
        if size + arr.nbytes > _SHARD_BYTES and shards[-1]:
            shards.append([])
            size = 0
        shards[-1].append((name, arr))
        size += arr.nbytes

    manifest = {"step": step, "extras": extras or {}, "shards": []}
    for i, shard in enumerate(shards):
        fname = f"shard_{i}.npz"
        np.savez(os.path.join(tmp, fname), **{n: a for n, a in shard})
        manifest["shards"].append({"file": fname, "leaves": [n for n, _ in shard]})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> tuple:
    """Restore into the structure of ``like`` (a template of tensors: their
    shapes, bf16-ness and devices).  Returns (tree, extras)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    by_name: dict = {}
    for shard in manifest["shards"]:
        with np.load(os.path.join(path, shard["file"])) as data:
            for n in shard["leaves"]:
                by_name[n] = data[n]

    out = []
    for name, leaf in tree_util.flatten_with_path(like):
        arr = by_name[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"restore: {name} has shape {arr.shape}, the template {leaf.shape}")
        out.append(_from_storable(arr, leaf))
    return tree_util.unflatten(like, out), manifest["extras"]
