"""Carry the reference's routing state into the port.

The inputs are plain numpy arrays and dicts (what the JAX package's
objects hold), so this module imports nothing of the reference:

* `index_from_arrays` builds a port `ToolIndex` from a compiled index's
  corpus weights, vocabularies and tool table, without re-tokenising;
* `routing_config_from_dict` rebuilds a `RoutingConfig` from
  ``dataclasses.asdict`` of the reference's, nested `QosParams` included;
* `adapt_state_from_arrays` carries a SONAR-ADAPT learner state (weights,
  reward baseline, step count) onto a device;
* `lm_params_from_arrays` turns any model's parameter tree (nested dicts
  of numpy arrays: an LM's stacked ``groups`` and a VLM's ``vision_proj``,
  whisper's ``enc_blocks`` / ``dec_blocks``, each with their leading layer
  axis) into the port's tensors, bf16 included;
* `model_config_from_dict` rebuilds a `ModelConfig` from
  ``dataclasses.asdict`` of the reference's.

A `TiledFleetIndex` needs no converter: the port builds it from the same
templates with the same numpy code, byte-equal to the reference's.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.adaptive import AdaptState
from repro_torch.core.bm25 import Bm25Corpus
from repro_torch.core.dataset import Server
from repro_torch.core.qos import QosParams
from repro_torch.core.routing import RoutingConfig, ToolIndex
from repro_torch.models.config import ModelConfig


def index_from_arrays(
    server_weights: np.ndarray,     # [n_servers, V_s] f32
    tool_weights: np.ndarray,       # [n_tools, V_t] f32
    tool_server: np.ndarray,        # [n_tools] host server per tool
    server_vocab: Mapping[str, int],
    tool_vocab: Mapping[str, int],
    tool_names: Sequence[str],
    servers: Sequence[Server],
) -> ToolIndex:
    """A port `ToolIndex` over already-compiled corpora."""
    sw = np.ascontiguousarray(server_weights, dtype=np.float32)
    tw = np.ascontiguousarray(tool_weights, dtype=np.float32)
    ts = np.asarray(tool_server, dtype=np.int32)
    n_tools = ts.shape[0]
    if sw.shape[0] != len(servers) or tw.shape[0] != n_tools or len(tool_names) != n_tools:
        raise ValueError("index_from_arrays: server/tool counts disagree")
    if sw.shape[1] != max(len(server_vocab), 1) or tw.shape[1] != max(len(tool_vocab), 1):
        raise ValueError("index_from_arrays: vocabulary sizes disagree with the weights")
    return ToolIndex.from_corpora(
        servers,
        Bm25Corpus(vocab=dict(server_vocab), weights=sw, n_docs=sw.shape[0]),
        Bm25Corpus(vocab=dict(tool_vocab), weights=tw, n_docs=tw.shape[0]),
        ts,
        tool_names,
    )


def routing_config_from_dict(d: Mapping) -> RoutingConfig:
    """`RoutingConfig` from ``dataclasses.asdict`` of the reference's."""
    d = dict(d)
    qos = d.pop("qos", None)
    if isinstance(qos, Mapping):
        qos = QosParams(**qos)
    return RoutingConfig(**d, **({} if qos is None else {"qos": qos}))


def adapt_state_from_arrays(weights, baseline, step, device) -> AdaptState:
    """`AdaptState` on ``device`` from the reference's state arrays:
    ``weights`` f32 [4] = [alpha, beta, gamma, delta], ``baseline`` the
    reward EMA, ``step`` the count of applied updates."""
    w = np.asarray(weights, dtype=np.float32)
    if w.shape != (4,):
        raise ValueError(f"adapt_state_from_arrays: weights shape {w.shape}, expected (4,)")
    dev = torch.device(device)
    return AdaptState(
        weights=torch.from_numpy(w.copy()).to(dev),
        baseline=torch.tensor(np.float32(baseline), dtype=torch.float32, device=dev),
        step=torch.tensor(int(step), dtype=torch.int32, device=dev),
    )


def _tensor(x, device) -> torch.Tensor:
    """One array as a tensor on ``device``.  bf16 arrays (``ml_dtypes``),
    which `torch.from_numpy` refuses, are viewed as uint16 and then as
    bfloat16: the same bits and no f32 round trip.  A read-only array (a
    view of a JAX buffer) is copied first, since the port writes caches in
    place."""
    a = np.asarray(x)
    if not a.flags.writeable:        # e.g. a view of a JAX buffer: one leaf copied at a time
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def lm_params_from_arrays(tree, device):
    """The port's parameters on ``device`` from the reference's tree of any
    model family (nested dicts of arrays: an LM's ``embed``, ``final_norm``,
    ``head``, ``vision_proj`` and stacked ``groups``; whisper's ``embed``,
    ``enc_blocks``, ``enc_norm``, ``dec_blocks``, ``dec_norm`` and
    ``head``), leaf for leaf, dtypes kept."""
    dev = torch.device(device)
    if isinstance(tree, Mapping):
        return {k: lm_params_from_arrays(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)


def model_config_from_dict(d: Mapping) -> ModelConfig:
    """`ModelConfig` from ``dataclasses.asdict`` of the reference's."""
    d = dict(d)
    if "block_pattern" in d:
        d["block_pattern"] = tuple(d["block_pattern"])
    return ModelConfig(**d)
