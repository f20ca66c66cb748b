"""The port's dry-run (`repro_torch.launch.{specs, hlo_analysis, dryrun}`,
the meta branch of `repro_torch.kernels.ops` and the abstract initialisers)
against the JAX reference and hand counts, on the CPU.

The reference's dry-run cannot run here (it writes `os.environ` when
imported, and its compile gate fails on jax 0.9), so what the port builds
is held to the reference's pieces: the input stand-ins of every cell, the
abstract parameters and their logical axes, `model_flops` and
`slstm_correction`, all equal.  What the port counts on meta tensors is
held to hand counts on reduced configs: a dense train step's matrix
products exactly (phase 3k's formula, with the remat recompute stopping
before the last product as `torch.utils.checkpoint` does), a two-layer
step's collective bytes exactly, and the scaled sequence loops (sLSTM
tokens, Mamba-2 chunks) against a full count within 1 %.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo_analysis as jhlo
from repro.launch import specs as jspecs
from repro.models.api import get_model as jget_model
from repro_torch import configs, tree
from repro_torch.configs import SHAPES, Shape
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hlo_analysis, specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.api import get_model
from repro_torch.nn.core import is_axes

FAMILIES = ("internlm2-1.8b", "deepseek-moe-16b", "jamba-1.5-large-398b", "xlstm-125m",
            "whisper-tiny", "internvl2-1b")
SMALL = {"train": Shape("train_s", 32, 4, "train"),
         "prefill": Shape("prefill_s", 32, 4, "prefill"),
         "decode": Shape("decode_s", 32, 4, "decode")}


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _jax_leaves(t, is_leaf=None):
    return [(jax.tree_util.keystr(k), v)
            for k, v in jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)[0]]


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_equal_reference_for_every_cell(arch):
    for a, shape in jconfigs.cells():
        if a != arch:
            continue
        want = [(k, tuple(v.shape), _dtype(v)) for k, v in
                _jax_leaves(jspecs.input_specs(a, shape))]
        got = tree.flatten_with_path(specs.input_specs(a, shape))
        assert [(k, tuple(v.shape), _dtype(v)) for k, v in got] == want, shape
        assert all(v.device.type == "meta" for _, v in got)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_abstract_params_and_axes_equal_reference(arch):
    jparams, jaxes = jget_model(jconfigs.get_config(arch)).init_params(
        jax.random.PRNGKey(0), abstract=True)
    model = get_model(configs.get_config(arch))
    params = tree.flatten_with_path(model.init_params(abstract=True))
    want = [(k, tuple(v.shape), _dtype(v)) for k, v in _jax_leaves(jparams)]
    assert [(k, tuple(v.shape), _dtype(v)) for k, v in params] == want
    assert all(v.device.type == "meta" for _, v in params)
    flat_axes = []

    def walk(t, path):
        if is_axes(t):
            flat_axes.append((path, t))
        else:
            for k in sorted(t):
                walk(t[k], f"{path}[{k!r}]")

    walk(model.param_axes(), "")
    assert flat_axes == _jax_leaves(jaxes, is_leaf=is_axes)


def test_model_flops_and_slstm_correction_equal_reference():
    for arch, shape in configs.cells(include_skipped=True):
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        assert hlo_analysis.model_flops(cfg, SHAPES[shape]) == \
            jhlo.model_flops(jcfg, jconfigs.SHAPES[shape])
        one = dryrun.analysis_cfg(cfg, 1)
        jone = dataclasses.replace(jcfg, n_layers=one.n_layers,
                                   n_encoder_layers=one.n_encoder_layers)
        for chips in (256, 512):
            for c, jc in ((cfg, jcfg), (one, jone)):
                assert hlo_analysis.slstm_correction(c, SHAPES[shape], chips) == \
                    jhlo.slstm_correction(jc, jconfigs.SHAPES[shape], chips)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_ok_on_a_debug_mesh(arch, kind):
    """Each family's reduced config builds and runs on a 2 x 2 mesh, costs
    no kernel launch, and its per-device bytes and roofline are sane."""
    before = ops.launch_counts()
    r = dryrun.run_cell(arch, SMALL[kind], cfg=configs.get_reduced(arch),
                        mesh=make_debug_mesh(2, 2), verbose=False)
    assert r["ok"], r.get("traceback")
    assert ops.launch_counts() == before
    mem, roof = r["memory"], r["roofline"]
    assert r["chips"] == 4 and r["mesh"] == "2x2"
    assert mem["params"] > 0 and mem["peak"] > mem["params"] + mem["opt_state"] + mem["cache"]
    assert (mem["opt_state"] > 0) == (mem["grads"] > 0) == (kind == "train")
    assert (mem["cache"] > 0) == (kind == "decode")
    assert roof["flops_per_device"] > 0 and roof["hbm_bytes_per_device"] > 0
    assert roof["collective_bytes_per_device"] > 0 and roof["bottleneck"] in (
        "compute", "memory", "collective")


def _dense_hand_count(cfg, B, S):
    """Phase 3k's operations of a remat="full" train step: the bf16
    products of the layers and the head forward and twice in backward, the
    layers' once more in the remat forward but for the down projection
    (the recompute stops at the last tensor the backward needs); the f32
    attention squares forward, recomputed and twice in backward (4 passes;
    the chunked path's chunk checkpoints add half a pass, their recompute
    also stopping before the P V product)."""
    tok, L = B * S, cfg.n_layers
    d, hd, nq, nkv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    layer_mm = 2 * (d * nq * hd * 2 + 2 * d * nkv * hd + 3 * d * cfg.d_ff)
    head_mm = 2 * d * cfg.padded_vocab
    attn_sq = L * 2 * 2 * B * nq * S * S * hd
    bf16 = tok * 3 * (L * layer_mm + head_mm) + tok * L * (layer_mm - 2 * d * cfg.d_ff)
    f32 = attn_sq * (4.5 if cfg.attn_impl == "chunked" else 4.0)
    return bf16, f32


@pytest.mark.parametrize("attn", ["naive", "chunked"])
def test_dense_train_step_operations_equal_hand_count(attn):
    cfg = dataclasses.replace(configs.get_reduced("internlm2-1.8b"), remat="full",
                              attn_impl=attn, attn_chunk=8)
    B, S = 4, 32
    shape = Shape("t", S, B, "train")
    counts = dryrun.measure(cfg, shape, make_debug_mesh(1, 1), "train")
    bf16, f32 = _dense_hand_count(cfg, B, S)
    assert counts["ops"]["bfloat16"] == bf16
    assert counts["ops"]["float32"] == f32
    assert set(counts["ops"]) == {"bfloat16", "float32"} and counts["kernels"] == {}
    # the same counts over 4 cards: each holds a quarter, the compute term
    # each dtype's share at its peak
    roof = dryrun.roofline_terms(cfg, shape, make_debug_mesh(2, 2), "train", 4)
    assert roof.flops_by_dtype == {"bfloat16": bf16 / 4, "float32": f32 / 4}
    assert roof.t_compute == pytest.approx(bf16 / 4 / 989e12 + f32 / 4 / 67e12, rel=1e-12)


@pytest.mark.parametrize("arch,kind", [("xlstm-125m", "train"), ("xlstm-125m", "prefill"),
                                       ("jamba-1.5-large-398b", "train")])
def test_scaled_sequence_loops_match_a_full_count(arch, kind):
    """The sLSTM tokens and the Mamba-2 / mLSTM chunks counted from 3 and 4
    iterations and scaled equal a count that runs every iteration: the
    operations and bytes within 1 %, the live peak within 5 %."""
    cfg = dryrun.analysis_cfg(configs.get_reduced(arch), 1)
    shape = Shape("s", 64, 2, kind)
    mesh = make_debug_mesh(1, 1)
    total = cfg.param_counts()["total"]
    full = dryrun._count(cfg, shape, mesh, dryrun.pick_layout(shape), total, {})
    scaled = dryrun._count_scaled(cfg, shape, mesh, dryrun.pick_layout(shape), total)
    assert full["loops"] == {}
    for dt, n in full["ops"].items():
        assert scaled["ops"][dt] == pytest.approx(n, rel=0.01), dt
    assert scaled["bytes"] == pytest.approx(full["bytes"], rel=0.01)
    assert scaled["peak"] == pytest.approx(full["peak"], rel=0.05)


def _collective_hand_count(cfg, B, S, kind):
    """Reduced internlm2-1.8b (remat none) on a 2 x 2 (data, model) mesh
    under the train / serve layout: bytes per device by kind."""
    d, V, L, ff = cfg.d_model, cfg.padded_vocab, cfg.n_layers, cfg.d_ff
    q, kv = cfg.n_heads * cfg.resolved_head_dim, cfg.n_kv_heads * cfg.resolved_head_dim
    b2 = 2                                        # bf16
    act = B * S * d * b2 / 2                      # [B, S, d] over the batch's 2 devices
    uses = 1 if kind == "prefill" else 2          # forward (and the backward's input grad)
    # weight all-gathers: embed_fsdp (data) gathered, the other dim stays on model
    per_layer = (d * q + 2 * d * kv + q * d + 3 * d * ff) * b2 / 2
    gather = L * uses * per_layer + V * d * b2 / 2 + uses * d * V * b2 / 2
    # all-reduces (ring weight 2): wo and w_down forward; backward the input
    # grads of wq, wk, wv, w_gate, w_up and the head
    reduce = L * 2 * 2 * act
    out = {"all-gather": gather}
    if kind == "train":
        reduce += (L * 5 + 1) * 2 * act
        # gradients: reduce-scatter of every gathered weight (over its model
        # shard), all-reduce of the norms over data
        out["reduce-scatter"] = (L * per_layer * 2 + 2 * V * d * b2) / 2
        reduce += 2 * (d + 2 * L * d) * b2
    out["all-reduce"] = reduce
    return out


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_two_layer_collective_bytes_equal_hand_count(kind):
    cfg = dataclasses.replace(configs.get_reduced("internlm2-1.8b"), remat="none")
    assert cfg.n_layers == 2
    B, S = 8, 16
    shape = Shape("c", S, B, kind)
    counts = dryrun.measure(cfg, shape, make_debug_mesh(2, 2), dryrun.pick_layout(shape))
    want = _collective_hand_count(cfg, B, S, kind)
    assert counts["coll_bytes"] == pytest.approx(want, rel=1e-12)
    one = dryrun.measure(cfg, shape, make_debug_mesh(1, 1), dryrun.pick_layout(shape))
    assert one["coll_bytes"] == {}                # a 1 x 1 mesh moves nothing


def test_meta_kernel_wrappers_report_work_and_launch_nothing():
    meta = torch.device("meta")
    heard = []
    before = ops.launch_counts()
    ops.meta_listeners.append(lambda *a: heard.append(a))
    try:
        q = torch.empty(2, 8, 64, 128, dtype=torch.bfloat16, device=meta)
        k = torch.empty(2, 4, 64, 128, dtype=torch.bfloat16, device=meta)
        o = ops.flash_attention(q, k, k)
        assert o.shape == q.shape and o.dtype == q.dtype and o.device == meta
        qd = torch.empty(2, 8, 128, dtype=torch.bfloat16, device=meta)
        lengths = torch.empty(2, dtype=torch.int32, device=meta)
        od = ops.decode_attention(qd, k, k, lengths)
        assert od.shape == qd.shape and od.dtype == torch.bfloat16
        qc = torch.empty(3, 50, device=meta)
        assert ops.bm25_scores(qc, torch.empty(50, 7, device=meta)).shape == (3, 7)
        assert ops.qos_scores(torch.empty(9, 64, device=meta)).shape == (9,)
        sel = torch.empty(3, 20, device=meta)
        idx, C, N, Sc = ops.fused_select(sel, sel, torch.empty(20, device=meta), k=4,
                                         alpha=0.5, beta=0.5)
        assert idx.dtype == torch.int32 and idx.shape == C.shape == N.shape == Sc.shape == (3,)
        res = ops.fused_score_select(
            qc, torch.empty(20, 50, device=meta), torch.empty(20, dtype=torch.int32, device=meta),
            torch.empty(3, 4, dtype=torch.int32, device=meta), torch.empty(20, device=meta),
            k=4, alpha=0.5, beta=0.5)
        assert [t.shape for t in res] == [(3,)] * 4
    finally:
        ops.meta_listeners.pop()
    assert ops.launch_counts() == before
    names = [h[0] for h in heard]
    assert names == ["flash_attention", "decode_attention", "bm25_scores", "qos_scores",
                     "fused_select", "fused_score_select"]
    # phase 4's reckoning: flash 4 B Hq S^2 D / 2 (causal), q k v read and o
    # written; decode 4 B Hq S D, the cache and q read, o written
    assert heard[0][1:] == (4 * 2 * 8 * 64 * 64 * 128 / 2, 2 * (2 * q.numel() + 2 * k.numel()),
                            torch.bfloat16)
    assert heard[1][1:] == (4 * 2 * 8 * 64 * 128, 2 * (2 * k.numel() + 2 * qd.numel()),
                            torch.bfloat16)
    with pytest.raises(ValueError, match="mixed devices"):
        ops.flash_attention(q, k, torch.empty(2, 4, 64, 128, dtype=torch.bfloat16))
    with pytest.raises(RuntimeError, match="forward only"):
        with torch.enable_grad():
            ops.flash_attention(q.requires_grad_(), k, k)


def test_dryrun_main_writes_a_cell_and_leaves_the_environment(tmp_path):
    env = dict(os.environ)
    for extra in ([], ["--no-roofline", "--multi-pod"]):
        with pytest.raises(SystemExit) as done:
            dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                         "--out", str(tmp_path)] + extra)
        assert done.value.code == 0
    assert dict(os.environ) == env
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["internlm2-1.8b__decode_32k__16x16__serve.json",
                     "internlm2-1.8b__decode_32k__2x16x16__serve.json"]
    r = json.loads((tmp_path / files[0]).read_text())
    assert {"arch", "shape", "mesh", "layout", "chips", "ok", "layout_drops",
            "n_layout_drops", "roofline", "memory"} <= set(r)
    assert set(jhlo.Roofline(0, 0, 0, 1, jhlo.CollectiveStats({}, {})).to_dict()) <= \
        set(r["roofline"])
    cfg = configs.get_config("internlm2-1.8b")
    # decode_32k's cache: 24 layers of k and v [128, 32768, 8, 128] bf16
    # over (data, model): batch over 16 cards, sequence over 16
    assert r["memory"]["cache"] == 24 * 2 * 128 * 32768 * 8 * 128 * 2 / 256
    assert r["ok"] and r["chips"] == 256 and r["attn_impl"] == cfg.attn_impl
    r2 = json.loads((tmp_path / files[1]).read_text())
    assert r2["ok"] and r2["chips"] == 512 and "roofline" not in r2
