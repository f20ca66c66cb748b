"""The harness on the CPU: cells found by name, a cell added as files alone,
the import guard, the refusal without a card, and each cell's checks
failing when the timed path is broken underneath."""
import json
import os
import subprocess
import sys

import pytest

from perfbench.harness import core
from perfbench.tests.tiny import ROOT, edit_json, tiny_root

CELLS = ("internlm2-1.8b.train-4x2048", "netmcp-mega-1m.sonar_ft-b256",
         "internlm2-1.8b.serve-agent")
SEED = 6_000_000_001          # past 32 bits, as the benchmark's seeds may be


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("perfbench"))


def _run(root, cell, trace=False, seed=SEED):
    bench, ctx, res = core.run_cell(root, cell, seed, 0.5, trace, device="cpu")
    return core.result_line(bench, ctx, res, "cpu", "cpu", 1), res


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_and_reports_its_metrics(root, cell):
    line, _ = _run(root, cell)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in core.metrics_of(bench, cell, "end_to_end")}
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "checks" and line["checks"]


def test_traced_run_reads_per_layer_metrics(root):
    line, res = _run(root, "internlm2-1.8b.serve-agent", trace=True)
    assert line["correct"]
    assert {"queue_wait_p90_ms.serve", "mfu.serve", "decode_step_ms.serve"} <= set(line["metrics"])
    assert line["device"]["window_s"] > 0 and "breakdown" in line
    assert res.trace_work["prefill_lengths"]


def test_a_cell_added_as_files_alone_is_run(root, tmp_path):
    """A new configuration and cell: a config file, a cell file and their
    entries in BENCHMARK.json, no code."""
    import shutil

    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    cfg = json.loads((new / "perfbench/configs/internlm2-1.8b.json").read_text())
    cfg["name"] = "internlm2-narrow"
    cfg["model"].update(hidden_size=32, intermediate_size=96)
    (new / "perfbench/configs/internlm2-narrow.json").write_text(json.dumps(cfg))
    spec = json.loads((new / "perfbench/workloads/internlm2-1.8b.train-4x2048.json").read_text())
    spec.update(name="internlm2-narrow.train-3x16", config="internlm2-narrow",
                traffic="train-3x16")
    spec["mix"].update(batch=3, seq_len=16)
    (new / "perfbench/workloads/internlm2-narrow.train-3x16.json").write_text(json.dumps(spec))

    def add(b):
        b["configs"].append({"name": "internlm2-narrow", "source": "https://example.org/narrow",
                             "file": "perfbench/configs/internlm2-narrow.json", "reduced": [],
                             "why": "a narrower copy"})
        b["workloads"].append({"name": "internlm2-narrow.train-3x16", "config": "internlm2-narrow",
                               "traffic": "train-3x16", "chips": 1, "why": "a new cell"})
        for m in b["end_to_end"] + b["per_layer"]:
            if "internlm2-1.8b.train-4x2048" in m.get("workloads", []):
                m["workloads"].append("internlm2-narrow.train-3x16")

    edit_json(new / "BENCHMARK.json", add)
    line, res = _run(new, "internlm2-narrow.train-3x16")
    assert line["correct"] and "train_tokens_per_s" in line["metrics"]
    assert res.values["batch"] == 3 and res.dims["d"] == 32


def test_unknown_cell_is_refused(root):
    with pytest.raises(SystemExit):
        core.find_cell(root, "no-such.cell")


def test_import_guard_compares_whole_top_level_names():
    assert core.forbidden_modules(["repro_torch", "repro_torch.core", "reprox", "jaxtyping"]) == []
    assert core.forbidden_modules(["repro.core.bm25", "numpy"]) == ["repro"]
    assert core.forbidden_modules(["jax", "jaxlib.xla", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_benchmark_process_loads_no_jax():
    """A cell's modules, imported in a fresh process, bring in neither JAX
    nor the JAX package."""
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import perfbench.harness.core as c, perfbench.drivers.train, "
            "perfbench.drivers.route, perfbench.drivers.serve\n"
            "import repro_torch.training.train_step, repro_torch.core.mesh_routing, "
            "repro_torch.serving.engine, repro_torch.ft.failure\n"
            "print(c.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/: no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['.']\n"
            "from perfbench.harness import core\n"
            "core.run_cell(core.ROOT, 'internlm2-1.8b.train-4x2048', 1, 0.1, False, 'cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and "repro_torch" in out.stderr


# ---------------------------------------------------------------------------
# Faults planted underneath the timed path: `correct` comes out false
# ---------------------------------------------------------------------------

def _fault_unchanged_state(monkeypatch):
    from repro_torch.training import optimizer

    def update(self, grads, state, params):
        return params, state._replace(step=state.step + 1), optimizer.global_norm(grads)

    monkeypatch.setattr(optimizer.AdamW, "update", update)


def _fault_half_batch(monkeypatch):
    from repro_torch.models import api

    loss = api.Model.loss

    def half(self, params, batch):
        n = batch["tokens"].shape[0] // 2
        return loss(self, params, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(api.Model, "loss", half)


def _fault_decision(monkeypatch):
    from repro_torch.core import mesh_routing

    route = mesh_routing.ShardedRoutingEngine.route

    def altered(self, *a, **kw):
        d = route(self, *a, **kw)
        d.tool_idx = d.tool_idx.copy()
        d.tool_idx[len(d.tool_idx) // 2] ^= 1          # the other tool of the same server
        return d

    monkeypatch.setattr(mesh_routing.ShardedRoutingEngine, "route", altered)


def _fault_token(monkeypatch):
    from repro_torch.serving import engine

    pick = engine.ServeEngine._next_tokens

    def altered(self, logits, reqs):
        toks = pick(self, logits, reqs)
        return [t + 1 if i == 0 else t for i, t in enumerate(toks)]

    monkeypatch.setattr(engine.ServeEngine, "_next_tokens", altered)


@pytest.mark.parametrize("cell,fault", [
    ("internlm2-1.8b.train-4x2048", _fault_unchanged_state),
    ("internlm2-1.8b.train-4x2048", _fault_half_batch),
    ("netmcp-mega-1m.sonar_ft-b256", _fault_decision),
    ("internlm2-1.8b.serve-agent", _fault_token),
], ids=["train-state-unchanged", "train-half-batch", "route-answer-altered",
        "serve-token-altered"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    line, _ = _run(root, cell)
    assert line["correct"] is False


@pytest.mark.parametrize("cell,name", [
    ("internlm2-1.8b.train-4x2048", "fp8"),
    ("internlm2-1.8b.train-4x2048", "half_batch"),
    ("netmcp-mega-1m.sonar_ft-b256", "int8"),
    ("internlm2-1.8b.serve-agent", "fp8"),
])
def test_the_control_fails_a_limit(root, cell, name):
    """The lower-precision control (and the planted half batch) read above
    one of the cell's limits at this size too."""
    bench, ctx = core.make_context(root, cell, SEED, 0.5, False, "cpu")
    got = core.load_driver(ctx.spec["driver"]).control(ctx, name)
    assert any(got[k] > ctx.spec["limits"][k] for k in got), got
