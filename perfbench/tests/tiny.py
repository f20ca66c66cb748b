"""A copy of the benchmark's files at sizes a CPU test run can hold.

`tiny_root(tmp_path)` copies ``BENCHMARK.json`` and ``perfbench/`` into
``tmp_path`` and shrinks each configuration and traffic mix there; the
harness then runs a cell from that root on the CPU, where every kernel of
the port runs its plain version.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 512,
              "torch_dtype": "float32"}
TINY_FLEET = {"n_servers": 3000, "n_shards": 2, "weights_dtype": "float32"}
TINY_MIX = {
    "internlm2-1.8b.train-4x2048": {"batch": 2, "seq_len": 32, "traced_steps": 1},
    "netmcp-mega-1m.sonar_ft-b256": {"batch": 16, "n_windows": 4, "sample_batches": 2},
    "internlm2-1.8b.serve-agent": {"prompt_median": 40, "prompt_min": 16, "prompt_max": 90,
                                   "out_min": 2, "out_max": 6, "rate_per_s": 20.0,
                                   "n_slots": 4, "cap": 128, "sample_requests": 3,
                                   "trace_from": 0.5, "trace_to": 1.0},
}


def edit_json(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def tiny_root(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    edit_json(root / "perfbench/configs/internlm2-1.8b.json",
              lambda d: d["model"].update(TINY_MODEL))
    edit_json(root / "perfbench/configs/netmcp-mega-1m.json",
              lambda d: d["fleet"].update(TINY_FLEET))
    for name, mix in TINY_MIX.items():
        path = root / "perfbench/workloads" / f"{name}.json"
        if path.exists():
            edit_json(path, lambda d, mix=mix: d["mix"].update(mix))
    return root
