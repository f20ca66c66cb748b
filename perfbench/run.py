"""Run one benchmark cell of the PyTorch/CUDA port once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and checks:
each number compared with its limit); the checks are also the last lines
of standard error.  See perfbench/harness/core.py.
"""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench.harness import core  # noqa: E402

_T0 = core.process_start_monotonic()

if __name__ == "__main__":
    sys.exit(core.main(t0=_T0))
