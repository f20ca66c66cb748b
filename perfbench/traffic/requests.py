"""Open-loop serving traffic: one Poisson schedule for the cell.

The schedule is drawn from the mix's ``schedule_seed``, not from the
run's seed, so every run offers the same requests at the same times:

* gaps between arrivals: independent exponential draws at ``rate_per_s``
  per second (Poisson arrivals), the first arrival at 0;
* prompt lengths: lognormal (``prompt_median``, ``prompt_sigma``),
  rounded and clipped to [``prompt_min``, ``prompt_max``];
* output lengths: uniform over ``out_min`` .. ``out_max``.

Each of the three is its own stream, drawn as unit values (unit-rate gaps,
standard normals) and then scaled, so the first ``k`` arrivals of a
longer schedule are the first ``k`` of a shorter one, and a schedule at
another rate is the same one stretched in time: a rate sweep offers the
cell's own traffic.  The run's seed draws the prompts' tokens, uniform
over the vocabulary.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Arrival:
    rid: int
    due_s: float                 # from the window's start
    prompt: np.ndarray           # int64 [S]
    max_new_tokens: int


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(stream)]))


def schedule(seed: int, n: int, t: dict, vocab: int) -> list:
    """The first ``n`` arrivals of the mix ``t`` (a workload file's ``mix``),
    their prompts drawn from ``seed``."""
    fixed = int(t["schedule_seed"])
    gaps = _rng(fixed, 1).standard_exponential(n)
    due = (np.cumsum(gaps) - gaps[0]) / float(t["rate_per_s"])
    z = _rng(fixed, 2).standard_normal(n)
    lengths = np.exp(np.log(t["prompt_median"]) + t["prompt_sigma"] * z)
    lengths = np.clip(np.rint(lengths), t["prompt_min"], t["prompt_max"]).astype(np.int64)
    outs = _rng(fixed, 3).integers(t["out_min"], t["out_max"] + 1, n)
    tok = _rng(seed, 4)
    return [Arrival(i, float(due[i]), tok.integers(0, vocab, int(lengths[i]), dtype=np.int64),
                    int(outs[i])) for i in range(n)]


def enough(mean: float) -> int:
    """How many arrivals to draw so that every one due in a window that
    expects ``mean`` of them is among them (the Poisson count's mean plus
    ten standard deviations)."""
    return int(np.ceil(mean + 10.0 * np.sqrt(mean) + 10))
