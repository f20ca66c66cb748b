"""Training batches from the seed: a frozen copy of the port's
`data/pipeline.py` generator (kept here so the yardstick does not move
when the program's pipeline does).

Each step's batch is drawn from a CPU `torch.Generator` seeded from (seed,
step) through numpy's SeedSequence: a Zipf(``alpha``) marginal over the
first min(vocab, 4096) ids, and with probability 0.5 a token copies the
one before it, so the loss has something to learn.  Labels are the tokens
shifted left by one, -100 last.  Every step's rows differ.
"""
from __future__ import annotations

import numpy as np
import torch


def _generator(seed: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(state))


def zipf_probs(vocab: int, alpha: float) -> torch.Tensor:
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = r ** (-alpha)
    return torch.from_numpy((p / p.sum()).astype(np.float32))


def batch(seed: int, step: int, B: int, S: int, vocab: int, alpha: float) -> dict:
    """{"tokens", "labels"} int32 [B, S] on the CPU for ``step``."""
    gen = _generator(seed, step)
    base = torch.multinomial(zipf_probs(min(vocab, 4096), alpha), B * S, replacement=True,
                             generator=gen).reshape(B, S)
    copy = torch.rand((B, S), generator=gen) < 0.5
    tokens = torch.where(copy, torch.roll(base, 1, dims=1), base).to(torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -100
    return {"tokens": tokens, "labels": labels}
