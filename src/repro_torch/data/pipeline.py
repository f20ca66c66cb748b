"""Deterministic synthetic token pipeline, twin of `repro.data.pipeline`.

Reproducible training batches without external data: a seeded per-step
stream with a Zipf marginal over the first min(vocab, 4096) token ids and
an induced structure (with p = 0.5 a token copies the previous one), so
the loss falls in the end-to-end runs.

`make_batch` draws from a CPU `torch.Generator` seeded from (seed, step),
so the CPU and the card train on the same batch; the caller moves it to
its device.  The reference draws from `jax.random`, so the bits differ and
parity tests feed both sides the reference's batches; `_zipf_probs` is
numpy and byte-equal to the reference's.  `host_shard` slices one host's
rows of the global batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


def _zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = r ** (-alpha)
    return (p / p.sum()).astype(np.float32)


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step) through numpy's SeedSequence
    (distinct steps and seeds give unrelated streams)."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(state))


def make_batch(cfg: DataConfig, step: int) -> dict:
    """Global batch for ``step`` (deterministic): {"tokens", "labels"} int32
    [global_batch, seq_len] on the CPU, labels the tokens shifted left by
    one with -100 last."""
    gen = _generator(cfg.seed, step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    probs = torch.from_numpy(_zipf_probs(min(V, 4096), cfg.zipf_alpha))
    base = torch.multinomial(probs, B * S, replacement=True, generator=gen).reshape(B, S)
    # induce structure: with p=0.5 copy the previous token (learnable signal)
    copy = torch.rand((B, S), generator=gen) < 0.5
    tokens = torch.where(copy, torch.roll(base, 1, dims=1), base).to(torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -100
    return {"tokens": tokens, "labels": labels}


def host_shard(batch: dict, host_id: int, n_hosts: int) -> dict:
    def shard(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per : (host_id + 1) * per]

    return {k: shard(v) for k, v in batch.items()}
