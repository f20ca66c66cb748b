"""Fault-tolerant training driver, twin of `repro.launch.train`.

Wires together: data pipeline -> train step (autograd, AdamW) ->
checkpoint/restart -> SONAR fleet monitoring (straggler and crash
detection on per-pod step-time telemetry, scored by the QoS kernel on the
card) -> elastic re-plan.  One card trains the model; the pods are
simulated (`FailureInjector` supplies their step times, the healthy pods
taking at least the real step's wall time), as in the reference.

``--device`` picks where it runs: the CUDA card by default (it raises
without one), ``cpu`` for the plain PyTorch versions of the kernels.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --full \\
      --steps 8 --batch 4 --seq 2048 --inject-failures
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --reduced \\
      --steps 50 --batch 8 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.failure import FailureInjector, FleetMonitor, plan_elastic
from repro_torch.models.api import get_model
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import make_train_step


def add_batch_extras(batch, cfg, B, rng):
    """A VLM's ``patches`` [B, V, d] and an encoder-decoder's ``frames``
    [B, F, d], f32 on the CPU, drawn from the numpy ``rng`` as the
    reference draws them."""
    if cfg.n_vision_tokens:
        batch["patches"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    return batch


def train_loop(
    cfg,
    steps: int = 50,
    global_batch: int = 8,
    seq_len: int = 128,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    n_pods: int = 4,
    inject_failures: bool = False,
    grad_compression_bits: Optional[int] = None,
    log_every: int = 10,
    seed: int = 0,
    device=None,
    records: Optional[list] = None,
):
    """Trains ``cfg`` from random weights drawn from ``seed`` on ``device``
    (None: the card) and returns the losses of the steps it ran (a restart
    resumes after the latest checkpoint in ``ckpt_dir``).  With
    ``records``, appends one dict per step: step, loss, grad_norm, seconds
    (the step's wall time, what the healthy pods report), telemetry (the monitor's [n_pods, 64] window
    after the step, host copy), scores and healthy (after the step)."""
    dev = resolve_device(device)
    model = get_model(cfg)
    opt = AdamW(lr=1e-3, warmup_steps=20)
    params = model.init_params(seed, device=dev)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, grad_compression_bits)

    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch, seed=seed
    )
    rng = np.random.default_rng(seed)

    start = 0
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            (params, opt_state), extras = ckpt.restore(
                ckpt_dir, last, (params, opt_state)
            )
            start = extras["next_step"]
            print(f"[restore] resumed from step {last}")

    # fleet telemetry: per-pod step times scored with the paper's QoS (Eq. 7)
    injector = FailureInjector(n_pods, base_step_s=1.0, seed=seed)
    monitor = FleetMonitor(n_pods, base_step_s=1.0, device=dev)
    healthy = list(range(n_pods))
    losses = []

    for step in range(start, steps):
        if inject_failures:
            if step == steps // 3:
                injector.straggle(1, factor=8.0)
                print(f"[inject] pod 1 straggling at step {step}")
            if step == steps // 2:
                injector.crash(2)
                print(f"[inject] pod 2 crashed at step {step}")

        batch = make_batch(data_cfg, step)
        batch = add_batch_extras(dict(batch), cfg, global_batch, rng)
        batch = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.monotonic()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        losses.append(loss)

        # fleet step: healthy pods take the real step time; injected pods
        # report their simulated (straggling / hung) times
        times = injector.step_times()
        times[healthy] = np.maximum(times[healthy], dt)
        monitor.record(times)
        plan = plan_elastic(monitor, global_batch, healthy)
        if plan.changed:
            excluded = sorted(set(healthy) - set(plan.healthy))
            print(
                f"[elastic] step {step}: excluding pods {excluded} "
                f"(QoS scores {np.round(monitor.scores(), 2)}); "
                f"{plan.n_pods} pods remain, per-pod batch -> {plan.per_pod_batch}"
            )
            healthy = plan.healthy
            if ckpt_dir:
                # restart path: persist, rebuild mesh over survivors, resume
                ckpt.save(ckpt_dir, step, (params, opt_state), {"next_step": step + 1})
                print(f"[elastic] checkpointed at step {step}; resuming on shrunk fleet")

        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, (params, opt_state), {"next_step": step + 1})
        if records is not None:
            records.append({
                "step": step, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                "seconds": dt, "telemetry": monitor.telemetry.cpu().numpy(),
                "scores": monitor.scores().copy(), "healthy": list(plan.healthy),
            })
        if step % log_every == 0 or step == steps - 1:
            print(
                f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                f"({time.monotonic() - t0:.2f}s) pods={len(healthy)}"
            )
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--inject-failures", action="store_true")
    ap.add_argument("--grad-compression-bits", type=int, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get_config(args.arch)
    losses = train_loop(
        cfg,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt_dir,
        inject_failures=args.inject_failures,
        grad_compression_bits=args.grad_compression_bits,
        device=args.device,
    )
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    assert losses[-1] < losses[0], "loss did not decrease"


if __name__ == "__main__":
    main()
