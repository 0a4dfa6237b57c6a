"""End-to-end training driver: real steps, on the card by default.

Counterpart of ``repro/launch/train.py`` with its flags, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions): synthetic
data, checkpoint/restart (auto-resume from the latest step in
``--ckpt-dir``), and a simulated failure (``--fail-at``, exit 42) to
exercise the restart.  The step is ``lm.loss_fn`` -> ``backward()`` ->
``clip_by_global_norm(1.0)`` -> ``adamw_update`` at ``cosine_schedule``
(warm-up 20).  On the card the attention, the gathers (the embedding and
the MoE dispatch), the mamba2 and rwkv6 scans and the MoE's grouped
matmuls differentiate through their backward kernels, so every
architecture trains there (arctic-480b at a size that fits the card).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
      --device cpu

Unlike the JAX package's, a resumed run reads the data from the step it
resumes at (``ShardedLoader(start=...)``), so its losses equal the
unbroken run's; the JAX package's loader starts again at step 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ArchConfig
from repro_torch.data import ShardedLoader, SyntheticTokens
from repro_torch.model import lm
from repro_torch.obs import trace
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule)


@dataclasses.dataclass
class TrainRun:
    """What ``train`` ran: the first step (after a resume), each step's
    loss and gradient norm, and each step's seconds on the host clock,
    ended by a device synchronize; the trained params and AdamW state."""
    start: int
    losses: list[float]
    grad_norms: list[float]
    step_s: list[float]
    params: lm.LM
    opt: dict


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_step(params: lm.LM, cfg: ArchConfig, opt: dict, tokens,
               lr: float):
    """One step in place: loss and grads at the current params, clipped to
    global norm 1, then AdamW.  A parameter the loss does not reach
    (zamba2's second shared block in a one-H pattern) takes a zero
    gradient, as under ``jax.grad``.  Returns (loss, grad norm), 0-d
    tensors on the params' device.

    Under ``torch.profiler`` (or ``obs.trace.enable``) it records the span
    ``train.step`` and, tiling it, ``train.forward``, ``train.backward``
    and ``train.optimizer`` (the zero fills, the clip, AdamW and the
    reset of ``.grad``)."""
    with trace.span("train.step"):
        named = dict(params.named_parameters())
        with trace.span("train.forward"):
            loss = lm.loss_fn(params, cfg, {"tokens": tokens})
        with trace.span("train.backward"):
            loss.backward()
        with trace.span("train.optimizer"):
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                     for k, p in named.items()}
            grads, gn = clip_by_global_norm(grads, 1.0)
            adamw_update(named, grads, opt, lr=lr)
            for p in named.values():
                p.grad = None
    return loss.detach(), gn


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-3, seed: int = 0, device="cuda",
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          fail_at: int | None = None, log_every: int = 10) -> TrainRun:
    """Train ``cfg`` from random weights (seed ``seed``) or the latest
    checkpoint in ``ckpt_dir`` for steps start..steps-1 of ``batch`` x
    ``seq`` tokens, saving every ``ckpt_every`` steps (in the background)
    and at the end.  At step ``fail_at`` it raises ``SystemExit(42)``
    after the pending save is on disk."""
    device = lm.resolve_device(device)
    print(f"train: {cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"batch={batch} seq={seq} device={device}", flush=True)
    params = lm.init_params(cfg, seed=seed, device=device)
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    opt = adamw_init(named)
    start = 0
    if ckpt_dir:
        step0 = latest_step(ckpt_dir)
        if step0 is not None:
            print(f"restoring from step {step0}", flush=True)
            tree = restore_checkpoint(ckpt_dir, step0,
                                      {"params": named, "opt": opt})
            with torch.no_grad():
                for k, p in named.items():
                    p.copy_(tree["params"][k])
            opt = tree["opt"]
            start = step0

    loader = ShardedLoader(SyntheticTokens(cfg.vocab, seed=seed), shard=0,
                           batch=batch, seq=seq, start=start)
    run = TrainRun(start, [], [], [], params, opt)
    pending = None
    t_start = time.perf_counter()
    try:
        for step in range(start, steps):
            if fail_at is not None and step == fail_at:
                print(f"simulated failure at step {step}", flush=True)
                raise SystemExit(42)
            tokens = torch.from_numpy(next(loader)).to(device)
            lr_t = cosine_schedule(step, peak=lr, warmup=20, total=steps)
            t0 = time.perf_counter()
            loss, gn = train_step(params, cfg, opt, tokens, lr_t)
            _sync(device)
            run.step_s.append(time.perf_counter() - t0)
            run.losses.append(float(loss))
            run.grad_norms.append(float(gn))
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d} loss {run.losses[-1]:.4f} "
                      f"gnorm {run.grad_norms[-1]:.2f} lr {lr_t:.2e} "
                      f"({time.perf_counter() - t_start:.1f}s)", flush=True)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = save_checkpoint(ckpt_dir, step + 1,
                                          {"params": named, "opt": opt},
                                          asynchronous=True)
    finally:
        loader.close()
        if pending is not None:
            pending.join()
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, {"params": named, "opt": opt})
    if run.losses:
        losses = run.losses
        first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
        last = np.mean(losses[-10:])
        print(f"done: loss {first:.3f} -> {last:.3f} "
              f"({'LEARNED' if last < first - 0.05 else 'flat'})",
              flush=True)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a crash at this step (exit 42)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get(args.arch)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          seed=args.seed, device=args.device, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, fail_at=args.fail_at,
          log_every=args.log_every)


if __name__ == "__main__":
    main()
