"""Where the training step's device time goes, by kernel, on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_train [--arch ARCH]
      [--layers N]

Builds ``--arch`` (default granite-8b) at full width and ``--layers``
layers (default ``LAYERS``, 8, the depth of ``chip_smoke.py``'s granite
train run: all 36 of granite-8b with AdamW need ~97 GB; rounded down to a
whole number of the pattern's groups, at least one: zamba2-7b takes 27),
at B 4 x S 1024, then runs ``launch.train``'s step
(loss, backward, clip, AdamW) on ``SyntheticTokens(seed=0)`` batches: two
untraced warm-up steps, then two steps under ``torch.profiler``.  It
prints the wall time, the device-busy share (the union of the device
operations' intervals), the device time summed by kernel name, largest
first, and the device ms a step of the step's phases (the spans
``train.forward``, ``train.backward``, ``train.optimizer``).  Every
architecture trains on the card (arctic-480b only at a depth that fits:
~960 GB whole).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.data import SyntheticTokens
from repro_torch.launch import train
from repro_torch.launch.profile_serve import _report, _traced
from repro_torch.model import lm
from repro_torch.obs import trace
from repro_torch.optim import adamw_init

WARMUP, STEPS, LAYERS, B, S = 2, 2, 8, 4, 1024
PHASES = ("train.forward", "train.backward", "train.optimizer")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=configs.ARCHS)
    ap.add_argument("--layers", type=int, default=LAYERS)
    args = ap.parse_args(argv)
    device = lm.resolve_device("cuda")
    full = configs.get(args.arch)
    P = len(full.layer_pattern)
    layers = max(P, min(args.layers, full.n_layers) // P * P)
    cfg = dataclasses.replace(
        full, name=f"{args.arch} at {layers} of {full.n_layers} layers",
        n_layers=layers)
    params = lm.init_params(cfg, seed=0, device=device)
    params.requires_grad_(True)
    opt = adamw_init(dict(params.named_parameters()))
    src = SyntheticTokens(cfg.vocab, seed=0)
    batches = [torch.from_numpy(src.batch(i, 0, B, S)).to(device)
               for i in range(WARMUP + STEPS)]
    for tokens in batches[:WARMUP]:
        train.train_step(params, cfg, opt, tokens, 1e-4)

    def steps():
        for tokens in batches[WARMUP:]:
            train.train_step(params, cfg, opt, tokens, 1e-4)

    print(f"{cfg.name} on {torch.cuda.get_device_name(0)}: "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"params, B {B} x S {S}")
    trace.clear()
    _report(f"train {STEPS} steps", *_traced(steps), top=20)
    spans = trace.drain()
    for phase in PHASES:
        ms = [e["dev_ms"] for e in spans if e["name"] == phase]
        print(f"  {phase}: {sum(ms) / len(ms):.3f} ms a step on the device")


if __name__ == "__main__":
    main()
