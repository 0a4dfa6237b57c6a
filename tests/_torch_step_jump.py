"""The first losses of a full-width model, in the reference and in the
port, from the same weights on the same batches: does the loss jump after
the first update in both?

The train CLI's schedule: ``clip_by_global_norm(1.0)``, AdamW at
``cosine_schedule(step, peak=3e-3, warmup=20, total=steps)`` (lr 0 at step
0, so step 2's loss is the first after a real update), batches
``SyntheticTokens(vocab, seed=0).batch(step, 0, B, S)``.

  # the reference (JAX, CPU): writes its init_params (f32) to DIR
  PYTHONPATH=src python tests/_torch_step_jump.py ref --dir DIR
  # the port on the CPU from those weights (carried by model.convert)
  PYTHONPATH=src python tests/_torch_step_jump.py port --dir DIR
  # the port on the card from its own seeded weights, f32 or bf16
  PYTHONPATH=src python tests/_torch_step_jump.py port --device cuda \\
      --dtype bf16

Defaults: granite-8b at full width and 2 layers (637.5 M parameters), B 1
x S 128, 3 steps, f32.  ``--steps 0`` takes the loss of the first batch
at the initial weights and no step (no gradient, no optimizer state), so
a larger model fits: ``--arch gemma3-12b --layers 6 --steps 0``.  The
``port`` side imports no JAX.  Each side prints one ``step_jump {...}``
JSON line with its losses and grad norms.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import resource
import time

import numpy as np

PEAK_LR, WARMUP = 3e-3, 20


def _ref(args):
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import optim as joptim
    from repro.data import SyntheticTokens
    from repro.model import lm as jlm

    cfg = dataclasses.replace(jconfigs.get(args.arch), n_layers=args.layers)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jlm.init_params(cfg, jax.random.PRNGKey(0)))
    os.makedirs(args.dir, exist_ok=True)
    with open(os.path.join(args.dir, "init.pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f, protocol=5)
    src = SyntheticTokens(cfg.vocab, seed=0)
    out = {"side": "ref", "device": "cpu", "dtype": "f32", "losses": [],
           "grad_norms": [], "lr": []}
    if args.steps == 0:
        toks = jnp.asarray(src.batch(0, 0, args.batch, args.seq))
        out["losses"].append(float(jax.jit(lambda p, t: jlm.loss_fn(
            p, cfg, {"tokens": t}))(params, toks)))
        return cfg, out
    opt = joptim.adamw_init(params)

    @jax.jit
    def train_step(params, opt_state, tokens, lr):
        loss, grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, cfg, {"tokens": tokens}))(params)
        grads, gn = joptim.clip_by_global_norm(grads, 1.0)
        params, opt_state = joptim.adamw_update(params, grads, opt_state,
                                                lr=lr)
        return params, opt_state, loss, gn

    for step in range(args.steps):
        lr = joptim.cosine_schedule(step, peak=PEAK_LR, warmup=WARMUP,
                                    total=args.steps)
        toks = jnp.asarray(src.batch(step, 0, args.batch, args.seq))
        params, opt, loss, gn = train_step(params, opt, toks, lr)
        out["losses"].append(float(loss))
        out["grad_norms"].append(float(gn))
        out["lr"].append(float(lr))
    return cfg, out


def _port(args):
    import torch

    from repro_torch import configs, optim
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.model import convert, lm

    cfg = dataclasses.replace(configs.get(args.arch), n_layers=args.layers)
    dtype = torch.float32 if args.dtype == "f32" else None
    if args.dir:
        with open(os.path.join(args.dir, "init.pkl"), "rb") as f:
            params = convert.from_jax_params(pickle.load(f), cfg,
                                             device=args.device, dtype=dtype)
    else:
        params = lm.init_params(cfg, seed=0, device=args.device)
        if dtype is not None:
            params = params.to(dtype)
    src = SyntheticTokens(cfg.vocab, seed=0)
    out = {"side": "port", "device": args.device, "dtype": args.dtype,
           "init": "reference" if args.dir else "port seed 0", "losses": [],
           "grad_norms": [], "lr": []}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    if args.steps == 0:
        toks = torch.from_numpy(src.batch(0, 0, args.batch, args.seq))
        with torch.no_grad():
            out["losses"].append(float(lm.loss_fn(
                params, cfg, {"tokens": toks.to(args.device)})))
        return cfg, out
    params.requires_grad_(True)
    opt = optim.adamw_init(params.named_parameters())
    for step in range(args.steps):
        lr = optim.cosine_schedule(step, peak=PEAK_LR, warmup=WARMUP,
                                   total=args.steps)
        toks = torch.from_numpy(src.batch(step, 0, args.batch, args.seq))
        loss, gn = train.train_step(params, cfg, opt, toks.to(args.device),
                                    lr)
        out["losses"].append(float(loss))
        out["grad_norms"].append(float(gn))
        out["lr"].append(lr)
    return cfg, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("side", choices=("ref", "port"))
    ap.add_argument("--dir", default=None,
                    help="where ref writes its init and port reads it")
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args(argv)
    if args.side == "ref" and (args.dir is None or args.device != "cpu"
                               or args.dtype != "f32"):
        raise SystemExit("ref: runs on the CPU in f32 and needs --dir")
    t0 = time.perf_counter()
    cfg, out = (_ref if args.side == "ref" else _port)(args)
    out.update(arch=cfg.name, layers=cfg.n_layers,
               params_m=round(cfg.param_count() / 1e6, 1),
               batch=args.batch, seq=args.seq,
               seconds=round(time.perf_counter() - t0, 1),
               host_peak_rss_gb=round(resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, 2))
    print("step_jump " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
