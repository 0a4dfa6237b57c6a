"""Batched serving: prefill a batch of prompts, then decode greedily
with the KV cache.

Counterpart of ``repro/launch/serve.py``, with the same flags and printed
lines, plus ``--device`` (default ``cuda``).  On the card every attention,
scan, expert FFN and embedding lookup runs through the hand-written CUDA
kernels; with ``--device cpu`` the plain PyTorch versions run instead.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.model import lm


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor        # (B, gen) int32, the greedy tokens
    logits: torch.Tensor        # (gen + 1, B, vocab_padded): prefill, decodes
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg: ArchConfig, batch: int, prompt_len: int, device,
                 seed: int = 1) -> torch.Tensor:
    """(batch, prompt_len) int32 ids below ``cfg.vocab``, drawn on the CPU
    from a seeded generator so every device sees the same prompts."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         dtype=torch.int32).to(device)


def generate(params, cfg: ArchConfig, prompts: torch.Tensor, gen: int, *,
             max_seq: int | None = None) -> Generation:
    """Greedy prefill of ``prompts`` (B, P), then ``gen`` decode steps."""
    B, P = prompts.shape
    device = prompts.device
    cache = lm.init_cache(params, cfg, B, max_seq=max_seq or P + gen,
                          device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = lm.step(params, cfg, cache, prompts)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    steps, out = [logits], []
    t0 = time.perf_counter()
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for _ in range(gen):
        out.append(tok)
        logits, cache = lm.step(params, cfg, cache, tok)
        steps.append(logits)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _sync(device)
    decode_s = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1) if out else prompts[:, :0]
    return Generation(tokens, torch.stack(steps), prefill_s, decode_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = lm.resolve_device(args.device)
    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get(args.arch)
    params = lm.init_params(cfg, seed=args.seed, device=device)

    B = args.batch
    prompts = make_prompts(cfg, B, args.prompt_len, device)
    res = generate(params, cfg, prompts, args.gen)
    print(f"prefill {args.prompt_len} tokens x {B}: {res.prefill_s:.2f}s")
    dt = res.decode_s
    print(f"decoded {args.gen} x {B} tokens in {dt:.2f}s "
          f"({args.gen*B/dt:.1f} tok/s)")
    print("sample token ids:", res.tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
