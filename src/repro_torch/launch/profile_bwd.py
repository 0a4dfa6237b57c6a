"""Device time of the two training backward kernels at the train phase's
shapes, split by the kernels each call launches, on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_bwd [--reps N]

``flash_attention_bwd`` at granite-8b's training shape (B 4, S 1024, 32 /
8 heads, D 128, causal, bf16) and ``burst_gather_bwd`` at its embedding
(the first training batch's 4,100 Zipfian ids into the (49152, 4096) bf16
table).  For each it prints the median device time of one call from CUDA
events (the L2 flushed before each call) and the device time per call of
each kernel the call launches, from ``torch.profiler``, after the card's
name and power limit.  It calls only the wrappers' public entry points,
so it also measures another checkout's kernels:
``PYTHONPATH=<checkout>/src python src/repro_torch/launch/profile_bwd.py``.
It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess

import torch

from repro_torch import configs
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import burst_gather as bg
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.profile_serve import _device_us, _traced

B, S, HQ, HKV, D = 4, 1024, 32, 8, 128
ARCH = "granite-8b"
#: clock cycles the card idles before each timed call (~0.5 ms at 2 GHz):
#: longer than the host takes to issue the slowest wrapper ``chip_smoke.py``
#: times, the split-KV decode with its scratch and two launches
SPIN_CYCLES = 1_000_000


def time_ms(fn, flush, reps=25):
    """Median device time of one call, with L2 flushed before each.

    Before each call the card spins for ``SPIN_CYCLES``, so the host has
    enqueued the call, and its end event, before the card reaches them: the
    events then time the call's kernels and not the host's issuing of them,
    which for a wrapper around one short kernel is the larger part.  A
    Python loop of launches, as the plain scans are, takes longer to issue
    than the spin lasts, and its time stays its host's."""
    fn()
    marks = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def _short(name: str) -> str:
    """``void (anonymous namespace)::bwd_write<float, true>(float const*,
    ...)`` -> ``bwd_write<float, true>``."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()
    return name.strip()


def kernel_split(fn, reps=10) -> dict[str, float]:
    """Device ms per call of each kernel (or memset) that ``fn`` launches,
    by name, from ``torch.profiler`` over ``reps`` calls after one
    untraced call."""
    fn()
    prof, _ = _traced(lambda: [fn() for _ in range(reps)])
    split: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and _device_us(e) > 0:
            key = _short(e.key)
            split[key] = split.get(key, 0.0) + _device_us(e) / reps / 1e3
    return split


def embedding_ids(batch=B, seq=S, device="cuda"):
    """The first training batch of ``ARCH``, flattened: the ids its
    embedding gathers (Zipfian, so heavily repeated), int32."""
    toks = SyntheticTokens(configs.get(ARCH).vocab, seed=0).batch(
        0, 0, batch, seq)
    return torch.from_numpy(toks).reshape(-1).to(device, torch.int32)


def attention_inputs(gen):
    """q, k, v, do at the training shape, and the forward's o and lse."""
    q, do = (torch.randn((B, S, HQ, D), generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((B, S, HKV, D), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    lse = torch.empty((B, HQ, S), dtype=torch.float32, device="cuda")
    o = fa._launch("flash_attention_fwd", q, k, v, causal=True, window=None,
                   softcap=None, scale=None, q_offset=0, kv_len=None,
                   lse=lse)
    return q, k, v, o, lse, do


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_bwd: no CUDA device is available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0)}

    q, k, v, o, lse, do = attention_inputs(gen)

    def attn():
        return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    out["flash_attention_bwd"] = {"ms": time_ms(attn, flush, args.reps),
                                  "kernels_ms": kernel_split(attn)}
    del q, k, v, o, lse, do

    R = configs.get(ARCH).vocab_padded
    idx = embedding_ids()
    dout = torch.randn((idx.numel(), 4096), generator=gen,
                       device="cuda").bfloat16()

    def gather():
        return bg.burst_gather_bwd(dout, idx, R)
    out["burst_gather_bwd"] = {"ms": time_ms(gather, flush, args.reps),
                               "kernels_ms": kernel_split(gather)}
    for name in ("flash_attention_bwd", "burst_gather_bwd"):
        row = out[name]
        parts = ", ".join(f"{k} {v:.4f}" for k, v in
                          row["kernels_ms"].items())
        print(f"{name}: {row['ms']:.4f} ms a call; by kernel (profiler, "
              f"ms a call): {parts}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
