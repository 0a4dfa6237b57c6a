"""Where the serving path's device time goes, by kernel, on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch ARCH]

Runs one architecture (default granite-8b; any of the ten but arctic-480b,
whose ~960 GB do not fit one card) at full width and depth, at
``chip_smoke.py``'s serve shapes (B=4 prompts of 512 tokens; a vlm or
audio model with ``serve.frontend_inputs``), under
``torch.profiler``: one greedy prefill and four decode steps, after an
untraced warm-up of the same shapes. For the prefill and for the decode
steps it prints:

- the wall time;
- the device-busy share;
- the device time summed by kernel name, largest first.

It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.model import lm

B, PROMPT, STEPS, TOP = 4, 512, 4, 12


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _report(name: str, prof, wall_s: float, top: int = TOP) -> None:
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    print(f"{name}: wall {wall_s * 1e3:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / (wall_s * 1e3):.1f} %)")
    for key, us, count in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms  {100 * us / 1e3 / busy_ms:5.1f} %  "
              f"x{count:<5d} {key[:90]}")


def _traced(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=configs.ARCHS)
    args = ap.parse_args(argv)
    device = lm.resolve_device("cuda")
    cfg = configs.get(args.arch)
    params = lm.init_params(cfg, seed=0, device=device)
    prompts = serve.make_prompts(cfg, B, PROMPT, device)
    extra = serve.frontend_inputs(cfg, B, device)
    max_seq = PROMPT + 2 * STEPS
    serve.generate(params, cfg, prompts, STEPS, max_seq=max_seq, extra=extra)

    # whisper's encoder runs here, outside the traced windows
    cache = lm.init_cache(params, cfg, B, max_seq, device=device,
                          extra=extra)
    state = {}

    def prefill():
        state["logits"], _ = lm.step(params, cfg, cache, prompts)

    def decode():
        for _ in range(STEPS):
            tok = torch.argmax(state["logits"], -1)[:, None].to(torch.int32)
            state["logits"], _ = lm.step(params, cfg, cache, tok)

    print(f"{cfg.name} on {torch.cuda.get_device_name(0)}")
    _report(f"prefill {PROMPT} x {B}", *_traced(prefill))
    _report(f"decode {STEPS} steps x {B}", *_traced(decode))


if __name__ == "__main__":
    main()
