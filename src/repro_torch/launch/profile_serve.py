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
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.model import lm

B, PROMPT, STEPS, TOP = 4, 512, 4, 12


def _device_ops(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every operation the profiler recorded
    on the device; the device mirrors of annotations (``record_function``,
    the phase spans) are no operation and are left out."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CPU
            and not getattr(e, "is_user_annotation", lambda: False)()]


def _union_ns(intervals) -> int:
    """The length of the union of (start, end) intervals."""
    total, reach = 0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def _report(name: str, prof, wall_s: float, top: int = TOP) -> None:
    ops = _device_ops(prof)
    by_name: dict[str, list] = {}
    for key, a, b in ops:
        row = by_name.setdefault(key, [0, 0])
        row[0] += b - a
        row[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy_ms = _union_ns((a, b) for _, a, b in ops) / 1e6
    print(f"{name}: wall {wall_s * 1e3:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / (wall_s * 1e3):.1f} %)")
    for key, (ns, count) in rows[:top]:
        print(f"  {ns / 1e6:9.3f} ms  {100 * ns / 1e6 / busy_ms:5.1f} %  "
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
