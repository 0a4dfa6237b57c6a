#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each printing its own lines:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles the CUDA sources of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a.
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16 (tolerance rtol = atol = 2e-2, as in tests/test_kernels.py; one f32
   case at 2e-5), the gather exactly.
4. reference: granite-8b-reduced on the card (kernels) against the same
   weights on the CPU (plain versions), teacher-forced, atol 2e-2.
5. serve: granite-8b at full width (random weights from seed 0), 4 prompts
   of 512 tokens, greedy prefill then 32 decode steps through
   ``repro_torch.launch.serve``; checks finite logits and the launch count
   of every kernel on the path.
6. cache: a second prefill over prompt + first generated token must give
   the first decode step's logits: in bf16 to a relative L2 error of 5e-2,
   then, after the kernel timings, with the weights widened to f32,
   elementwise to rtol = atol = 1e-3 (see ``check_cache``).
7. a JSON line with each kernel's launches, error, times and bound, then
   the result line.

Exits non-zero, printing no result line, if any phase fails or there is no
CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import burst_gather as bg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.model import lm  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
CACHE_F32_TOL = dict(rtol=1e-3, atol=1e-3)
CACHE_BF16_REL_L2 = 5e-2
B, PROMPT, GEN = 4, 512, 32


def _phase(msg):
    print(msg, flush=True)


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def _assert_close(name, got, want, tol):
    err = _max_err(got, want)
    bad = (got.float() - want.float()).abs() > \
        tol["atol"] + tol["rtol"] * want.float().abs()
    status = "ok" if not bool(bad.any()) and bool(torch.isfinite(got).all()) \
        else "FAIL"
    _phase(f"check {name}: max_abs_err={err:.3e} "
           f"(rtol={tol['rtol']}, atol={tol['atol']}) {status}")
    if status != "ok":
        raise AssertionError(f"{name}: disagrees with its reference "
                             f"(max abs err {err:.3e})")
    return err


def _rand(shape, gen, dtype=None):
    dtype = dtype or torch.bfloat16
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check_attention(gen):
    """Every attention case; returns the max error at the serve shapes."""
    errs = {}
    prefill = [
        # name, (B, Sq, Skv, Hq, Hkv, D), kwargs
        ("serve", (4, 512, 512, 32, 8, 128), dict(causal=True)),
        ("window", (4, 512, 512, 32, 8, 128), dict(causal=True, window=128)),
        ("softcap", (4, 512, 512, 32, 8, 128), dict(causal=True,
                                                    softcap=50.0)),
        ("full", (4, 512, 512, 32, 8, 128), dict(causal=False)),
        ("ragged", (4, 64, 544, 32, 8, 128), dict(
            causal=True, q_offset=[480, 100, 0, 300],
            kv_len=[544, 164, 64, 364])),
        ("edge33", (2, 33, 33, 4, 1, 128), dict(causal=True)),
        ("d64", (2, 256, 256, 8, 2, 64), dict(causal=True)),
        ("d112", (2, 256, 256, 8, 2, 112), dict(causal=True, window=100)),
        ("d256", (2, 256, 256, 8, 2, 256), dict(causal=True, softcap=30.0)),
    ]
    for name, (b, sq, skv, hq, hkv, d), kw in prefill:
        kw = {k: torch.tensor(v, dtype=torch.int32, device="cuda")
              if isinstance(v, list) else v for k, v in kw.items()}
        q = _rand((b, sq, hq, d), gen)
        k, v = _rand((b, skv, hkv, d), gen), _rand((b, skv, hkv, d), gen)
        got = fa.flash_attention(q, k, v, **kw)
        errs[name] = _assert_close(f"flash_attention[{name}]", got,
                                   ref.attention_ref(q, k, v, **kw), BF16_TOL)
    q = _rand((2, 48, 4, 24), gen, torch.float32)
    k = _rand((2, 48, 2, 24), gen, torch.float32)
    v = _rand((2, 48, 2, 24), gen, torch.float32)
    _assert_close("flash_attention[f32]", fa.flash_attention(q, k, v),
                  ref.attention_ref(q, k, v), F32_TOL)

    decode = [
        ("serve", (4, 544, 32, 8, 128), dict(kv_len=[544, 300, 17, 1])),
        ("softcap-window", (4, 544, 32, 8, 128), dict(
            causal=True, window=64, softcap=50.0, q_offset=[543, 299, 16, 0],
            kv_len=[544, 300, 17, 1])),
        ("mqa-d64", (2, 200, 32, 2, 64), dict(kv_len=[200, 77])),
        ("d256", (2, 130, 8, 2, 256), dict(kv_len=[130, 9])),
        ("empty", (2, 64, 8, 8, 128), dict(kv_len=[0, 64])),
    ]
    for name, (b, skv, hq, hkv, d), kw in decode:
        kw = {k: torch.tensor(v, dtype=torch.int32, device="cuda")
              if isinstance(v, list) else v for k, v in kw.items()}
        q = _rand((b, 1, hq, d), gen)
        k, v = _rand((b, skv, hkv, d), gen), _rand((b, skv, hkv, d), gen)
        got = fa.decode_attention(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **{"causal": False, **kw})
        errs[f"decode-{name}"] = _assert_close(
            f"decode_attention[{name}]", got, want, BF16_TOL)
    return errs["serve"], errs["decode-serve"]


def gather_streams(gen, R):
    n = 2048
    mixed, left = [], n + 3
    while left:
        m = min(left, int(torch.randint(1, 40, (1,), generator=gen,
                                        device="cuda")))
        s = int(torch.randint(0, R - m, (1,), generator=gen, device="cuda"))
        mixed.append(torch.arange(s, s + m, device="cuda"))
        left -= m
    return {
        "contiguous": torch.arange(1000, 1000 + n, device="cuda"),
        "random": torch.randint(0, R, (n,), generator=gen, device="cuda"),
        "mixed-2051": torch.cat(mixed),
        "decode-4": torch.randint(0, R, (4,), generator=gen, device="cuda"),
    }


def check_gather(table, gen):
    for name, idx in gather_streams(gen, table.shape[0]).items():
        idx = idx.to(torch.int32)
        got = bg.burst_gather(table, idx)
        exact = torch.equal(got, ref.burst_gather_ref(table, idx))
        _phase(f"check burst_gather[{name}]: N={idx.numel()} exact="
               f"{exact} {'ok' if exact else 'FAIL'}")
        if not exact:
            raise AssertionError(f"burst_gather[{name}] is not exact")


def check_reference():
    """granite-8b-reduced: kernels on the card vs plain versions on the
    CPU, same weights, teacher-forced prefill 24 + 8 decode steps."""
    cfg = configs.get_reduced("granite-8b")
    cpu = lm.init_params(cfg, seed=0, device="cpu")
    gpu = lm.LM(cfg, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen,
                           dtype=torch.int32)
    caches = [lm.init_cache(p, cfg, 2, 40, device=d)
              for p, d in ((cpu, "cpu"), (gpu, "cuda"))]
    worst = 0.0
    feeds = [tokens[:, :24]] + [tokens[:, i:i + 1] for i in range(24, 32)]
    for t in feeds:
        want, _ = lm.step(cpu, cfg, caches[0], t)
        got, _ = lm.step(gpu, cfg, caches[1], t.cuda())
        err = _max_err(got.cpu(), want)
        worst = max(worst, err)
        if err > 2e-2:
            raise AssertionError(f"reduced model: card vs CPU logits differ "
                                 f"by {err:.3e} > 2e-2")
    _phase(f"check granite-8b-reduced card vs cpu (teacher-forced, 9 steps):"
           f" max_abs_err={worst:.3e} (atol=2e-2) ok")


def check_cache(dtype, params, cfg, prompts, res):
    """A prefill over prompt + first generated token must give the logits
    of the first decode step.  In f32 the two paths differ only by the
    order of sums, so the check is elementwise and tight (rtol = atol =
    1e-3); a wrong cache slot, position or kv_len moves logits by O(0.1).
    In bf16 36 layers of rounding at other GEMM shapes leave ~0.1 max abs
    on logits of max ~6 for the plain versions too, so the 5e-2 of
    tests/test_models_smoke.py bounds the relative L2 error instead."""
    again = serve.generate(params, cfg,
                           torch.cat([prompts, res.tokens[:, :1]], 1), 0)
    got, want = again.logits[0].float(), res.logits[1].float()
    rel = float((got - want).norm() / want.norm())
    name = f"cache ({dtype}): prefill of prompt+1 vs first decode step"
    if dtype == "f32":
        _assert_close(name, got, want, CACHE_F32_TOL)
        return
    ok = rel <= CACHE_BF16_REL_L2 and bool(torch.isfinite(got).all())
    _phase(f"check {name}: rel_l2_err={rel:.3e} (<= {CACHE_BF16_REL_L2}), "
           f"max_abs_err={_max_err(got, want):.3e} "
           f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: relative L2 error {rel:.3e}")


def time_ms(fn, flush, reps=25):
    """Median device time of one call, with L2 flushed before each."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def _sdpa(q, k, v, **kw):
    """scaled_dot_product_attention on (B, H, S, D) views, GQA by
    enable_gqa."""
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def kernel_line(params, prompts, launches, errs):
    gen = torch.Generator(device="cuda").manual_seed(11)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    Hq, Hkv, D = 32, 8, 128
    rows = []

    q = _rand((B, PROMPT, Hq, D), gen)
    k, v = _rand((B, PROMPT, Hkv, D), gen), _rand((B, PROMPT, Hkv, D), gen)
    pairs = B * Hq * PROMPT * (PROMPT + 1) // 2          # causal (q, k)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms, plain = time_ms(lambda: fa.flash_attention(q, k, v), flush), \
        time_ms(lambda: ref.attention_ref(q, k, v), flush)
    lib = time_ms(_sdpa(qt, kt, vt, is_causal=True), flush)
    rows.append(("flash_attention", "src/repro/kernels/flash_attention.py:90",
                 launches["flash_attention"], errs[0], ms, plain, lib,
                 *bound(4 * pairs * D, 2 * (2 * q.numel() + 2 * k.numel()))))

    S = PROMPT + GEN
    q = _rand((B, 1, Hq, D), gen)
    k, v = _rand((B, S, Hkv, D), gen), _rand((B, S, Hkv, D), gen)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = time_ms(lambda: fa.decode_attention(q, k, v, kv_len=S), flush)
    plain = time_ms(lambda: ref.attention_ref(q, k, v, causal=False,
                                              kv_len=S), flush)
    lib = time_ms(_sdpa(qt, kt, vt), flush)
    rows.append(("decode_attention",
                 "src/repro/kernels/flash_attention.py:149",
                 launches["decode_attention"], errs[1], ms, plain, lib,
                 *bound(4 * B * Hq * S * D,
                        2 * (2 * q.numel() + 2 * k.numel()))))

    table, idx = params.embed, prompts.reshape(-1)
    row_bytes = table.shape[1] * table.element_size()
    nbytes = row_bytes * (idx.unique().numel() + idx.numel()) + 4 * idx.numel()
    ms = time_ms(lambda: bg.burst_gather(table, idx), flush)
    plain = time_ms(lambda: ref.burst_gather_ref(table, idx), flush)
    lib = time_ms(lambda: torch.index_select(table, 0, idx), flush)
    err = _max_err(bg.burst_gather(table, idx),
                   ref.burst_gather_ref(table, idx))
    rows.append(("burst_gather", "src/repro/kernels/burst_gather.py:59",
                 launches["burst_gather"], err, ms, plain, lib,
                 *bound(0, nbytes)))

    keys = ("name", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")
    source = {"flash_attention": "flash_attention.cu",
              "decode_attention": "flash_attention.cu",
              "burst_gather": "burst_gather.cu"}
    out = []
    for row in rows:
        d = dict(zip(keys, row, strict=True))
        d.update(route="cuda", source="src/repro_torch/kernels/csrc/"
                 + source[d["name"]])
        out.append(d)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    _phase(smi)
    _phase(f"device: {name}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")

    _phase(f"build: {_build.build_all():.1f}s (nvcc, sm_90a)")

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_attention(gen)
    check_reference()

    cfg = configs.get("granite-8b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    _phase(f"init granite-8b: {cfg.param_count() / 1e9:.2f} B params, "
           f"{time.perf_counter() - t0:.1f}s")
    check_gather(params.embed, gen)

    prompts = serve.make_prompts(cfg, B, PROMPT, "cuda")
    counters = {"flash_attention": fa.flash_attention,
                "decode_attention": fa.decode_attention,
                "burst_gather": bg.burst_gather}
    for fn in counters.values():
        fn.launches = 0
    res = serve.generate(params, cfg, prompts, GEN)
    launches = {n: fn.launches for n, fn in counters.items()}
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * GEN,
            "burst_gather": 1 + GEN}
    _phase(f"serve granite-8b on {name}: prefill {PROMPT} tokens x {B}: "
           f"{res.prefill_s:.3f}s; decoded {GEN} x {B} tokens in "
           f"{res.decode_s:.3f}s ({GEN * B / res.decode_s:.1f} tok/s); "
           f"launches {launches}")
    _phase(f"sample token ids: {res.tokens[0, :12].tolist()}")
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")
    if tuple(res.logits.shape) != (GEN + 1, B, cfg.vocab_padded) or \
            not bool(torch.isfinite(res.logits.float()).all()):
        raise AssertionError("serve: logits not finite or of the wrong shape")

    check_cache("bf16", params, cfg, prompts, res)
    kernels = kernel_line(params, prompts, launches, errs)
    params.to(torch.float32)
    torch.cuda.empty_cache()
    check_cache("f32", params, cfg, prompts,
                serve.generate(params, cfg, prompts, 1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
