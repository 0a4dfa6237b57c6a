#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each printing its own lines:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles the CUDA sources of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a.
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16 (tolerance rtol = atol = 2e-2, as in tests/test_kernels.py; one f32
   case at 2e-5), the gather exactly.  The two scans at the serve shapes
   (prefill from a zero state, decode at S = 1 from a random one), at
   S = 33, at head size 16 and at odd and largest sizes: y at 2e-2 and the
   f32 state at 3e-2 in bf16; one f32 case each, y at 2e-5 (2e-4 for
   rwkv6, as in tests/test_kernels.py) and the state at 1e-4.  The grouped
   matmul in bf16 and f32 at granite-moe-3b's prefill and decode shapes,
   at ragged sizes, on unsorted and out-of-range ids, and at one
   arctic-480b layer's expert shapes.
4. reference: granite-8b-, zamba2-7b-, rwkv6- and granite-moe-3b-reduced
   on the card (kernels) against the same weights on the CPU (plain
   versions), teacher-forced, atol 2e-2; for the MoE model a batch row may
   exceed it only after one of its tokens was routed to other experts on
   the two devices, first at a near-tie (see ``check_reference``).
5. serve, for granite-8b, zamba2-7b, rwkv6-1.6b and granite-moe-3b-a800m
   in turn, each at full width and depth (random weights from seed 0): 4
   prompts of 512 tokens, greedy prefill then 32 decode steps through
   ``repro_torch.launch.serve``; checks finite logits and the exact launch
   count of every kernel.
6. no sync: for each model a prefill and a decode step run with PyTorch's
   sync debug mode set to "error".
7. cache, for each model: a second prefill over prompt + first generated
   token must give the first decode step's logits: in bf16 to a relative
   L2 error of 5e-2, then, with the weights widened to f32, elementwise to
   rtol = atol = 1e-3 (see ``check_cache``).  For zamba2 and rwkv6 this
   checks the carried conv, ssd, token-shift and wkv states.
8. a JSON line with each kernel's launches, error, times and bound, then
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
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import rwkv6_scan as r6  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.model import lm, moe  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
#: outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
#: the scans' final f32 state (tests/test_kernels.py), and rwkv6's y in f32
STATE_BF16_TOL = dict(rtol=3e-2, atol=3e-2)
STATE_F32_TOL = dict(rtol=1e-4, atol=1e-4)
RWKV_F32_TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("granite-8b", "zamba2-7b", "rwkv6-1.6b", "granite-moe-3b-a800m")
#: kernel name -> wrapper, each counting its launches
COUNTERS = {"flash_attention": fa.flash_attention,
            "decode_attention": fa.decode_attention,
            "burst_gather": bg.burst_gather,
            "mamba2_scan": m2.mamba2_scan,
            "rwkv6_scan": r6.rwkv6_scan,
            "moe_gmm": gmm.moe_gmm}
CACHE_F32_TOL = dict(rtol=1e-3, atol=1e-3)
CACHE_BF16_REL_L2 = 5e-2
B, PROMPT, GEN = 4, 512, 32
#: clock cycles the card idles before each timed call (~0.1 ms at 2 GHz)
SPIN_CYCLES = 200_000


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


def mamba2_inputs(gen, b, s, h, p, n, dtype=torch.bfloat16, state=True,
                  strided=False):
    """x, dt, A, B, C, state of the SSD scan; ``strided`` cuts x, B and C
    out of one fused tensor, as the model does."""
    if strided:
        fused = _rand((b, s, h * p + 2 * n), gen, dtype)
        x, Bm, Cm = torch.split(fused, [h * p, n, n], dim=-1)
        x = x.unflatten(2, (h, p))
    else:
        x = _rand((b, s, h, p), gen, dtype)
        Bm, Cm = _rand((b, s, n), gen, dtype), _rand((b, s, n), gen, dtype)
    dt = torch.nn.functional.softplus(_rand((b, s, h), gen, torch.float32))
    A = -torch.exp(_rand((h,), gen, torch.float32))
    h0 = _rand((b, h, p, n), gen, torch.float32) if state else None
    return x, dt, A, Bm, Cm, h0


def rwkv6_inputs(gen, b, s, h, d, dtype=torch.bfloat16, state=True):
    """r, k, v, w, u, state of the WKV scan, w = exp(-exp(normal))."""
    r, k, v = (_rand((b, s, h, d), gen, dtype) for _ in range(3))
    w = torch.exp(-torch.exp(_rand((b, s, h, d), gen, torch.float32)))
    u = 0.3 * _rand((h, d), gen, torch.float32)
    s0 = _rand((b, h, d, d), gen, torch.float32) if state else None
    return r, k, v, w.to(dtype), u, s0


#: (case, shape, dtype, initial state, strided x/B/C)
MAMBA2_CASES = [
    ("serve-prefill", (B, PROMPT, 112, 64, 64), torch.bfloat16, False, True),
    ("serve-decode", (B, 1, 112, 64, 64), torch.bfloat16, True, True),
    ("s33", (2, 33, 8, 64, 64), torch.bfloat16, True, False),
    ("p16", (2, 40, 4, 16, 16), torch.bfloat16, True, True),
    ("odd-p24-n40", (1, 17, 3, 24, 40), torch.bfloat16, True, False),
    ("p128-n128", (1, 9, 2, 128, 128), torch.bfloat16, True, False),
    ("f32", (2, 33, 4, 64, 64), torch.float32, True, False),
]
#: (case, shape, dtype, initial state)
RWKV6_CASES = [
    ("serve-prefill", (B, PROMPT, 32, 64), torch.bfloat16, False),
    ("serve-decode", (B, 1, 32, 64), torch.bfloat16, True),
    ("s33", (2, 33, 8, 64), torch.bfloat16, True),
    ("d16", (2, 40, 4, 16), torch.bfloat16, True),
    ("odd-d24", (1, 17, 3, 24), torch.bfloat16, True),
    ("d128", (1, 9, 2, 128), torch.bfloat16, True),
    ("f32", (2, 33, 4, 64), torch.float32, True),
]


def _check_scan(name, got, want, f32, y_tol):
    errs = [_assert_close(f"{name} y", got[0], want[0],
                          y_tol if f32 else BF16_TOL),
            _assert_close(f"{name} state", got[1], want[1],
                          STATE_F32_TOL if f32 else STATE_BF16_TOL)]
    return max(errs)


def check_scans(gen):
    """Both scans against their plain versions; returns the max error of
    each at its serve prefill shape."""
    errs = {}
    for case, shape, dtype, state, strided in MAMBA2_CASES:
        args = mamba2_inputs(gen, *shape, dtype=dtype, state=state,
                             strided=strided)
        errs[f"mamba2_scan[{case}]"] = _check_scan(
            f"mamba2_scan[{case}]", m2.mamba2_scan(*args),
            ref.mamba2_scan_ref(*args), dtype == torch.float32, F32_TOL)
    for case, shape, dtype, state in RWKV6_CASES:
        args = rwkv6_inputs(gen, *shape, dtype=dtype, state=state)
        errs[f"rwkv6_scan[{case}]"] = _check_scan(
            f"rwkv6_scan[{case}]", r6.rwkv6_scan(*args),
            ref.rwkv6_scan_ref(*args), dtype == torch.float32, RWKV_F32_TOL)
    return (errs["mamba2_scan[serve-prefill]"],
            errs["rwkv6_scan[serve-prefill]"])


def moe_ids(gen, tokens, E, k, order="sorted"):
    """(tokens * k,) int32 expert ids: the top-k of random router scores,
    flattened in (token, k) order, then sorted as the model's dispatch
    sorts them, or left in token order ("token")."""
    top = torch.randn((tokens, E), generator=gen, device="cuda").topk(
        k, -1).indices.reshape(-1)
    return (top.sort().values if order == "sorted" else top).to(torch.int32)


def moe_inputs(gen, T, K, N, E, dtype=torch.bfloat16):
    """x (T, K) standard normal and w (E, K, N) at std 1/sqrt(K), drawn one
    expert at a time: no f32 copy of an arctic-sized w is ever held."""
    x = _rand((T, K), gen, dtype)
    w = torch.empty((E, K, N), dtype=dtype, device="cuda")
    for e in range(E):
        w[e] = torch.randn((K, N), generator=gen, device="cuda").mul_(
            K ** -0.5)
    return x, w


#: (case, (tokens, top_k), K, N, E, dtype, ids): ids "sorted" or "token"
#: (routed ids in token order), or (lo, hi) for T = tokens uniform ids in
#: [lo, hi), unsorted, out of range where lo < 0 or hi > E
MOE_CASES = [
    ("prefill-gate-up", (B * PROMPT, 8), 1536, 512, 40, torch.bfloat16,
     "sorted"),
    ("prefill-down", (B * PROMPT, 8), 512, 1536, 40, torch.bfloat16,
     "sorted"),
    ("decode-gate-up", (B, 8), 1536, 512, 40, torch.bfloat16, "sorted"),
    ("decode-down", (B, 8), 512, 1536, 40, torch.bfloat16, "sorted"),
    ("ragged-t33-k40-n24", (33, 1), 40, 24, 5, torch.bfloat16, "sorted"),
    ("unsorted", (512, 8), 1536, 512, 40, torch.bfloat16, "token"),
    ("out-of-range", (300, 1), 64, 72, 8, torch.bfloat16, (-3, 11)),
    ("f32-prefill", (512, 8), 1536, 512, 40, torch.float32, "sorted"),
    ("f32-ragged-unsorted-oor", (33, 1), 40, 24, 5, torch.float32, (-2, 8)),
    ("arctic-480b", (B * PROMPT, 2), 7168, 4864, 128, torch.bfloat16,
     "sorted"),
]


def moe_case(gen, shape, K, N, E, dtype, ids):
    tokens, k = shape
    if isinstance(ids, tuple):
        g = torch.randint(*ids, (tokens,), generator=gen, device="cuda",
                          dtype=torch.int32)
    else:
        g = moe_ids(gen, tokens, E, k, ids)
    return (*moe_inputs(gen, g.numel(), K, N, E, dtype), g)


def check_moe_gmm(gen):
    """The grouped matmul against its plain version at every case of
    ``MOE_CASES``, and against itself run again (bit for bit); returns the
    max error at each."""
    errs = {}
    for case, shape, K, N, E, dtype, ids in MOE_CASES:
        x, w, g = moe_case(gen, shape, K, N, E, dtype, ids)
        got = gmm.moe_gmm(x, w, g)
        torch.cuda.synchronize()
        want = ref.moe_gmm_ref(x, w, g)
        errs[case] = _assert_close(
            f"moe_gmm[{case}] T={g.numel()} K={K} N={N} E={E}", got, want,
            F32_TOL if dtype == torch.float32 else BF16_TOL)
        outside = (g < 0) | (g >= E)
        if bool(got[outside].any()):
            raise AssertionError(f"moe_gmm[{case}]: rows of ids outside "
                                 f"[0, E) are not zero")
        # the plan orders each expert's rows by atomics, differently each
        # run; every row's sums must not depend on that order
        if not torch.equal(got, gmm.moe_gmm(x, w, g)):
            raise AssertionError(f"moe_gmm[{case}]: two runs differ")
        del x, w, got, want
        torch.cuda.empty_cache()
    return errs


#: router-probability margin (k-th minus (k+1)-th) below which two devices
#: may route a token to other experts (tests/test_torch_moe_model.py)
ROUTE_MARGIN = 1e-3


def _route_hooks(params, cfg):
    """Forward hooks on every MoE layer recording (probs, top_i) on the
    CPU, in call order; returns the record and the hook handles."""
    record = []

    def hook(module, args, out):
        x = args[0]
        probs, _, top_i = moe.route(module.router, cfg,
                                    x.reshape(-1, x.shape[-1]))
        record.append((probs.cpu(), top_i.cpu()))

    return record, [layer.moe.register_forward_hook(hook)
                    for layer in params.layers if hasattr(layer, "moe")]


def _rerouted(cpu_rec, gpu_rec, k, rerouted):
    """Update ``rerouted`` (B,), the rows with a token the two devices
    routed to other experts.  A row not rerouted yet differs only by
    roundings, so its first such token must be a near-tie (CPU margin
    below ``ROUTE_MARGIN``).  Returns the tokens routed otherwise."""
    n = 0
    for (probs, ti_c), (_, ti_g) in zip(cpu_rec, gpu_rec, strict=True):
        differ = torch.tensor([set(a.tolist()) != set(b.tolist())
                               for a, b in zip(ti_c, ti_g)]).view(
            rerouted.shape[0], -1)
        srt = probs.sort(-1, descending=True).values
        margin = (srt[:, k - 1] - srt[:, k]).view_as(differ)
        first = margin[differ & ~rerouted[:, None]]
        if bool((first >= ROUTE_MARGIN).any()):
            raise AssertionError(f"tokens routed otherwise at a margin of "
                                 f"{first.tolist()} >= {ROUTE_MARGIN}")
        n += int(differ.sum())
        rerouted |= differ.any(1)
    return n


def check_reference(arch):
    """The reduced model: kernels on the card vs plain versions on the
    CPU, same weights, teacher-forced prefill 24 + 8 decode steps.  For an
    MoE model each step's routing is recorded on both devices: a batch row
    may exceed the tolerance only once one of its tokens went to other
    experts, the first of them at a near-tie (``_rerouted``)."""
    cfg = configs.get_reduced(arch)
    cpu = lm.init_params(cfg, seed=0, device="cpu")
    gpu = lm.LM(cfg, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen,
                           dtype=torch.int32)
    caches = [lm.init_cache(p, cfg, 2, 40, device=d)
              for p, d in ((cpu, "cpu"), (gpu, "cuda"))]
    (cpu_rec, h_cpu), (gpu_rec, h_gpu) = (_route_hooks(p, cfg)
                                          for p in (cpu, gpu))
    rerouted = torch.zeros(2, dtype=torch.bool)
    worst, n_routed, excused = 0.0, 0, 0
    feeds = [tokens[:, :24]] + [tokens[:, i:i + 1] for i in range(24, 32)]
    for t in feeds:
        cpu_rec.clear()
        gpu_rec.clear()
        want, _ = lm.step(cpu, cfg, caches[0], t)
        got, _ = lm.step(gpu, cfg, caches[1], t.cuda())
        n_routed += _rerouted(cpu_rec, gpu_rec, cfg.top_k, rerouted)
        err = (got.cpu().float() - want.float()).abs().amax(-1)
        over = err > 2e-2
        if bool((over & ~rerouted).any()):
            raise AssertionError(f"{cfg.name}: card vs CPU logits differ "
                                 f"by {err.tolist()} > 2e-2")
        excused += int(over.sum())
        worst = max(worst, float(err[~over].max()) if bool((~over).any())
                    else 0.0)
    for h in h_cpu + h_gpu:
        h.remove()
    routed = (f"; tokens routed otherwise {n_routed}, row-steps over atol "
              f"after a near-tie {excused}") if cfg.n_experts else ""
    _phase(f"check {cfg.name} card vs cpu (teacher-forced, 9 steps):"
           f" max_abs_err={worst:.3e} (atol=2e-2){routed} ok")


def check_cache(dtype, params, cfg, prompts, res):
    """A prefill over prompt + first generated token must give the logits
    of the first decode step.  In f32 the two paths differ only by the
    order of sums, so the check is elementwise and tight (rtol = atol =
    1e-3); a wrong cache slot, position or kv_len moves logits by O(0.1).
    In bf16 granite-8b's 36 layers of rounding at other GEMM shapes leave
    ~0.1 max abs on logits of max ~6 for the plain versions too, so the
    5e-2 of tests/test_models_smoke.py bounds the relative L2 error
    instead.

    For an MoE model both runs record their routing, and the line says at
    how many (layer, row) pairs the first decode step and the prefill's
    last position chose other experts, and the smallest router margin
    (k-th minus (k+1)-th probability) among them."""
    routed = ""
    if cfg.n_experts:
        record, handles = _route_hooks(params, cfg)
        res = serve.generate(params, cfg, prompts, 1)
        decode = record[-cfg.n_layers:]
        record.clear()
    again = serve.generate(params, cfg,
                           torch.cat([prompts, res.tokens[:, :1]], 1), 0)
    if cfg.n_experts:
        for h in handles:
            h.remove()
        n, margins = 0, []
        for (probs, ti_d), (_, ti_p) in zip(decode, record, strict=True):
            last = ti_p.view(prompts.shape[0], -1, cfg.top_k)[:, -1]
            srt = probs.sort(-1, descending=True).values
            for b, (a, c) in enumerate(zip(ti_d, last)):
                if set(a.tolist()) != set(c.tolist()):
                    n += 1
                    margins.append(float(srt[b, cfg.top_k - 1]
                                         - srt[b, cfg.top_k]))
        routed = (f", routed otherwise at {n} (layer, row) pairs"
                  + (f", smallest margin {min(margins):.2e}" if margins
                     else ""))
    got, want = again.logits[0].float(), res.logits[1].float()
    rel = float((got - want).norm() / want.norm())
    name = (f"cache {cfg.name} ({dtype}): prefill of prompt+1 vs first "
            f"decode step{routed}")
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
    """Median device time of one call, with L2 flushed before each.

    Before each call the card spins for ``SPIN_CYCLES`` (~0.1 ms), so the
    host has enqueued the call, and its end event, before the card reaches
    them: the events then time the call's kernels and not the host's
    issuing of them, which for a wrapper around one short kernel is the
    larger part.  A Python loop of launches, as the plain scans are, takes
    longer to issue than the spin lasts, and its time stays its host's."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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


def _row(name, replaces, err, ms, plain, lib, bound_ms, bound_by):
    """A row of the kernels line; ``main`` fills in its launches."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCE[name]}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound_ms, "bound_by": bound_by}


SOURCE = {"flash_attention": "flash_attention.cu",
          "decode_attention": "flash_attention.cu",
          "burst_gather": "burst_gather.cu",
          "mamba2_scan": "mamba2_scan.cu", "rwkv6_scan": "rwkv6_scan.cu",
          "moe_gmm": "moe_gmm.cu"}


def granite_rows(table, prompts, errs, flush, gen):
    """The attention and gather rows, at granite-8b's serve shapes."""
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
                 errs[0], ms, plain, lib,
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
                 errs[1], ms, plain, lib,
                 *bound(4 * B * Hq * S * D,
                        2 * (2 * q.numel() + 2 * k.numel()))))

    idx = prompts.reshape(-1)
    row_bytes = table.shape[1] * table.element_size()
    nbytes = row_bytes * (idx.unique().numel() + idx.numel()) + 4 * idx.numel()
    ms = time_ms(lambda: bg.burst_gather(table, idx), flush)
    plain = time_ms(lambda: ref.burst_gather_ref(table, idx), flush)
    lib = time_ms(lambda: torch.index_select(table, 0, idx), flush)
    err = _max_err(bg.burst_gather(table, idx),
                   ref.burst_gather_ref(table, idx))
    rows.append(("burst_gather", "src/repro/kernels/burst_gather.py:59",
                 err, ms, plain, lib,
                 *bound(0, nbytes)))

    return [_row(*r) for r in rows]


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def scan_rows(errs, flush, gen):
    """The two scans at their serve shapes: the row's times are the
    prefill's (S = 512 from a zero state); a phase line gives the decode
    step's (S = 1 from a random state) and the f32 FMA floor of the
    sequential recurrence.  Bytes count each input read once and each
    output written once; operations are the recurrence's f32 FLOPs, 5 per
    state element and step for mamba2, 7 for rwkv6."""
    rows = []
    cases = {
        "mamba2_scan": (m2.mamba2_scan, ref.mamba2_scan_ref,
                        lambda S, st: mamba2_inputs(gen, B, S, 112, 64, 64,
                                                    state=st),
                        lambda a: 5 * a[0].numel() * a[3].shape[-1],
                        "src/repro/kernels/mamba2_scan.py:71"),
        "rwkv6_scan": (r6.rwkv6_scan, ref.rwkv6_scan_ref,
                       lambda S, st: rwkv6_inputs(gen, B, S, 32, 64,
                                                  state=st),
                       lambda a: 7 * a[0].numel() * a[0].shape[-1],
                       "src/repro/kernels/rwkv6_scan.py:76"),
    }
    for name, (kernel, plain_fn, inputs, flops, replaces) in cases.items():
        timed = {}
        for phase, S, state in (("prefill", PROMPT, False), ("decode", 1,
                                                              True)):
            args = inputs(S, state)
            y, st = kernel(*args)
            nbytes = _nbytes(*args, y, st)
            timed[phase] = (time_ms(lambda: kernel(*args), flush),
                            time_ms(lambda: plain_fn(*args), flush, reps=5),
                            *bound(flops(args), nbytes),
                            flops(args) / PEAK_F32_FLOPS * 1e3, nbytes)
        for phase, (ms, plain, b_ms, b_by, f32_ms, nbytes) in timed.items():
            _phase(f"time {name}[{phase}]: {ms:.4f} ms, plain {plain:.3f} "
                   f"ms, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} "
                   f"MB), f32 FMA floor {f32_ms:.4f} ms")
        ms, plain, b_ms, b_by, _, _ = timed["prefill"]
        rows.append(_row(name, replaces, errs[name], ms, plain, None, b_ms,
                         b_by))
    return rows


def _grouped_mm(x, w, ids, E):
    """``torch._grouped_mm`` over the sorted rows, timed as the library
    yardstick and never called by the port; None where this PyTorch lacks
    it or refuses the inputs."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or x.dtype != torch.bfloat16:
        return None
    offs = torch.bincount(ids.long(), minlength=E).cumsum(0).to(torch.int32)
    try:
        fn(x, w, offs=offs)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        _phase(f"library torch._grouped_mm refused: {str(exc)[:200]}")
        return None
    return lambda: fn(x, w, offs=offs)


#: the cases of ``MOE_CASES`` that are timed
MOE_TIMED = ("prefill-gate-up", "prefill-down", "decode-gate-up",
             "decode-down", "arctic-480b")


def moe_rows(errs, flush, gen):
    """The grouped matmul at granite-moe-3b's serve shapes (gate/up and
    down, prefill and decode) and at one arctic-480b layer's: the row's
    times are the prefill gate/up launch's, its ``decode_*`` keys the
    decode gate/up launch's; a phase line gives each.  Bytes count x, the
    weights of the experts present (what these ids need) and the output
    once; operations are 2 T K N bf16 FLOPs."""
    timed, cases = {}, {c[0]: c[1:] for c in MOE_CASES}
    for phase in MOE_TIMED:
        shape, K, N, E, dtype, ids = cases[phase]
        x, w, g = moe_case(gen, shape, K, N, E, dtype, ids)
        T = g.numel()
        present = int(g.unique().numel())
        nbytes = 2 * (T * K + present * K * N + T * N) + 4 * T
        ms = time_ms(lambda: gmm.moe_gmm(x, w, g), flush)
        plain = time_ms(lambda: ref.moe_gmm_ref(x, w, g), flush, reps=3)
        lib = _grouped_mm(x, w, g, E)
        lib_ms = time_ms(lib, flush) if lib is not None else None
        b_ms, b_by = bound(2 * T * K * N, nbytes)
        timed[phase] = (ms, plain, lib_ms, b_ms, b_by)
        _phase(f"time moe_gmm[{phase}] T={T} K={K} N={N} E={E} "
               f"({present} present): {ms:.4f} ms, plain {plain:.3f} ms, "
               f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
               f", bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, "
               f"{2 * T * K * N / 1e9:.2f} GFLOP), "
               f"{2 * T * K * N / ms / 1e9:.1f} TFLOP/s")
        del x, w, g
        torch.cuda.empty_cache()
    ms, plain, lib_ms, b_ms, b_by = timed["prefill-gate-up"]
    row = _row("moe_gmm", "src/repro/kernels/moe_gmm.py:50",
               errs["prefill-gate-up"], ms, plain, lib_ms, b_ms, b_by)
    d_ms, d_plain, d_lib, d_b, _ = timed["decode-gate-up"]
    row.update(decode_ms=d_ms, decode_plain_ms=d_plain,
               decode_library_ms=d_lib, decode_bound_ms=d_b)
    return [row]


def _params_b(params):
    return sum(p.numel() for p in params.parameters()) / 1e9


def serve_phase(arch, gen):
    """Serve ``arch`` at full width and depth; check the launch counts,
    the logits and the bf16 cache.  Returns (params, prompts, launches),
    the params still in bf16."""
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    _phase(f"init {arch}: {_params_b(params):.2f} B params, "
           f"{time.perf_counter() - t0:.1f}s")
    if arch == "granite-8b":
        check_gather(params.embed, gen)

    prompts = serve.make_prompts(cfg, B, PROMPT, "cuda")
    for fn in COUNTERS.values():
        fn.launches = 0
    res = serve.generate(params, cfg, prompts, GEN)
    launches = {n: fn.launches for n, fn in COUNTERS.items()}
    kinds = [cfg.layer_pattern[i % len(cfg.layer_pattern)]
             for i in range(cfg.n_layers)]
    n_attn = sum(k in "GLH" for k in kinds)
    # every MoE layer gathers its dispatch once and runs 3 grouped matmuls
    n_moe = sum(k in "GL" for k in kinds) if cfg.n_experts else 0
    want = {"flash_attention": n_attn,
            "decode_attention": n_attn * GEN,
            "burst_gather": (1 + n_moe) * (1 + GEN),
            "mamba2_scan": sum(k in "MH" for k in kinds) * (1 + GEN),
            "rwkv6_scan": kinds.count("R") * (1 + GEN),
            "moe_gmm": (3 if cfg.gated_mlp else 2) * n_moe * (1 + GEN)}
    _phase(f"serve {arch} on {torch.cuda.get_device_name(0)}: "
           f"{_params_b(params):.2f} B params, {cfg.n_layers} layers, "
           f"d_model {cfg.d_model}: prefill {PROMPT} tokens x {B}: "
           f"{res.prefill_s:.3f}s; decoded {GEN} x {B} tokens in "
           f"{res.decode_s:.3f}s ({GEN * B / res.decode_s:.1f} tok/s); "
           f"launches {launches}")
    _phase(f"sample token ids: {res.tokens[0, :12].tolist()}")
    if launches != want:
        raise AssertionError(f"{arch}: launch counts {launches}, want {want}")
    if tuple(res.logits.shape) != (GEN + 1, B, cfg.vocab_padded) or \
            not bool(torch.isfinite(res.logits.float()).all()):
        raise AssertionError(f"serve {arch}: logits not finite or of the "
                             f"wrong shape")
    check_no_sync(params, cfg, prompts)
    check_cache("bf16", params, cfg, prompts, res)
    return params, prompts, launches


def check_no_sync(params, cfg, prompts):
    """A prefill and a decode step under PyTorch's sync debug mode set to
    "error": the serving path never makes the host wait for the card
    (``.item()``, ``nonzero``, a copy to the host, ``torch.bincount``)."""
    cache = lm.init_cache(params, cfg, B, PROMPT + 1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = lm.step(params, cfg, cache, prompts)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        lm.step(params, cfg, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _phase(f"check {cfg.name}: a prefill and a decode step ran with no "
           f"host sync ok")


def check_cache_f32(params, arch, prompts):
    """The f32 cache check; widens ``params`` in place."""
    cfg = configs.get(arch)
    params.to(torch.float32)
    torch.cuda.empty_cache()
    check_cache("f32", params, cfg, prompts,
                serve.generate(params, cfg, prompts, 1))


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
    scan_errs = check_scans(gen)
    moe_errs = check_moe_gmm(gen)
    for arch in ARCHS:
        check_reference(arch)

    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    tgen = torch.Generator(device="cuda").manual_seed(11)
    kernels, launches = [], dict.fromkeys(COUNTERS, 0)
    for arch in ARCHS:
        params, prompts, counted = serve_phase(arch, gen)
        launches = {n: launches[n] + counted[n] for n in COUNTERS}
        if arch == "granite-8b":
            kernels += granite_rows(params.embed, prompts, errs, flush, tgen)
        check_cache_f32(params, arch, prompts)
        del params
        torch.cuda.empty_cache()
    kernels += scan_rows(dict(zip(("mamba2_scan", "rwkv6_scan"), scan_errs)),
                         flush, tgen)
    kernels += moe_rows(moe_errs, flush, tgen)
    # each kernel's launches, summed over the serve runs
    for row in kernels:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
