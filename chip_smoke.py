#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each printing its own lines:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles the CUDA sources of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a.
   Prints each kernel's registers and spills (ptxas -v) and its count of
   tensor-core instructions (cuobjdump -sass); the bf16 prefill attention
   must have HMMA/HGMMA instructions and no spill at head sizes <= 128,
   the bf16 prefill grouped matmul (gmm_wgmma<128, 256, 4>) HGMMA and no
   spill, the bf16 chunked SSD scan (mamba2_chunked<1, 1>, zamba2-7b's
   prefill) HMMA/HGMMA and no spill, and the gather's 16-byte copy
   (burst_vec<uint4>) the 64 registers that hold a lane's loads of a row
   in flight.
3. the simulator (``repro_torch.core.simulate_batch``): the sweep kernel
   (``csrc/sim_sweep.cu``) against its plain version on the card, exactly
   in cycles, deadlock verdicts, firings and ``steps``, and run twice for
   the same bits: a mixed batch (random graphs, the edge jobs and some of
   the paper's designs), warp rows and block rows of every width in one
   launch (the 48 paper designs with small random graphs), firings 0, a
   batch with no data stream (S* = 0), deadlock (the tokenless loop, a FIFO
   of capacity 0), horizons at, one before and well before the slowest
   job's end, II up to 8, a ring too deep for its row's shared memory
   (latency 4,000) and a chain whose streams and tasks overflow a block's
   registers into global scratch (6,000 tasks), these two also launched
   on a scratch followed by a guard that must come back untouched and
   the long chain's scratch of exactly its surplus streams and tasks; a
   lone job with the
   backend forced to torch against the plain version and the event
   engine.  Then the main path: ``simulate_batch(jobs, firings=300)``
   with backend auto on the card over 384 jobs (8 seeded variants of each
   of the paper's 48 rows), equal to the plain version on the card, its 48
   first variants (a batch of their own) equal to ``_simulate_batch_numpy``
   with ``steps``, one launch a chunk and no fallback; times of the kernel
   (beside the earlier kernel's), the wrapper's whole call (the rows'
   extents read from the tensors and the work list built), the plain
   version and the NumPy oracle
   on the 48 jobs in three rounds; the ``simulate_batch`` line (jobs, wall
   seconds, jobs/s).
4. kernels: each kernel against its plain PyTorch version on the card, in
   bf16 (tolerance rtol = atol = 2e-2, as in tests/test_kernels.py; one f32
   case at 2e-5), the gather exactly.  Prefill attention at the three
   served shapes (granite-8b, zamba2-7b's H layers, granite-moe) and edge
   cases; decode at the served shapes (g = 4, 1, 3), g = 16, with kv_len
   on and beside the split boundaries, 0, a window and softcap, one f32
   case, and the serve-shape decode run twice, bit for bit.  The two
   scans at the serve shapes (prefill from a zero state, decode at S = 1
   from a random one), at S = 33, at head size 16 and at odd and largest
   sizes; at one chunk, one chunk and a step, and S = 0; with a ragged
   last slice of P (mamba2) or of the value axis (rwkv6); at widths the
   16-byte copies cannot take; mamba2 on zamba2-7b-reduced's strided
   slices (P = N = 16, 8 heads) over several chunks; rwkv6 at decays
   whose chunk-local log cumsum falls below -88.7, and with exact zeros of
   w in bf16 and f32.  y at 2e-2 and the f32 state at 3e-2 in bf16; the
   f32 cases y at 2e-5 (2e-4 for rwkv6, as in tests/test_kernels.py) and
   the state at 1e-4; each serve shape run twice, bit for bit. The grouped
   matmul in bf16 and f32 at granite-moe-3b's prefill and decode shapes, at
   ragged sizes (K and N off the tiles, and not multiples of 8, which take
   the generic kernels, also in 64-row sub-tiles of 128-row tiles), on
   unsorted and out-of-range ids, with one expert, with fewer rows than one
   tile over many experts, and at one arctic-480b layer's expert shapes; at
   each, its plan equals the plain plan and a second run with that plan
   gives the same bits. The gather, exactly, on granite-8b's embedding
   streams, granite-moe's prefill and decode dispatch and an odd row width,
   with its count of burst tiles equal to the detector's rule.
5. reference: granite-8b-, zamba2-7b-, rwkv6- and granite-moe-3b-reduced
   on the card (kernels) against the same weights on the CPU (plain
   versions), teacher-forced, atol 2e-2; for the MoE model a batch row may
   exceed it only after one of its tokens was routed to other experts on
   the two devices, first at a near-tie (see ``check_reference``).
6. serve, for granite-8b, zamba2-7b, rwkv6-1.6b and granite-moe-3b-a800m
   in turn, each at full width and depth (random weights from seed 0): 4
   prompts of 512 tokens, greedy prefill then 32 decode steps through
   ``repro_torch.launch.serve``; checks finite logits and the exact launch
   count of every kernel (and of the MoE plans: one per layer and step).
7. no sync: for each model a prefill and a decode step run with PyTorch's
   sync debug mode set to "error".
8. cache, for each model: a second prefill over prompt + first generated
   token must give the first decode step's logits: in bf16 to a relative
   L2 error of 5e-2, then, with the weights widened to f32, elementwise to
   rtol = atol = 1e-3 (see ``check_cache``).  For zamba2 and rwkv6 this
   checks the carried conv, ssd, token-shift and wkv states.
9. times: both attention kernels at each served model's shapes beside
   SDPA and their bound (``time flash_attention[<model>]``,
   ``time decode_attention[<model>]``), the gather at the embedding and
   the MoE dispatch beside ``index_select`` (three rounds, alternating),
   the scans, and the grouped matmul with its plan inside the call and
   with a shared plan, beside ``torch._grouped_mm``, with the schedule it
   chose;
   a JSON line with each kernel's launches, error, times and bound (the
   sweep's launches from its main path), then the result line.

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core import (SimJob, Stream, Task, TaskGraph,  # noqa: E402
                              TaskGraphBuilder, pipeline_headroom)
from repro_torch.core.simulate import (  # noqa: E402
    _simulate_batch_numpy, engine_counts, reset_engine_counts,
    simulate_batch)
from repro_torch.fpga import benchmarks  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import burst_gather as bg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import rwkv6_scan as r6  # noqa: E402
from repro_torch.kernels import sim_sweep as ss  # noqa: E402
from repro_torch.kernels.padded_batch import build_padded_batch  # noqa: E402
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
            "moe_gmm": gmm.moe_gmm,
            "moe_plan": gmm.plan}
CACHE_F32_TOL = dict(rtol=1e-3, atol=1e-3)
CACHE_BF16_REL_L2 = 5e-2
B, PROMPT, GEN = 4, 512, 32
#: clock cycles the card idles before each timed call (~0.5 ms at 2 GHz):
#: longer than the host takes to issue the slowest wrapper timed here, the
#: split-KV decode with its scratch and two launches, on a slow host
SPIN_CYCLES = 1_000_000


def _phase(msg):
    print(msg, flush=True)


def _max_err(got, want):
    if got.numel() == 0:
        return 0.0
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
        ("granite-moe", (4, 512, 512, 24, 8, 64), dict(causal=True)),
        ("zamba2-h", (4, 512, 512, 32, 32, 112), dict(causal=True)),
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

    _, chunk = fa.decode_splits(4, 8, 544, fa._sm_count(0))
    decode = [
        ("serve", (4, 544, 32, 8, 128), dict(kv_len=[544, 300, 17, 1])),
        ("softcap-window", (4, 544, 32, 8, 128), dict(
            causal=True, window=64, softcap=50.0, q_offset=[543, 299, 16, 0],
            kv_len=[544, 300, 17, 1])),
        ("mqa-d64", (2, 200, 32, 2, 64), dict(kv_len=[200, 77])),
        ("d256", (2, 130, 8, 2, 256), dict(kv_len=[130, 9])),
        ("empty", (2, 64, 8, 8, 128), dict(kv_len=[0, 64])),
        # kv_len on and beside the split boundaries of the serve plan
        ("split-bounds", (4, 544, 32, 8, 128), dict(
            kv_len=[chunk, chunk + 1, 1, 544])),
        ("g1-zamba2", (4, 544, 32, 32, 112), dict(kv_len=[544, 513, 33, 1])),
        ("g3-granite-moe", (4, 544, 24, 8, 64), dict(
            kv_len=[544, 512, 100, 31])),
        # the window starts inside a split, and whole splits lie before it
        ("window", (4, 544, 32, 8, 128), dict(
            causal=True, window=200, q_offset=[543, 420, 130, 40],
            kv_len=[544, 421, 131, 41])),
        ("f32", (2, 200, 8, 2, 40), dict(kv_len=[200, 65])),
    ]
    for name, (b, skv, hq, hkv, d), kw in decode:
        kw = {k: torch.tensor(v, dtype=torch.int32, device="cuda")
              if isinstance(v, list) else v for k, v in kw.items()}
        dtype = torch.float32 if name == "f32" else torch.bfloat16
        q = _rand((b, 1, hq, d), gen, dtype)
        k = _rand((b, skv, hkv, d), gen, dtype)
        v = _rand((b, skv, hkv, d), gen, dtype)
        got = fa.decode_attention(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **{"causal": False, **kw})
        errs[f"decode-{name}"] = _assert_close(
            f"decode_attention[{name}]", got, want,
            F32_TOL if name == "f32" else BF16_TOL)
        if name == "serve":
            # the splits merge in a fixed order: the same bits every run
            if not torch.equal(got, fa.decode_attention(q, k, v, **kw)):
                raise AssertionError("decode_attention[serve]: two runs "
                                     "differ")
            _phase("check decode_attention[serve]: two runs give the same "
                   "bits ok")
    return errs["serve"], errs["decode-serve"]


def dispatch_ids(gen, tokens, E=40, k=8):
    """The ids of granite-moe's dispatch gather (``model/moe.py``): the
    (token, k) pairs of the top-k of random router scores over E experts,
    stably sorted by expert, as token ids (order // k)."""
    top = torch.randn((tokens, E), generator=gen, device="cuda").topk(
        k, -1).indices.reshape(-1)
    return torch.argsort(top, stable=True) // k


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


def burst_tiles(idx, R):
    """Tiles of ``bg.TILE`` ids that are one run of in-range rows (the
    burst detector's rule), counted on the host."""
    t = bg.TILE
    pad = -idx.numel() % t
    ids = torch.cat([idx.long(), idx.new_full((pad,), -1).long()]).view(-1, t)
    n = torch.full((ids.shape[0],), t, device=idx.device)
    if pad:
        n[-1] = t - pad
    lane = torch.arange(t, device=idx.device)
    live = lane[None] < n[:, None]
    ok = (ids >= 0) & (ids < R) & (ids == ids[:, :1] + lane[None])
    return int((ok | ~live).all(1).sum()), ids.shape[0]


#: the dispatch gather's table: granite-moe's (B x PROMPT, d_model) bf16
#: activations
DISPATCH_TABLE = (B * PROMPT, 1536)


def gather_tables(table, gen):
    """(name, table, ids) of every gather checked: the streams of
    ``gather_streams`` into ``table`` (granite-8b's embedding), granite-
    moe's prefill and decode dispatch, and random ids into a table of an
    odd bf16 width, whose rows are not a multiple of 16 bytes."""
    cases = [(name, table, idx) for name, idx in
             gather_streams(gen, table.shape[0]).items()]
    moe_x = _rand(DISPATCH_TABLE, gen)
    cases += [("dispatch-prefill", moe_x, dispatch_ids(gen, B * PROMPT)),
              ("dispatch-decode", moe_x, dispatch_ids(gen, B))]
    odd = _rand((3000, 1535), gen)
    cases.append(("odd-width-1535", odd, torch.randint(
        0, 3000, (2051,), generator=gen, device="cuda")))
    return cases


def check_gather(table, gen):
    """Every stream exact, with the kernel's count of burst tiles equal to
    the detector's rule on the host."""
    for name, tab, idx in gather_tables(table, gen):
        idx = idx.to(torch.int32)
        want = ref.burst_gather_ref(tab, idx)
        bursts = torch.zeros(1, dtype=torch.int32, device="cuda")
        got = bg.burst_gather(tab, idx, bursts=bursts)
        exact = torch.equal(got, want)
        runs, tiles = burst_tiles(idx, tab.shape[0])
        counted = int(bursts)
        ok = exact and counted == runs
        _phase(f"check burst_gather[{name}]: N={idx.numel()} row "
               f"{tab.shape[1] * tab.element_size()} B, exact={exact}, burst"
               f" tiles {counted} of {tiles} (host rule {runs}) "
               f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"burst_gather[{name}] is not exact or "
                                 f"miscounts its bursts")


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


def rwkv6_inputs(gen, b, s, h, d, dtype=torch.bfloat16, state=True,
                 decay="normal"):
    """r, k, v, w, u, state of the WKV scan, w = exp(-exp(z)): z standard
    normal ("normal"), shifted by +3 ("strong": a chunk's log-decay cumsum
    falls far below -88.7), or normal with a third of w set to exactly 0
    ("zeros")."""
    r, k, v = (_rand((b, s, h, d), gen, dtype) for _ in range(3))
    z = _rand((b, s, h, d), gen, torch.float32)
    w = torch.exp(-torch.exp(z + (3.0 if decay == "strong" else 0.0)))
    if decay == "zeros":
        w = torch.where(torch.rand(w.shape, generator=gen, device="cuda")
                        < 1 / 3, 0.0, w)
    u = 0.3 * _rand((h, d), gen, torch.float32)
    s0 = _rand((b, h, d, d), gen, torch.float32) if state else None
    return r, k, v, w.to(dtype), u, s0


#: (case, shape (B, S, H, P, N), dtype, initial state, strided x/B/C);
#: bf16 with S >= m2.CHUNK (64) runs the chunked kernel (slices of 64 rows
#: of P), the rest the sequential one
MAMBA2_CASES = [
    ("serve-prefill", (B, PROMPT, 112, 64, 64), torch.bfloat16, False, True),
    ("serve-decode", (B, 1, 112, 64, 64), torch.bfloat16, True, True),
    ("s33", (2, 33, 8, 64, 64), torch.bfloat16, True, False),
    ("p16", (2, 40, 4, 16, 16), torch.bfloat16, True, True),
    ("odd-p24-n40", (1, 17, 3, 24, 40), torch.bfloat16, True, False),
    ("p128-n128", (1, 9, 2, 128, 128), torch.bfloat16, True, False),
    ("f32", (2, 33, 4, 64, 64), torch.float32, True, False),
    ("s64-one-chunk", (2, 64, 4, 64, 64), torch.bfloat16, True, False),
    ("s65-chunk-and-a-step", (2, 65, 4, 64, 64), torch.bfloat16, True, True),
    ("s0", (2, 0, 4, 64, 64), torch.bfloat16, True, False),
    ("p40-ragged-slice", (1, 70, 3, 40, 16), torch.bfloat16, True, False),
    ("p80-two-slices", (1, 70, 3, 80, 16), torch.bfloat16, True, False),
    ("p24-n40-chunked", (1, 80, 3, 24, 40), torch.bfloat16, False, False),
    ("p20-n20-unaligned", (1, 70, 2, 20, 20), torch.bfloat16, True, True),
    ("p128-n128-chunked", (1, 130, 2, 128, 128), torch.bfloat16, True,
     False),
    ("zamba2-reduced-strided", (2, 100, 8, 16, 16), torch.bfloat16, True,
     True),
    ("f32-p40-s65", (1, 65, 2, 40, 24), torch.float32, True, False),
]
#: (case, shape (B, S, H, D), dtype, initial state, decay of
#: ``rwkv6_inputs``); S >= r6.CHUNK (16) runs the chunked kernel (slices of
#: 32 value columns), the rest the sequential one
RWKV6_CASES = [
    ("serve-prefill", (B, PROMPT, 32, 64), torch.bfloat16, False, "normal"),
    ("serve-decode", (B, 1, 32, 64), torch.bfloat16, True, "normal"),
    ("s33", (2, 33, 8, 64), torch.bfloat16, True, "normal"),
    ("d16", (2, 40, 4, 16), torch.bfloat16, True, "normal"),
    ("odd-d24", (1, 17, 3, 24), torch.bfloat16, True, "normal"),
    ("d128", (1, 9, 2, 128), torch.bfloat16, True, "normal"),
    ("f32", (2, 33, 4, 64), torch.float32, True, "normal"),
    ("s16-one-chunk", (2, 16, 4, 64), torch.bfloat16, True, "normal"),
    ("s17-chunk-and-a-step", (2, 17, 4, 64), torch.bfloat16, True, "normal"),
    ("s0", (2, 0, 4, 64), torch.bfloat16, True, "normal"),
    ("d48-ragged-slice", (1, 40, 3, 48), torch.bfloat16, True, "normal"),
    ("d20-unaligned", (1, 37, 2, 20), torch.bfloat16, True, "normal"),
    ("d128-chunked", (1, 50, 2, 128), torch.bfloat16, True, "normal"),
    ("f32-d128-chunked", (1, 35, 2, 128), torch.float32, True, "normal"),
    ("strong-decay", (2, 64, 3, 16), torch.bfloat16, True, "strong"),
    ("strong-decay-f32", (2, 64, 3, 16), torch.float32, True, "strong"),
    ("w-zeros", (2, 50, 3, 64), torch.bfloat16, True, "zeros"),
    ("w-zeros-f32", (2, 50, 3, 64), torch.float32, True, "zeros"),
]


def _check_scan(name, got, want, f32, y_tol):
    errs = [_assert_close(f"{name} y", got[0], want[0],
                          y_tol if f32 else BF16_TOL),
            _assert_close(f"{name} state", got[1], want[1],
                          STATE_F32_TOL if f32 else STATE_BF16_TOL)]
    return max(errs)


def _same_bits(name, fn, args, got):
    """A second run gives the same bits (no atomics, a fixed order of
    sums)."""
    again = fn(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again, strict=True)):
        raise AssertionError(f"{name}: two runs differ")
    _phase(f"check {name}: two runs give the same bits ok")


def check_scans(gen):
    """Both scans against their plain versions, each serve shape also
    against itself run again; returns the max error of each at its serve
    prefill shape."""
    errs = {}
    for case, shape, dtype, state, strided in MAMBA2_CASES:
        args = mamba2_inputs(gen, *shape, dtype=dtype, state=state,
                             strided=strided)
        name = f"mamba2_scan[{case}] {m2.schedule(dtype, shape[1])}"
        got = m2.mamba2_scan(*args)
        errs[f"mamba2_scan[{case}]"] = _check_scan(
            name, got, ref.mamba2_scan_ref(*args), dtype == torch.float32,
            F32_TOL)
        if case.startswith("serve"):
            _same_bits(name, m2.mamba2_scan, args, got)
    for case, shape, dtype, state, decay in RWKV6_CASES:
        args = rwkv6_inputs(gen, *shape, dtype=dtype, state=state,
                            decay=decay)
        name = f"rwkv6_scan[{case}] {r6.schedule(dtype, shape[1])}"
        if decay == "zeros":
            _phase(f"{name}: {int((args[3] == 0).sum())} exact zeros of w")
        got = r6.rwkv6_scan(*args)
        errs[f"rwkv6_scan[{case}]"] = _check_scan(
            name, got, ref.rwkv6_scan_ref(*args), dtype == torch.float32,
            RWKV_F32_TOL)
        if case.startswith("serve"):
            _same_bits(name, r6.rwkv6_scan, args, got)
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
    # T below one tile over many experts (most SMs without a block), sorted
    # (rows by TMA) and in token order (rows gathered through perm)
    ("t24-many-experts", (3, 8), 1536, 512, 40, torch.bfloat16, "sorted"),
    ("t24-many-experts-unsorted", (3, 8), 1536, 512, 40, torch.bfloat16,
     "token"),
    # K and N multiples of 8 but not of the tiles (K step 64; 256 columns)
    ("ragged-k1000-n200", (256, 4), 1000, 200, 8, torch.bfloat16, "sorted"),
    ("e1-every-row", (300, 1), 256, 264, 1, torch.bfloat16, (0, 1)),
    ("all-out-of-range", (100, 1), 128, 64, 4, torch.bfloat16, (4, 9)),
    # bf16 with K and N not multiples of 8 (the generic wmma kernel): ids in
    # token order; and T >= 128 E, so its 128-row tiles are cut into two
    # 64-row sub-tiles, with ids out of range (in f32 too)
    ("wmma-k37-n23-unsorted", (96, 2), 37, 23, 6, torch.bfloat16, "token"),
    ("wmma-k37-n23-sub-tiles-oor", (1200, 1), 37, 23, 4, torch.bfloat16,
     (-1, 5)),
    ("f32-k37-n23-sub-tiles-oor", (1200, 1), 37, 23, 4, torch.float32,
     (-1, 5)),
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
        # the plan on the card is the plain plan of the same ids
        plan = gmm.plan(g, E)
        if not all(torch.equal(a.cpu(), b) for a, b in
                   zip(plan[:4], gmm.plan(g.cpu(), E)[:4])):
            raise AssertionError(f"moe_gmm[{case}]: the plan differs from "
                                 f"its plain version")
        # the same bits on every run, with the plan built inside the call
        # or shared
        if not torch.equal(got, gmm.moe_gmm(x, w, g, plan)):
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

    Before each call the card spins for ``SPIN_CYCLES`` (~0.5 ms), so the
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


SOURCE = {"moe_plan": "moe_gmm.cu",
          "flash_attention": "flash_attention.cu",
          "decode_attention": "flash_attention.cu",
          "burst_gather": "burst_gather.cu",
          "mamba2_scan": "mamba2_scan.cu", "rwkv6_scan": "rwkv6_scan.cu",
          "moe_gmm": "moe_gmm.cu", "sim_sweep": "sim_sweep.cu"}


#: (model, Hq, Hkv, D) of each served model's attention layers
ATTN_SHAPES = (("granite-8b", 32, 8, 128), ("zamba2-7b", 32, 32, 112),
               ("granite-moe-3b-a800m", 24, 8, 64))


def attention_times(flush, gen):
    """Both attention kernels at each served model's shapes (prefill of
    B x 512 causal, decode against a cache of 544), beside SDPA and the
    bound, on a line each.  Bytes count q, k, v and o once; operations are
    4 D per (query, key) pair.  Returns granite-8b's ``(ms, plain,
    library, bound_ms, bound_by)`` for prefill and for decode."""
    n_sm = fa._sm_count(0)
    S = PROMPT + GEN
    rows = {}
    for model, Hq, Hkv, D in ATTN_SHAPES:
        for kind, sq, skv, kw in (("flash_attention", PROMPT, PROMPT, {}),
                                  ("decode_attention", 1, S,
                                   dict(kv_len=S))):
            q = _rand((B, sq, Hq, D), gen)
            k, v = _rand((B, skv, Hkv, D), gen), _rand((B, skv, Hkv, D), gen)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if kind == "flash_attention":
                pairs = B * Hq * PROMPT * (PROMPT + 1) // 2  # causal (q, k)
                fn = fa.flash_attention
                lib = time_ms(_sdpa(qt, kt, vt, is_causal=True), flush)
                nq = -(-PROMPT // 64)
                grid = f"grid {Hq} x {B} x {nq} = {Hq * B * nq} blocks"
            else:
                pairs = B * Hq * S
                fn = fa.decode_attention
                lib = time_ms(_sdpa(qt, kt, vt), flush)
                n_split, chunk = fa.decode_splits(B, Hkv, S, n_sm)
                grid = (f"grid {n_split} x {Hkv} x {B} = "
                        f"{n_split * Hkv * B} blocks (chunk {chunk}) + "
                        f"combine {Hkv * B}")
            ms = time_ms(lambda: fn(q, k, v, **kw), flush)
            plain = time_ms(lambda: ref.attention_ref(
                q, k, v, causal=kind == "flash_attention", **kw), flush) \
                if model == "granite-8b" else None
            b_ms, b_by = bound(4 * pairs * D,
                               2 * (2 * q.numel() + 2 * k.numel()))
            _phase(f"time {kind}[{model}] (B, Sq, Skv, Hq, Hkv, D) = "
                   f"{(B, sq, skv, Hq, Hkv, D)}: {ms:.4f} ms, SDPA "
                   f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                   f"{4 * pairs * D / ms / 1e9:.1f} TFLOP/s, {grid}")
            if model == "granite-8b":
                rows[kind] = (ms, plain, lib, b_ms, b_by)
            del q, k, v, qt, kt, vt
    return rows["flash_attention"], rows["decode_attention"]


def granite_rows(table, prompts, errs, flush, gen):
    """The attention and gather rows, at granite-8b's serve shapes."""
    prefill, decode = attention_times(flush, gen)
    rows = [("flash_attention", "src/repro/kernels/flash_attention.py:90",
             errs[0], *prefill),
            ("decode_attention", "src/repro/kernels/flash_attention.py:149",
             errs[1], *decode)]

    moe_x = _rand(DISPATCH_TABLE, gen)
    timed = {}
    for name, tab, idx in (
            ("embedding", table, prompts.reshape(-1)),
            ("dispatch-prefill", moe_x,
             dispatch_ids(gen, B * PROMPT).to(torch.int32)),
            ("dispatch-decode", moe_x, dispatch_ids(gen, B).to(torch.int32))):
        row_bytes = tab.shape[1] * tab.element_size()
        nbytes = row_bytes * (idx.unique().numel() + idx.numel()) + \
            4 * idx.numel()
        # the kernel and index_select in three alternating rounds: their
        # gap is a few percent, near the spread of one round
        rounds = [(time_ms(lambda: bg.burst_gather(tab, idx), flush),
                   time_ms(lambda: torch.index_select(tab, 0, idx), flush))
                  for _ in range(3)]
        ms, lib = (statistics.median(r) for r in zip(*rounds))
        plain = time_ms(lambda: ref.burst_gather_ref(tab, idx), flush)
        err = _max_err(bg.burst_gather(tab, idx),
                       ref.burst_gather_ref(tab, idx))
        b_ms, b_by = bound(0, nbytes)
        runs, tiles = burst_tiles(idx, tab.shape[0])
        _phase(f"time burst_gather[{name}] N={idx.numel()} into "
               f"{tuple(tab.shape)}: {ms:.4f} ms, index_select {lib:.4f} ms"
               f" (rounds: {', '.join(f'{a:.4f}/{b:.4f}' for a, b in rounds)}"
               f"), bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB); "
               f"burst tiles {runs} of {tiles}")
        timed[name] = (err, ms, plain, lib, b_ms, b_by)
    rows.append(("burst_gather", "src/repro/kernels/burst_gather.py:59",
                 *timed["embedding"]))
    out = [_row(*r) for r in rows]
    _, d_ms, d_plain, d_lib, d_b, _ = timed["dispatch-prefill"]
    out[-1].update(dispatch_ms=d_ms, dispatch_plain_ms=d_plain,
                   dispatch_library_ms=d_lib, dispatch_bound_ms=d_b)
    return out


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def scan_rows(errs, flush, gen):
    """The two scans at their serve shapes: the row's times are the
    prefill's (S = 512 from a zero state), its ``decode_*`` keys the decode
    step's (S = 1 from a random state); a phase line gives each, with the
    kernel that ran and the f32 FMA floor of the sequential recurrence.
    Bytes count each input read once and each output written once;
    operations are the recurrence's f32 FLOPs, 5 per state element and step
    for mamba2, 7 for rwkv6."""
    rows = []
    schedules = {"mamba2_scan": m2.schedule, "rwkv6_scan": r6.schedule}
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
            kernel_name = schedules[name](
                torch.bfloat16, PROMPT if phase == "prefill" else 1)
            _phase(f"time {name}[{phase}] ({kernel_name}): {ms:.4f} ms, "
                   f"plain {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
                   f"{nbytes / 1e6:.1f} MB), f32 FMA floor {f32_ms:.4f} ms")
        ms, plain, b_ms, b_by, _, _ = timed["prefill"]
        row = _row(name, replaces, errs[name], ms, plain, None, b_ms, b_by)
        d_ms, d_plain, d_b, _, _, _ = timed["decode"]
        row.update(decode_ms=d_ms, decode_plain_ms=d_plain,
                   decode_library_ms=None, decode_bound_ms=d_b)
        rows.append(row)
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
        p = gmm.plan(g, E)
        shared = time_ms(lambda: gmm.moe_gmm(x, w, g, p), flush)
        plan_ms = time_ms(lambda: gmm.plan(g, E), flush)
        _phase(f"time moe_gmm[{phase}] with a shared plan: {shared:.4f} ms;"
               f" the plan alone {plan_ms:.4f} ms; schedule "
               f"{gmm.schedule(T, K, N, E, x.dtype)}")
        if phase == "prefill-gate-up":
            # the plan reads the ids and writes perm, off, toff and tiles
            plan_bytes = 8 * T + 8 * (E + 2) + 16 * gmm.tile_bound(T, E)
            plan_row = _row(
                "moe_plan", "src/repro/kernels/moe_gmm.py:50", 0.0, plan_ms,
                time_ms(lambda: gmm.plan_ref(g, E), flush, reps=5), None,
                *bound(0, plan_bytes))
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
    return [row, plan_row]


#: the sweep's firings on the main path, and int32 peak of the card: 132
#: SMs x 64 int32 lanes x 1.98 GHz (Hopper white paper, SXM5 boost clock)
SIM_FIRINGS = 300
#: seeded variants of each of the paper's 48 (design, device) rows
SIM_VARIANTS = 8
PEAK_INT32_OPS = 132 * 64 * 1.98e9
#: int32 operations of the reference sweep's body a stream, and a task, per
#: cycle (``_sweep``: look-up, visibility and space tests, the AND counts,
#: pops / pushes / ring update, in-flight tests; firing rule, fired,
#: next_free, progress and II tests, the done test)
SIM_OPS_STREAM, SIM_OPS_TASK = 16, 14
#: the kernel's group barriers a simulated cycle, and an assumed cost of
#: one barrier of 16 warps with no work between, at the boost clock
SIM_BARRIERS, SIM_BARRIER_CLOCKS, SIM_CLOCK_HZ = 2, 24, 1.98e9
#: a latency deep enough that the ring of a 24-task chain leaves its warp
#: row's shared memory, and a chain long enough that its streams and tasks
#: overflow a block's registers into global scratch
SIM_DEEP_LATENCY = 4000
SIM_LONG_CHAIN = 6000
#: the sweep's time on the main path's batch with the earlier kernel,
#: ``sweep_row`` (a 256-thread block a row, three barriers a cycle; PERF.md
#: section 6, NVIDIA H100 80GB HBM3 at 700 W)
SIM_SWEEP_ROW_MS = 3.158


def _sim_graph(rng, name):
    """A random dataflow graph: a layered DAG with random fan-in, skip
    edges, zero-capacity FIFOs, control streams, detached sinks and, now
    and then, a feedback edge that may close a tokenless cycle."""
    n = int(rng.integers(2, 14))
    g = TaskGraph(name)
    for i in range(n):
        g.add_task(Task(f"t{i}", detached=bool(i == n - 1 and n > 3 and
                                               rng.random() < 0.3)))
    edges = [(int(rng.integers(0, i)), i) for i in range(1, n)
             for _ in range(int(rng.integers(1, 3)))]
    edges += [(int(rng.integers(0, n - 1)), int(rng.integers(1, n)))
              for _ in range(int(rng.integers(0, 3)))]
    if n > 2 and rng.random() < 0.2:
        edges.append((int(rng.integers(1, n)), 0))
    for k, (a, b) in enumerate(edges):
        if a == b:
            continue
        depth = 0 if rng.random() < 0.03 else int(rng.choice([1, 2, 4]))
        g.add_stream(Stream(f"s{k}", f"t{a}", f"t{b}", depth=depth,
                            control=bool(rng.random() < 0.1)),
                     validate=False)
    return g


def _sim_knobs(rng, g, ii_max=4):
    """Random latency 0-4, headroom and II 1-``ii_max`` knobs."""
    lat = {s.name: int(rng.integers(0, 5)) for s in g.streams}
    extra = {s.name: int(rng.choice([0, 0, 2, 2 * lat[s.name]]))
             for s in g.streams}
    ii = {t: int(rng.integers(1, ii_max + 1)) for t in g.tasks}
    return SimJob(g, latency=lat, extra_capacity=extra, ii=ii)


def _sim_chain(name, n, depth=2, control=False, detached=False):
    g = TaskGraph(name)
    for i in range(n):
        g.add_task(Task(f"t{i}", detached=detached and i == n - 1))
    for i in range(n - 1):
        g.add_stream(Stream(f"s{i}", f"t{i}", f"t{i + 1}", depth=depth,
                            control=control), validate=False)
    return g


def _sim_edge_jobs():
    """Deadlock (the tokenless loop of ``analysis/__init__.py``'s doctest,
    a FIFO of capacity 0), its control-closed twin, control-only and
    stream-less graphs, detached tasks, II > 1."""
    def loop(name, control):
        b = TaskGraphBuilder(name)
        b.stream("ab")
        b.stream("ba", control=control)
        b.invoke("A", ins=["ba"], outs=["ab"])
        b.invoke("B", ins=["ab"], outs=["ba"])
        return b.build()

    return [SimJob(loop("loop", False)), SimJob(loop("loop2", True)),
            SimJob(_sim_chain("zero", 2, depth=0), latency={"s0": 1}),
            SimJob(_sim_chain("ctl", 3, control=True), ii={"t1": 2}),
            SimJob(_sim_chain("det", 4, detached=True),
                   latency={"s2": 3}, ii={"t3": 3}),
            SimJob(_sim_chain("solo", 1)),
            SimJob(_sim_chain("ii", 3), latency={"s0": 2},
                   extra_capacity={"s0": 4}, ii={"t0": 2, "t2": 5})]


def sim_paper_jobs(seed=0, variants=SIM_VARIANTS):
    """``variants`` seeded variants of each of the 48 (design, device) rows
    of ``autobridge_suite()`` + ``hbm_suite()``: latency 0-4 on ~30 % of
    the data streams, ``pipeline_headroom`` as extra capacity, II = 2 on
    ~5 % of the tasks."""
    rng = np.random.default_rng(seed)
    jobs = []
    for _, _, g in benchmarks.autobridge_suite() + benchmarks.hbm_suite():
        data = [s.name for s in g.streams if not s.control]
        for _ in range(variants):
            lat = {s: int(rng.integers(0, 5)) for s in data
                   if rng.random() < 0.3}
            ii = {t: 2 for t in g.tasks if rng.random() < 0.05}
            jobs.append(SimJob(g, latency=lat,
                               extra_capacity=pipeline_headroom(lat), ii=ii))
    return jobs


def _sim_key(r):
    return r.cycles, r.fired, r.deadlocked, r.steps


def _plan_text(plan):
    rows = plan.rows
    warp = int((rows["warps"] == 1).sum())
    return (f"{warp} warp rows, {len(rows) - warp} block rows (warps "
            f"{sorted(set(rows['warps'].tolist()))}) in {plan.blocks} "
            f"blocks, {plan.smem} B shared a block, {plan.scratch} ints of "
            f"global scratch")


def _sweep_plan(args):
    """The kernel's work list for the sweep's inputs, as the wrapper builds
    it."""
    lat, _, _, active, counted, cons, prod = args
    return ss.schedule(*ss.row_shapes(lat, active, counted, cons, prod))


#: ints past the end of the global scratch that must stay as they were
SIM_GUARD = 1 << 16


def _launch(args, plan, scratch, firings, max_cycles):
    """The kernel launched as the wrapper launches it, on a work list and a
    scratch given here; returns (cycles, dead, fired, row_steps) on the
    card, uncounted."""
    lat, cap, ii, active, counted, cons, prod = args
    V, S = lat.shape
    T = ii.shape[1]
    flags = (active.to(torch.uint8) | (counted.to(torch.uint8) << 1))
    meta = torch.from_numpy(np.concatenate(
        [plan.rows.view(np.uint8), plan.warp_row.view(np.uint8)])).cuda()
    outs = [torch.empty(V, dtype=torch.int32, device="cuda"),
            torch.empty(V, dtype=torch.int32, device="cuda"),
            torch.empty((V, T), dtype=torch.int32, device="cuda"),
            torch.empty(V, dtype=torch.int32, device="cuda")]
    err = _build.load("sim_sweep").sim_sweep_fwd(
        lat.data_ptr(), cap.data_ptr(), cons.data_ptr(), prod.data_ptr(),
        ii.data_ptr(), flags.data_ptr(), meta.data_ptr(),
        meta.data_ptr() + plan.rows.nbytes, plan.blocks, S, T, firings,
        max_cycles, *(o.data_ptr() for o in outs), scratch.data_ptr(),
        plan.smem, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sim_sweep")
    return outs


def _scratch_guard(name, pb, got, firings, max_cycles):
    """The kernel on a scratch of its work list's size followed by a guard
    of ``SIM_GUARD`` ints holding a pattern: the guard must come back
    untouched and the results equal the wrapper's ``got``."""
    args = ss.padded_tensors(pb, "cuda")
    plan = _sweep_plan(args)
    pattern = torch.randint(-(1 << 30), 1 << 30, (SIM_GUARD,),
                            dtype=torch.int32, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(3))
    scratch = torch.cat([torch.full((plan.scratch,), -7, dtype=torch.int32,
                                    device="cuda"), pattern])
    outs = _launch(args, plan, scratch, firings, max_cycles)
    torch.cuda.synchronize()
    if not torch.equal(scratch[plan.scratch:], pattern):
        hit = (scratch[plan.scratch:] != pattern).nonzero().flatten()
        raise AssertionError(f"sim_sweep[{name}]: the kernel wrote "
                             f"{hit.numel()} ints past its {plan.scratch} "
                             f"ints of scratch (up to +{int(hit.max()) + 1})")
    if not (torch.equal(outs[0], got[0]) and torch.equal(outs[1].bool(),
                                                         got[1])
            and torch.equal(outs[2], got[2])
            and int(outs[3].max()) == got[3]):
        raise AssertionError(f"sim_sweep[{name}]: the guarded launch "
                             f"differs from the wrapper's")
    _phase(f"check sim_sweep[{name}] scratch: {plan.scratch} ints, "
           f"nothing written in the {SIM_GUARD} past them ok")


def _sweep_case(name, jobs, firings, max_cycles=None):
    """The kernel against its plain version on the card, exactly in every
    output, and run twice for the same bits.  Returns the layout, the
    kernel's results and its work list."""
    max_cycles = max_cycles or firings * 64 + 10_000
    pb = build_padded_batch(jobs)
    args = ss.padded_tensors(pb, "cuda")
    got = ss.sim_sweep(*args, pb.H, firings, max_cycles)
    again = ss.sim_sweep(*args, pb.H, firings, max_cycles)
    want = ref.sim_sweep_ref(*args, pb.H, firings, max_cycles)
    torch.cuda.synchronize()
    plan = _sweep_plan(args)
    for what, other in (("plain", want), ("second run", again)):
        same = all(torch.equal(a, b) for a, b in zip(got[:3], other[:3])) \
            and got[3] == other[3]
        if not same:
            bad = (got[0] != other[0]) | (got[1] != other[1]) | \
                (got[2] != other[2]).any(1)
            raise AssertionError(
                f"sim_sweep[{name}]: differs from its {what} in rows "
                f"{bad.nonzero().flatten().tolist()[:10]} (steps "
                f"{got[3]} vs {other[3]})")
    _phase(f"check sim_sweep[{name}] V={pb.V} T*={pb.T} S*={pb.S} "
           f"H={pb.H} firings={firings} max_cycles={max_cycles}: cycles "
           f"{int(got[0].min()) if pb.V else 0}-"
           f"{int(got[0].max()) if pb.V else 0}, "
           f"{int(got[1].sum())} deadlocked, steps {got[3]}; "
           f"{_plan_text(plan)}; exact against the plain version, same "
           f"bits twice ok")
    return pb, got, plan


def check_sim_sweep():
    """Every case of the sweep kernel against its plain version."""
    rng = np.random.default_rng(17)
    mixed = [_sim_knobs(rng, _sim_graph(rng, f"g{i}")) for i in range(40)]
    mixed += _sim_edge_jobs() + sim_paper_jobs(seed=5, variants=1)[::6]
    _sweep_case("mixed", mixed, 25)
    _, _, plan = _sweep_case(
        "warp-and-block-rows",
        sim_paper_jobs(seed=9, variants=1)
        + [_sim_knobs(rng, _sim_graph(rng, f"w{i}")) for i in range(24)], 20)
    widths = plan.rows["warps"]
    per_block = np.bincount((np.cumsum(widths) - widths) // ss.WARPS)
    if set(widths.tolist()) != {1, 2, 4, 8, 16} or per_block.max() < 2:
        raise AssertionError(f"sim_sweep: the warp-and-block-rows case must "
                             f"hold rows of 1-16 warps, several in a block, "
                             f"got {sorted(set(widths.tolist()))} and "
                             f"{per_block.max()} rows a block at most")
    _sweep_case("mixed-firings-0", mixed[:12], 0)
    _sweep_case("no-data-stream", [
        SimJob(_sim_chain("solo", 1)), SimJob(_sim_chain("ctl", 3,
                                                         control=True)),
        SimJob(_sim_chain("ctl2", 2, control=True), ii={"t1": 3})], 9)
    _, dead, _ = _sweep_case("deadlock", _sim_edge_jobs()[:3], 10)
    if dead[1].tolist() != [True, False, True]:
        raise AssertionError(f"sim_sweep: deadlock verdicts "
                             f"{dead[1].tolist()}, want [True, False, "
                             f"True]")
    _, full, _ = _sweep_case("horizon-free", mixed, 12)
    finished = full[0][~full[1]]
    last = int(finished.max())
    for cut in (last, last - 1, 7):
        _, cutres, _ = _sweep_case(f"horizon-{cut}", mixed, 12,
                                   max_cycles=cut)
        at = (full[0] == last) & ~full[1]
        if cut != 7 and not bool((cutres[0][at] == cut).all()) or \
                cut == last and bool(cutres[1][at].any()) or \
                cut == last - 1 and not bool(cutres[1][at].all()):
            raise AssertionError(f"sim_sweep: horizon {cut} mishandled the "
                                 f"jobs finishing at {last}")
    _sweep_case("ii", [_sim_knobs(rng, _sim_graph(rng, f"h{i}"), ii_max=8)
                       for i in range(16)], 20)
    deep = [SimJob(_sim_chain("deep", 24),
                   latency={"s0": SIM_DEEP_LATENCY, "s1": 1},
                   extra_capacity={"s0": 2 * SIM_DEEP_LATENCY}),
            SimJob(_sim_chain("pc", 2))]
    deep_pb, deep_got, deep_plan = _sweep_case("deep-ring", deep, 5)
    _scratch_guard("deep-ring", deep_pb, deep_got, 5, 5 * 64 + 10_000)
    long = [SimJob(_sim_chain("long", SIM_LONG_CHAIN)),
            SimJob(_sim_chain("pc", 2), ii={"t1": 2})]
    long_pb, long_got, long_plan = _sweep_case("long-chain", long, 3)
    _scratch_guard("long-chain", long_pb, long_got, 3, 3 * 64 + 10_000)
    kept = ss.PER_THREAD * 32 * ss.WARPS
    deep_row = deep_plan.rows[deep_plan.rows["n_streams"] == 23]
    long_row = long_plan.rows[long_plan.rows["n_tasks"] == SIM_LONG_CHAIN]
    # the long chain's streams (9 ints each) and tasks (5) past a block's
    # registers, and nothing else: both rows' rings and flags are shared
    long_spill = 9 * (SIM_LONG_CHAIN - 1 - kept) + 5 * (SIM_LONG_CHAIN - kept)
    if len(deep_row) != 1 or deep_row["ring_shared"][0] or \
            len(long_row) != 1 or long_plan.scratch != long_spill:
        raise AssertionError(f"sim_sweep: the deep ring must take global "
                             f"memory, and the long chain's streams and "
                             f"tasks past the registers {long_spill} ints "
                             f"of it ({deep_plan.rows}, {long_plan.scratch} "
                             f"ints)")
    # a lone job with the backend forced to torch, against the event engine
    one = [_sim_knobs(rng, _sim_graph(rng, "lone"))]
    got = simulate_batch(one, firings=20, backend="torch")
    ev = simulate_batch(one, firings=20, backend="event")
    want = simulate_batch(one, firings=20, backend="torch", device="cpu")
    if _sim_key(got[0]) != _sim_key(want[0]) or \
            _sim_key(got[0])[:3] != _sim_key(ev[0])[:3] or \
            got[0].engine != "torch-padded":
        raise AssertionError(f"sim_sweep: a lone job differs: {got[0]}, "
                             f"plain {want[0]}, event {ev[0]}")
    _phase(f"check simulate_batch(backend='torch') on one job: "
           f"{got[0].cycles} cycles, as the plain version and the event "
           f"engine ok")


def _sim_bound(pb, cycles):
    """Least time of the sweep on the card: each row does ~16 int32
    operations a real stream and ~14 a real task for each of its cycles
    (its active iterations equal its cycles), over the int32 peak; bytes
    are the inputs read once and the outputs written once."""
    ops = float((cycles.astype("int64") * (
        SIM_OPS_STREAM * pb.stream_active.sum(axis=1)
        + SIM_OPS_TASK * pb.task_active.sum(axis=1))).sum())
    nbytes = 4 * 4 * pb.V * pb.S + 5 * pb.V * pb.T + 4 * 2 * pb.V \
        + 4 * pb.V * (pb.T + 3)
    t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", ops, nbytes)


def sim_phase(flush):
    """The main path: ``simulate_batch(jobs, firings=300)`` with backend
    auto on the card over 384 jobs of the paper's designs, its launches
    counted; every result against the plain version's run on the card, and
    each design's first variant (48 jobs, a batch of their own) against
    the NumPy oracle, ``steps`` included.  Then the times.  Returns the
    kernels-line row."""
    jobs = sim_paper_jobs()
    ss.sim_sweep.launches = 0
    reset_engine_counts()
    t0 = time.perf_counter()
    res = simulate_batch(jobs, firings=SIM_FIRINGS)
    wall = time.perf_counter() - t0
    launches, counts = ss.sim_sweep.launches, engine_counts()
    if launches < 1 or launches != counts["torch"] or counts["fallback"] \
            or counts["numpy"] or counts["event"] or \
            any(r.engine != "torch-padded" for r in res):
        raise AssertionError(f"simulate_batch: {launches} launches, engine "
                             f"counts {counts}")
    max_cycles = SIM_FIRINGS * 64 + 10_000
    pb = build_padded_batch(jobs)
    args = ss.padded_tensors(pb, "cuda")
    plain = pb.unpack(*(x.cpu().numpy() if torch.is_tensor(x) else x
                        for x in ref.sim_sweep_ref(
                            *args, pb.H, SIM_FIRINGS, max_cycles)),
                      "torch-padded")
    if [_sim_key(r) for r in res] != [_sim_key(r) for r in plain]:
        raise AssertionError("simulate_batch: the kernel's results differ "
                             "from the plain version's on the card")
    first = jobs[::SIM_VARIANTS]
    t0 = time.perf_counter()
    oracle = _simulate_batch_numpy(first, firings=SIM_FIRINGS,
                                       max_cycles=max_cycles)
    np_times = [time.perf_counter() - t0]
    got48 = simulate_batch(first, firings=SIM_FIRINGS)
    if [_sim_key(r) for r in got48] != [_sim_key(r) for r in oracle]:
        raise AssertionError(f"simulate_batch: the {len(first)} first "
                             f"variants differ from _simulate_batch_numpy")
    cycles = np.array([r.cycles for r in res])
    _phase(f"check simulate_batch[paper x {SIM_VARIANTS}] {len(jobs)} jobs, T*={pb.T} "
           f"S*={pb.S} H={pb.H}: equal to the plain version on the card; "
           f"{len(first)} first variants equal to the NumPy oracle, steps "
           f"{got48[0].steps} included; cycles {cycles.min()}-"
           f"{cycles.max()}, {sum(r.deadlocked for r in res)} deadlocked; "
           f"{launches} launch(es) for {counts['torch']} chunk(s) ok")

    # times: three rounds, the kernel (CUDA events, median of 10 calls) and
    # the plain version on the card (one call) in turns; the NumPy oracle
    # on the 48-job batch by the host clock
    # the kernel on a work list built beforehand (its launch as the
    # wrapper makes it, with the list's copy); the wrapper's whole call,
    # which also reads the rows' extents from the tensors (one copy to the
    # host) and builds the list
    plan = _sweep_plan(args)
    scratch = torch.empty(max(plan.scratch, 1), dtype=torch.int32,
                          device="cuda")
    k_ms, p_ms, c_ms, walls = [], [], [], [wall]
    for _ in range(3):
        k_ms.append(time_ms(lambda: _launch(args, plan, scratch, SIM_FIRINGS,
                                            max_cycles), flush, reps=10))
        c_ms.append(time_ms(lambda: ss.sim_sweep(*args, pb.H, SIM_FIRINGS,
                                                 max_cycles),
                            flush, reps=10))
        p_ms.append(time_ms(lambda: ref.sim_sweep_ref(
            *args, pb.H, SIM_FIRINGS, max_cycles), flush, reps=1))
        t0 = time.perf_counter()
        simulate_batch(jobs, firings=SIM_FIRINGS)
        walls.append(time.perf_counter() - t0)
    for _ in range(2):
        t0 = time.perf_counter()
        _simulate_batch_numpy(first, firings=SIM_FIRINGS,
                                  max_cycles=max_cycles)
        np_times.append(time.perf_counter() - t0)
    # where a warm call's wall time goes, by the port's own spans, and the
    # host's parts of it timed alone
    trace.enable(clear=True)
    simulate_batch(jobs, firings=SIM_FIRINGS)
    trace.disable()
    spans = {e["name"]: e["dur_ns"] / 1e9 for e in trace.drain()}
    t0 = time.perf_counter()
    ss.fits_int32(jobs, SIM_FIRINGS, max_cycles)
    t1 = time.perf_counter()
    build_padded_batch(jobs)
    t2 = time.perf_counter()
    outs = ss.simulate_padded_torch(pb, firings=SIM_FIRINGS,
                                    max_cycles=max_cycles, device="cuda")
    t3 = time.perf_counter()
    pb.unpack(*outs, "torch-padded")
    t4 = time.perf_counter()
    fits_s, layout_s, sweep_s, unpack_s = t1 - t0, t2 - t1, t3 - t2, t4 - t3
    ms, plain_ms = statistics.median(k_ms), statistics.median(p_ms)
    b_ms, b_by, ops, nbytes = _sim_bound(pb, cycles)
    per_cycle_us = ms * 1e3 / int(cycles.max())
    chain_ms = int(cycles.max()) * SIM_BARRIERS * SIM_BARRIER_CLOCKS \
        / SIM_CLOCK_HZ * 1e3
    _phase(f"time sim_sweep[paper x {SIM_VARIANTS}] V={pb.V}: {ms:.4f} ms "
           f"(rounds {', '.join(f'{t:.4f}' for t in k_ms)}; the earlier "
           f"sweep_row {SIM_SWEEP_ROW_MS} ms, {SIM_SWEEP_ROW_MS / ms:.2f}x), "
           f"{pb.V / ms * 1e3:.0f} jobs/s; {per_cycle_us:.3f} us a "
           f"simulated cycle over the longest row's {int(cycles.max())}; "
           f"{_plan_text(plan)}; the wrapper's whole call, extents read "
           f"from the tensors and the work list built, "
           f"{statistics.median(c_ms):.4f} ms (rounds "
           f"{', '.join(f'{t:.4f}' for t in c_ms)}); plain on the card "
           f"{plain_ms:.1f} "
           f"ms (rounds {', '.join(f'{t:.1f}' for t in p_ms)}); NumPy "
           f"oracle on {len(first)} jobs {statistics.median(np_times):.2f} s "
           f"(rounds {', '.join(f'{t:.2f}' for t in np_times)}), "
           f"{len(first) / statistics.median(np_times):.2f} jobs/s; bound "
           f"{b_ms:.4f} ms ({b_by}; {ops / 1e9:.3f} G int32 ops, "
           f"{nbytes / 1e6:.2f} MB); chain: {int(cycles.max())} cycles of "
           f"the longest row x {SIM_BARRIERS} barriers of "
           f"~{SIM_BARRIER_CLOCKS} clocks = {chain_ms:.4f} ms")
    _phase(f"time simulate_batch[paper x {SIM_VARIANTS}] warm call by its "
           f"spans: simulate.batch {spans['simulate.batch']:.4f} s, of which "
           f"sim_sweep (copies in and out, the work list, the kernel) "
           f"{spans['sim_sweep']:.4f} s; alone: fits_int32 {fits_s:.4f} s, "
           f"build_padded_batch {layout_s:.4f} s, simulate_padded_torch "
           f"{sweep_s:.4f} s, unpack {unpack_s:.4f} s")
    _phase(f"simulate_batch {json.dumps({'jobs': len(jobs), 'firings': SIM_FIRINGS, 'wall_s': wall, 'jobs_per_s': len(jobs) / wall, 'warm_wall_s': walls[1:], 'warm_jobs_per_s': len(jobs) / statistics.median(walls[1:])})}")
    row = _row("sim_sweep", "src/repro/kernels/sim_sweep.py:108", 0.0, ms,
               plain_ms, None, b_ms, b_by)
    row["launches"] = launches
    return row


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
            "moe_gmm": (3 if cfg.gated_mlp else 2) * n_moe * (1 + GEN),
            # one plan per MoE layer and step, shared by its products
            "moe_plan": n_moe * (1 + GEN)}
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


def check_build_report():
    """Registers and spills (``ptxas -v``) and tensor-core instructions
    (HMMA/HGMMA lines of ``cuobjdump -sass``) of every kernel.  The bf16
    prefill must run on the tensor cores at every head-size bucket, and
    must not spill at DP <= 128, which covers the served head sizes."""
    for name in _build.SOURCES:
        for kernel, r in sorted(_build.kernel_report(name).items()):
            _phase(f"ptxas {name}.cu {kernel}: {r.get('registers')} "
                   f"registers, spill stores {r.get('spill_stores')} B, "
                   f"spill loads {r.get('spill_loads')} B; SASS HMMA/HGMMA "
                   f"{r.get('tensor_core')} (HGMMA {r.get('hgmma')})")
    gmm_r = _build.kernel_report("moe_gmm").get("gmm_wgmma<128, 256, 4>",
                                                {})
    if not gmm_r.get("hgmma") or gmm_r.get("spill_stores") or \
            gmm_r.get("spill_loads"):
        raise AssertionError(f"gmm_wgmma<128, 256, 4>, the bf16 prefill "
                             f"grouped matmul, needs HGMMA and no spill: "
                             f"{gmm_r}")
    _phase("check gmm_wgmma<128, 256, 4>: HGMMA in its SASS, no spill ok")
    # zamba2-7b's bf16 prefill scan runs on the tensor cores
    ssd = _build.kernel_report("mamba2_scan").get("mamba2_chunked<1, 1>",
                                                  {})
    if not ssd.get("tensor_core") or ssd.get("spill_stores") or \
            ssd.get("spill_loads"):
        raise AssertionError(f"mamba2_chunked<1, 1>, the bf16 chunked SSD "
                             f"scan, needs HMMA/HGMMA and no spill: {ssd}")
    _phase("check mamba2_chunked<1, 1>: HMMA/HGMMA in its SASS, no spill "
           "ok")
    # each lane holds its 16 loads of 16 bytes (64 registers) before it
    # stores any: fewer registers mean the compiler interleaved the stores
    gather = _build.kernel_report("burst_gather").get("burst_vec<uint4>", {})
    if gather.get("registers", 0) < 64 or gather.get("spill_stores"):
        raise AssertionError(f"burst_vec<uint4> does not keep a row's loads "
                             f"in flight (< 64 registers) or spills: "
                             f"{gather}")
    _phase("check burst_vec<uint4>: a row's loads in flight (>= 64 "
           "registers), no spill ok")
    attn = _build.kernel_report("flash_attention")
    for dp in (64, 128, 256):
        r = attn.get(f"flash_fwd_bf16<{dp}>", {})
        if not r.get("tensor_core"):
            raise AssertionError(f"flash_fwd_bf16<{dp}>: no tensor-core "
                                 f"instruction in its SASS")
        if dp <= 128 and (r.get("spill_stores") or r.get("spill_loads")):
            raise AssertionError(f"flash_fwd_bf16<{dp}> spills: {r}")
    _phase("check flash_fwd_bf16: HGMMA in the SASS of every instantiation, "
           "no spill at DP <= 128 ok")


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
    check_build_report()

    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    check_sim_sweep()
    sim_row = sim_phase(flush)

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_attention(gen)
    scan_errs = check_scans(gen)
    moe_errs = check_moe_gmm(gen)
    for arch in ARCHS:
        check_reference(arch)

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
    # the sweep's, from its own main path
    kernels.append(sim_row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
