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
   the bf16 grouped matmul's product (gmm_wgmma at both tiles), dX
   (gmm_dx_wgmma at both tiles) and dW (gmm_dw_wgmma) HGMMA and no
   spill, the bf16 chunked SSD scan (mamba2_chunked<1, 1, 0>, zamba2-7b's
   prefill) HMMA/HGMMA and no spill, its chunked backward
   (mamba2_bwd_chunked<1, 1>, zamba2-7b's training) HGMMA and no spill,
   and the gather's 16-byte copy
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
   Then the paper's co-optimization flow (``coopt``) on the same 48 rows:
   the baseline (``packed_placement``, ``analyze_timing``) and TAPA's
   (``autobridge`` at the first feasible util of 0.70-1.0, then
   ``analyze_timing``) on the host, each row's plan and both timing
   reports equal to the reference's (``tests/torch_coopt_golden.json``),
   every SDC balance checked; then the throughput check, one
   ``simulate_batch`` (firings 200) on the card over every feasible row's
   baseline and optimized job, its launches counted: equal to the plain
   version on the card, the rows but cnn_13x10-16 and gaussian_24 to the
   NumPy oracle (``steps`` included), no optimized job deadlocked, each
   within its plan's fill/drain cycles, one launch a chunk; the kernel's
   time on this batch and the ``coopt`` line (rows, mean MHz, failures
   recovered, host seconds, counters, wall and spans).
   Then the paper's §6.3 design-space search (``search``) on the 10
   (design, board) rows of ``benchmarks/fmax_suite.py``'s fast subset:
   ``prepare_design_space`` over the util sweep on the host, then one
   ``timed_pool_simulations`` (firings 200) on the card over all 80 jobs
   in one launch, equal to the plain version on the card and to
   ``_simulate_batch_numpy`` (``steps`` included), each row's frontier and
   best candidate equal to the reference's
   (``tests/torch_search_golden.json``); the kernel's time on the batch
   and ``measure_backend_speedup``; then ``search_until_converged`` on
   each row as ``--converge --jobs 2`` runs it, its pool forked after the
   card is in use: rounds, points, hypervolumes, frontiers and the ILP's
   ``exact`` flags equal to the golden file, no pool retry, timeout,
   quarantine or rebuild, one launch a round; the ``search`` line. Then
   ``run_differential`` on the card over 26 generated designs
   (``corpus``): ``ok``, every design's torch result equal to NumPy's,
   the counters equal to the golden file; the ``corpus`` line.
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
   with its count of burst tiles equal to the detector's rule.  The
   attention kernels at the shapes and modes of the five attention
   families (also in ``check_attention``): gemma2's softcap 50 with scale
   1/12, gemma3's head size 256, chatglm3's group of 16, whisper's head
   size 64 and group of 1, whisper's non-causal 1500 x 1500 encoder, and
   the cross-attention over 1601 and 1500 memory rows in prefill and
   decode; one f32 case of each kernel.
5. reference: granite-8b-, zamba2-7b-, rwkv6-, granite-moe-3b-,
   gemma2-27b-, gemma3-12b-, chatglm3-6b-, llama-vision- and
   whisper-tiny-reduced on the card (kernels) against the same weights on
   the CPU (plain versions), teacher-forced, atol 2e-2 (for
   llama-vision's untied head 0.125, the same at its logits' scale: see
   ``ref_atol``); for the MoE model a batch row may exceed
   it only after one of its tokens was routed to other experts on the two
   devices, first at a near-tie (see ``check_reference``).  X layers'
   gates are set to 0.5 and the memory inputs drawn from a seed, and the
   same weights with the gates at 0 must miss the CPU's logits by more
   than the tolerance on every row and step; gemma prefills past its
   window of 32 and decodes past a full ring.
6. serve, for granite-8b, zamba2-7b, rwkv6-1.6b, granite-moe-3b-a800m,
   gemma2-27b, gemma3-12b, chatglm3-6b, llama-3.2-vision-11b and
   whisper-tiny in turn, each at full width and depth (random weights from
   seed 0; serve's stub frontend inputs): 4 prompts of 512 tokens, greedy
   prefill then 32 decode steps through ``repro_torch.launch.serve``;
   checks finite logits and the exact launch count of every kernel (and
   of the MoE plans: one per layer and step; whisper's encoder, one
   prefill a layer; an X layer's cross-attention, one more kernel a step).
7. no sync: for each model the cache's set-up (whisper's encoder), a
   prefill and a decode step run with PyTorch's sync debug mode set to
   "error".
8. cache, for each model: a second prefill over prompt + first generated
   token must give the first decode step's logits: in bf16 to a relative
   L2 error of 5e-2, then, with the weights widened to f32, elementwise to
   rtol = atol = 1e-3 (see ``check_cache``; in bf16 granite-moe's decode
   step takes the experts of the prefill it is compared with); gemma2-27b's
   f32 weights do
   not fit, so its f32 check runs on fresh weights at 4 of its 46 layers
   (``F32_DEPTH``).  For zamba2 and rwkv6 this checks the carried conv,
   ssd, token-shift and wkv states.
9. times: both attention kernels at each served model's shapes beside
   SDPA (none where there is a softcap) and their bound (``time
   flash_attention[<model>]``, ``time decode_attention[<model>]``; the
   families' in the attention rows' ``by_model``), the gather at the
   embedding and
   the MoE dispatch beside ``index_select`` (three rounds, alternating),
   the scans, and the grouped matmul with its plan inside the call and
   with a shared plan, beside ``torch._grouped_mm``, with the schedule it
   chose;
   a JSON line with each kernel's launches, error, times and bound (the
   sweep's launches from its main path and the ``coopt``, ``search`` and
   ``corpus`` paths, each also by path), then the result line.
10. train: ``flash_attention_bwd`` (reached through autograd) against
   autograd through the plain version at the training shape and the
   families' modes (softcap 50 with scale 1/12 and a window, D = 256,
   g = 16, cross-attention with Sq != Skv, whisper's encoder, a ragged
   head size, f32, and bf16 rows four times the training length), and
   ``burst_gather_bwd`` with heavily repeated ids
   (one id taken by every row too) bit for bit equal to a sequential f32
   sum, also past the one-block sort's 16,384 ids on the multi-block path
   (granite-moe's 32,800-id dispatch, a B 16 batch's 16,400 embedding
   ids, N either side of the limit, one id taken 32,800 times), both run
   twice for the same bits; ``moe_gmm_bwd`` (dX and dW through autograd
   from ``moe_gmm``) against autograd through the plain version at
   granite-moe's training products, arctic-reduced's, unsorted and
   out-of-range ids, an expert with no row, one expert, T off the tile,
   K or N not a multiple of 8, f32, experts ending 63, 64 and 65 rows past
   a stage edge, fewer work items than SMs, a partial N tile (N 264), the
   unsorted gather at the training rows and runs of x beside gathered rows
   on one block at the training width, twice for the same bits;
   ``mamba2_scan_bwd`` and
   ``rwkv6_scan_bwd`` (through autograd from the scans' wrappers) against
   autograd through the plain versions at zamba2-7b's and rwkv6-1.6b's
   training shapes (bf16, x, B and C sliced from one projection, no state,
   as the models call them) and in f32 (at ``F32_BWD_TOL``) with a state
   going in and a final-state gradient, at S a multiple of neither
   checkpoint length, S 1 and 0, ragged row slices, N or D 128, the
   reduced models' shapes, rwkv6's strong decays and exact zeros of w,
   each run twice for the same bits and one launch (mamba2's on the path
   ``m2.bwd_schedule`` names: bf16 with S >= 64 chunked, on the tensor
   cores, also at one chunk, two with a state, N 128, P 40 / N 24, P 36 /
   N 20 loaded element by element, and dt A down to -100; the rest
   sequential; each chunked case, and each rwkv6 case, loading its inputs
   the way the library's counts by load say it must); the chunked mamba2
   backward at every cluster size and rwkv6's, called 40 rounds round
   robin, the same bits every time; the wrapper with no backward kernel
   (decode attention) must raise on a CUDA input that requires grad; one
   f32 step of ten reduced models (granite, zamba2, rwkv6, the five
   attention families, granite-moe and arctic) on the card against the
   CPU (loss and every gradient; an MoE model's routing recorded on both
   devices, a reroute allowed only at a near-tie and then compared on
   one routing); the restart on the card
   (checkpoint at step 2, a failure at step 3, resumed into fresh
   tensors: the same losses, norms and final checkpoint bit for bit);
   one step of granite-8b at B 16 x S 1024 (16,400 embedding ids, the
   multi-block gather backward); then the main path,
   ``repro_torch.launch.train.train`` for 5 steps of B 4 x S 1024 on
   granite-8b (8 of its 36 layers), zamba2-7b (27 of its 81: one
   layer_pattern), rwkv6-1.6b (all 24) and granite-moe-3b-a800m (all
   32), each at full width (exact launches of every kernel on its path,
   forward and backward, the gather backward's by path, zamba2's SSD
   backward all on the chunked path, finite losses; each step's loss,
   grad norm and seconds, tokens/s, peak memory); the backward kernels'
   times beside SDPA's backward, ``index_add_``, autograd through
   ``torch._grouped_mm`` or none, each with the device time of every
   kernel it launched by name (``torch.profiler``: the attention's delta
   and wgmma passes, the gather's sorts and writer, each scan's reverse
   walk and sums, the grouped matmul's dX and dW), and their rows in the
   kernels line (the forward rows' launches by path).
11. dist: the distributed runtime (``repro_torch.launch.steps``).
   ``flash_attention`` and its backward at tp 2's local heads (16 / 4,
   D 128) against the plain version; a one-rank NCCL group in this
   process: ``build_baseline_train`` on a (1, 1) mesh and
   ``build_tapa_train`` with a one-stage plan, each first on
   granite-8b-reduced in f32 against ``train.train_step`` (loss and every
   gradient at ``check_train_reference``'s bounds, the grad norm, each
   parameter entry after the step within what those bounds leave of an
   AdamW first step, against the reference's and the step written out),
   then the main path, 3 steps of granite-8b at 8 of 36 layers,
   full width, B 8 x S 1024 in 8 microbatches; ``build_baseline_serve`` on
   granite-8b-reduced teacher-forced against ``lm.step`` on the CPU.  Then
   two gloo ranks sharing the card (NCCL refuses two ranks on one GPU; gloo
   stages every collective through host memory), processes of this
   script (``--dist-child``) under ``DIST_TIMEOUT``: tp 2 and 2 stages of
   boundary depth 2, the f32 runs against the one-rank runs, step 1's bf16
   loss and grad norm within ``DIST_BF16_LOSS`` and ``DIST_BF16_NORM_REL``
   of theirs; the f32 run alone at data 2 (ZeRO-1); serving at tp 2.  Each
   rank's launches exactly; the ``dist`` line (step seconds, tokens/s, peak
   memory per rank, launches per rank); the kernels line's launches gain
   the ``dist`` path.

Exits non-zero, printing no result line, if any phase fails or there is no
CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.ckpt import restore_checkpoint  # noqa: E402
from repro_torch.core import (FloorplanCache, InfeasibleError,  # noqa: E402
                              Interval, SearchPoint, SearchSpace, SimJob,
                              Stream, Task, TaskGraph, TaskGraphBuilder,
                              analyze_timing, autobridge, floorplan_counts,
                              measure_backend_speedup, packed_placement,
                              pipeline_headroom, prepare_design_space,
                              reset_floorplan_counts, search_until_converged,
                              timed_pool_simulations)
from repro_torch.core.ilp import solve_counts  # noqa: E402
from repro_torch.corpus import run_differential, sample_corpus  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.core.simulate import (  # noqa: E402
    _simulate_batch_numpy, engine_counts, reset_engine_counts,
    simulate_batch)
from repro_torch.fpga import benchmarks, grid_for  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.search import pool_counts, reset_pool_counts  # noqa: E402
from repro_torch.kernels import _build, _scan_bwd, ref  # noqa: E402
from repro_torch.kernels import burst_gather as bg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import rwkv6_scan as r6  # noqa: E402
from repro_torch.kernels import sim_sweep as ss  # noqa: E402
from repro_torch.kernels.padded_batch import build_padded_batch  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.profile_bwd import (  # noqa: E402
    embedding_ids, kernel_split, mamba2_bwd_inputs, rwkv6_bwd_inputs,
    time_ms)
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
#: the other attention families: gemma's post-norms, softcaps and
#: local layers, chatglm3's partial rope at g = 16, llama-vision's and
#: whisper's cross-attention, whisper's encoder
ATTN_ARCHS = ("gemma2-27b", "gemma3-12b", "chatglm3-6b",
              "llama-3.2-vision-11b", "whisper-tiny")
#: gemma2-27b's f32 weights (108.9 GB) do not fit the card: its f32 cache
#: check runs at this depth, at full width
F32_DEPTH = {"gemma2-27b": 4}
#: the cross-attention gate of the reference checks' X layers: the init's 0
#: would leave the cross-attention out of the logits
XATTN_GATE = 0.5
#: kernel name -> wrapper, each counting its launches
COUNTERS = {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "decode_attention": fa.decode_attention,
            "burst_gather": bg.burst_gather,
            "burst_gather_bwd": bg.burst_gather_bwd,
            "mamba2_scan": m2.mamba2_scan,
            "mamba2_scan_bwd": m2.mamba2_scan_bwd,
            "rwkv6_scan": r6.rwkv6_scan,
            "rwkv6_scan_bwd": r6.rwkv6_scan_bwd,
            "moe_gmm": gmm.moe_gmm,
            "moe_gmm_bwd": gmm.moe_gmm_bwd,
            "moe_plan": gmm.plan}
CACHE_F32_TOL = dict(rtol=1e-3, atol=1e-3)
CACHE_BF16_REL_L2 = 5e-2
#: the same for an MoE model, its decode step routed as the prefill it is
#: compared with: on an H100, granite-moe's bf16 rounding alone leaves
#: 7.9e-2 there, and the decode step one position early 1.15 (see
#: ``check_cache``)
CACHE_BF16_REL_L2_MOE = 0.2
B, PROMPT, GEN = 4, 512, 32


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


#: gemma2's query scale, (d_model / n_heads)^-0.5 = 1/12
GEMMA2_SCALE = (4608 / 32) ** -0.5
#: memory rows of llama-vision's cross-attention (patches) and whisper's
#: (frames); neither is a multiple of the 32-key decode tile
VISION_ROWS, AUDIO_ROWS = 1601, 1500
G2 = dict(softcap=50.0, scale=GEMMA2_SCALE)


def _attention_case(fn, name, shape, kw, gen):
    """One case of ``fn`` against ``ref.attention_ref`` on the card, in f32
    where the name starts with f32; returns (error, inputs, result)."""
    b, sq, skv, hq, hkv, d = shape
    kw = {k: torch.tensor(v, dtype=torch.int32, device="cuda")
          if isinstance(v, list) else v for k, v in kw.items()}
    f32 = name.startswith("f32")
    dtype = torch.float32 if f32 else torch.bfloat16
    q = _rand((b, sq, hq, d), gen, dtype)
    k = _rand((b, skv, hkv, d), gen, dtype)
    v = _rand((b, skv, hkv, d), gen, dtype)
    got = fn(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **({"causal": False, **kw}
                                         if fn is fa.decode_attention
                                         else kw))
    err = _assert_close(f"{fn.__name__}[{name}]", got, want,
                        F32_TOL if f32 else BF16_TOL)
    return err, (q, k, v, kw), got


def check_attention(gen):
    """Every attention case; returns the max error at the serve shapes.

    Also the shapes and modes of the five attention families:
    gemma2 (softcap 50 with scale 1/12, its 4096 window), gemma3 (head
    size 256, its 1024 window), chatglm3 (a group of 16), whisper (head
    size 64, a group of 1), whisper's encoder (non-causal 1500 x 1500),
    and the cross-attention over llama-vision's 1601 patch rows and
    whisper's 1500 frames in prefill (512 queries, non-causal) and decode
    (the whole memory, no kv_len), at B = 4 so that a tail tile that read
    the next batch's rows would show."""
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
        ("f32", (2, 48, 48, 4, 2, 24), {}),
        ("gemma2-global", (4, 512, 512, 32, 16, 128), dict(causal=True, **G2)),
        ("gemma2-local", (4, 512, 512, 32, 16, 128),
         dict(causal=True, window=4096, **G2)),
        ("gemma2-window-bites", (2, 300, 300, 32, 16, 128),
         dict(causal=True, window=100, **G2)),
        ("gemma3-global", (4, 512, 512, 16, 8, 256), dict(causal=True)),
        ("gemma3-local", (4, 512, 512, 16, 8, 256),
         dict(causal=True, window=1024)),
        ("gemma3-window-bites", (2, 300, 300, 16, 8, 256),
         dict(causal=True, window=100)),
        ("chatglm3-g16", (4, 512, 512, 32, 2, 128), dict(causal=True)),
        ("whisper-self", (4, 512, 512, 6, 6, 64), dict(causal=True)),
        ("whisper-encoder", (4, AUDIO_ROWS, AUDIO_ROWS, 6, 6, 64),
         dict(causal=False)),
        ("llama-vision-cross", (4, 512, VISION_ROWS, 32, 8, 128),
         dict(causal=False)),
        ("whisper-cross", (4, 512, AUDIO_ROWS, 6, 6, 64), dict(causal=False)),
        # f32 with gemma2's softcap and scale, over a memory off the tiles
        ("f32-cross-softcap", (2, 48, 101, 8, 2, 128),
         dict(causal=False, **G2)),
    ]
    for name, shape, kw in prefill:
        errs[name], _, _ = _attention_case(fa.flash_attention, name, shape,
                                           kw, gen)

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
        ("gemma2-decode", (4, 544, 32, 16, 128),
         dict(kv_len=[544, 300, 17, 1], q_offset=[543, 299, 16, 0], **G2)),
        ("gemma3-decode-d256", (4, 544, 16, 8, 256),
         dict(kv_len=[544, 300, 17, 1], q_offset=[543, 299, 16, 0])),
        # a ring of 544 slots that wrapped: every slot valid
        ("gemma3-decode-ring", (4, 544, 16, 8, 256), dict(kv_len=544)),
        ("chatglm3-decode-g16", (4, 544, 32, 2, 128),
         dict(kv_len=[544, 513, 33, 1], q_offset=[543, 512, 32, 0])),
        ("whisper-decode", (4, 544, 6, 6, 64),
         dict(kv_len=[544, 100, 31, 1], q_offset=[543, 99, 30, 0])),
        ("llama-vision-cross-decode", (4, VISION_ROWS, 32, 8, 128), {}),
        ("whisper-cross-decode", (4, AUDIO_ROWS, 6, 6, 64), {}),
        ("f32-cross-softcap", (2, 101, 8, 2, 128), G2),
    ]
    for name, (b, skv, hq, hkv, d), kw in decode:
        err, (q, k, v, kw), got = _attention_case(
            fa.decode_attention, name, (b, 1, skv, hq, hkv, d), kw, gen)
        errs[f"decode-{name}"] = err
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
                  strided=False, decay="normal"):
    """x, dt, A, B, C, state of the SSD scan; ``strided`` cuts x, B and C
    out of one fused tensor, as the model does; ``decay`` "strong" takes
    dt uniform in [0, 1) and A in (-100, -1], so dt A reaches -100 a step
    and the chunked kernels' exp(s) underflow to exact zeros."""
    if strided:
        fused = _rand((b, s, h * p + 2 * n), gen, dtype)
        x, Bm, Cm = torch.split(fused, [h * p, n, n], dim=-1)
        x = x.unflatten(2, (h, p))
    else:
        x = _rand((b, s, h, p), gen, dtype)
        Bm, Cm = _rand((b, s, n), gen, dtype), _rand((b, s, n), gen, dtype)
    dt = torch.nn.functional.softplus(_rand((b, s, h), gen, torch.float32))
    A = -torch.exp(_rand((h,), gen, torch.float32))
    if decay == "strong":
        dt = torch.rand((b, s, h), generator=gen, device="cuda")
        A = -1.0 - 99.0 * torch.rand((h,), generator=gen, device="cuda")
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
        with torch.no_grad():
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


#: (prompt, decode steps) of the reference checks: gemma's reduced window
#: is 32, so its run prefills past it and decodes past a full ring
REF_RUNS = {"gemma2-27b": (40, 12), "gemma3-12b": (40, 12)}
#: logits atol of the reference checks, set for logits of a tied head
#: (the embedding, drawn at std 0.02)
REF_ATOL = 2e-2


def ref_atol(cfg):
    """``REF_ATOL`` in units of the logits' init scale: an untied head is
    drawn at std 1/sqrt(d), 6.25 times the tied heads' 0.02 at the reduced
    d = 64, and the logits and their bf16 rounding scale with it
    (llama-vision-reduced's reach ~3.7, where one bf16 step is 0.0156; on
    the same weights the JAX package's own compiled and op-by-op steps
    differ by up to 0.06 on the CPU, tests/test_torch_attn_families.py)."""
    return REF_ATOL * (1.0 if cfg.tie_embeddings
                       else cfg.d_model ** -0.5 / 0.02)


def seeded_extra(cfg, batch, gen):
    """The stub frontend's inputs drawn from ``gen`` on the CPU (bf16), or
    None: serve's inputs are all 0.01, which makes every memory row equal
    and would hide a wrong row or mask of the cross-attention."""
    stub = serve.frontend_inputs(cfg, batch, "cpu")
    return stub and {k: torch.randn(v.shape, generator=gen).to(v.dtype)
                     for k, v in stub.items()}


def check_reference(arch):
    """The reduced model: kernels on the card vs plain versions on the
    CPU, same weights, teacher-forced prefill (24 tokens; gemma 40, past
    its window) then decode steps (8; gemma 12, wrapping its rings).  X
    layers' gates are set to ``XATTN_GATE`` and the memory inputs drawn
    from a seed.  For an MoE model each step's routing is recorded on both
    devices: a batch row may exceed the tolerance only once one of its
    tokens went to other experts, the first of them at a near-tie
    (``_rerouted``).

    A model with a memory also runs a negative control on the card, the
    same weights with every gate at 0: each of its rows must differ from
    the CPU's logits by more than the tolerance at every step, so that a
    broken cross-attention would fail the check."""
    cfg = configs.get_reduced(arch)
    prompt, steps = REF_RUNS.get(arch, (24, 8))
    cpu = lm.init_params(cfg, seed=0, device="cpu")
    for layer in cpu.layers:
        if hasattr(layer, "xattn_gate"):
            layer.xattn_gate.fill_(XATTN_GATE)
    gpu = lm.LM(cfg, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (2, prompt + steps), generator=gen,
                           dtype=torch.int32)
    extra = seeded_extra(cfg, 2, gen)
    models = [(cpu, "cpu"), (gpu, "cuda")]
    if extra:
        ctrl = lm.LM(cfg, "cuda")
        ctrl.load_state_dict(gpu.state_dict())
        for layer in ctrl.layers:
            if hasattr(layer, "xattn_gate"):
                layer.xattn_gate.fill_(0.0)
        models.append((ctrl, "cuda"))
    caches = [lm.init_cache(p, cfg, 2, prompt + steps + 8, device=d,
                            extra=extra and {k: v.to(d)
                                             for k, v in extra.items()})
              for p, d in models]
    (cpu_rec, h_cpu), (gpu_rec, h_gpu) = (_route_hooks(p, cfg)
                                          for p in (cpu, gpu))
    rerouted = torch.zeros(2, dtype=torch.bool)
    worst, n_routed, excused, moved = 0.0, 0, 0, math.inf
    atol = ref_atol(cfg)
    feeds = [tokens[:, :prompt]] + [tokens[:, i:i + 1]
                                    for i in range(prompt, prompt + steps)]
    for t in feeds:
        cpu_rec.clear()
        gpu_rec.clear()
        want, _ = lm.step(cpu, cfg, caches[0], t)
        got, _ = lm.step(gpu, cfg, caches[1], t.cuda())
        n_routed += _rerouted(cpu_rec, gpu_rec, cfg.top_k, rerouted)
        diff = (got.cpu().float() - want.float()).abs()
        err = diff.amax(-1)
        over = err > atol
        if bool((over & ~rerouted).any()):
            raise AssertionError(f"{cfg.name}: card vs CPU logits differ "
                                 f"by {err.tolist()} > {atol}")
        excused += int(over.sum())
        worst = max(worst, float(err[~over].max()) if bool((~over).any())
                    else 0.0)
        if extra:
            ctl, _ = lm.step(ctrl, cfg, caches[2], t.cuda())
            moved = min(moved, float((ctl.cpu().float() - want.float())
                                     [:, :cfg.vocab].abs().amax(-1).min()))
    if extra and moved <= atol:
        raise AssertionError(f"{cfg.name}: with the gates at 0 a row's "
                             f"logits are within {moved:.3e} <= {atol} of "
                             f"the CPU's, so the check cannot see the "
                             f"cross-attention")
    for h in h_cpu + h_gpu:
        h.remove()
    routed = (f"; tokens routed otherwise {n_routed}, row-steps over atol "
              f"after a near-tie {excused}") if cfg.n_experts else ""
    tol = "atol=2e-2" if atol == REF_ATOL else \
        f"atol={atol:g}: 2e-2 at the untied head's scale"
    memory = (f"; memory {tuple(caches[1]['memory'].shape)}, gates "
              f"{XATTN_GATE}; gates at 0 on the card: every row off by "
              f">= {moved:.3e}") if extra else ""
    window = (f"; window {cfg.sliding_window}, prompt {prompt}"
              if cfg.sliding_window else "")
    _phase(f"check {cfg.name} card vs cpu (teacher-forced, {len(feeds)} "
           f"steps{window}{memory}): max_abs_err={worst:.3e} ({tol})"
           f"{routed} ok")


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm())


def _replayed_decode(params, cfg, prompts, tok, record, extra=None,
                     shift=0):
    """The first decode step's logits after a prefill of ``prompts``, with
    every MoE layer taking the experts that ``record`` (the prefill of
    prompt + ``tok``: one (probs, top_i) a layer) chose for the same token,
    weighted by its own probabilities renormalised over them.  Also returns
    at how many (layer, row) pairs the decode step's own top-k differed.
    ``shift`` > 0 decodes that many positions early: a cache fault, for
    the check's negative control."""
    b, s = prompts.shape
    rows = [ti.view(b, s + 1, -1) for _, ti in record]
    plan = ([ti[:, :s].reshape(b * s, -1) for ti in rows]
            + [ti[:, s] for ti in rows])
    own, differ = moe.route, []

    def route(router, cfg_, xf):
        probs, _, top_i = own(router, cfg_, xf)
        ti = plan.pop(0).to(top_i.device)
        if ti.shape != top_i.shape:
            raise AssertionError(f"replayed routing {tuple(ti.shape)} for "
                                 f"{tuple(top_i.shape)} tokens")
        if ti.shape[0] == b:
            differ.append((top_i.sort(-1).values
                           != ti.sort(-1).values).any(-1))
        top_p = probs.gather(-1, ti)
        return probs, top_p / torch.clamp_min(
            top_p.sum(-1, keepdim=True), 1e-9), ti

    moe.route = route
    try:
        cache = lm.init_cache(params, cfg, b, s + 1, device=prompts.device,
                              extra=extra)
        _, cache = lm.step(params, cfg, cache, prompts)
        cache = dict(cache, pos=cache["pos"] - shift)
        logits, _ = lm.step(params, cfg, cache, tok)
    finally:
        moe.route = own
    if plan:
        raise AssertionError(f"{len(plan)} replayed routings left unused")
    return logits, int(torch.stack(differ).sum())


def check_cache(dtype, params, cfg, prompts, res, extra=None):
    """A prefill over prompt + first generated token must give the logits
    of the first decode step.  In f32 the two paths differ only by the
    order of sums, so the check is elementwise and tight (rtol = atol =
    1e-3); a wrong cache slot, position or kv_len moves logits by O(0.1).
    In bf16 granite-8b's 36 layers of rounding at other GEMM shapes leave
    ~0.1 max abs on logits of max ~6 for the plain versions too, so the
    5e-2 of tests/test_models_smoke.py bounds the relative L2 error
    instead.

    For an MoE model in f32 both runs record their routing, and the line
    says at how many (layer, row) pairs the first decode step and the
    prefill's last position chose other experts, and the smallest router
    margin (k-th minus (k+1)-th probability) among them.  In bf16 a
    rounding can tip a near-tie to other experts, whose outputs dwarf the
    rest of the residual stream and move the routing of every later layer
    (granite-moe on an H100: most of its (layer, row) pairs and all four
    rows).  So there the prefill and the decode step that the prefill of
    prompt + 1 is compared with take that prefill's experts
    (``_replayed_decode``), the check compares every row, and its bound is
    ``CACHE_BF16_REL_L2_MOE``; the same decode step one position early
    must exceed it."""
    routed = ""
    tok = res.tokens[:, :1]
    replay = bool(cfg.n_experts) and dtype == "bf16"
    if cfg.n_experts:
        record, handles = _route_hooks(params, cfg)
    if cfg.n_experts and not replay:
        res = serve.generate(params, cfg, prompts, 1, extra=extra)
        tok = res.tokens[:, :1]
        decode = record[-cfg.n_layers:]
        record.clear()
    again = serve.generate(params, cfg, torch.cat([prompts, tok], 1), 0,
                           extra=extra)
    if cfg.n_experts:
        for h in handles:
            h.remove()
    # over the real vocab: the pad rows' -1e30 would make the norm inf and
    # the relative error 0 whatever the logits (granite-moe and whisper
    # pad theirs)
    got = again.logits[0, :, :cfg.vocab].float()
    bound = CACHE_BF16_REL_L2
    if replay:
        want, n = _replayed_decode(params, cfg, prompts, tok, record, extra)
        want = want[:, :cfg.vocab].float()
        off = _replayed_decode(params, cfg, prompts, tok, record, extra,
                               shift=1)[0][:, :cfg.vocab].float()
        bound, off_rel = CACHE_BF16_REL_L2_MOE, _rel_l2(got, off)
        if off_rel <= bound:
            raise AssertionError(f"cache {cfg.name}: decoding one position "
                                 f"early gives {off_rel:.3e} <= {bound}, so "
                                 f"the check cannot see a cache fault")
        routed = (f", each MoE layer routed as the prefill of prompt+1 (the "
                  f"decode step's own top-k differed at {n} of "
                  f"{len(record) * prompts.shape[0]} (layer, row) pairs; one "
                  f"position early: rel_l2_err={off_rel:.3e})")
    else:
        want = res.logits[1, :, :cfg.vocab].float()
    if cfg.n_experts and not replay:
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
                  + (f", smallest margin {min(margins):.2e}"
                     if margins else ""))
    name = (f"cache {cfg.name} ({dtype}): prefill of prompt+1 vs first "
            f"decode step{routed}")
    if dtype == "f32":
        _assert_close(name, got, want, CACHE_F32_TOL)
        return
    rel = _rel_l2(got, want)
    ok = rel <= bound and bool(torch.isfinite(got).all())
    _phase(f"check {name}: rel_l2_err={rel:.3e} (<= {bound}), "
           f"max_abs_err={_max_err(got, want):.3e} "
           f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: relative L2 error {rel:.3e}")


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
          "flash_attention_bwd": "flash_attention.cu",
          "burst_gather_bwd": "burst_gather.cu",
          "burst_gather_bwd[dispatch]": "burst_gather.cu",
          "decode_attention": "flash_attention.cu",
          "burst_gather": "burst_gather.cu",
          "mamba2_scan": "mamba2_scan.cu", "rwkv6_scan": "rwkv6_scan.cu",
          "mamba2_scan_bwd": "mamba2_scan.cu",
          "rwkv6_scan_bwd": "rwkv6_scan.cu",
          "moe_gmm": "moe_gmm.cu", "moe_gmm_bwd": "moe_gmm.cu",
          "sim_sweep": "sim_sweep.cu"}


#: (model, kernel, (Sq, Skv, Hq, Hkv, D), kwargs) of each served model's
#: attention at B = 4: prefill of 512 causal (or over the whole memory),
#: decode against the serve cache of 544 (or the whole memory).  SDPA
#: computes the same function where there is no softcap: gemma3's 1024
#: window and gemma2's 4096 do not bite at 512 + 32 tokens, so the causal
#: SDPA is their local layers' function too.
ATTN_SHAPES = tuple(
    (model, kind, shape, kw)
    for model, hq, hkv, d, extra in (
        ("granite-8b", 32, 8, 128, {}), ("zamba2-7b", 32, 32, 112, {}),
        ("granite-moe-3b-a800m", 24, 8, 64, {}),
        ("gemma2-27b", 32, 16, 128, G2), ("gemma3-12b", 16, 8, 256, {}),
        ("chatglm3-6b", 32, 2, 128, {}),
        ("llama-3.2-vision-11b", 32, 8, 128, {}),
        ("whisper-tiny", 6, 6, 64, {}))
    for kind, shape, kw in (
        ("flash_attention", (PROMPT, PROMPT, hq, hkv, d),
         dict(causal=True, **extra)),
        ("decode_attention", (1, PROMPT + GEN, hq, hkv, d),
         dict(kv_len=PROMPT + GEN, **extra)))) + (
    ("llama-3.2-vision-11b-cross", "flash_attention",
     (PROMPT, VISION_ROWS, 32, 8, 128), dict(causal=False)),
    ("llama-3.2-vision-11b-cross", "decode_attention",
     (1, VISION_ROWS, 32, 8, 128), {}),
    ("whisper-tiny-encoder", "flash_attention",
     (AUDIO_ROWS, AUDIO_ROWS, 6, 6, 64), dict(causal=False)),
    ("whisper-tiny-cross", "flash_attention", (PROMPT, AUDIO_ROWS, 6, 6, 64),
     dict(causal=False)),
    ("whisper-tiny-cross", "decode_attention", (1, AUDIO_ROWS, 6, 6, 64),
     {}))


def attention_times(flush, gen):
    """Both attention kernels at each served model's shapes
    (``ATTN_SHAPES``), beside SDPA (none with a softcap) and the bound, on
    a line each (``time flash_attention[<model>]``).  Bytes count q, k, v
    and o once; operations are 4 D per (query, key) pair the mask lets
    through.  Returns {kernel: {model: (ms, plain, library, bound_ms,
    bound_by)}}, the plain version timed at granite-8b's shapes only."""
    n_sm = fa._sm_count(0)
    out = {"flash_attention": {}, "decode_attention": {}}
    for model, kind, (sq, skv, hq, hkv, d), kw in ATTN_SHAPES:
        q = _rand((B, sq, hq, d), gen)
        k, v = _rand((B, skv, hkv, d), gen), _rand((B, skv, hkv, d), gen)
        causal = kw.get("causal", False)
        pairs = B * hq * (sq * (sq + 1) // 2 if causal else sq * skv)
        if kind == "flash_attention":
            fn = fa.flash_attention
            nq = -(-sq // 64)
            grid = f"grid {hq} x {B} x {nq} = {hq * B * nq} blocks"
        else:
            fn = fa.decode_attention
            n_split, chunk = fa.decode_splits(B, hkv, skv, n_sm)
            grid = (f"grid {n_split} x {hkv} x {B} = "
                    f"{n_split * hkv * B} blocks (chunk {chunk}) + "
                    f"combine {hkv * B}")
        ms = time_ms(lambda: fn(q, k, v, **kw), flush)
        lib = None
        if "softcap" not in kw:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = time_ms(_sdpa(qt, kt, vt, is_causal=causal), flush)
            del qt, kt, vt
        plain = time_ms(lambda: ref.attention_ref(
            q, k, v, **{"causal": False, **kw}), flush) \
            if model == "granite-8b" else None
        b_ms, b_by = bound(4 * pairs * d, 2 * (2 * q.numel() + 2 * k.numel()))
        _phase(f"time {kind}[{model}] (B, Sq, Skv, Hq, Hkv, D) = "
               f"{(B, sq, skv, hq, hkv, d)}"
               f"{', softcap 50, scale 1/12' if 'softcap' in kw else ''}: "
               f"{ms:.4f} ms, SDPA "
               f"{'none (softcap)' if lib is None else f'{lib:.4f} ms'}, "
               f"bound {b_ms:.4f} ms ({b_by}), "
               f"{4 * pairs * d / ms / 1e9:.1f} TFLOP/s, {grid}")
        out[kind][model] = (ms, plain, lib, b_ms, b_by)
        del q, k, v
    return out


def granite_rows(table, prompts, errs, flush, gen):
    """The attention and gather rows, at granite-8b's serve shapes; each
    attention row's ``by_model`` holds every served model's times."""
    times = attention_times(flush, gen)
    rows = [(kind, f"src/repro/kernels/flash_attention.py:{line}", err,
             *times[kind]["granite-8b"])
            for kind, line, err in (("flash_attention", 90, errs[0]),
                                    ("decode_attention", 149, errs[1]))]

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
    for row in out[:2]:
        row["by_model"] = {
            model: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by"), t))
            for model, t in times[row["name"]].items()}
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


#: the co-optimization flow's utilization sweep and throughput firings
#: (``benchmarks/fmax_suite.py``'s ``UTIL_SWEEP`` and ``DEFAULT_FIRINGS``)
COOPT_UTILS = (0.70, 0.75, 0.80, 0.85, 0.90, 0.95, 1.0)
COOPT_FIRINGS = 200
#: the reference's plans of the 48 rows (``tests/test_torch_floorplan.py``)
COOPT_GOLDEN = ROOT / "tests" / "torch_coopt_golden.json"
#: designs left out of the NumPy oracle's check, for the script's time
COOPT_ORACLE_SKIP = ("cnn_13x10", "cnn_13x12", "cnn_13x14", "cnn_13x16",
                     "gaussian_24")


def _digest(obj):
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:16]


def _timing(rep):
    return [rep.fmax_mhz, rep.routed, rep.fail_reason]


def coopt_row(name, board, graph):
    """One (design, board) row of the paper's flow on the host: the
    baseline (``packed_placement`` then ``analyze_timing``) and TAPA's
    (``autobridge`` at the first feasible util, then ``analyze_timing``).
    Returns the row's record, as the golden file keeps it, its plan (None
    if no util is feasible), the row's host seconds and, of those, the
    seconds spent on utils found infeasible."""
    t0 = time.perf_counter()
    grid = grid_for(board)
    base = analyze_timing(graph, grid, packed_placement(graph, grid))
    rec = {"name": name, "board": board, "util": None, "base": _timing(base)}
    infeasible_s = 0.0
    for u in COOPT_UTILS:
        t1 = time.perf_counter()
        try:
            plan = autobridge(graph, grid, max_util=u)
        except InfeasibleError:
            infeasible_s += time.perf_counter() - t1
            continue
        opt = analyze_timing(graph, grid, plan.floorplan.placement,
                             plan.depth)
        rec.update(
            util=u,
            placement=_digest(sorted(plan.floorplan.placement.items())),
            depth=_digest(sorted(plan.depth.items())),
            cost=plan.floorplan.cost,
            exact=[st["exact"] for st in plan.floorplan.iteration_stats],
            feedback_rounds=plan.feedback_rounds,
            co_located=sorted(sorted(g) for g in plan.co_located),
            demoted_streams=plan.demoted_streams,
            tapa=_timing(opt))
        return rec, plan, time.perf_counter() - t0, infeasible_s
    return rec, None, time.perf_counter() - t0, infeasible_s


def _check_sdc(name, graph, plan):
    """Every data stream's balance is S[src] - S[dst] - lat >= 0 over the
    balancer's potentials; every control stream's is 0."""
    S, lat = plan.balancing.potentials, plan.pipelining.lat
    bal = plan.balancing.balance
    for s in graph.streams:
        want = 0 if s.control else S[s.src] - S[s.dst] - lat[s.name]
        if bal[s.name] != want or want < 0 or \
                plan.depth[s.name] != lat[s.name] + bal[s.name]:
            raise AssertionError(f"coopt {name}: stream {s.name} balance "
                                 f"{bal[s.name]}, want {want} >= 0")


def coopt_phase(flush):
    """The paper's co-optimization flow through the port, on all 48 rows of
    ``autobridge_suite()`` + ``hbm_suite()``: each row's baseline and TAPA
    plans on the host, held to the reference's (the golden file) and to the
    SDC; then the throughput check, one ``simulate_batch`` on the card over
    every feasible row's ``SimJob(graph)`` and ``plan.sim_job()``, its
    launches counted, equal to the plain version on the card, a subset to
    the NumPy oracle (``steps`` included), with no deadlock and no more
    than the fill/drain cycles of each plan.  Returns the sweep's launches
    on this path and its phase line's numbers."""
    golden = {(r["name"], r["board"]): r
              for r in json.loads(COOPT_GOLDEN.read_text())}
    rows = benchmarks.autobridge_suite() + benchmarks.hbm_suite()
    reset_floorplan_counts()
    recs, plans, secs, infeasible_s = [], [], [], 0.0
    for name, board, graph in rows:
        rec, plan, sec, lost = coopt_row(name, board, graph)
        infeasible_s += lost
        if rec != golden.get((name, board)):
            raise AssertionError(f"coopt {name}/{board}: the plan differs "
                                 f"from the reference's: {rec} vs "
                                 f"{golden.get((name, board))}")
        if plan is not None:
            _check_sdc(f"{name}/{board}", graph, plan)
        recs.append(rec)
        plans.append(plan)
        secs.append(sec)
    counts, ilp = floorplan_counts(), solve_counts()
    flow_s = sum(secs)
    feasible = [i for i, p in enumerate(plans) if p is not None]
    _phase(f"check coopt: {len(rows)} rows, {len(feasible)} feasible, "
           f"each plan (placement, depths, cost, exact flags, feedback "
           f"rounds, co-location, demotions, util) and both timing reports "
           f"equal to the reference's; SDC balances S[src] - S[dst] - lat "
           f">= 0, control streams 0 ok; host {flow_s:.2f} s")

    # the throughput check: one call over every feasible row's baseline and
    # optimized job, on the card
    jobs = []
    for i in feasible:
        jobs += [SimJob(rows[i][2]), plans[i].sim_job()]
    max_cycles = COOPT_FIRINGS * 64 + 10_000
    ss.sim_sweep.launches = 0
    reset_engine_counts()
    trace.enable(clear=True)
    t0 = time.perf_counter()
    res = simulate_batch(jobs, firings=COOPT_FIRINGS)
    wall = time.perf_counter() - t0
    trace.disable()
    launches, engines = ss.sim_sweep.launches, engine_counts()
    spans = {e["name"]: e["dur_ns"] / 1e9 for e in trace.drain()}
    if launches < 1 or launches != engines["torch"] or engines["fallback"] \
            or engines["numpy"] or engines["event"] or \
            any(r.engine != "torch-padded" for r in res):
        raise AssertionError(f"coopt simulate_batch: {launches} launches, "
                             f"engine counts {engines}")
    pb = build_padded_batch(jobs)
    args = ss.padded_tensors(pb, "cuda")
    plain = pb.unpack(*(x.cpu().numpy() if torch.is_tensor(x) else x
                        for x in ref.sim_sweep_ref(
                            *args, pb.H, COOPT_FIRINGS, max_cycles)),
                      "torch-padded")
    if [_sim_key(r) for r in res] != [_sim_key(r) for r in plain]:
        raise AssertionError("coopt simulate_batch: the kernel's results "
                             "differ from the plain version's on the card")
    for k, i in enumerate(feasible):
        base, opt = res[2 * k], res[2 * k + 1]
        slack = sum(plans[i].depth.values()) + rows[i][2].num_tasks
        if opt.deadlocked or opt.cycles - base.cycles > slack:
            raise AssertionError(f"coopt {rows[i][0]}/{rows[i][1]}: "
                                 f"optimized {opt}, baseline {base}, "
                                 f"slack {slack}")
    sub = [j for k, i in enumerate(feasible)
           if rows[i][0] not in COOPT_ORACLE_SKIP
           for j in jobs[2 * k:2 * k + 2]]
    t0 = time.perf_counter()
    oracle = _simulate_batch_numpy(sub, firings=COOPT_FIRINGS,
                                   max_cycles=max_cycles)
    oracle_s = time.perf_counter() - t0
    if [_sim_key(r) for r in simulate_batch(sub, firings=COOPT_FIRINGS)] \
            != [_sim_key(r) for r in oracle]:
        raise AssertionError(f"coopt simulate_batch: the {len(sub)} jobs of "
                             f"the subset differ from _simulate_batch_numpy")
    # the default device of the entry point a user calls on one plan
    one = feasible[0]
    vt = plans[one].verify_throughput()
    if [_sim_key(r)[:3] for r in vt] != \
            [_sim_key(r)[:3] for r in res[:2]]:
        raise AssertionError(f"coopt verify_throughput: {vt} vs {res[:2]}")
    cycles = np.array([r.cycles for r in res])
    plan = _sweep_plan(args)
    _phase(f"check coopt simulate_batch {len(jobs)} jobs (baseline and "
           f"optimized of {len(feasible)} rows), T*={pb.T} S*={pb.S} "
           f"H={pb.H} firings={COOPT_FIRINGS}: equal to the plain version "
           f"on the card; {len(sub)} jobs equal to the NumPy oracle, steps "
           f"included ({oracle_s:.2f} s); cycles {cycles.min()}-"
           f"{cycles.max()}, no optimized job deadlocked, each within its "
           f"plan's fill/drain slack; {launches} launch(es) for "
           f"{engines['torch']} chunk(s); {_plan_text(plan)} ok")

    scratch = torch.empty(max(plan.scratch, 1), dtype=torch.int32,
                          device="cuda")
    k_ms = [time_ms(lambda: _launch(args, plan, scratch, COOPT_FIRINGS,
                                    max_cycles), flush, reps=10)
            for _ in range(3)]
    plain_ms = time_ms(lambda: ref.sim_sweep_ref(
        *args, pb.H, COOPT_FIRINGS, max_cycles), flush, reps=1)
    ms = statistics.median(k_ms)
    b_ms, b_by, ops, nbytes = _sim_bound(pb, cycles)
    _phase(f"time sim_sweep[coopt] V={pb.V}: {ms:.4f} ms (rounds "
           f"{', '.join(f'{t:.4f}' for t in k_ms)}), plain on the card "
           f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; "
           f"{ops / 1e9:.3f} G int32 ops, {nbytes / 1e6:.2f} MB)")

    base_mhz = [r["base"][0] if r["base"][1] else 0.0 for r in recs]
    tapa_mhz = [r["tapa"][0] if r["util"] is not None and r["tapa"][1]
                else 0.0 for r in recs]
    failed = [i for i, r in enumerate(recs) if not r["base"][1]]
    slowest = sorted(range(len(rows)), key=lambda i: -secs[i])[:5]
    line = {
        "rows": len(rows), "feasible": len(feasible),
        "infeasible_at_every_util": [f"{n}/{b}" for (n, b, _), p
                                     in zip(rows, plans) if p is None],
        "base_mhz_mean": statistics.mean(base_mhz),
        "tapa_mhz_mean": statistics.mean(tapa_mhz),
        "base_failures": len(failed),
        "recovered_by_tapa": sum(tapa_mhz[i] > 0 for i in failed),
        "flow_s": flow_s, "infeasible_utils_s": infeasible_s,
        "slowest_s": {f"{rows[i][0]}/{rows[i][1]}": secs[i] for i in slowest},
        "floorplan": counts, "ilp": ilp, "jobs": len(jobs),
        "firings": COOPT_FIRINGS, "launches": launches,
        "simulate_batch_wall_s": wall,
        "simulate_batch_span_s": spans["simulate.batch"],
        "sim_sweep_span_s": spans["sim_sweep"], "sim_sweep_ms": ms,
        "sim_sweep_plain_ms": plain_ms, "sim_sweep_bound_ms": b_ms}
    _phase(f"coopt {json.dumps(line)}")
    return launches


#: the paper's §6.3 search as ``benchmarks/fmax_suite.py --subset fast``
#: runs it: its fast subset (10 (design, board) rows of
#: ``autobridge_suite()``), ``UTIL_SWEEP`` (``COOPT_UTILS``), 200 firings,
#: and ``--converge``'s 3 rounds of 12 points over ``Interval(0.70, 1.0)``
SEARCH_FAST = ("stencil_x2", "stencil_x4", "cnn_13x2", "gaussian_12",
               "bucket_sort", "page_rank")
SEARCH_FIRINGS = 200
CONVERGE_ROUNDS = 3
CONVERGE_POINTS = 12
#: pool workers of the converged path, forked after the card is in use
SEARCH_JOBS = 2
#: the reference's results of both paths and of the corpus batch
#: (``tests/test_torch_search.py``)
SEARCH_GOLDEN = ROOT / "tests" / "torch_search_golden.json"
#: the corpus batch: (family, designs, first seed)
CORPUS_BATCH = (("dag", 4, 500), ("cyclic", 4, 500), ("sdf", 4, 500),
                ("wide", 4, 500), ("hbm", 4, 500), ("fuzz", 6, 600))
CORPUS_COUNTERS = ("designs", "families", "verdicts_checked",
                   "sims_checked", "feasible", "infeasible",
                   "searches_checked", "surrogate_checked", "mismatches",
                   "torch_checked")


def _cand_row(c):
    return [list(dataclasses.astuple(c.point)), c.fmax, c.plan.area_overhead,
            c.sim.cycles if c.sim is not None else None,
            c.sim.deadlocked if c.sim is not None else None]


def _best_row(res):
    try:
        c = res.best
    except InfeasibleError:
        return None
    return [list(dataclasses.astuple(c.point)), c.fmax]


def _exact(c):
    return [st["exact"] for st in c.plan.floorplan.iteration_stats]


def _spans():
    """Seconds by span name over the trace just taken, nested spans each
    counted under their own name."""
    out = {}
    for e in trace.drain():
        out[e["name"]] = out.get(e["name"], 0.0) + e["dur_ns"] / 1e9
    return out


def _check_launches(where, launches, engines, want=None):
    if launches < 1 or launches != engines["torch"] or \
            engines["fallback"] or engines["numpy"] or \
            (want is not None and launches != want):
        raise AssertionError(f"{where}: {launches} launches, engine counts "
                             f"{engines}, want {want}")


def search_default(golden, flush):
    """The default path: one ``prepare_design_space`` a row over the util
    sweep (host), then ONE ``timed_pool_simulations`` on the card over
    every row's baseline and candidates, in one launch; its results against
    the plain version on the card and the NumPy oracle (``steps``
    included), each row's frontier and best candidate against the golden
    file.  Returns the launches, the rows and the numbers of the line."""
    rows = [r for r in benchmarks.autobridge_suite() if r[0] in SEARCH_FAST]
    space = SearchSpace(seeds=(0,), utils=COOPT_UTILS)
    reset_floorplan_counts()
    t0 = time.perf_counter()
    preps = [prepare_design_space(g, grid_for(b), space=space)
             for _, b, g in rows]
    prep_s = time.perf_counter() - t0
    ss.sim_sweep.launches = 0
    trace.enable(clear=True)
    t0 = time.perf_counter()
    res, meta = timed_pool_simulations(preps, firings=SEARCH_FIRINGS)
    score_s = time.perf_counter() - t0
    trace.disable()
    launches, spans = ss.sim_sweep.launches, _spans()
    _check_launches("search simulate_batch", launches, meta["counts"], 1)
    if meta["jobs"] != golden["default_jobs"] or \
            any(r.engine != "torch-padded" for r in res):
        raise AssertionError(f"search: {meta['jobs']} jobs on "
                             f"{meta['backends']}")
    # the call's jobs, in the order the search gathered them
    jobs = []
    for p in preps:
        jobs.append(SimJob(p.graph))
        jobs += [c.plan.sim_job() for c in p.feasible
                 if c.sim.engine != "static"]
    max_cycles = SEARCH_FIRINGS * 64 + 10_000
    pb = build_padded_batch(jobs)
    args = ss.padded_tensors(pb, "cuda")
    plain = pb.unpack(*(x.cpu().numpy() if torch.is_tensor(x) else x
                        for x in ref.sim_sweep_ref(
                            *args, pb.H, SEARCH_FIRINGS, max_cycles)),
                      "torch-padded")
    t0 = time.perf_counter()
    oracle = _simulate_batch_numpy(jobs, firings=SEARCH_FIRINGS,
                                   max_cycles=max_cycles)
    oracle_s = time.perf_counter() - t0
    got = [_sim_key(r) for r in res]
    if got != [_sim_key(r) for r in plain] or \
            got != [_sim_key(r) for r in oracle]:
        raise AssertionError("search simulate_batch: the kernel's results "
                             "differ from the plain version's on the card "
                             "or from _simulate_batch_numpy")
    recs = []
    for (name, board, g), prep in zip(rows, preps):
        grid = grid_for(board)
        base = analyze_timing(g, grid, packed_placement(g, grid))
        r = prep.finish(sim_calls=1)
        recs.append({
            "name": name, "board": board,
            "base_mhz": base.fmax_mhz if base.routed else 0.0,
            "space_size": r.space_size, "feasible": len(prep.feasible),
            "base_cycles": prep.base_sim.cycles,
            "frontier": [_cand_row(c) for c in r.frontier],
            "exact": [_exact(c) for c in r.frontier],
            "best": _best_row(r)})
    for rec, want in zip(recs, golden["default"]):
        if rec != want:
            raise AssertionError(f"search {rec['name']}/{rec['board']}: the "
                                 f"frontier differs from the reference's: "
                                 f"{rec} vs {want}")
    plan = _sweep_plan(args)
    _phase(f"check search default path: {len(rows)} rows, {len(jobs)} jobs "
           f"(T*={pb.T} S*={pb.S} H={pb.H}) in {launches} launch; equal to "
           f"the plain version on the card and to the NumPy oracle, steps "
           f"included ({oracle_s:.2f} s); every row's frontier and best "
           f"candidate equal to the reference's; {_plan_text(plan)} ok")

    scratch = torch.empty(max(plan.scratch, 1), dtype=torch.int32,
                          device="cuda")
    k_ms = [time_ms(lambda: _launch(args, plan, scratch, SEARCH_FIRINGS,
                                    max_cycles), flush, reps=10)
            for _ in range(3)]
    plain_ms = time_ms(lambda: ref.sim_sweep_ref(
        *args, pb.H, SEARCH_FIRINGS, max_cycles), flush, reps=1)
    ms = statistics.median(k_ms)
    cycles = np.array([r.cycles for r in res])
    b_ms, b_by, ops, nbytes = _sim_bound(pb, cycles)
    speed = measure_backend_speedup(jobs, firings=SEARCH_FIRINGS)
    _phase(f"time sim_sweep[search] V={pb.V}: {ms:.4f} ms (rounds "
           f"{', '.join(f'{t:.4f}' for t in k_ms)}), plain on the card "
           f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; "
           f"{ops / 1e9:.3f} G int32 ops, {nbytes / 1e6:.2f} MB); "
           f"measure_backend_speedup {json.dumps(speed)}")
    best = [r["best"][1] if r["best"] else 0.0 for r in recs]
    line = {"rows": len(rows), "jobs": len(jobs), "launches": launches,
            "base_mhz_mean": statistics.mean(r["base_mhz"] for r in recs),
            "best_mhz_mean": statistics.mean(best),
            "prepare_s": prep_s, "score_s": score_s,
            "simulate_batch_wall_s": meta["wall_s"],
            "simulate_batch_span_s": spans["simulate.batch"],
            "sim_sweep_span_s": spans["sim_sweep"], "sim_sweep_ms": ms,
            "sim_sweep_ms_rounds": k_ms, "sim_sweep_plain_ms": plain_ms,
            "sim_sweep_bound_ms": b_ms, "speedup": speed,
            "floorplan": floorplan_counts()}
    return launches, line


def search_converged(golden):
    """The converged path: ``search_until_converged`` on each row as
    ``fmax_suite.py --converge --jobs 2`` runs it, the pool forked after
    the card is in use, one ``FloorplanCache`` for the suite; rounds,
    points, hypervolumes and frontier against the golden file (the ILP's
    ``exact`` flags first), no pool rebuild, retry or quarantine, each
    round's scoring on the card.  Returns the launches and the line."""
    gold = {(r["name"], r["board"]): r for r in golden["converged"]}
    rows = [r for r in benchmarks.autobridge_suite() if r[0] in SEARCH_FAST]
    anchors = [SearchPoint(seed=0, max_util=u) for u in COOPT_UTILS]
    space = SearchSpace(utils=Interval(COOPT_UTILS[0], COOPT_UTILS[-1]))
    cache = FloorplanCache()
    reset_floorplan_counts()
    reset_pool_counts()
    reset_engine_counts()
    ss.sim_sweep.launches = 0
    trace.enable(clear=True)
    t0 = time.perf_counter()
    per_row, sim_calls, points, pool = {}, 0, 0, None
    for name, board, g in rows:
        t1 = time.perf_counter()
        res = search_until_converged(
            g, grid_for(board), space=space, rounds=CONVERGE_ROUNDS,
            points_per_round=CONVERGE_POINTS, sim_firings=SEARCH_FIRINGS,
            initial_points=anchors, cache=cache, jobs=SEARCH_JOBS)
        per_row[f"{name}/{board}"] = time.perf_counter() - t1
        every = [c for r in res.rounds for c in r.candidates
                 if c.plan is not None]
        rec = {"name": name, "board": board, "rounds_run": res.rounds_run,
               "converged": res.converged,
               "points_evaluated": res.points_evaluated,
               "hypervolumes": res.hypervolumes,
               "frontier": [_cand_row(c) for c in res.frontier],
               "exact": [_exact(c) for c in res.frontier],
               "inexact": sum(not e for c in every for e in _exact(c)),
               "best": _best_row(res)}
        want = gold[(name, board)]
        if (rec["exact"], rec["inexact"]) != (want["exact"],
                                              want["inexact"]):
            raise AssertionError(f"search converged {name}/{board}: the "
                                 f"ILP's exact flags differ from the "
                                 f"reference's (its time limit was hit on "
                                 f"one side): {rec['exact']}, "
                                 f"{rec['inexact']} inexact vs "
                                 f"{want['exact']}, {want['inexact']}")
        if rec != want:
            raise AssertionError(f"search converged {name}/{board}: differs "
                                 f"from the reference's: {rec} vs {want}")
        p = res.pool
        if p is None or p.merged != p.dispatched or p.retried or \
                p.timed_out or p.quarantined or p.pool_rebuilds:
            raise AssertionError(f"search converged {name}/{board}: pool "
                                 f"{p}")
        if pool is None:
            pool = p
        else:
            pool.absorb(p)
        sim_calls += res.sim_calls
        points += res.points_evaluated
    wall = time.perf_counter() - t0
    trace.disable()
    launches, engines = ss.sim_sweep.launches, engine_counts()
    spans = _spans()
    _check_launches("search converged", launches, engines)
    if engines["torch"] + engines["event"] != sim_calls:
        raise AssertionError(f"search converged: {sim_calls} simulate_batch "
                             f"calls, engine counts {engines}")
    counts = floorplan_counts()
    _phase(f"check search converged path: {len(rows)} rows, {points} points "
           f"in {sim_calls} simulate_batch calls, jobs={SEARCH_JOBS} forked "
           f"after the card was in use; rounds, points, hypervolumes, "
           f"frontiers and exact flags equal to the reference's; pool "
           f"{pool.dispatched} dispatched, {pool.merged} merged, no retry, "
           f"timeout, quarantine or rebuild; {launches} launches ok")
    slowest = sorted(per_row, key=lambda k: -per_row[k])[:3]
    line = {"rows": len(rows), "points": points, "sim_calls": sim_calls,
            "launches": launches, "engines": engines, "wall_s": wall,
            "slowest_s": {k: per_row[k] for k in slowest},
            "spans_s": {k: spans.get(k, 0.0) for k in (
                "search.round", "search.prepare", "pool.warm",
                "pool.worker_solve", "floorplan.ilp", "simulate.batch",
                "sim_sweep")},
            "floorplan": counts, "pool": pool.as_dict(),
            "pool_counts": pool_counts(), "cache": cache.stats()}
    return launches, line


def search_phase(flush):
    """The paper's §6.3 search through the port, both paths, and its
    ``search`` line.  Returns the sweep's launches on this path."""
    golden = json.loads(SEARCH_GOLDEN.read_text())
    d_launches, default = search_default(golden, flush)
    c_launches, converged = search_converged(golden)
    _phase(f"search {json.dumps({'default': default, 'converged': converged})}")
    return d_launches + c_launches


def corpus_phase():
    """``run_differential`` on the card over the corpus batch: ``ok``, the
    torch row on every design (one launch), the counters equal to the
    reference's.  Returns the sweep's launches on this path."""
    want = json.loads(SEARCH_GOLDEN.read_text())["corpus"]
    designs = [d for fam, n, seed in CORPUS_BATCH
               for d in sample_corpus(fam, n, seed=seed)]
    reset_engine_counts()
    ss.sim_sweep.launches = 0
    t0 = time.perf_counter()
    rep = run_differential(designs, device="cuda")
    wall = time.perf_counter() - t0
    launches, engines = ss.sim_sweep.launches, engine_counts()
    got = {k: getattr(rep, k) for k in CORPUS_COUNTERS}
    if not rep.ok or rep.torch_checked != len(designs) or got != want:
        raise AssertionError(f"corpus: {got} vs the reference's {want}")
    if launches < 1 or launches != engines["torch"] or engines["fallback"]:
        raise AssertionError(f"corpus: {launches} launches, engine counts "
                             f"{engines}")
    _phase(f"check corpus: {len(designs)} designs, run_differential ok, "
           f"torch_checked {rep.torch_checked} (the kernel against the "
           f"NumPy oracle, steps included), counters equal to the "
           f"reference's; {launches} launch(es) ok")
    line = dict(got, ok=rep.ok, launches=launches, engines=engines,
                wall_s=wall)
    _phase(f"corpus {json.dumps(line)}")
    return launches


def _params_b(params):
    return sum(p.numel() for p in params.parameters()) / 1e9


def serve_phase(arch, gen):
    """Serve ``arch`` at full width and depth; check the launch counts,
    the logits and the bf16 cache.  Returns (params, prompts, launches,
    extra), the params still in bf16.

    A vlm or audio model gets serve's stub frontend inputs.  The launch
    window opens before ``generate``, so it holds ``init_cache``: whisper's
    encoder runs there, one prefill kernel a layer.  An X layer launches a
    second attention kernel at every step, for its cross-attention."""
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    _phase(f"init {arch}: {_params_b(params):.2f} B params, "
           f"{time.perf_counter() - t0:.1f}s")
    if arch == "granite-8b":
        check_gather(params.embed, gen)

    prompts = serve.make_prompts(cfg, B, PROMPT, "cuda")
    extra = serve.frontend_inputs(cfg, B, "cuda")
    for fn in COUNTERS.values():
        fn.launches = 0
    res = serve.generate(params, cfg, prompts, GEN, extra=extra)
    launches = {n: fn.launches for n, fn in COUNTERS.items()}
    kinds = [cfg.layer_pattern[i % len(cfg.layer_pattern)]
             for i in range(cfg.n_layers)]
    n_attn = sum(k in "GLHX" for k in kinds) + kinds.count("X")
    n_enc = cfg.n_enc_layers if extra and "frames" in extra else 0
    # every MoE layer gathers its dispatch once and runs 3 grouped matmuls
    n_moe = sum(k in "GL" for k in kinds) if cfg.n_experts else 0
    want = {"flash_attention": n_attn + n_enc,
            "decode_attention": n_attn * GEN,
            "burst_gather": (1 + n_moe) * (1 + GEN),
            "mamba2_scan": sum(k in "MH" for k in kinds) * (1 + GEN),
            "rwkv6_scan": kinds.count("R") * (1 + GEN),
            "moe_gmm": (3 if cfg.gated_mlp else 2) * n_moe * (1 + GEN),
            # one plan per MoE layer and step, shared by its products
            "moe_plan": n_moe * (1 + GEN),
            # serving takes no gradient
            "flash_attention_bwd": 0, "burst_gather_bwd": 0,
            "mamba2_scan_bwd": 0, "rwkv6_scan_bwd": 0, "moe_gmm_bwd": 0}
    memory = ""
    if extra:
        memory = (f"; memory {tuple(next(iter(extra.values())).shape)} -> "
                  f"{cfg.frontend_tokens} rows"
                  + (f" through {n_enc} encoder layers (in the launch "
                     f"window, outside the prefill's clock)" if n_enc else
                     ""))
    _phase(f"serve {arch} on {torch.cuda.get_device_name(0)}: "
           f"{_params_b(params):.2f} B params, {cfg.n_layers} layers, "
           f"d_model {cfg.d_model}{memory}: prefill {PROMPT} tokens x {B}: "
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
    check_no_sync(params, cfg, prompts, extra)
    check_cache("bf16", params, cfg, prompts, res, extra)
    return params, prompts, launches, extra


# ----------------------------------------------------------------- training

#: the model of the attention and gather checks and of the restart
TRAIN_ARCH = "granite-8b"
#: the main path's train runs, (arch, depth), each at full width.  At 12 B
#: a param (bf16 weights and grads, f32 AdamW moments): granite-8b's 36
#: layers need 8.05 B params, ~97 GB before any activation, over the
#: card's 80 GB, so 8 layers (1.95 B params, ~23 GB); zamba2-7b's 81 need
#: 7.30 B (~88 GB), so one whole layer_pattern, 27 layers (23 M, 4 H and
#: the two shared blocks: 2.79 B, ~33 GB, ~70 GB at its peak with the
#: activations); rwkv6-1.6b all 24 (1.45 B, ~17 GB); granite-moe-3b-a800m
#: all 32 (3.30 B, ~39.6 GB, with ~0.6-0.8 GB of routed activations a layer
#: at B 4 x S 1024: 32,800 rows of 1536, the f32 combine among them)
TRAIN_RUNS = (("granite-8b", 8), ("zamba2-7b", 27), ("rwkv6-1.6b", 24),
              ("granite-moe-3b-a800m", 32))
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 5
#: the backward kernels' f32 cases against autograd through the plain
#: version: the same f32 arithmetic summed in another order, over up to 1024
#: keys and, for dK and dV, the group's query heads as well
F32_BWD_TOL = dict(rtol=1e-4, atol=1e-4)
#: (case, (B, Sq, Skv, Hq, Hkv, D), kwargs, dtype) of flash_attention_bwd:
#: the training shape, the families' modes (gemma2's softcap 50 with scale
#: 1/12, with and without a window that bites; gemma3's D = 256;
#: chatglm3's g = 16; cross-attention with Sq != Skv; whisper's encoder),
#: a ragged head size, f32, and rows four times the training length (the
#: bf16-rounded P and dS of the wgmma kernels summed over 4096 rows)
BWD_CASES = (
    ("train", (TRAIN_B, TRAIN_S, TRAIN_S, 32, 8, 128), dict(causal=True),
     torch.bfloat16),
    ("gemma2-softcap", (2, 256, 256, 32, 16, 128), dict(causal=True, **G2),
     torch.bfloat16),
    ("gemma2-softcap-window-100", (2, 300, 300, 32, 16, 128),
     dict(causal=True, window=100, **G2), torch.bfloat16),
    ("gemma3-d256", (2, 256, 256, 16, 8, 256), dict(causal=True),
     torch.bfloat16),
    ("chatglm3-g16", (2, 256, 256, 32, 2, 128), dict(causal=True),
     torch.bfloat16),
    ("cross-200x333", (2, 200, 333, 32, 8, 128), dict(causal=False),
     torch.bfloat16),
    ("whisper-encoder", (2, AUDIO_ROWS, AUDIO_ROWS, 6, 6, 64),
     dict(causal=False), torch.bfloat16),
    ("ragged-d24", (1, 77, 77, 4, 2, 24), dict(causal=True),
     torch.bfloat16),
    ("f32", (2, 130, 130, 8, 2, 64), dict(causal=True), torch.float32),
    ("f32-softcap-window-40", (2, 130, 130, 8, 2, 128),
     dict(causal=True, window=40, softcap=50.0), torch.float32),
    ("f32-cross-d256", (1, 70, 90, 4, 4, 256), dict(causal=False),
     torch.float32),
    ("s4096", (1, 4096, 4096, 32, 8, 128), dict(causal=True),
     torch.bfloat16),
)


def _attn_grads(fn, q, k, v, do, **kw):
    """(dq, dk, dv) of ``fn(q, k, v, **kw)`` for the output gradient do."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        return torch.autograd.grad(fn(q, k, v, **kw), (q, k, v), do)


def check_attention_bwd(gen):
    """``flash_attention_bwd``, reached through autograd from
    ``flash_attention``, against autograd through ``ref.attention_ref`` on
    the same inputs (bf16 at 2e-2, f32 at ``F32_BWD_TOL``), and run twice
    for the same bits.  Returns the worst error at the training shape."""
    errs = {}
    for name, (b, sq, skv, hq, hkv, d), kw, dtype in BWD_CASES:
        q, do = (_rand((b, sq, hq, d), gen, dtype) for _ in range(2))
        k, v = (_rand((b, skv, hkv, d), gen, dtype) for _ in range(2))
        got = _attn_grads(fa.flash_attention, q, k, v, do, **kw)
        want = _attn_grads(ref.attention_ref, q, k, v, do, **kw)
        tol = F32_BWD_TOL if dtype == torch.float32 else BF16_TOL
        errs[name] = max(_assert_close(f"flash_attention_bwd[{name}] {g}",
                                       a, w, tol)
                         for g, a, w in zip(("dq", "dk", "dv"), got, want))
        again = _attn_grads(fa.flash_attention, q, k, v, do, **kw)
        if not all(torch.equal(a, w) for a, w in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd[{name}]: two runs "
                                 f"differ")
        _phase(f"check flash_attention_bwd[{name}]: two runs, same bits ok")
    return errs["train"]


#: the MoE dispatch of the train phase: B 4 x (S + 1) tokens, each
#: gathered top_k = 8 times, rows of granite-moe's d_model
DISPATCH_BWD = (TRAIN_B * (TRAIN_S + 1), 8, 1536)


def check_gather_bwd(gen):
    """``burst_gather_bwd``: bit for bit equal to a sequential f32
    ``index_add_`` on the CPU rounded once to the dtype, within 2e-2 (bf16)
    of autograd through ``ref.burst_gather_ref`` on f32-widened rows on the
    card, and the same bits on two runs, each on the path ``bg.bwd_path``
    names (the launch counted there).  Cases: the training batch's ids into
    granite-8b's (49152, 4096) embedding, one id taken by every row, an odd
    bf16 width (element-by-element loads), f32, rows no id takes; past the
    one-block sort's ``SORT_MAX`` ids (the multi-block path): granite-moe's
    dispatch (32,800 ids, each of 4,100 rows 8 times, in the order of a
    random routing, D 1536), a B 16 x S 1024 batch's 16,400 ids into the
    embedding, N at ``SORT_MAX`` - 1, ``SORT_MAX`` and ``SORT_MAX`` + 1, and
    one id taken by all 32,800.  Returns the errors of the embedding and
    dispatch cases."""
    R = configs.get(TRAIN_ARCH).vocab_padded
    emb = embedding_ids()
    tokens, k, d = DISPATCH_BWD
    dispatch = torch.randperm(tokens * k, generator=gen, device="cuda") // k
    cases = [
        ("embedding", R, 4096, emb, torch.bfloat16),
        ("one-id-every-row", R, 4096, torch.full_like(emb, 7),
         torch.bfloat16),
        ("odd-width-1535", 3000, 1535, torch.randint(
            0, 3000, (2051,), generator=gen, device="cuda"), torch.bfloat16),
        ("f32", 5000, 256, emb % 5000, torch.float32),
        ("few-rows-taken", 1000, 64, torch.randint(
            0, 10, (333,), generator=gen, device="cuda"), torch.bfloat16),
        ("dispatch", tokens, d, dispatch, torch.bfloat16),
        ("embedding-b16", R, 4096, embedding_ids(batch=16), torch.bfloat16),
        *((f"n-{n}", 3000, 256, torch.randint(
            0, 3000, (n,), generator=gen, device="cuda"), torch.bfloat16)
          for n in (bg.SORT_MAX - 1, bg.SORT_MAX, bg.SORT_MAX + 1)),
        ("one-id-past-sort-max", tokens, d, torch.full_like(dispatch, 7),
         torch.bfloat16),
    ]
    errs = {}
    for name, rows, width, idx, dtype in cases:
        idx = idx.to(torch.int32)
        dout = _rand((idx.numel(), width), gen, dtype)
        path = bg.bwd_path(idx.numel())
        before = getattr(bg.burst_gather_bwd, f"{path}_launches")
        got = bg.burst_gather_bwd(dout, idx, rows)
        again = bg.burst_gather_bwd(dout, idx, rows)
        if getattr(bg.burst_gather_bwd, f"{path}_launches") != before + 2:
            raise AssertionError(f"burst_gather_bwd[{name}]: not launched "
                                 f"on the {path} path")
        seq_sum = torch.zeros((rows, width), dtype=torch.float32).index_add_(
            0, idx.cpu().long(), dout.cpu().float()).to(dtype)
        exact = torch.equal(got.cpu(), seq_sum)
        table = torch.zeros((rows, width), dtype=torch.float32,
                            device="cuda", requires_grad=True)
        with torch.enable_grad():
            (plain,) = torch.autograd.grad(
                ref.burst_gather_ref(table, idx), table, dout.float())
        errs[name] = _assert_close(
            f"burst_gather_bwd[{name}] vs plain (f32 rows)", got, plain,
            F32_TOL if dtype == torch.float32 else BF16_TOL)
        same = torch.equal(got, again)
        _phase(f"check burst_gather_bwd[{name}]: N={idx.numel()} ({path})"
               f" into ({rows}, {width}) {str(dtype).split('.')[-1]}, "
               f"{int(idx.unique().numel())} rows taken, equal to the "
               f"sequential f32 sum: {exact}, two runs same bits: {same} "
               f"{'ok' if exact and same else 'FAIL'}")
        if not (exact and same):
            raise AssertionError(f"burst_gather_bwd[{name}] is not the "
                                 f"sequential f32 sum or not deterministic")
        del got, again, dout, plain, table, seq_sum
        torch.cuda.empty_cache()
    return errs["embedding"], errs["dispatch"]


#: (case, (T, K, N, E), dtype, ids) of moe_gmm_bwd: granite-moe's training
#: products (B 4 x S 1024: 4,100 tokens x top 8, sorted as the model
#: dispatches; gate/up K 1536 -> N 512, down 512 -> 1536), arctic-reduced's
#: (N 96: top 2 of 8 over 2 x 129 tokens), then unsorted ids, ids out of
#: range, an expert no row takes, a single expert, T not a multiple of the
#: row tile, bf16 with K or N not a multiple of 8 (the generic kernels,
#: also in 64-row sub-tiles of 128-row tiles) and f32 (ids in any order,
#: out of range among them); then for the persistent bf16 kernels: experts
#: whose rows end 63, 64 and 65 past a stage edge with the next expert's
#: rows behind them in the same stage (three K tiles: a cluster along K
#: has a spare block), fewer work items than SMs, a partial last N tile
#: (N 264), the unsorted gather at the training width and rows, and
#: ("mixed") tiles and experts that are runs of x, of 8 and more stages,
#: beside gathered ones on the same block at the training width (the
#: producers' barrier phases across a run).  ids: ("sorted" or "token",
#: k), the top-k of random router scores for T / k tokens, sorted as the
#: model dispatches or in token order; (lo, hi), T uniform ids in [lo,
#: hi); "empty", uniform over the experts but expert 1; ("rows", counts),
#: each expert's count of rows, sorted; or ("mixed", n): experts 0 .. n -
#: 1 a run of T // (3 n) consecutive rows each, expert n the row tile
#: plus one rows (a one-row run tile after a gathered one) and the rest
#: uniform over the other experts, all in token order
MOE_BWD_CASES = [
    ("train-gate-up", (TRAIN_B * (TRAIN_S + 1) * 8, 1536, 512, 40),
     torch.bfloat16, ("sorted", 8)),
    ("train-down", (TRAIN_B * (TRAIN_S + 1) * 8, 512, 1536, 40),
     torch.bfloat16, ("sorted", 8)),
    ("arctic-reduced-n96", (516, 64, 96, 8), torch.bfloat16, ("sorted", 2)),
    ("arctic-reduced-down", (516, 96, 64, 8), torch.bfloat16,
     ("sorted", 2)),
    ("unsorted", (4096, 1536, 512, 40), torch.bfloat16, ("token", 8)),
    ("out-of-range", (3000, 256, 136, 8), torch.bfloat16, (-3, 11)),
    ("empty-expert", (2000, 128, 256, 6), torch.bfloat16, "empty"),
    ("one-expert", (1500, 256, 264, 1), torch.bfloat16, (0, 1)),
    ("t-off-the-tile", (1001, 192, 320, 4), torch.bfloat16, ("sorted", 1)),
    ("generic-k37-n23", (1200, 37, 23, 4), torch.bfloat16, (-1, 5)),
    ("generic-k40-n36-unsorted", (333, 40, 36, 5), torch.bfloat16,
     ("token", 1)),
    ("f32", (2064, 64, 96, 8), torch.float32, ("token", 4)),
    ("f32-out-of-range", (700, 40, 24, 5), torch.float32, (-2, 7)),
    ("stage-edge", (577, 384, 512, 7), torch.bfloat16,
     ("rows", (63, 64, 65, 127, 128, 129, 1))),
    ("few-items", (100, 256, 512, 1), torch.bfloat16, (0, 1)),
    ("n264", (1500, 512, 264, 4), torch.bfloat16, ("sorted", 1)),
    ("unsorted-train", (TRAIN_B * (TRAIN_S + 1) * 8, 1536, 512, 40),
     torch.bfloat16, ("token", 8)),
    ("mixed-train", (TRAIN_B * (TRAIN_S + 1) * 8, 1536, 512, 40),
     torch.bfloat16, ("mixed", 8)),
    ("mixed-train-down", (TRAIN_B * (TRAIN_S + 1) * 8, 512, 1536, 40),
     torch.bfloat16, ("mixed", 8)),
]


def _moe_bwd_ids(gen, T, E, ids):
    if ids == "empty":
        g = torch.randint(0, E - 1, (T,), generator=gen, device="cuda")
        return torch.where(g >= 1, g + 1, g).to(torch.int32)
    order, k = ids
    if order == "rows":
        return torch.repeat_interleave(
            torch.arange(E, dtype=torch.int32, device="cuda"),
            torch.tensor(k, device="cuda"))
    if order == "mixed":
        run = T // (3 * k)
        g = torch.randint(k + 1, E, (T,), generator=gen, device="cuda",
                          dtype=torch.int32)
        g[:k * run] = torch.arange(k, dtype=torch.int32,
                                   device="cuda").repeat_interleave(run)
        rest = k * run + torch.randperm(T - k * run, generator=gen,
                                        device="cuda")
        g[rest[:gmm.row_tile(T, E) + 1]] = k
        return g
    if isinstance(order, int):
        return torch.randint(order, k, (T,), generator=gen, device="cuda",
                             dtype=torch.int32)
    return moe_ids(gen, T // k, E, k, order)


def _gmm_grads(fn, x, w, ids, dy, *extra):
    """(dx, dw) of ``fn(x, w, ids, *extra)`` for the output gradient dy."""
    x, w = (t.detach().requires_grad_(True) for t in (x, w))
    with torch.enable_grad():
        return torch.autograd.grad(fn(x, w, ids, *extra), (x, w), dy)


def check_moe_gmm_bwd(gen):
    """``moe_gmm_bwd``, reached through autograd from ``gmm.moe_gmm``, at
    every case of ``MOE_BWD_CASES``, against autograd through
    ``ref.moe_gmm_ref`` on the same inputs on the card (bf16 at 2e-2, f32 at
    ``F32_BWD_TOL``), one launch a backward on ``bwd_schedule``'s path, and
    run twice for the same bits; the dx rows of ids outside [0, E) and the
    dw of an expert no row takes are zeros.  Returns the worst error at
    the training shapes (gate/up, down)."""
    errs = {}
    for name, (T, K, N, E), dtype, how in MOE_BWD_CASES:
        g = _moe_bwd_ids(gen, T, E, how)
        if g.numel() != T:
            raise AssertionError(f"moe_gmm_bwd[{name}]: {g.numel()} ids")
        x, w = moe_inputs(gen, T, K, N, E, dtype)
        dy = _rand((T, N), gen, dtype)
        before = gmm.moe_gmm_bwd.launches
        got = _gmm_grads(gmm.moe_gmm, x, w, g, dy)
        if gmm.moe_gmm_bwd.launches != before + 1:
            raise AssertionError(f"moe_gmm_bwd[{name}]: "
                                 f"{gmm.moe_gmm_bwd.launches - before} "
                                 f"launches")
        want = _gmm_grads(ref.moe_gmm_ref, x, w, g, dy)
        tol = F32_BWD_TOL if dtype == torch.float32 else BF16_TOL
        s = gmm.bwd_schedule(T, K, N, E, dtype)
        errs[name] = max(_assert_close(
            f"moe_gmm_bwd[{name}] {what} T={T} K={K} N={N} E={E} ({s.path})",
            a, b, tol) for what, a, b in zip(("dx", "dw"), got, want))
        outside = (g < 0) | (g >= E)
        counts = torch.bincount(g[~outside].long(), minlength=E)
        if bool(got[0][outside].any()) or bool(got[1][counts == 0].any()):
            raise AssertionError(f"moe_gmm_bwd[{name}]: a row out of range "
                                 f"or an expert with no row is not zero")
        plan = gmm.plan(g, E)
        again = _gmm_grads(gmm.moe_gmm, x, w, g, dy, plan)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        _phase(f"check moe_gmm_bwd[{name}]: two runs (a shared plan the "
               f"second), same bits: {same}; {int((counts == 0).sum())} "
               f"experts without a row, {int(outside.sum())} ids out of "
               f"range {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"moe_gmm_bwd[{name}]: two runs differ")
        del x, w, dy, got, want, again
        torch.cuda.empty_cache()
    return errs["train-gate-up"], errs["train-down"]


#: (case, (B, S, H, P, N), dtype, state in, final-state gradient, x/B/C
#: sliced from one projection, decay of ``mamba2_inputs``) of
#: mamba2_scan_bwd: zamba2-7b's training shape as its M layers call it
#: (bf16, no state, no final-state gradient); f32 with a state and a
#: final-state gradient at S a multiple of neither the 64-step checkpoints
#: nor the 8-step sub-chunks; ragged slices of 32 rows; N 128 (8 registers
#: a lane); S 1 and 0; zamba2-7b-reduced's heads.  bf16 with S >= 64 takes
#: the chunked path (``m2.bwd_schedule``): one chunk exactly, two with a
#: ragged last and a state, N 128 (two panels), P 40 and N 24 (TMA's tiles
#: zero-filled past P and N), P 36 and N 20 sliced from one projection
#: (not multiples of 8: loaded element by element, ``MAMBA2_BWD_ELEMENT``)
#: and dt A down to -100 a step
MAMBA2_BWD_CASES = [
    ("train", (TRAIN_B, TRAIN_S, 112, 64, 64), torch.bfloat16, False, False,
     True, "normal"),
    ("f32-s200", (2, 200, 4, 64, 64), torch.float32, True, True, False,
     "normal"),
    ("f32-p40-n24-s70", (1, 70, 3, 40, 24), torch.float32, True, True,
     False, "normal"),
    ("bf16-state-s65", (2, 65, 8, 64, 64), torch.bfloat16, True, True, True,
     "normal"),
    ("f32-p128-n128", (1, 37, 2, 128, 128), torch.float32, True, True,
     False, "normal"),
    ("s1", (2, 1, 4, 64, 64), torch.bfloat16, True, True, False, "normal"),
    ("s0", (2, 0, 4, 64, 64), torch.float32, True, True, False, "normal"),
    ("zamba2-reduced", (2, 128, 8, 16, 16), torch.float32, False, False,
     True, "normal"),
    ("bf16-s64", (2, 64, 8, 64, 64), torch.bfloat16, True, True, False,
     "normal"),
    ("bf16-state-s127", (2, 127, 8, 64, 64), torch.bfloat16, True, True,
     True, "normal"),
    ("bf16-n128", (1, 100, 4, 64, 128), torch.bfloat16, True, True, False,
     "normal"),
    ("bf16-p40-n24", (1, 70, 3, 40, 24), torch.bfloat16, True, True, False,
     "normal"),
    ("bf16-strong-decay", (2, 130, 4, 64, 64), torch.bfloat16, True, True,
     False, "strong"),
    ("bf16-p36-n20", (1, 130, 8, 36, 20), torch.bfloat16, True, True, True,
     "normal"),
]
#: the chunked mamba2 cases that load B, C, x and dY element by element
#: (``m2.bwd_chunked_loads``); the other chunked cases load them by TMA
MAMBA2_BWD_ELEMENT = ("bf16-p36-n20",)
#: (case, (B, S, H, D), dtype, state in, final-state gradient, decay of
#: ``rwkv6_inputs``) of rwkv6_scan_bwd: rwkv6-1.6b's training shape, then
#: as above, with the strong decays, the exact zeros of w and D 36 in bf16
#: (72 bytes a row: staged element by element, ``RWKV6_BWD_ELEMENT``)
RWKV6_BWD_CASES = [
    ("train", (TRAIN_B, TRAIN_S, 32, 64), torch.bfloat16, False, False,
     "normal"),
    ("f32-s200", (2, 200, 4, 64), torch.float32, True, True, "normal"),
    ("f32-d40-s70", (1, 70, 3, 40), torch.float32, True, True, "normal"),
    ("bf16-state-s65", (2, 65, 8, 64), torch.bfloat16, True, True, "normal"),
    ("f32-d128", (1, 37, 2, 128), torch.float32, True, True, "normal"),
    ("s1", (2, 1, 4, 64), torch.bfloat16, True, True, "normal"),
    ("s0", (2, 0, 4, 64), torch.float32, True, True, "normal"),
    ("strong-decay", (2, 64, 3, 16), torch.bfloat16, True, True, "strong"),
    ("strong-decay-f32", (2, 64, 3, 16), torch.float32, True, True,
     "strong"),
    ("w-zeros", (2, 50, 3, 64), torch.bfloat16, True, True, "zeros"),
    ("w-zeros-f32", (2, 50, 3, 64), torch.float32, True, True, "zeros"),
    ("rwkv6-reduced", (2, 128, 4, 16), torch.float32, False, False,
     "normal"),
    ("bf16-d36", (1, 70, 3, 36), torch.bfloat16, True, True, "normal"),
]
#: the rwkv6 cases staged element by element (``r6.bwd_loads``); the
#: others by 16-byte copies
RWKV6_BWD_ELEMENT = ("bf16-d36",)


def _scan_grads(fn, leaves, build, cots):
    """The gradient of each of ``leaves`` through ``fn(*build(leaves))``
    for the outputs' gradients ``cots`` (None: that output unused, as the
    final state is in training)."""
    return _scan_bwd.plain_vjp(lambda *lv: fn(*build(lv)), leaves, cots)


def _mamba2_leaves(args, strided):
    """(leaves, build, names): the fused projection as one leaf where x, B
    and C are its slices (its gradient holds dx, dB and dC)."""
    x, dt, A, Bm, Cm, h0 = args
    st = [] if h0 is None else [h0]
    if strided:
        fused = x._base
        h, p, n = x.shape[2], x.shape[3], Bm.shape[-1]
        assert fused is not None and fused.shape[-1] == h * p + 2 * n

        def build(lv):
            xs, bs, cs = torch.split(lv[0], [h * p, n, n], dim=-1)
            return (xs.unflatten(2, (h, p)), lv[1], lv[2], bs, cs,
                    lv[3] if st else None)
        return [fused, dt, A] + st, build, ["d(x|B|C)", "ddt", "dA",
                                            "dstate0"][:3 + len(st)]

    def build(lv):
        return lv[0], lv[3], lv[4], lv[1], lv[2], lv[5] if st else None
    return [x, Bm, Cm, dt, A] + st, build, ["dx", "dB", "dC", "ddt", "dA",
                                            "dstate0"][:5 + len(st)]


def _rwkv6_leaves(args):
    *rkvwu, s0 = args
    st = [] if s0 is None else [s0]

    def build(lv):
        return (*lv[:5], lv[5] if st else None)
    return list(rkvwu) + st, build, ["dr", "dk", "dv", "dw", "du",
                                     "dstate0"][:5 + len(st)]


def _check_scan_bwd_case(kernel, plain, name, leaves, build, names, cots,
                         f32, path=None, loads=None):
    """The kernel's gradients (through autograd from its wrapper) against
    autograd through the plain version: f32 at ``F32_BWD_TOL``; in bf16
    the bf16 gradients at ``BF16_TOL``, the f32 ones (of dt, A, u and the
    state) at ``STATE_BF16_TOL``, the scans' forward tolerances; then a
    second run, which must give the same bits.  Each run must launch the
    backward wrapper once, on ``path`` where one is named (its counter
    ``<path>_launches``), and where ``loads`` is (the library's counts by
    how the kernel loads its inputs, the way this case must take), that
    way and no other."""
    bwd = COUNTERS[f"{kernel.__name__}_bwd"]
    before = bwd.launches
    on_path = getattr(bwd, f"{path}_launches") if path else 0
    by_load = loads[0]() if loads else {}
    got = _scan_grads(kernel, leaves, build, cots)
    want = _scan_grads(plain, leaves, build, cots)
    err = 0.0
    for g_name, a, w in zip(names, got, want):
        tol = F32_BWD_TOL if f32 else (
            STATE_BF16_TOL if a.dtype == torch.float32 else BF16_TOL)
        err = max(err, _assert_close(f"{name} {g_name}", a, w, tol))
    again = _scan_grads(kernel, leaves, build, cots)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two runs differ")
    if bwd.launches - before != 2:
        raise AssertionError(f"{name}: {bwd.launches - before} launches of "
                             f"the backward in two runs, want 2")
    if path and getattr(bwd, f"{path}_launches") - on_path != 2:
        raise AssertionError(f"{name}: the backward did not take the "
                             f"{path} path in both runs")
    if loads:
        now = loads[0]()
        took = {k: now[k] - by_load[k] for k in now}
        if took != {k: 2 * (k == loads[1]) for k in now}:
            raise AssertionError(f"{name}: the kernel's loads in two runs "
                                 f"were {took}, want both {loads[1]}")
    _phase(f"check {name}: two runs, same bits, one launch each"
           f"{f' on the {path} path' if path else ''}"
           f"{f', loads {loads[1]}' if loads else ''} ok")
    return err


def check_scan_bwd(gen):
    """``mamba2_scan_bwd`` and ``rwkv6_scan_bwd``, reached through autograd
    from the scans' wrappers, against autograd through ``ref.*_scan_ref``
    on the same inputs (``MAMBA2_BWD_CASES``, ``RWKV6_BWD_CASES``).
    Returns the worst error of each at its training shape."""
    errs = {}
    for case, shape, dtype, state, dstate, strided, decay in \
            MAMBA2_BWD_CASES:
        args = mamba2_inputs(gen, *shape, dtype=dtype, state=state,
                             strided=strided, decay=decay)
        b, s, h, p, n = shape
        cots = (_rand((b, s, h, p), gen, dtype),
                _rand((b, h, p, n), gen, torch.float32) if dstate else None)
        leaves, build, names = _mamba2_leaves(args, strided)
        path = m2.bwd_schedule(dtype, s)
        loads = (m2.bwd_chunked_loads, "element" if case in
                 MAMBA2_BWD_ELEMENT else "tma") if path == "chunked" else None
        errs[f"mamba2_scan_bwd[{case}]"] = _check_scan_bwd_case(
            m2.mamba2_scan, ref.mamba2_scan_ref,
            f"mamba2_scan_bwd[{case}]", leaves, build, names, cots,
            dtype == torch.float32, path, loads)
    for case, shape, dtype, state, dstate, decay in RWKV6_BWD_CASES:
        args = rwkv6_inputs(gen, *shape, dtype=dtype, state=state,
                            decay=decay)
        b, s, h, d = shape
        if decay == "zeros":
            _phase(f"rwkv6_scan_bwd[{case}]: {int((args[3] == 0).sum())} "
                   f"exact zeros of w")
        cots = (_rand((b, s, h, d), gen, dtype),
                _rand((b, h, d, d), gen, torch.float32) if dstate else None)
        leaves, build, names = _rwkv6_leaves(args)
        errs[f"rwkv6_scan_bwd[{case}]"] = _check_scan_bwd_case(
            r6.rwkv6_scan, ref.rwkv6_scan_ref, f"rwkv6_scan_bwd[{case}]",
            leaves, build, names, cots, dtype == torch.float32,
            loads=(r6.bwd_loads, "element" if case in RWKV6_BWD_ELEMENT
                   else "vec"))
    return errs["mamba2_scan_bwd[train]"], errs["rwkv6_scan_bwd[train]"]


#: rounds of ``check_scan_bwd_repeats``, and the cases it repeats: mamba2's
#: at every cluster size the chunked kernel takes (the cluster a case can
#: form is the largest of these that divides H ceil(P / 64))
BWD_REPEATS = 40
BWD_REPEAT_CASES = {"mamba2": ("train", "bf16-state-s127", "bf16-p36-n20"),
                    "rwkv6": ("train", "bf16-d36")}
BWD_CLUSTERS = (8, 4, 2, 1)


def check_scan_bwd_repeats(gen):
    """The chunked mamba2 backward's cluster barriers (the blocks of a
    cluster sum dB and dC through each other's shared memory) and both
    kernels' scratch, called again and again: the ``BWD_REPEAT_CASES``,
    mamba2's at each of ``BWD_CLUSTERS`` (``m2.CLUSTER`` set for the
    call), round robin for ``BWD_REPEATS`` rounds, so that each call finds
    in its scratch what another case left there.  The first call of each
    is held against the plain version at the bf16 tolerances; every later
    call must give its bits again."""
    runs = []
    cases = {c[0]: c for c in MAMBA2_BWD_CASES}
    for case in BWD_REPEAT_CASES["mamba2"]:
        _, shape, dtype, state, dstate, strided, decay = cases[case]
        b, s, h, p, n = shape
        x, dt, A, Bm, Cm, h0 = mamba2_inputs(
            gen, *shape, dtype=dtype, state=state, strided=strided,
            decay=decay)
        dy = _rand((b, s, h, p), gen, dtype)
        dh = _rand((b, h, p, n), gen, torch.float32) if dstate else None
        plain = _scan_bwd.plain_vjp(ref.mamba2_scan_ref, (
            x, dt, A, Bm, Cm, torch.zeros((b, h, p, n), device="cuda")
            if h0 is None else h0), (dy, dh))
        for cl in BWD_CLUSTERS:
            if cl > m2.bwd_cluster(h * -(-p // m2.CHUNK_ROWS)):
                continue

            def call(args=(x, dt, A, Bm, Cm, h0, dy, dh), cl=cl):
                keep, m2.CLUSTER = m2.CLUSTER, cl
                try:
                    return m2.mamba2_scan_bwd(*args)
                finally:
                    m2.CLUSTER = keep
            runs.append((f"mamba2_scan_bwd[{case}] cluster {cl}", call,
                         plain))
    cases = {c[0]: c for c in RWKV6_BWD_CASES}
    for case in BWD_REPEAT_CASES["rwkv6"]:
        _, shape, dtype, state, dstate, decay = cases[case]
        b, s, h, d = shape
        args = rwkv6_inputs(gen, *shape, dtype=dtype, state=state,
                            decay=decay)
        dy = _rand((b, s, h, d), gen, dtype)
        ds = _rand((b, h, d, d), gen, torch.float32) if dstate else None
        *rkvwu, s0 = args
        plain = _scan_bwd.plain_vjp(ref.rwkv6_scan_ref, (
            *rkvwu, torch.zeros((b, h, d, d), device="cuda")
            if s0 is None else s0), (dy, ds))
        runs.append((f"rwkv6_scan_bwd[{case}]",
                     lambda args=(*args, dy, ds): r6.rwkv6_scan_bwd(*args),
                     plain))
    first = {}
    for _ in range(BWD_REPEATS):
        for name, call, plain in runs:
            got = call()
            if name not in first:
                for i, (a, w) in enumerate(zip(got, plain)):
                    _assert_close(f"{name} gradient {i}", a, w,
                                  STATE_BF16_TOL if a.dtype == torch.float32
                                  else BF16_TOL)
                first[name] = got
            elif not all(torch.equal(a, w)
                         for a, w in zip(got, first[name])):
                raise AssertionError(f"{name}: a repeated call differs")
    torch.cuda.synchronize()
    _phase(f"check scan backward repeats: {len(runs)} calls round robin "
           f"({', '.join(name for name, _, _ in runs)}), {BWD_REPEATS} "
           f"rounds, each call the same bits as its first ok")


def check_grad_refusals(gen):
    """The CUDA wrapper with no backward kernel (decode attention, which no
    training path calls) raises NotImplementedError on an input that
    requires grad, instead of cutting the graph."""
    q = _rand((2, 1, 8, 64), gen).requires_grad_(True)
    k, v = _rand((2, 64, 2, 64), gen), _rand((2, 64, 2, 64), gen)
    cases = {
        "decode_attention": lambda: fa.decode_attention(q, k, v, kv_len=64),
    }
    for name, fn in cases.items():
        try:
            with torch.enable_grad():
                fn()
        except NotImplementedError as e:
            _phase(f"check {name} refuses a gradient on CUDA: {e} ok")
            continue
        raise AssertionError(f"{name}: ran on a CUDA input that requires "
                             f"grad, with no backward kernel")


#: the reduced models whose f32 step is held to the CPU's: every
#: architecture (the MoE models through the grouped matmul's backward)
TRAIN_REF_ARCHS = ("granite-8b", "zamba2-7b", "rwkv6-1.6b", "gemma2-27b",
                   "gemma3-12b", "chatglm3-6b", "llama-3.2-vision-11b",
                   "whisper-tiny", "granite-moe-3b-a800m", "arctic-480b")
#: router margin (k-th minus (k+1)-th probability) below which the f32
#: step may route a token otherwise on the two devices: their inputs to a
#: layer agree to f32 roundings (ROADMAP §3: 1e-5 on identical inputs)
TRAIN_REF_ROUTE_MARGIN = 1e-5
#: a reduced model in f32, card against CPU: the loss within 1e-5 and each
#: gradient within 1e-4 of the CPU's largest entry of that gradient plus
#: 1e-7; the same f32 arithmetic in another order (cuBLAS against the
#: CPU's matmuls, the kernels against the plain versions)
TRAIN_REF_LOSS_TOL, TRAIN_REF_GRAD_REL, TRAIN_REF_GRAD_ABS = 1e-5, 1e-4, 1e-7
#: ... except the gradients that reach a parameter through a cast to bf16,
#: within two bf16 steps (2^-7) of their largest entry: the memory is
#: rounded to bf16 after ``frontend_proj`` (``lm._frontend``, as the JAX
#: package casts it), so the gradient into ``frontend_proj`` is rounded to
#: bf16 too, from f32 values that differ a little between the devices
#: (whisper-tiny-reduced: 2.0e-6 off, against 1e-4 x 1.02e-2 + 1e-7)
TRAIN_REF_BF16_CAST = ("frontend_proj",)
TRAIN_REF_GRAD_REL_BF16 = 2.0 ** -7


@contextlib.contextmanager
def _replayed_routes(top_is):
    """Every MoE layer routes as ``top_is`` (one (T, k) top_i a layer, in
    call order, again at each forward pass) says, weighted by its own
    probabilities renormalised over those experts, as ``moe.route``
    weighs its own top-k; None leaves the routing alone."""
    if top_is is None:
        yield
        return
    own, calls = moe.route, [0]

    def route(router, cfg_, xf):
        probs, _, _ = own(router, cfg_, xf)
        ti = top_is[calls[0] % len(top_is)].to(probs.device)
        calls[0] += 1
        top_p = probs.gather(-1, ti)
        return probs, top_p / torch.clamp_min(top_p.sum(-1, keepdim=True),
                                              1e-9), ti

    moe.route = route
    try:
        yield
    finally:
        moe.route = own


def _train_ref_step(params, cfg, toks, extra, dev, replay=None):
    """The loss and every gradient of one f32 step of ``params`` on
    ``dev`` (CPU tensors), the routing of each MoE layer (CPU (probs,
    top_i), recorded unless ``replay`` gives it), then the step's clip and
    AdamW update in place."""
    batch = {"tokens": toks.to(dev)}
    if extra:
        batch["extra"] = {k: v.to(dev) for k, v in extra.items()}
    record, handles = _route_hooks(params, cfg) \
        if cfg.n_experts and replay is None else ([], [])
    with _replayed_routes(replay):
        params.requires_grad_(True)
        loss = lm.loss_fn(params, cfg, batch)
        loss.backward()
        for h in handles:
            h.remove()
        # a parameter no layer reaches (zamba2-reduced's one H layer uses
        # the first of its two shared blocks) has no gradient: zeros
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                 for n, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
        train.train_step(params, cfg, adamw_init(
            dict(params.named_parameters())), toks.to(dev), 1e-3)
    return float(loss.detach()), grads, record


def _first_reroute(cpu_rec, gpu_rec, k):
    """The tokens of the first MoE layer (in call order) that the two
    devices routed to other experts, as (layer, tokens, their CPU
    margins); None where every layer routed alike.  Later layers see
    hidden states that such a token has moved, so only the first layer's
    margins say whether a near-tie caused it."""
    for layer, ((probs, ti_c), (_, ti_g)) in enumerate(zip(
            cpu_rec, gpu_rec, strict=True)):
        differ = torch.tensor([set(a.tolist()) != set(b.tolist())
                               for a, b in zip(ti_c, ti_g)])
        if bool(differ.any()):
            srt = probs.sort(-1, descending=True).values
            margin = srt[:, k - 1] - srt[:, k]
            return layer, int(differ.sum()), margin[differ].tolist()
    return None


def check_train_reference(arch):
    """One step of ``arch``'s reduced config in f32 on the card (kernels)
    and on the CPU (plain versions), same weights and batch (B 2, S 128;
    the X layers' gates at ``XATTN_GATE`` and a seeded memory): the loss
    and every parameter's gradient (the tied embedding's is the gather's
    scatter-add plus the head's), then the params after clip and AdamW,
    whose largest difference is printed.

    An MoE model records each layer's routing on both devices.  Where they
    differ, the first such layer's tokens must sit below
    ``TRAIN_REF_ROUTE_MARGIN`` on the CPU (a near-tie), which is printed;
    then both devices run the step again from the same weights on the
    CPU's routing (``_replayed_routes``) and that run is compared, at the
    same tolerances."""
    cfg = configs.get_reduced(arch)
    cpu = lm.init_params(cfg, seed=0, device="cpu").to(torch.float32)
    for layer in cpu.layers:
        if hasattr(layer, "xattn_gate"):
            layer.xattn_gate.fill_(XATTN_GATE)
    start = {n: t.clone() for n, t in cpu.state_dict().items()}
    gpu = lm.LM(cfg, "cuda").to(torch.float32)
    gpu.load_state_dict(start)
    toks = torch.from_numpy(SyntheticTokens(cfg.vocab, seed=3).batch(
        0, 0, 2, 128))
    extra = seeded_extra(cfg, 2, torch.Generator().manual_seed(6))
    l_cpu, g_cpu, cpu_rec = _train_ref_step(cpu, cfg, toks, extra, "cpu")
    l_gpu, g_gpu, gpu_rec = _train_ref_step(gpu, cfg, toks, extra, "cuda")
    routed = ""
    if cfg.n_experts:
        first = _first_reroute(cpu_rec, gpu_rec, cfg.top_k)
        routed = f"; {len(cpu_rec)} MoE layers routed alike on both devices"
        if first is not None:
            layer, n, margins = first
            if not max(margins) < TRAIN_REF_ROUTE_MARGIN:
                raise AssertionError(
                    f"train reference {cfg.name}: MoE layer {layer} routed "
                    f"{n} tokens otherwise at CPU margins {margins} >= "
                    f"{TRAIN_REF_ROUTE_MARGIN}")
            _phase(f"train reference {cfg.name}: MoE layer {layer} routed "
                   f"{n} tokens otherwise on the card, at CPU margins "
                   f"{margins} < {TRAIN_REF_ROUTE_MARGIN}; both devices run "
                   f"the step again on the CPU's routing")
            replay = [ti for _, ti in cpu_rec]
            cpu.load_state_dict(start)
            gpu.load_state_dict(start)
            l_cpu, g_cpu, _ = _train_ref_step(cpu, cfg, toks, extra, "cpu",
                                              replay)
            l_gpu, g_gpu, _ = _train_ref_step(gpu, cfg, toks, extra, "cuda",
                                              replay)
            routed = (f"; layer {layer} rerouted {n} tokens at a near-tie, "
                      f"compared on the CPU's routing")
    worst, worst_name, bad = 0.0, "", []
    for n, want in g_cpu.items():
        err = float((g_gpu[n] - want).abs().max())
        rel = TRAIN_REF_GRAD_REL_BF16 if n in TRAIN_REF_BF16_CAST \
            else TRAIN_REF_GRAD_REL
        lim = rel * float(want.abs().max()) + TRAIN_REF_GRAD_ABS
        if not err <= lim:
            bad.append(f"{n} off by {err:.3e} > {lim:.3e}")
        elif err / lim > worst:
            worst, worst_name = err / lim, n
    if bad:
        raise AssertionError(f"train reference {cfg.name}: grads "
                             f"{'; '.join(bad)}")
    if not abs(l_gpu - l_cpu) <= TRAIN_REF_LOSS_TOL:
        raise AssertionError(f"train reference {cfg.name}: loss {l_gpu} on "
                             f"the card, {l_cpu} on the CPU")
    p_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(gpu.parameters(), cpu.parameters()))
    memory = f"; memory {tuple(next(iter(extra.values())).shape)}, gates " \
        f"{XATTN_GATE}" if extra else ""
    _phase(f"check train {cfg.name} f32 card vs cpu{memory}{routed}: "
           f"loss {l_gpu:.7f} / {l_cpu:.7f} (|diff| "
           f"{abs(l_gpu - l_cpu):.2e} <= "
           f"{TRAIN_REF_LOSS_TOL}); {len(g_cpu)} grads each within "
           f"{TRAIN_REF_GRAD_REL} x its largest entry + "
           f"{TRAIN_REF_GRAD_ABS} ({TRAIN_REF_GRAD_REL_BF16:g} behind the "
           f"bf16 cast: {', '.join(TRAIN_REF_BF16_CAST)}; worst "
           f"{worst:.3f} of its bound, {worst_name}); params after one step "
           f"max diff {p_err:.2e} ok")


def check_train_restart(tmp):
    """The fault-tolerant restart on the card: granite-8b-reduced for 5
    steps unbroken (checkpoints every 2), and again failing at step 3
    (exit 42) then resumed from the checkpoint of step 2 into fresh
    tensors.  The resumed steps' losses and gradient norms and the final
    checkpoint equal the unbroken run's bit for bit."""
    cfg = configs.get_reduced(TRAIN_ARCH)
    kw = dict(steps=5, batch=TRAIN_B, seq=256, device="cuda",
              ckpt_every=2, log_every=100)
    whole = train.train(cfg, ckpt_dir=str(tmp / "whole"), **kw)
    try:
        train.train(cfg, ckpt_dir=str(tmp / "broken"), fail_at=3, **kw)
        raise AssertionError("train --fail-at 3 did not fail")
    except SystemExit as e:
        if e.code != 42:
            raise
    resumed = train.train(cfg, ckpt_dir=str(tmp / "broken"), **kw)
    same = (resumed.start == 2 and resumed.losses == whole.losses[2:]
            and resumed.grad_norms == whole.grad_norms[2:])
    final = [restore_checkpoint(str(tmp / d), 5, {"params": dict(
        whole.params.named_parameters())}) for d in ("whole", "broken")]
    same_params = all(torch.equal(final[0]["params"][n], final[1]["params"]
                                  [n]) for n in final[0]["params"])
    _phase(f"check train restart on the card: {cfg.name}, failed at step 3,"
           f" resumed from step {resumed.start}: losses {resumed.losses} "
           f"vs unbroken {whole.losses[2:]}, same bits {same}; final "
           f"checkpoints equal {same_params} "
           f"{'ok' if same and same_params else 'FAIL'}")
    if not (same and same_params):
        raise AssertionError("train restart: the resumed run differs from "
                             "the unbroken one")


def train_phase(arch, depth):
    """``arch`` at full width and ``depth`` layers: ``TRAIN_STEPS`` steps of
    ``launch.train.train`` at B ``TRAIN_B``, S ``TRAIN_S`` from
    ``SyntheticTokens(seed=0)``.  Checks the exact launches of every kernel
    on its path, forward and backward (a step: one attention a G, L or H
    layer and two an X layer, one SSD scan an M or H layer, one WKV scan
    an R layer, the embedding's gather, an MoE layer's plan, dispatch
    gather and three grouped matmuls, and the backward of each; the
    embedding's gather backward on the one-block sort, the dispatch's
    32,800 ids on the multi-block one), and finite losses and norms;
    prints each step's loss, grad norm and seconds, tokens/s and the peak
    memory.  Returns its launches, and the gather backward's by path."""
    full = configs.get(arch)
    cfg = full if depth == full.n_layers else dataclasses.replace(
        full, name=f"{arch} at {depth} of {full.n_layers} layers",
        n_layers=depth)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    m2.mamba2_scan_bwd.chunked_launches = 0
    bg.burst_gather_bwd.one_block_launches = 0
    bg.burst_gather_bwd.multi_block_launches = 0
    t0 = time.perf_counter()
    run = train.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                      device="cuda", log_every=1)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in COUNTERS.items()}
    paths = {"one_block": bg.burst_gather_bwd.one_block_launches,
             "multi_block": bg.burst_gather_bwd.multi_block_launches}
    chunked = m2.mamba2_scan_bwd.chunked_launches
    pattern = cfg.layer_pattern
    kinds = [pattern[i % len(pattern)] for i in range(cfg.n_layers)]
    # every MoE layer plans once, gathers its dispatch once and runs 3
    # grouped matmuls (2 without a gate)
    n_moe = sum(k in "GL" for k in kinds) if cfg.n_experts else 0
    # an X layer attends twice (itself, then the memory)
    per_step = {"flash_attention": sum(k in "GLXH" for k in kinds)
                + kinds.count("X"),
                "mamba2_scan": sum(k in "MH" for k in kinds),
                "rwkv6_scan": kinds.count("R"), "burst_gather": 1 + n_moe,
                "moe_gmm": (3 if cfg.gated_mlp else 2) * n_moe}
    want = dict.fromkeys(COUNTERS, 0)
    for name, n in per_step.items():
        want[name] = want[f"{name}_bwd"] = n * TRAIN_STEPS
    want["moe_plan"] = n_moe * TRAIN_STEPS
    # B (S + 1) = 4,100 embedding ids take one block; a dispatch's 8 x
    # that many, the multi-block sort
    want_paths = {"one_block": TRAIN_STEPS,
                  "multi_block": n_moe * TRAIN_STEPS}
    tokens = TRAIN_B * (TRAIN_S + 1)
    steady = statistics.median(run.step_s[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    params = sum(p.numel() for p in run.params.parameters()) / 1e9
    _phase(f"train {cfg.name} on {torch.cuda.get_device_name(0)}: "
           f"{params:.3f} B params, d_model {cfg.d_model}, B {TRAIN_B} x S "
           f"{TRAIN_S} ({tokens} tokens a step), {TRAIN_STEPS} steps in "
           f"{wall:.1f}s: losses {[round(x, 4) for x in run.losses]}, grad "
           f"norms {[round(x, 4) for x in run.grad_norms]}, step s "
           f"{[round(x, 4) for x in run.step_s]} (first with the build and "
           f"warm-up); steady {steady:.4f} s a step, {tokens / steady:.0f} "
           f"tokens/s; max_memory_allocated {peak:.2f} GB; launches "
           f"{launches}; burst_gather_bwd by path {paths}")
    if launches != want or paths != want_paths:
        raise AssertionError(f"train {cfg.name}: launch counts {launches}, "
                             f"{paths}, want {want}, {want_paths}")
    # bf16 at S 1024: every SSD backward on the chunked path
    if chunked != launches["mamba2_scan_bwd"]:
        raise AssertionError(f"train {cfg.name}: {chunked} of "
                             f"{launches['mamba2_scan_bwd']} mamba2_scan_bwd "
                             f"launches on the chunked path")
    if launches["mamba2_scan_bwd"]:
        _phase(f"check train {cfg.name}: all {chunked} mamba2_scan_bwd "
               f"launches on the chunked path ok")
    if not all(math.isfinite(x) for x in run.losses + run.grad_norms):
        raise AssertionError(f"train {cfg.name}: a loss or grad norm is not "
                             f"finite")
    del run
    torch.cuda.empty_cache()
    return launches, paths


#: the batch whose 16,400 embedding ids (B 16 x S 1024) exceed the
#: one-block sort: granite-8b at this depth, full width, one step
BIG_BATCH, BIG_BATCH_DEPTH = 16, 2


def check_train_big_batch():
    """One step of granite-8b (at ``BIG_BATCH_DEPTH`` of its layers, full
    width) at B 16 x S 1024, the batch of ``launch.train --batch 16 --seq
    1024``: its embedding's 16,400 ids take the gather backward's
    multi-block path; the loss and norm are finite."""
    full = configs.get(TRAIN_ARCH)
    cfg = dataclasses.replace(
        full, name=f"{TRAIN_ARCH} at {BIG_BATCH_DEPTH} of {full.n_layers} "
        f"layers", n_layers=BIG_BATCH_DEPTH)
    before = bg.burst_gather_bwd.multi_block_launches
    run = train.train(cfg, steps=1, batch=BIG_BATCH, seq=TRAIN_S,
                      device="cuda", log_every=1)
    multi = bg.burst_gather_bwd.multi_block_launches - before
    ok = multi == 1 and all(math.isfinite(x) for x in run.losses +
                            run.grad_norms)
    _phase(f"check train {cfg.name} at B {BIG_BATCH} x S {TRAIN_S} "
           f"({BIG_BATCH * (TRAIN_S + 1)} embedding ids): loss "
           f"{run.losses[0]:.4f}, grad norm {run.grad_norms[0]:.4f}, "
           f"{multi} multi-block gather backward {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"train {cfg.name} at B {BIG_BATCH}: not "
                             f"finite or not on the multi-block path")
    del run
    torch.cuda.empty_cache()


def train_rows(errs, flush, gen):
    """The kernels line's rows of the two backward kernels at the train
    phase's shapes.  flash_attention_bwd: B 4, S 1024, Hq 32, Hkv 8, D 128,
    causal, bf16; plain: autograd through ``ref.attention_ref`` (its
    forward included, which autograd needs); library: the backward of
    ``scaled_dot_product_attention`` (cuDNN/flash, enable_gqa).  Bound: the
    five products of the causal backward, 2 x 5 D flops a (query, key)
    pair; bytes q, k, v, o, dO, lse read and dq, dk, dv written once.
    Each line also gives the device time of every kernel the call launched
    (``kernel_split``), and the row keeps them as ``kernels_ms``.
    burst_gather_bwd: the train batch's 4,100 ids into the (49152, 4096)
    bf16 embedding gradient; plain: autograd through
    ``ref.burst_gather_ref``; library: ``index_add_`` into a zero f32
    table.  Bound: bytes, dout and ids read and the whole table written."""
    b, s, hq, hkv, d = TRAIN_B, TRAIN_S, 32, 8, 128
    q, do = (_rand((b, s, hq, d), gen) for _ in range(2))
    k, v = (_rand((b, s, hkv, d), gen) for _ in range(2))
    lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
    o = fa._launch("flash_attention_fwd", q, k, v, causal=True, window=None,
                   softcap=None, scale=None, q_offset=0, kv_len=None,
                   lse=lse)
    def bwd():
        return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ms = time_ms(bwd, flush)
    split = kernel_split(bwd)
    plain = time_ms(lambda: _attn_grads(ref.attention_ref, q, k, v, do,
                                        causal=True), flush, reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                              retain_graph=True), flush)
    pairs = b * hq * s * (s + 1) // 2
    flops = 2 * 5 * d * pairs
    nbytes = 2 * (3 * q.numel() + 2 * do.numel() + 4 * k.numel()) + \
        4 * lse.numel()
    b_ms, b_by = bound(flops, nbytes)
    _phase(f"time flash_attention_bwd[train] (B, S, Hq, Hkv, D) = "
           f"{(b, s, hq, hkv, d)} causal bf16: {ms:.4f} ms, plain "
           f"{plain:.4f} ms, SDPA backward {lib:.4f} ms, bound {b_ms:.4f} "
           f"ms ({b_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
           f"{flops / ms / 1e9:.1f} TFLOP/s; by kernel (profiler, ms a "
           f"call) {_split_text(split)}")
    rows = [_row("flash_attention_bwd", "src/repro/kernels/"
                 "flash_attention.py:90", errs[0], ms, plain, lib, b_ms,
                 b_by)]
    rows[-1]["kernels_ms"] = split
    del q, k, v, o, do, qt, kt, vt, out, dot

    R, D = configs.get(TRAIN_ARCH).vocab_padded, 4096
    idx = embedding_ids()
    dout = _rand((idx.numel(), D), gen)
    def gather_bwd():
        return bg.burst_gather_bwd(dout, idx, R)
    ms = time_ms(gather_bwd, flush)
    split = kernel_split(gather_bwd)
    table = torch.zeros((R, D), dtype=torch.bfloat16, device="cuda",
                        requires_grad=True)

    def plain_fn():
        with torch.enable_grad():
            return torch.autograd.grad(ref.burst_gather_ref(table, idx),
                                       table, dout)
    plain = time_ms(plain_fn, flush)
    idx64, doutf = idx.long(), dout.float()
    lib = time_ms(lambda: torch.zeros((R, D), dtype=torch.float32,
                                      device="cuda").index_add_(
        0, idx64, doutf), flush)
    nbytes = 2 * dout.numel() + 4 * idx.numel() + 2 * R * D
    b_ms, b_by = bound(dout.numel(), nbytes)
    _phase(f"time burst_gather_bwd[embedding] N={idx.numel()} "
           f"({int(idx.unique().numel())} rows taken, the commonest "
           f"{int(torch.bincount(idx).max())} times) into ({R}, {D}) bf16: "
           f"{ms:.4f} ms, plain {plain:.4f} ms, index_add_ into f32 "
           f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
           f"{nbytes / 1e6:.1f} MB); by stage (profiler, ms a call) "
           f"{_split_text(split)}")
    rows.append(_row("burst_gather_bwd", "src/repro/kernels/"
                     "burst_gather.py:59", errs[1], ms, plain, lib, b_ms,
                     b_by))
    rows[-1].update(kernels_ms=split, path="one_block")
    del idx, dout, table, idx64, doutf
    return rows + scan_bwd_rows(errs[2:], flush, gen)


def _grouped_mm_bwd(x, w, ids, E, dy):
    """Autograd through ``torch._grouped_mm`` over the sorted rows (its
    backward: dx and dw), timed as the library yardstick and never called
    by the port; None where this PyTorch lacks it, or does not
    differentiate it, as printed."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or x.dtype != torch.bfloat16:
        return None
    offs = torch.bincount(ids.long(), minlength=E).cumsum(0).to(torch.int32)
    xg, wg = (t.detach().requires_grad_(True) for t in (x, w))
    try:
        with torch.enable_grad():
            out = fn(xg, wg, offs=offs)
            torch.autograd.grad(out, (xg, wg), dy, retain_graph=True)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        _phase(f"library: autograd through torch._grouped_mm refused: "
               f"{str(exc)[:200]}")
        return None
    return lambda: torch.autograd.grad(out, (xg, wg), dy, retain_graph=True)


def _grouped_mm_parts(x, w, ids, E, dy):
    """One ``torch._grouped_mm`` call for each backward kernel alone, over
    the sorted rows: dX ``dy @ w[e]^T`` (``_grouped_mm(dy, w.transpose(1,
    2), offs=offs)``) and dW ``x^T dy`` summed over each expert's rows
    (``_grouped_mm(x.t(), dy, offs=offs)``), timed as yardsticks and never
    called by the port: {"dx": fn, "dw": fn}, a form this PyTorch refuses
    left out, as printed."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or x.dtype != torch.bfloat16:
        return {}
    offs = torch.bincount(ids.long(), minlength=E).cumsum(0).to(torch.int32)
    wt, xt = w.transpose(1, 2), x.t()
    parts = {}
    for name, call in (("dx", lambda: fn(dy, wt, offs=offs)),
                       ("dw", lambda: fn(xt, dy, offs=offs))):
        try:
            call()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as exc:
            _phase(f"library: torch._grouped_mm for {name} alone refused: "
                   f"{str(exc)[:200]}")
            continue
        parts[name] = call
    return parts


def moe_bwd_rows(errs, dispatch_err, flush, gen):
    """The kernels line's rows of the new backward kernels at granite-moe's
    training shapes (B 4 x S 1024: 32,800 routed rows, sorted as the model
    dispatches them, E 40, bf16).  moe_gmm_bwd: one backward call of the
    gate/up product (K 1536, N 512; dX and dW, each kernel's device time
    in ``kernels_ms``, and a call asking for each alone in ``ms_alone``)
    on a shared plan, as the model calls it; the down
    product's (K 512, N 1536) as ``down_*`` keys; plain: autograd through
    ``ref.moe_gmm_ref``; library: autograd through ``torch._grouped_mm``
    where this PyTorch differentiates it, else none, and one
    ``torch._grouped_mm`` call for each kernel alone in
    ``library_ms_by_kernel`` (``_grouped_mm_parts``; a refused form takes
    the whole call's time, as printed).  Bound: dX and dW 2 T K N FLOPs
    each; bytes x, w and dy read and dx and dw written once (each kernel's
    own in ``bound_ms_by_kernel``).
    burst_gather_bwd[dispatch]: the dispatch gather's gradient, 32,800 ids
    (each of 4,100 rows 8 times, in a random routing's order) into (4100,
    1536) bf16, the multi-block path; plain: autograd through
    ``ref.burst_gather_ref``; library: ``index_add_`` into f32.  Bound:
    bytes, dout and ids read and the table written once."""
    cases = {c[0]: c[1:] for c in MOE_BWD_CASES}
    timed = {}
    for case in ("train-gate-up", "train-down"):
        (T, K, N, E), dtype, how = cases[case]
        g = _moe_bwd_ids(gen, T, E, how)
        x, w = moe_inputs(gen, T, K, N, E, dtype)
        dy = _rand((T, N), gen, dtype)
        plan = gmm.plan(g, E)

        def kernel(x=x, w=w, g=g, dy=dy, plan=plan):
            return gmm.moe_gmm_bwd(dy, x, w, g, plan)
        ms = time_ms(kernel, flush)
        split = kernel_split(kernel)
        alone = {k: time_ms(lambda need=need: gmm.moe_gmm_bwd(
            dy, x, w, g, plan, need=need), flush)
            for k, need in (("dx", (True, False)), ("dw", (False, True)))}
        plain = time_ms(lambda: _gmm_grads(ref.moe_gmm_ref, x, w, g, dy),
                        flush, reps=3)
        lib = _grouped_mm_bwd(x, w, g, E, dy)
        lib_ms = time_ms(lib, flush) if lib is not None else None
        parts = _grouped_mm_parts(x, w, g, E, dy)
        lib_parts = {k: time_ms(parts[k], flush) if k in parts else lib_ms
                     for k in ("dx", "dw")}
        one = 2 * T * K * N
        by_kernel = {"dx": bound(one, 2 * (T * N + E * K * N + T * K))[0],
                     "dw": bound(one, 2 * (T * K + T * N + E * K * N))[0]}
        nbytes = 2 * (2 * T * K + 2 * E * K * N + T * N) + 4 * T
        b_ms, b_by = bound(2 * one, nbytes)
        timed[case] = (ms, plain, lib_ms, b_ms, b_by, split, by_kernel,
                       lib_parts, alone)
        _phase(f"time moe_gmm_bwd[{case}] T={T} K={K} N={N} E={E} bf16 "
               f"(dX and dW): {ms:.4f} ms, plain {plain:.3f} ms, library "
               f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
               f"{b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, "
               f"{2 * one / 1e9:.1f} GFLOP; dX {by_kernel['dx']:.4f}, dW "
               f"{by_kernel['dw']:.4f}), {2 * one / ms / 1e9:.1f} TFLOP/s; "
               f"by kernel (profiler, ms a call) {_split_text(split)}; "
               f"each asked for alone {_split_text(alone)} ms; "
               f"library by kernel (torch._grouped_mm alone, ms) "
               f"{', '.join(f'{k} {v}' for k, v in lib_parts.items())}")
        del x, w, g, dy, plan, lib, parts
        torch.cuda.empty_cache()
    ms, plain, lib_ms, b_ms, b_by, split, by_kernel, lib_parts, alone = \
        timed["train-gate-up"]
    row = _row("moe_gmm_bwd", "src/repro/kernels/moe_gmm.py:50", errs[0],
               ms, plain, lib_ms, b_ms, b_by)
    row.update(kernels_ms=split, ms_alone=alone,
               bound_ms_by_kernel=by_kernel, library_ms_by_kernel=lib_parts)
    ms, plain, lib_ms, b_ms, _, split, by_kernel, lib_parts, alone = \
        timed["train-down"]
    row.update(down_ms=ms, down_plain_ms=plain, down_library_ms=lib_ms,
               down_bound_ms=b_ms, down_kernels_ms=split,
               down_ms_alone=alone, down_library_ms_by_kernel=lib_parts,
               down_max_abs_err=errs[1])

    tokens, k, d = DISPATCH_BWD
    idx = (torch.randperm(tokens * k, generator=gen, device="cuda") //
           k).to(torch.int32)
    dout = _rand((tokens * k, d), gen)

    def gather_bwd():
        return bg.burst_gather_bwd(dout, idx, tokens)
    ms = time_ms(gather_bwd, flush)
    split = kernel_split(gather_bwd)
    table = torch.zeros((tokens, d), dtype=torch.bfloat16, device="cuda",
                        requires_grad=True)

    def plain_fn():
        with torch.enable_grad():
            return torch.autograd.grad(ref.burst_gather_ref(table, idx),
                                       table, dout)
    plain = time_ms(plain_fn, flush)
    idx64, doutf = idx.long(), dout.float()
    lib = time_ms(lambda: torch.zeros((tokens, d), dtype=torch.float32,
                                      device="cuda").index_add_(
        0, idx64, doutf), flush)
    nbytes = 2 * dout.numel() + 4 * idx.numel() + 2 * tokens * d
    b_ms, b_by = bound(dout.numel(), nbytes)
    _phase(f"time burst_gather_bwd[dispatch] N={idx.numel()} "
           f"({bg.bwd_path(idx.numel())}) into ({tokens}, {d}) bf16: "
           f"{ms:.4f} ms, plain {plain:.4f} ms, index_add_ into f32 "
           f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
           f"{nbytes / 1e6:.1f} MB); by stage (profiler, ms a call) "
           f"{_split_text(split)}")
    gather = _row("burst_gather_bwd[dispatch]", "src/repro/kernels/"
                  "burst_gather.py:59", dispatch_err, ms, plain, lib, b_ms,
                  b_by)
    gather.update(kernels_ms=split, path="multi_block")
    del idx, dout, table, idx64, doutf
    torch.cuda.empty_cache()
    return [row, gather]


#: the scans' backward FLOPs a state element and step: mamba2 12 (the
#: state's step 3, the gradient g 2, its sums against B and h_{t-1} 4, its
#: products into dB and dC 2, the carry 1), rwkv6 15 (the state's step 3,
#: G's sums against v and S_{t-1} and dy's against S_{t-1} 6, the dv term
#: 3, the carry 3)
SCAN_BWD_FLOPS = {"mamba2_scan_bwd": 12, "rwkv6_scan_bwd": 15}


def scan_bwd_rows(errs, flush, gen):
    """The kernels line's rows of the scans' backward at the train runs'
    shapes (``profile_bwd``'s inputs: zamba2-7b's M layers, B 4, S 1024,
    112 heads, P 64, N 64, and rwkv6-1.6b's, 32 heads, D 64, bf16, no state
    and no final-state gradient, as the models call them).  Plain: autograd
    through ``ref.*_scan_ref``; library: none (PyTorch has no call for
    either gradient).  Bound: bytes, each input (dy among them) read once
    and each gradient written once, or the f32 FLOPs of
    ``SCAN_BWD_FLOPS`` at the bf16 tensor-core peak; the line also gives
    them at the f32 FMA peak.  Each row keeps the device time of each
    kernel it launched (``kernels_ms``: mamba2's chunked path the states
    pass ``mamba2_chunked<.., true>``, ``mamba2_bwd_chunked`` and
    ``mamba2_bwd_sum``; rwkv6's ``rwkv6_bwd_scan`` and ``rwkv6_bwd_sum``)
    and the path (``bwd_schedule``)."""
    rows = []
    cases = (("mamba2_scan_bwd", m2.mamba2_scan_bwd, ref.mamba2_scan_ref,
              mamba2_bwd_inputs, lambda a: a[0].numel() * a[3].shape[-1],
              "src/repro/kernels/mamba2_scan.py:71"),
             ("rwkv6_scan_bwd", r6.rwkv6_scan_bwd, ref.rwkv6_scan_ref,
              rwkv6_bwd_inputs, lambda a: a[0].numel() * a[0].shape[-1],
              "src/repro/kernels/rwkv6_scan.py:76"))
    for (name, fn, plain_fn, inputs, elems, replaces), err in zip(cases,
                                                                   errs):
        args = inputs(gen)
        *fwd_args, dy = args

        def kernel(fn=fn, args=args):
            return fn(*args)

        def plain(plain_fn=plain_fn, fwd_args=fwd_args, dy=dy):
            # the inputs' gradients (no state goes in)
            return _scan_bwd.plain_vjp(plain_fn, fwd_args[:5], (dy, None))
        ms = time_ms(kernel, flush)
        split = kernel_split(kernel)
        plain_ms = time_ms(plain, flush, reps=2)
        out = kernel()
        nbytes = _nbytes(*args, *out)
        flops = SCAN_BWD_FLOPS[name] * elems(args)
        b_ms, b_by = bound(flops, nbytes)
        shape = tuple(args[0].shape)
        path = m2.bwd_schedule(args[0].dtype, shape[1]) \
            if name == "mamba2_scan_bwd" else "sequential"
        _phase(f"time {name}[train] {shape} bf16 ({path}): {ms:.4f} ms, "
               f"plain {plain_ms:.3f} ms, library none, bound {b_ms:.4f} ms "
               f"({b_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
               f"f32 FMA floor {flops / PEAK_F32_FLOPS * 1e3:.4f} ms; by "
               f"kernel (profiler, ms a call) {_split_text(split)}")
        rows.append(_row(name, replaces, err, ms, plain_ms, None, b_ms,
                         b_by))
        rows[-1]["kernels_ms"] = split
        rows[-1]["path"] = path
        del args, fwd_args, dy, out
        torch.cuda.empty_cache()
    return rows


def _split_text(split):
    return ", ".join(f"{k} {v:.4f}" for k, v in split.items())


def check_build_report():
    """Registers and spills (``ptxas -v``) and tensor-core instructions
    (HMMA/HGMMA lines of ``cuobjdump -sass``) of every kernel.  The bf16
    prefill must run on the tensor cores at every head-size bucket, and
    must not spill at DP <= 128, which covers the served head sizes; the
    bf16 backward's three passes must run on them at DP 64 and 128."""
    for name in _build.SOURCES:
        for kernel, r in sorted(_build.kernel_report(name).items()):
            _phase(f"ptxas {name}.cu {kernel}: {r.get('registers')} "
                   f"registers, spill stores {r.get('spill_stores')} B, "
                   f"spill loads {r.get('spill_loads')} B; SASS HMMA/HGMMA "
                   f"{r.get('tensor_core')} (HGMMA {r.get('hgmma')})")
    # the bf16 grouped matmul at prefill and training, and its backward's
    # dX (w read transposed) and dW (x^T, M-major from shared memory)
    gmm_report = _build.kernel_report("moe_gmm")
    gmm_kernels = (("gmm_wgmma<128, 256, 4>", "the product"),
                   ("gmm_wgmma<64, 128, 4>", "the product at 64-row tiles"),
                   ("gmm_dx_wgmma<128, 256>", "its dX"),
                   ("gmm_dx_wgmma<64, 128>", "its dX at 64-row tiles"),
                   ("gmm_dw_wgmma", "its dW"))
    for kernel, what in gmm_kernels:
        gmm_r = gmm_report.get(kernel, {})
        if not gmm_r.get("hgmma") or gmm_r.get("spill_stores") or \
                gmm_r.get("spill_loads"):
            raise AssertionError(f"{kernel}, {what} of the bf16 grouped "
                                 f"matmul, needs HGMMA and no spill: {gmm_r}")
    _phase(f"check {', '.join(k for k, _ in gmm_kernels)}: HGMMA in their "
           f"SASS, no spill ok")
    # zamba2-7b's bf16 prefill scan runs on the tensor cores
    ssd = _build.kernel_report("mamba2_scan").get(
        "mamba2_chunked<1, 1, 0>", {})
    if not ssd.get("tensor_core") or ssd.get("spill_stores") or \
            ssd.get("spill_loads"):
        raise AssertionError(f"mamba2_chunked<1, 1, 0>, the bf16 chunked "
                             f"SSD scan, needs HMMA/HGMMA and no spill: "
                             f"{ssd}")
    _phase("check mamba2_chunked<1, 1, 0>: HMMA/HGMMA in its SASS, no spill "
           "ok")
    # and its backward, the chunked path at N <= 64 (zamba2-7b's training)
    ssd_bwd = _build.kernel_report("mamba2_scan").get(
        "mamba2_bwd_chunked<1, 1>", {})
    if not ssd_bwd.get("hgmma") or ssd_bwd.get("spill_stores") or \
            ssd_bwd.get("spill_loads"):
        raise AssertionError(f"mamba2_bwd_chunked<1, 1>, the bf16 chunked "
                             f"SSD backward, needs HGMMA and no spill: "
                             f"{ssd_bwd}")
    _phase("check mamba2_bwd_chunked<1, 1>: HGMMA in its SASS, no spill ok")
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
    # the bf16 backward at DP <= 128 runs its three passes (dV, dK, dQ) on
    # the tensor cores
    for dp in (64, 128):
        for kernel in (f"flash_bwd_kv_wg<{dp}, 1>", f"flash_bwd_kv_wg<{dp}, 0>",
                       f"flash_bwd_dq_wg<{dp}>"):
            if not attn.get(kernel, {}).get("hgmma"):
                raise AssertionError(f"{kernel}: no HGMMA in its SASS")
    _phase("check flash_bwd_kv_wg (dV, dK) / flash_bwd_dq_wg: HGMMA in the "
           "SASS at DP 64 and 128 ok")


def check_no_sync(params, cfg, prompts, extra=None):
    """The cache's set-up (with whisper's encoder), a prefill and a decode
    step under PyTorch's sync debug mode set to "error": the serving path
    never makes the host wait for the card (``.item()``, ``nonzero``, a
    copy to the host, ``torch.bincount``)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cache = lm.init_cache(params, cfg, B, PROMPT + 1, device="cuda",
                              extra=extra)
        logits, cache = lm.step(params, cfg, cache, prompts)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        lm.step(params, cfg, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _phase(f"check {cfg.name}: a prefill and a decode step ran with no "
           f"host sync ok")


def check_cache_f32(params, cfg, prompts, extra=None):
    """The f32 cache check; widens ``params`` in place."""
    params.to(torch.float32)
    torch.cuda.empty_cache()
    check_cache("f32", params, cfg, prompts,
                serve.generate(params, cfg, prompts, 1, extra=extra), extra)



# ---------------------------------------------------------------------------
# dist: the distributed runtime (repro_torch.launch.steps)
# ---------------------------------------------------------------------------

#: the distributed runtime's full-width runs: granite-8b at the train
#: phase's depth (8 of 36 layers), B 8 x S 1024 in 8 microbatches of one
#: row, 3 steps a builder at the reference's lr 3e-4
DIST_DEPTH, DIST_B, DIST_S, DIST_MICRO, DIST_STEPS = 8, 8, 1024, 8, 3
DIST_LR = 3e-4
#: the f32 check: granite-8b-reduced on ``check_train_reference``'s
#: batch (B 2 x S 128 of SyntheticTokens seed 3) and rate (1e-3), in 2
#: microbatches
DIST_REF_B, DIST_REF_S, DIST_REF_MICRO, DIST_REF_LR = 2, 128, 2, 1e-3
#: step 1's bf16 loss and grad norm of a two-rank run against the one-rank
#: run's, on the same weights and batch.  Under tp 2 each layer's attention
#: and MLP outputs are two bf16 partial sums added after rounding, where one
#: rank rounds the whole sum once: one more bf16 rounding (2^-8 relative)
#: of both sublayers in each of the 8 layers, and the vocab-parallel cross
#: entropy sums its shards in another order.  Those roundings are
#: independent across the 8,192 tokens and largely cancel in the mean:
#: the NVIDIA H100 80GB HBM3 (700 W) read a loss gap of 1.9e-4 (tp 2) and
#: 0 (2 stages) and grad norms 3.7e-5 and 4.8e-6 apart (relative), so the
#: bounds are 5x and 27x those readings.  The loss at random weights sits
#: near ln 49,152 = 10.8 whatever the layers do: the grad norm is the
#: check that reads them.
DIST_BF16_LOSS, DIST_BF16_NORM_REL = 1e-3, 1e-3
#: the f32 step's grad norm against the reference's, relative (the
#: gradients' own f32 bounds allow about that much)
DIST_F32_NORM_REL = 1e-5
#: AdamW's eps and weight decay (``optim.adamw_update``'s defaults)
ADAM_EPS, ADAM_WD = 1e-8, 0.1
#: serving through ``build_baseline_serve``: granite-8b-reduced, B 2,
#: a 24-token prefill then 8 decode steps, teacher-forced against
#: ``lm.step`` on the CPU at ``REF_ATOL``
DIST_SERVE_B, DIST_SERVE_PROMPT, DIST_SERVE_STEPS = 2, 24, 8
#: seconds the two ranks sharing the card may take in all
DIST_TIMEOUT = 300
#: the groups: NCCL with one rank in this process, then gloo with two
#: ranks (two processes) sharing the card, which NCCL refuses.  Each train
#: run is (name, builder, mesh (data, model), stages of its plan).
DIST_GROUPS = {
    "nccl-1": dict(backend="nccl", world=1, train=(
        ("baseline", "baseline", (1, 1), None),
        ("tapa-1-stage", "tapa", (1, 1), 1)), serve=(1, 1)),
    "gloo-2": dict(backend="gloo", world=2, train=(
        ("baseline-tp2", "baseline", (1, 2), None),
        ("tapa-2-stages", "tapa", (1, 2), 2)), serve=(1, 2),
        # the f32 check alone at data 2 (one row a rank, one microbatch):
        # the batch split, the grads' average and ZeRO-1's AdamW slices
        f32_only=(("baseline-dp2", "baseline", (2, 1), None, 1),)),
}
#: a two-rank run against this one-rank run
DIST_PAIRS = {"baseline-tp2": "baseline", "tapa-2-stages": "tapa-1-stage",
              "baseline-dp2": "baseline"}


def _dist_cfg():
    full = configs.get(TRAIN_ARCH)
    return dataclasses.replace(
        full, name=f"{TRAIN_ARCH} at {DIST_DEPTH} of {full.n_layers} layers",
        n_layers=DIST_DEPTH)


def _dist_plan(cfg, n_stages):
    """A plan of ``n_stages`` stages on slots (0, 0), (0, 1), ..., each
    boundary of depth 2 (two skew ticks)."""
    from repro_torch.distributed.sharding import TpuPlan
    n_groups = cfg.n_layers // len(cfg.layer_pattern)
    return TpuPlan(mode="tapa", n_stages=n_stages,
                   groups_per_stage=n_groups // n_stages,
                   stage_slots=[(0, c) for c in range(n_stages)],
                   boundary_depth=[2] * (n_stages - 1), tp=1,
                   crossing_cost=0.0)


def _dist_step(builder, cfg, mesh_shape, stages, device_type, *, B, S,
               n_micro, lr):
    from repro_torch.distributed.taskgraph import ShapeCell
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(mesh_shape, ("data", "model"), device_type=device_type)
    cell = ShapeCell("dist", S, B, "train")
    if builder == "baseline":
        return steps.build_baseline_train(cfg, mesh, cell, n_micro=n_micro,
                                          lr=lr)
    return steps.build_tapa_train(cfg, mesh, cell, plan=_dist_plan(
        cfg, stages), n_micro=n_micro, lr=lr)


def _dist_batch(step, toks):
    """A numpy (B, S + 1) batch as the step takes it: (n_micro, B /
    n_micro, S + 1) for the pipeline."""
    t = torch.from_numpy(toks)
    if step.mode == "tapa":
        t = t.reshape(step.n_micro, -1, t.shape[-1])
    return {"tokens": t}


def _dist_reference_run(builder, mesh_shape, stages, device_type,
                        n_micro=DIST_REF_MICRO):
    """granite-8b-reduced in f32 through the builder: the loss, every
    gradient, the grad norm and every parameter after the step,
    gathered."""
    cfg = configs.get_reduced(TRAIN_ARCH)
    step = _dist_step(builder, cfg, mesh_shape, stages, device_type,
                      B=DIST_REF_B, S=DIST_REF_S, n_micro=n_micro,
                      lr=DIST_REF_LR)
    params = step.shard(lm.init_params(cfg, seed=0, device="cpu").to(
        torch.float32))
    opt = step.init_opt(params)
    toks = SyntheticTokens(cfg.vocab, seed=3).batch(0, 0, DIST_REF_B,
                                                     DIST_REF_S)
    loss, grads = step.loss_and_grads(params, _dist_batch(step, toks))
    full_grads = step.gather(grads)
    gn = step.apply(params, opt, grads)
    return {"loss": float(loss), "grads": full_grads, "grad_norm": float(gn),
            "params": step.gather(dict(params.named_parameters())),
            "data": step.ranks.data.size}


def _zero_counts():
    for fn in COUNTERS.values():
        fn.launches = 0
    bg.burst_gather_bwd.one_block_launches = 0
    bg.burst_gather_bwd.multi_block_launches = 0


def _counts():
    out = {n: fn.launches for n, fn in COUNTERS.items()}
    out["burst_gather_bwd/one_block"] = bg.burst_gather_bwd.one_block_launches
    out["burst_gather_bwd/multi_block"] = \
        bg.burst_gather_bwd.multi_block_launches
    return out


def _dist_train_run(builder, mesh_shape, stages, device_type):
    """The main path: granite-8b at ``DIST_DEPTH`` layers, full width,
    ``DIST_STEPS`` steps of B ``DIST_B`` x S ``DIST_S``.  Returns the
    losses, norms, step seconds, peak memory and launches of this rank."""
    cfg = _dist_cfg()
    step = _dist_step(builder, cfg, mesh_shape, stages, device_type,
                      B=DIST_B, S=DIST_S, n_micro=DIST_MICRO, lr=DIST_LR)
    whole = lm.init_params(cfg, seed=0, device="cuda")
    params = step.shard(whole)
    del whole
    torch.cuda.empty_cache()
    # the peak of training, not of the whole model made to be cut
    torch.cuda.reset_peak_memory_stats()
    opt = step.init_opt(params)
    out = {"losses": [], "grad_norms": [], "step_s": []}
    _zero_counts()
    for i in range(DIST_STEPS):
        toks = SyntheticTokens(cfg.vocab, seed=0).batch(i, 0, DIST_B, DIST_S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, _dist_batch(step, toks))
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
    out["launches"] = _counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["layout"] = {"stage": step.ranks.stage.size,
                     "data": step.ranks.data.size,
                     "tp": step.ranks.tp.size,
                     "first_layer": step.first_layer,
                     "layers": len(params.layers)}
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def _dist_serve_run(mesh_shape, device_type):
    """``build_baseline_serve`` on granite-8b-reduced in bf16: prefill
    then decode, each step's logits of this rank's rows against
    ``lm.step`` on the CPU (same weights), teacher-forced, within
    ``REF_ATOL``.  Returns the worst error and the launches."""
    from repro_torch.distributed.taskgraph import ShapeCell
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    cfg = configs.get_reduced(TRAIN_ARCH)
    n = DIST_SERVE_PROMPT + DIST_SERVE_STEPS
    mesh = make_mesh(mesh_shape, ("data", "model"), device_type=device_type)
    step = steps.build_baseline_serve(
        cfg, mesh, ShapeCell("dist-serve", n, DIST_SERVE_B, "prefill"))
    cpu = lm.init_params(cfg, seed=0, device="cpu")
    params = step.shard(cpu)
    cache = step.init_cache(params, DIST_SERVE_B, n + 1)
    want_cache = lm.init_cache(cpu, cfg, DIST_SERVE_B, n + 1, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (DIST_SERVE_B, n),
                           generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    rows = step.rows(DIST_SERVE_B)
    feeds = [tokens[:, :DIST_SERVE_PROMPT]] + [
        tokens[:, i:i + 1] for i in range(DIST_SERVE_PROMPT, n)]
    worst = 0.0
    _zero_counts()
    for t in feeds:
        got, cache = step(params, cache, t)
        want, want_cache = lm.step(cpu, cfg, want_cache, t)
        err = _max_err(got.cpu(), want[rows])
        if not (err <= REF_ATOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"dist serve {mesh_shape}: logits off by "
                                 f"{err} > {REF_ATOL}")
        worst = max(worst, err)
    return {"err": worst, "launches": _counts(), "steps": len(feeds)}


def dist_group(name, device_type):
    """Every run of group ``name`` on this rank (the group is
    initialised): each train run's f32 check, then its main path; then
    serving."""
    spec = DIST_GROUPS[name]
    out = {"train": {}, "f32_only": {}, "serve": None,
           "rank": torch.distributed.get_rank()}
    for run, builder, mesh_shape, stages, n_micro in spec.get("f32_only",
                                                              ()):
        out["f32_only"][run] = _dist_reference_run(
            builder, mesh_shape, stages, device_type, n_micro)
    for run, builder, mesh_shape, stages in spec["train"]:
        ref_run = _dist_reference_run(builder, mesh_shape, stages,
                                      device_type)
        main = _dist_train_run(builder, mesh_shape, stages, device_type)
        out["train"][run] = {"ref": ref_run, "main": main}
        _phase(f"dist {name} rank {out['rank']} {run}: layout "
               f"{main['layout']}, losses "
               f"{[round(x, 4) for x in main['losses']]}, step s "
               f"{[round(x, 4) for x in main['step_s']]}, peak "
               f"{main['peak_gb']:.2f} GB")
    out["serve"] = _dist_serve_run(spec["serve"], device_type)
    return out


def dist_child(argv):
    """One rank of the gloo group sharing the card: ``chip_smoke.py
    --dist-child DIR RANK WORLD``."""
    tmp, rank, world = Path(argv[0]), int(argv[1]), int(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank,
        world_size=world)
    out = dist_group("gloo-2", "cpu")
    torch.save(out, tmp / f"out{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _dist_children(tmp, world):
    """Run the gloo group's ranks as processes of this script, each under
    ``DIST_TIMEOUT``; a rank that fails or hangs ends them all.  Returns
    each rank's output; their logs are printed."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--dist-child", str(tmp), str(r), str(world)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DIST_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for log in logs:
        for line in log.read_text(errors="replace").splitlines():
            print(f"[{log.stem}] {line}", flush=True)
    if any(p.returncode for p in procs):
        raise AssertionError(f"dist: the gloo group's ranks exited "
                             f"{[p.returncode for p in procs]} (timeout "
                             f"{DIST_TIMEOUT} s)")
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def check_dist_attention(gen):
    """``flash_attention`` and its backward at granite-8b's heads under tp
    2 (16 query, 4 KV heads, D 128) on one microbatch row (S 1024), against
    the plain version (bf16 2e-2)."""
    q, do = (_rand((1, DIST_S, 16, 128), gen) for _ in range(2))
    k, v = (_rand((1, DIST_S, 4, 128), gen) for _ in range(2))
    err = _assert_close("flash_attention[dist tp 2: 16 / 4 heads]",
                        fa.flash_attention(q, k, v, causal=True),
                        ref.attention_ref(q, k, v, causal=True), BF16_TOL)
    got = _attn_grads(fa.flash_attention, q, k, v, do, causal=True)
    want = _attn_grads(ref.attention_ref, q, k, v, do, causal=True)
    for g, a, w in zip(("dq", "dk", "dv"), got, want):
        err = max(err, _assert_close(
            f"flash_attention_bwd[dist tp 2: 16 / 4 heads] {g}", a, w,
            BF16_TOL))
    return err


def _dist_train_want(main):
    """The launches a rank's train run must make: an attention a layer and
    microbatch, twice with the group's recomputation, its backward once;
    the embedding's gather and its backward (one block: 1,025 ids) a
    microbatch on the first stage."""
    want = dict.fromkeys(_counts(), 0)
    n = DIST_STEPS * DIST_MICRO
    lay = main["layout"]
    first = n if lay["first_layer"] == 0 else 0
    want.update({"flash_attention": 2 * n * lay["layers"],
                 "flash_attention_bwd": n * lay["layers"],
                 "burst_gather": first, "burst_gather_bwd": first,
                 "burst_gather_bwd/one_block": first})
    return want


def _dist_serve_want(steps):
    """A rank's serving: an attention a layer for the prefill, a decode
    attention a layer a decode step, a gather a step."""
    cfg = configs.get_reduced(TRAIN_ARCH)
    want = dict.fromkeys(_counts(), 0)
    want.update(flash_attention=cfg.n_layers,
                decode_attention=cfg.n_layers * (steps - 1),
                burst_gather=steps)
    return want


def _grad_norm(grads):
    return math.sqrt(sum(float(g.double().pow(2).sum())
                         for g in grads.values()))


def _first_step_bound(grad, gn, lr):
    """Per entry: how far one AdamW step (after the clip to norm 1) of a
    run may land from the reference's, given that its gradient is within
    ``check_train_reference``'s bound of ``grad`` and its norm within
    ``DIST_F32_NORM_REL`` of ``gn``.  At step 1 AdamW moves an entry by
    lr (f(c g) + wd p), c the clip's scale and f(x) = x / (|x| + eps); the
    two runs' c g differ by at most d = c (tol + rel (|g| + tol)), so their
    updates by at most lr d eps / (max(c |g| - d, 0) + eps)^2 (the slope
    of f over the interval), and never more than 2 lr; 1e-6 more for the
    f32 roundings.  Far below lr wherever a gradient stands clear of its
    tolerance."""
    c = min(1.0, 1.0 / max(gn, 1e-9))
    g = grad.double()
    tol = TRAIN_REF_GRAD_REL * float(g.abs().max()) + TRAIN_REF_GRAD_ABS
    d = c * (tol + DIST_F32_NORM_REL * (g.abs() + tol))
    slope = d * ADAM_EPS / ((c * g.abs() - d).clamp(min=0) + ADAM_EPS) ** 2
    return lr * slope.clamp(max=2.0) + 1e-6


def _check_dist_ref(label, got, want, start, lr):
    """An f32 run's loss, gradients, grad norm and params after one step
    against ``want``'s, at ``check_train_reference``'s bounds for the loss
    and gradients, ``DIST_F32_NORM_REL`` for the norm, and each parameter
    entry within ``_first_step_bound`` both of ``want``'s and of AdamW's
    first step written out from ``start`` (so each entry moved from where
    it started by its lr (f + wd p)), with at least 90 % of each
    parameter's entries held within lr / 10 (granite-8b-reduced: over
    99 %), so that no slice of ZeRO-1 can be skipped unseen."""
    if not abs(got["loss"] - want["loss"]) <= TRAIN_REF_LOSS_TOL:
        raise AssertionError(f"{label}: loss {got['loss']} vs "
                             f"{want['loss']}")
    if set(got["grads"]) != set(want["grads"]):
        raise AssertionError(f"{label}: gradients of other parameters")
    worst = 0.0
    for n, w in want["grads"].items():
        err = float((got["grads"][n].float() - w.float()).abs().max())
        lim = TRAIN_REF_GRAD_REL * float(w.abs().max()) + TRAIN_REF_GRAD_ABS
        if not err <= lim:
            raise AssertionError(f"{label}: grad {n} off by {err} > {lim}")
        worst = max(worst, err / lim)
    gn = _grad_norm(want["grads"])
    if not abs(got["grad_norm"] - gn) <= DIST_F32_NORM_REL * gn:
        raise AssertionError(f"{label}: grad norm {got['grad_norm']} vs "
                             f"{gn}")
    c = min(1.0, 1.0 / max(gn, 1e-9))
    p_worst, held = 0.0, 1.0
    for n, w in want["params"].items():
        bound = _first_step_bound(want["grads"][n], gn, lr)
        p0, g = start[n].double(), want["grads"][n].double()
        written = p0 - lr * (c * g / (c * g.abs() + ADAM_EPS) + ADAM_WD * p0)
        p = got["params"][n].double()
        for ref_p, what in ((w.double(), "the reference's step"),
                            (written, "AdamW's first step written out")):
            over = float(((p - ref_p).abs() - bound).max())
            if over > 0:
                raise AssertionError(f"{label}: {n} after the step off "
                                     f"{what} by {over} over its bound")
        p_worst = max(p_worst, float((p - w.double()).abs().max()))
        held = min(held, float((bound <= lr / 10).double().mean()))
    if held < 0.9:
        raise AssertionError(f"{label}: only {held:.3f} of a parameter's "
                             f"entries held within lr / 10")
    _phase(f"check dist {label}: f32 loss {got['loss']:.7f} / "
           f"{want['loss']:.7f} (<= {TRAIN_REF_LOSS_TOL}); "
           f"{len(want['grads'])} grads within {TRAIN_REF_GRAD_REL} x "
           f"largest + {TRAIN_REF_GRAD_ABS} (worst {worst:.3f} of its "
           f"bound); grad norm {got['grad_norm']:.6f} / {gn:.6f}; params "
           f"after one step max diff {p_worst:.2e}, each entry within its "
           f"first-step bound ({held:.4f} of each parameter within lr / "
           f"10) ok")


def dist_phase(tmp, gen):
    """The distributed runtime on the card: flash attention at tp 2's
    local heads; a one-rank NCCL group in this process (the baseline and
    a one-stage pipeline, each first in f32 on granite-8b-reduced against
    ``train.train_step``'s loss, gradients and update, then 3 full-width
    steps of granite-8b at 8 layers; serving); then a two-rank gloo group
    sharing the card (tp 2, 2 stages): the f32 runs against the one-rank
    runs, step 1's loss and grad norm within ``DIST_BF16_LOSS`` and
    ``DIST_BF16_NORM_REL`` of theirs; data 2 (ZeRO-1) in f32 alone;
    serving.
    Checks each rank's exact launches.  Prints the ``dist`` line; returns
    the launches of the main path (full-width steps and serving), summed
    over every rank."""
    check_dist_attention(gen)
    # the train path's reference: lm.loss_fn and train.train_step
    cfg = configs.get_reduced(TRAIN_ARCH)
    cpu = lm.init_params(cfg, seed=0, device="cpu").to(torch.float32)
    start = {n: p.detach() for n, p in cpu.named_parameters()}
    gpu = lm.LM(cfg, "cuda").to(torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(SyntheticTokens(cfg.vocab, seed=3).batch(
        0, 0, DIST_REF_B, DIST_REF_S))
    loss, grads, _ = _train_ref_step(gpu, cfg, toks, None, "cuda")
    ref_step = {"loss": loss, "grads": grads,
                "params": {n: p.detach().cpu() for n, p in
                           gpu.named_parameters()}}
    del gpu
    results = {}
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{tmp}/nccl_store", rank=0,
        world_size=1)
    try:
        results["nccl-1"] = [dist_group("nccl-1", "cuda")]
    finally:
        torch.distributed.destroy_process_group()
    # the two ranks need the card's memory: this process lets go of its own
    gc.collect()
    torch.cuda.empty_cache()
    _phase(f"dist: this process keeps {torch.cuda.memory_reserved() / 1e9:.2f}"
           f" GB reserved while the gloo group runs")
    results["gloo-2"] = _dist_children(tmp, DIST_GROUPS["gloo-2"]["world"])
    one = results["nccl-1"][0]["train"]
    for run in one:
        _check_dist_ref(f"nccl-1 {run} vs train.train_step", one[run]["ref"],
                        ref_step, start, DIST_REF_LR)
    two = results["gloo-2"][0]
    for run, base in DIST_PAIRS.items():
        if run in two["f32_only"]:
            if two["f32_only"][run]["data"] != 2:
                raise AssertionError(f"dist {run}: "
                                     f"{two['f32_only'][run]['data']} data "
                                     f"ranks, not 2")
            _check_dist_ref(f"gloo-2 {run} vs nccl-1 {base}",
                            two["f32_only"][run], one[base]["ref"], start,
                            DIST_REF_LR)
            continue
        _check_dist_ref(f"gloo-2 {run} vs nccl-1 {base}",
                        two["train"][run]["ref"], one[base]["ref"], start,
                        DIST_REF_LR)
        want = one[base]["main"]
        for rank_out in results["gloo-2"]:
            main = rank_out["train"][run]["main"]
            d = abs(main["losses"][0] - want["losses"][0])
            rel = abs(main["grad_norms"][0] - want["grad_norms"][0]) / \
                want["grad_norms"][0]
            if not (d <= DIST_BF16_LOSS and rel <= DIST_BF16_NORM_REL):
                raise AssertionError(
                    f"dist {run}: step-1 loss {main['losses'][0]} and grad "
                    f"norm {main['grad_norms'][0]} vs one rank's "
                    f"{want['losses'][0]} and {want['grad_norms'][0]}")
        main = two["train"][run]["main"]
        _phase(f"check dist {run}: step-1 bf16 loss "
               f"{main['losses'][0]:.5f} vs nccl-1 {base} "
               f"{want['losses'][0]:.5f} (|diff| <= {DIST_BF16_LOSS}), grad "
               f"norm {main['grad_norms'][0]:.5f} vs "
               f"{want['grad_norms'][0]:.5f} (relative <= "
               f"{DIST_BF16_NORM_REL}) ok")
    launches = dict.fromkeys(_counts(), 0)
    line = []
    tokens = DIST_B * DIST_S
    for group, ranks in results.items():
        for run in ranks[0]["train"]:
            mains = [r["train"][run]["main"] for r in ranks]
            for r, main in zip(ranks, mains):
                if main["launches"] != _dist_train_want(main):
                    raise AssertionError(
                        f"dist {group} {run} rank {r['rank']}: launches "
                        f"{main['launches']}, want {_dist_train_want(main)}")
                if not all(math.isfinite(x) for x in main["losses"]
                           + main["grad_norms"]):
                    raise AssertionError(f"dist {group} {run}: not finite")
                for k, v in main["launches"].items():
                    launches[k] += v
            steady = statistics.median(
                max(m["step_s"][i] for m in mains)
                for i in range(1, DIST_STEPS))
            line.append({
                "group": group, "run": run, "layout": mains[0]["layout"],
                "losses": mains[-1]["losses"],
                "grad_norms": mains[-1]["grad_norms"],
                "step_s": [max(m["step_s"][i] for m in mains)
                           for i in range(DIST_STEPS)],
                "steady_step_s": steady, "tokens_per_s": tokens / steady,
                "peak_gb_per_rank": [m["peak_gb"] for m in mains],
                "launches_per_rank": [
                    {k: v for k, v in m["launches"].items() if v}
                    for m in mains]})
        serves = [r["serve"] for r in ranks]
        for r, s in zip(ranks, serves):
            if s["launches"] != _dist_serve_want(s["steps"]):
                raise AssertionError(
                    f"dist {group} serve rank {r['rank']}: launches "
                    f"{s['launches']}, want {_dist_serve_want(s['steps'])}")
            for k, v in s["launches"].items():
                launches[k] += v
        line.append({"group": group, "run": "serve",
                     "max_abs_err": max(s["err"] for s in serves),
                     "atol": REF_ATOL,
                     "launches_per_rank": [
                         {k: v for k, v in s["launches"].items() if v}
                         for s in serves]})
        _phase(f"check dist {group} serve: teacher-forced logits vs "
               f"lm.step on the CPU, max_abs_err "
               f"{max(s['err'] for s in serves):.3e} (atol {REF_ATOL}) ok")
    _phase("dist " + json.dumps({"device": torch.cuda.get_device_name(0),
                                 "B": DIST_B, "S": DIST_S,
                                 "n_micro": DIST_MICRO, "runs": line}))
    return launches


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
    coopt_launches = coopt_phase(flush)
    search_launches = search_phase(flush)
    corpus_launches = corpus_phase()

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_attention(gen)
    scan_errs = check_scans(gen)
    moe_errs = check_moe_gmm(gen)
    for arch in ARCHS + ATTN_ARCHS:
        check_reference(arch)

    tgen = torch.Generator(device="cuda").manual_seed(11)
    kernels, launches = [], dict.fromkeys(COUNTERS, 0)
    for arch in ARCHS + ATTN_ARCHS:
        params, prompts, counted, extra = serve_phase(arch, gen)
        launches = {n: launches[n] + counted[n] for n in COUNTERS}
        if arch == "granite-8b":
            kernels += granite_rows(params.embed, prompts, errs, flush, tgen)
        cfg = configs.get(arch)
        if arch in F32_DEPTH:
            # f32 weights that do not fit the card: fresh ones at the depth
            # the check can hold, named so on its line
            del params
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(
                cfg, name=f"{arch} at {F32_DEPTH[arch]} of {cfg.n_layers} "
                f"layers", n_layers=F32_DEPTH[arch])
            params = lm.init_params(cfg, seed=0, device="cuda")
        check_cache_f32(params, cfg, prompts, extra)
        del params
        torch.cuda.empty_cache()
    kernels += scan_rows(dict(zip(("mamba2_scan", "rwkv6_scan"), scan_errs)),
                         flush, tgen)
    kernels += moe_rows(moe_errs, flush, tgen)

    # training: the backward kernels against their plain versions, the
    # refusals, the f32 step against the CPU, the restart, then the path
    trgen = torch.Generator(device="cuda").manual_seed(22)
    attn_bwd_err = check_attention_bwd(trgen)
    emb_bwd_err, dispatch_bwd_err = check_gather_bwd(trgen)
    moe_bwd_errs = check_moe_gmm_bwd(trgen)
    train_errs = (attn_bwd_err, emb_bwd_err, *check_scan_bwd(trgen))
    check_scan_bwd_repeats(trgen)
    check_grad_refusals(trgen)
    for arch in TRAIN_REF_ARCHS:
        check_train_reference(arch)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        check_train_restart(Path(tmp))
    check_train_big_batch()
    train_launches = dict.fromkeys(COUNTERS, 0)
    train_paths = {"one_block": 0, "multi_block": 0}
    for arch, depth in TRAIN_RUNS:
        run, paths = train_phase(arch, depth)
        train_launches = {n: train_launches[n] + run[n] for n in COUNTERS}
        train_paths = {p: train_paths[p] + paths[p] for p in train_paths}
    kernels += train_rows(train_errs, flush, trgen)
    kernels += moe_bwd_rows(moe_bwd_errs, dispatch_bwd_err, flush, trgen)
    # the distributed runtime: one rank on NCCL, two sharing the card
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        dist_launches = dist_phase(Path(tmp), trgen)
    # each kernel's launches, summed over the serve, train and dist runs
    # (the gather backward's rows: the train and dist runs' launches on the
    # row's path; serving takes no gradient)
    for row in kernels:
        kernel = row["name"]
        if kernel.startswith("burst_gather_bwd"):
            paths = {"train": train_paths[row["path"]],
                     "dist": dist_launches[f"burst_gather_bwd/{row['path']}"]}
        else:
            paths = {"serve": launches[kernel],
                     "train": train_launches[kernel],
                     "dist": dist_launches.get(kernel, 0)}
        row["launches"] = sum(paths.values())
        if sum(1 for n in paths.values() if n) > 1:
            row["launches_by_path"] = {k: n for k, n in paths.items() if n}
    # the sweep's, from its own main path, the co-optimization flow's, the
    # search's and the corpus's
    sim_row["launches_by_path"] = {"simulate_batch": sim_row["launches"],
                                   "coopt": coopt_launches,
                                   "search": search_launches,
                                   "corpus": corpus_launches}
    sim_row["launches"] += coopt_launches + search_launches + corpus_launches
    kernels.append(sim_row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        sys.exit(dist_child(sys.argv[2:]))
    sys.exit(main())
