"""Serving traffic: ``repro_torch.launch.serve.generate`` calls back to
back, each ``batch`` prompts of ``prompt_len`` ids and ``gen`` greedy
tokens (a closed loop of one client).

Set-up loads the benchmark's weights into the program's model and runs
one call of the window's shapes (the warm-up).  The window sends call 0,
1, ... until ``--seconds`` have passed and ends with the last call's end;
every call's served tokens are kept.  A traced run profiles
``trace_calls`` more calls, recording the device alone, and one more
recording the host's ops too, whose gaps are named by them.  Once the
program's state is freed, a sample of ``sample_requests`` finished
requests drawn from the seed is run through the reference (f32, each
prompt with its served tokens, the whole sequence at once), and each
served token's logit is compared with the reference's best at its
position (``check``).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import compare, devtrace, harness, traffic, weights
from portbench.drivers import train
from portbench.reference import granite
from portbench.reference.precision import F32, FP8

#: the call index of the warm-up's prompts, outside the window's
WARM_CALL = 1 << 30


def build(cell: harness.Cell, seed: int, device):
    """The object set-up builds: ``call(i)``, one ``generate`` call of the
    traffic's ``i``-th prompts on the benchmark's weights."""
    from repro_torch.launch import serve as program

    m, tr = cell.model, cell.traffic
    pc = harness.program_config(cell.config)
    params = harness.program_params(pc, m, seed, device)

    def call(i: int):
        prompts = traffic.prompts(m["vocab"], seed, i, tr, device)
        return program.generate(params, pc, prompts, tr["gen"])

    return call


def check(cell: harness.Cell, seed: int, tokens, device,
          control: bool = False) -> tuple[dict, dict]:
    """(numbers, notes) of the served tokens (calls, B, gen): the widest
    gap of a sample's tokens below the reference's best (``logit_gap``);
    with ``control`` also the gap of the tokens the fp8 reference puts
    first at the same positions (``control_logit_gap``)."""
    P = cell.traffic["prompt_len"]
    seqs = sample(cell, seed, tokens, device)
    ref = reference_logits(cell, seed, seqs, device)
    gaps = compare.token_gaps(ref, seqs[:, P:].to(device))
    numbers = {"logit_gap": float(gaps.max())}
    if control:
        low = reference_logits(cell, seed, seqs, device, FP8)
        numbers["control_logit_gap"] = float(
            compare.token_gaps(ref, low.argmax(-1)).max())
        del low
    del ref
    harness.free_device()
    return numbers, {"requests_compared": seqs.shape[0],
                     "tokens_compared": int(gaps.numel()),
                     "tokens_not_best": int((gaps > 0).sum())}


def run(cell: harness.Cell, *, seed: int, seconds: float, trace: bool,
        device, t0: float) -> harness.Outcome:
    m, tr = cell.model, cell.traffic
    B, P, gen = tr["batch"], tr["prompt_len"], tr["gen"]
    t1 = time.perf_counter()
    call = build(cell, seed, device)
    sync(device)
    t2 = time.perf_counter()
    call(WARM_CALL)
    gc.collect()
    parts = {"weights_s": t2 - t1, "warm_call_s": time.perf_counter() - t2}
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    w0 = now = time.perf_counter()
    served, ends = [], []
    clocks = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0}
    while now - w0 < seconds:
        res = call(len(served))
        served.append(res.tokens.cpu())
        clocks["prefill_s"] += res.prefill_s
        clocks["decode_s"] += res.decode_s
        clocks["decode_steps"] += gen
        del res
        now = time.perf_counter()
        ends.append(now)
    window_s = now - w0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    calls = len(served)
    reading = harness.Reading("serve", m, tr, window_s, calls,
                              program=clocks)
    if trace:
        reading.trace = devtrace.profile(
            lambda i: call(WARM_CALL + 1 + i), tr["trace_calls"], device,
            host=False)
        reading.host_trace = devtrace.profile(
            lambda i: call(WARM_CALL + 1 + tr["trace_calls"]), 1, device,
            host=True)
    del call
    harness.free_device()

    tokens = torch.stack(served)                       # (calls, B, gen)
    failed = int(((tokens < 0) | (tokens >= m["vocab"])).any(-1).sum())
    t3 = time.perf_counter()
    numbers, notes = check(cell, seed, tokens, device)
    return harness.Outcome(
        end_to_end={"serve_tokens_per_s": calls * B * (P + gen) / window_s,
                    "peak_mem_gb": peak / 1e9, "setup_s": setup_s},
        numbers=numbers, attempted=calls * B, failed=failed,
        memory_peak_bytes=peak, reading=reading,
        notes={**notes, "reference_s": time.perf_counter() - t3,
               "call_s": train.durations(w0, ends)},
        setup_parts=parts)


def sample(cell: harness.Cell, seed: int, tokens, device) -> torch.Tensor:
    """A sample drawn from the seed of the finished requests (every
    request is as long as the longest), each prompt with its served tokens:
    (n, prompt_len + gen) int64 on ``device``.  tokens: (calls, B, gen)
    served."""
    m, tr = cell.model, cell.traffic
    calls, B = tokens.shape[:2]
    pick = np.random.default_rng(seed).choice(
        calls * B, size=min(tr["sample_requests"], calls * B), replace=False)
    asked = {c: traffic.prompts(m["vocab"], seed, c, tr, device)
             for c in sorted({int(r) // B for r in pick})}
    return torch.stack([torch.cat([
        asked[int(r) // B][int(r) % B].long(),
        tokens[int(r) // B, int(r) % B].to(device).long()]) for r in pick])


def reference_logits(cell: harness.Cell, seed: int, seqs, device,
                     prec=F32) -> torch.Tensor:
    """The reference's logits at the positions that chose each served
    token of ``seqs``: (n, gen, vocab) f32, from the same weights."""
    m = cell.model
    granite.strict_f32()
    params = weights.draw(m, seed, device, torch.float32)
    out = granite.served_logits(params, m, seqs.to(device),
                                cell.traffic["prompt_len"], prec)
    del params
    harness.free_device()
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
