"""Training traffic: ``repro_torch.launch.train.train_step`` back to back,
as ``launch.train.train`` runs it.

Set-up builds one object, the model and its AdamW state with the
benchmark's weights, and drives it through the traffic's first
``check_steps`` steps, fed by the program's ``ShardedLoader`` over the
benchmark's batches.  Those steps are the warm-up of every shape the
window uses, and what the reference follows: their losses, the first
step's gradient as AdamW took it (its first moment over 1 - b1) and each
leaf's change over them.  The window then drives the same object for
``--seconds``, reading each step's loss as ``train`` does, so the host
waits at every step.  A traced run profiles ``trace_steps`` more steps
after the window, recording the device alone, and one more recording the
host's ops too, whose gaps are named by them.  Once the program's state
is freed, the reference (``reference/train.py``, f32) trains the same
weights on the same batches, and the two are compared
(``compare.train_numbers``).
"""
from __future__ import annotations

import gc
import math
import time

import torch

from portbench import compare, devtrace, harness, weights
from portbench.reference import granite
from portbench.reference import train as ref_train
from portbench.reference.precision import F32
from portbench.traffic import TrainTokens


def hyper(traffic: dict) -> dict:
    return {k: traffic[k] for k in ("lr", "clip", "b1", "b2", "eps",
                                    "weight_decay")}


def build(cell: harness.Cell, seed: int, device):
    """The object set-up builds: (step, params, opt, loader), ``step()``
    one ``train_step`` on the loader's next batch, returning its loss."""
    from repro_torch.data import ShardedLoader
    from repro_torch.launch import train as program
    from repro_torch.optim import adamw_init

    m, tr = cell.model, cell.traffic
    pc = harness.program_config(cell.config)
    params = harness.program_params(pc, m, seed, device)
    params.requires_grad_(True)
    opt = adamw_init(dict(params.named_parameters()))
    loader = ShardedLoader(TrainTokens(m["vocab"], seed, tr), shard=0,
                           batch=tr["batch"], seq=tr["seq"])

    def step():
        tokens = torch.from_numpy(next(loader)).to(device)
        loss, _ = program.train_step(params, pc, opt, tokens, tr["lr"])
        return float(loss)

    return step, params, opt, loader


def first_steps(cell: harness.Cell, seed: int, device, step, params,
                opt) -> dict:
    """The traffic's first ``check_steps`` steps: their losses, each leaf's
    norm of the first step's gradient as AdamW took it (its first moment
    over 1 - b1) and of its change over the steps."""
    m, tr = cell.model, cell.traffic
    prog = {"losses": [], "grad_norms": {}, "change_norms": {}}
    for i in range(tr["check_steps"]):
        prog["losses"].append(step())
        if i == 0:
            prog["grad_norms"] = {
                k: float(torch.linalg.vector_norm(mo)) / (1 - tr["b1"])
                for k, mo in opt["m"].items()}
    start = weights.draw(m, seed, device)
    with torch.no_grad():
        prog["change_norms"] = {
            k: float(torch.linalg.vector_norm(p.float() - start[k].float()))
            for k, p in params.named_parameters()}
    return prog


def reference(cell: harness.Cell, seed: int, device, prec=F32,
              fault: str | None = None) -> dict:
    """The reference's first steps from the same weights and batches."""
    m, tr = cell.model, cell.traffic
    granite.strict_f32()
    src = TrainTokens(m["vocab"], seed, tr)
    batches = [torch.from_numpy(src.batch(i, 0, tr["batch"], tr["seq"]))
               .to(device).long() for i in range(tr["check_steps"])]
    out = ref_train.run(m, weights.draw(m, seed, device, torch.float32),
                        batches, hyper(tr), prec, fault=fault)
    harness.free_device()
    return out


def run(cell: harness.Cell, *, seed: int, seconds: float, trace: bool,
        device, t0: float) -> harness.Outcome:
    tr = cell.traffic
    t1 = time.perf_counter()
    step, params, opt, loader = build(cell, seed, device)
    sync(device)
    t2 = time.perf_counter()
    prog = first_steps(cell, seed, device, step, params, opt)
    gc.collect()
    parts = {"weights_s": t2 - t1, "first_steps_s": time.perf_counter() - t2}

    # the window
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    w0 = now = time.perf_counter()
    ends = []
    failed = 0
    while now - w0 < seconds:
        failed += not math.isfinite(step())
        now = time.perf_counter()
        ends.append(now)
    steps, window_s = len(ends), now - w0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    reading = harness.Reading("train", cell.model, tr, window_s, steps)
    if trace:
        reading.trace = devtrace.profile(lambda i: step(),
                                         tr["trace_steps"], device,
                                         host=False)
        reading.host_trace = devtrace.profile(lambda i: step(), 1, device,
                                              host=True)
    loader.close()
    del step, params, opt
    harness.free_device()

    t3 = time.perf_counter()
    ref = reference(cell, seed, device)
    tokens = steps * tr["batch"] * tr["seq"]
    return harness.Outcome(
        end_to_end={"train_tokens_per_s": tokens / window_s,
                    "peak_mem_gb": peak / 1e9, "setup_s": setup_s},
        numbers=compare.train_numbers(prog, ref), attempted=steps,
        failed=failed, memory_peak_bytes=peak, reading=reading,
        notes={"losses": prog["losses"], "ref_losses": ref["losses"],
               "reference_s": time.perf_counter() - t3,
               "step_s": durations(w0, ends)},
        setup_parts=parts)


def durations(start: float, ends: list[float]) -> list[float]:
    """Each unit's seconds in the window, from the ends of the units."""
    return [b - a for a, b in zip([start] + ends[:-1], ends)]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
