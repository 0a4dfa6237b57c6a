"""Runs the port's distributed runtime on a gloo group of CPU processes,
for ``tests/test_torch_dist_*.py``.

``launch(tmp, runs)`` starts ``world`` processes of this file, each one
rank of a gloo group joined through a file store under ``tmp`` (no port
to collide with another test worker), with one thread each, and kills
them all if the group has not finished within ``timeout`` seconds, so a
hang fails one test.  Every rank plays each run of ``runs`` in turn (a
dict with a "kind" that names a function of ``KINDS``, the model's
weights as the JAX package's tree of numpy arrays, and the inputs) and
rank 0 returns what the run gathered.  This file imports no JAX.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def launch(tmp, runs, *, world: int = 4, timeout: float = 240.0):
    """[result of each run] from rank 0 (each rank checks its own part
    too and fails the group if it does not hold)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "runs.pkl", "wb") as f:
        pickle.dump(runs, f)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    logs = [tmp / f"rank{rank}.log" for rank in range(world)]
    procs = []
    for rank in range(world):
        with open(logs[rank], "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(tmp), str(rank), str(world)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    # a rank that fails leaves the others waiting in a collective: end
    # them all at once, or at the time limit
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            why = "a rank failed" if failed else \
                f"the group did not finish in {timeout} s"
            raise AssertionError(f"{why}:\n{_tails(logs)}")
        time.sleep(0.05)
    if any(p.returncode for p in procs):
        raise AssertionError(f"rank exit codes {[p.returncode for p in procs]}"
                             f":\n{_tails(logs)}")
    with open(tmp / "out0.pkl", "rb") as f:
        return pickle.load(f)


#: AdamW's eps and weight decay (``optim.adamw_update``'s defaults)
ADAM_EPS, WEIGHT_DECAY = 1e-8, 0.1
#: the share of each parameter's entries a step check must hold within
#: lr / 10 (those whose gradient stands clear of its tolerance; granite-8b-
#: and granite-moe-reduced hold over 99 %), so that no slice of ZeRO-1 can
#: be skipped unseen
HELD = 0.9


def assert_first_step(got, want, start, grad, grad_norm, *, lr, grad_rel,
                      norm_rel, name):
    """Hold a parameter after one AdamW step (the clip to norm 1 first) of
    a run whose gradient is within ``grad_rel`` of ``grad``'s largest
    entry and whose norm within ``norm_rel`` of ``grad_norm`` against
    ``want``, the reference run's parameter after its step, entry by
    entry; ``start`` is the parameter before the step.

    At step 1 AdamW moves an entry by lr (f(c g) + wd p), with c the clip's
    scale and f(x) = x / (|x| + eps) (m-hat is g and v-hat g^2).  The two
    runs' c g differ by at most d = c (tol + norm_rel (|g| + tol)), so
    their updates by at most lr d sup f' over the interval, where sup f' =
    eps / (max(c |g| - d, 0) + eps)^2, and never by more than 2 lr; 1e-6
    more covers the f32 roundings.  Where a gradient stands clear of its
    tolerance that is far below lr: a slice left as it was, or an update of
    another sign, fails.  ``got`` is held to the same bound against the
    step written out from ``start`` and ``grad`` too, so each entry must
    have moved by its lr (f + wd p) from where it started.  Returns the
    share of entries held within lr / 10."""
    c = min(1.0, 1.0 / max(grad_norm, 1e-9))
    grad = grad.astype(np.float64)
    tol = grad_rel * np.abs(grad).max()
    g = c * np.abs(grad)
    d = c * (tol + norm_rel * (np.abs(grad) + tol))
    slope = d * ADAM_EPS / (np.maximum(g - d, 0.0) + ADAM_EPS) ** 2
    bound = lr * np.minimum(2.0, slope) + 1e-6
    written = start - lr * (c * grad / (g + ADAM_EPS) + WEIGHT_DECAY * start)
    for ref, what in ((want, "the reference's step"),
                      (written, "AdamW's first step written out")):
        err = np.abs(got.astype(np.float64) - ref)
        bad = err > bound
        assert not bad.any(), (
            f"{name}: {int(bad.sum())} of {bad.size} entries off "
            f"{what}, worst {float((err - bound).max())} over the bound")
    return float((bound <= lr / 10).mean())


def _tails(logs):
    return "\n".join(f"--- {log.name}\n"
                     f"{log.read_text(errors='replace')[-3000:]}"
                     for log in logs)


# ---------------------------------------------------------------------------
# inside a rank
# ---------------------------------------------------------------------------

def _config(run):
    from repro_torch import configs
    cfg = configs.get_reduced(run["arch"])
    return dataclasses.replace(cfg, **run.get("overrides", {}))


def _params(run, cfg):
    from repro_torch.model import convert
    dtype = torch.float32 if run.get("dtype") == "f32" else None
    return convert.from_jax_params(run["tree"], cfg, device="cpu",
                                   dtype=dtype)


def _mesh(run):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(run["mesh"], run.get("axes", ("data", "model")),
                     device_type="cpu")


def _cell(run):
    from repro_torch.distributed.taskgraph import ShapeCell
    toks = run["tokens"]
    return ShapeCell("test", toks.shape[-1] - 1,
                     int(np.prod(toks.shape[:-1])), run.get("cell", "train"))


def _numpy(tensors):
    return {k: v.detach().float().numpy() for k, v in tensors.items()}


def train(run):
    """A train step's loss and gradients, then the step: the gathered
    gradients, grad norm and params after the step.  ``memory_f32`` runs
    with ``lm.PDTYPE`` at f32 (the memory is cast to it)."""
    from repro_torch.model import lm
    pdtype = lm.PDTYPE
    if run.get("memory_f32"):
        lm.PDTYPE = torch.float32
    try:
        return _train(run)
    finally:
        lm.PDTYPE = pdtype


def _train(run):
    from repro_torch.distributed.sharding import TpuPlan
    from repro_torch.launch import steps
    cfg = _config(run)
    mesh = _mesh(run)
    cell = _cell(run)
    kw = dict(n_micro=run["n_micro"], device="cpu")
    if run["mode"] == "tapa":
        step = steps.build_tapa_train(cfg, mesh, cell,
                                      plan=TpuPlan(**run["plan"]), **kw)
    else:
        step = steps.build_baseline_train(cfg, mesh, cell, **kw)
    params = step.shard(_params(run, cfg))
    opt = step.init_opt(params)
    batch = {"tokens": torch.from_numpy(run["tokens"])}
    if run.get("extra") is not None:
        batch["extra"] = {k: torch.from_numpy(v)
                          for k, v in run["extra"].items()}
    loss, grads = step.loss_and_grads(params, batch)
    full_grads = step.gather(grads)
    gn = step.apply(params, opt, grads)
    full_params = step.gather(dict(params.named_parameters()))
    return {"loss": float(loss), "grad_norm": float(gn),
            "grads": _numpy(full_grads), "params": _numpy(full_params),
            "layout": {"stage": step.ranks.stage.size,
                       "data": step.ranks.data.size,
                       "tp": step.ranks.tp.size}}


def serve(run):
    """Teacher-forced logits of every feed, this rank's rows, gathered
    over the data ranks in rank order."""
    from repro_torch.distributed.collectives import all_gather
    from repro_torch.launch import steps
    cfg = _config(run)
    mesh = _mesh(run)
    feeds = [torch.from_numpy(t) for t in run["feeds"]]
    B = feeds[0].shape[0]
    cell = _cell({"tokens": run["feeds"][0], "cell": "prefill"})
    step = steps.build_baseline_serve(cfg, mesh, cell, device="cpu")
    params = step.shard(_params(run, cfg))
    cache = step.init_cache(params, B, run["max_seq"])
    out = []
    for t in feeds:
        logits, cache = step(params, cache, t)
        out.append(all_gather(logits, step.ranks.data, 0).float().numpy())
    return {"logits": out, "pos": cache["pos"],
            "heads": params.layers[0].attn.wk.shape[1] // cfg.head_dim}


def refuse(run):
    """The message of each case that must raise ``NotImplementedError``."""
    from repro_torch.launch import steps
    got = []
    for case in run["cases"]:
        cfg = _config(case)
        mesh = _mesh(case)
        cell = _cell({"tokens": np.zeros((8, 17), np.int32),
                      "cell": case.get("cell", "train")})
        try:
            if case["builder"] == "serve":
                steps.build_baseline_serve(cfg, mesh, cell, device="cpu",
                                           kv_shard=case["kv_shard"])
            else:
                steps.build_baseline_train(cfg, mesh, cell, device="cpu")
        except NotImplementedError as e:
            got.append(str(e))
        else:
            got.append(None)
    return {"messages": got}


KINDS = {"train": train, "serve": serve, "refuse": refuse}


def main(argv):
    import torch.distributed as dist
    tmp, rank, world = Path(argv[0]), int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    with open(tmp / "runs.pkl", "rb") as f:
        runs = pickle.load(f)
    try:
        results = [KINDS[run["kind"]](run) for run in runs]
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    if rank == 0:
        with open(tmp / "out0.pkl", "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
