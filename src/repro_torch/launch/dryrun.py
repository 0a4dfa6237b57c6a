"""Multi-pod dry run: trace one step of every (arch x shape x mesh x mode)
cell on the production mesh (16 x 16 one pod, 2 x 16 x 16 two pods) on
meta stand-ins: no memory, no card.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell on 512 forced host devices.  Here one process joins a fake process
group of 256 (512) ranks as one of them, builds the production mesh and
the cell's step with ``launch.steps``' builders, and calls the step once,
backward and optimizer included, on meta tensors of that rank's shards:
every op runs its meta kernel and every kernel wrapper its shape-only
path (``kernels.shape_only``), so the step's arithmetic and its
collectives are those of the card's run.  (A fake CUDA tensor would do
too on a PyTorch built with CUDA; autograd over one needs CUDA's device
guard, which a CPU build lacks, so the stand-ins are meta tensors.)  The
trace runs under ``FlopCounter`` (``FlopCounterMode``'s formulas), the
collectives' recorder
(``distributed.collectives.recording``) and ``ByteTracker``, and writes
the reference's JSON keys to ``--out``:

  * ``flops``: every op's FLOPs by ``FlopCounterMode``'s formulas (a
    kernel by its own count, ``kernels.costs``); ``aten_flops`` and
    ``kernel_flops`` the two parts; ``kernels`` each kernel's launches
    (its shape-only launches, which its wrapper's counter counts too) and
    FLOPs;
  * ``bytes_accessed``: the operand and result bytes of every dispatched
    op, a kernel counted as one op;
  * ``arg_bytes``: the bytes live when the step is called (this rank's
    parameters, optimizer state or cache, and batch);
  * ``peak_bytes_per_device``: the most bytes live during the step;
  * ``out_bytes``: the bytes of the step's results; ``alias_bytes`` those
    of them that are arguments updated in place (parameters, optimizer
    state, cache); ``temp_bytes`` = peak - arg - (out - alias), so that
    peak = arg + out + temp - alias, the reference's identity;
  * ``collectives``: ``collective_analysis.collective_summary`` of the
    recorded collectives (ICI against DCN by pod);
  * ``beyond_ref_bytes``: the bytes of parameters and optimizer state
    this rank holds beyond the reference's flat-column sharding: the
    attention leaves whose heads split over fewer ranks than tp
    (``tensor_parallel.attn_split``, ``kv_share``) hold a piece on
    ``share`` ranks where the reference cuts their columns over all tp;
  * ``plan`` (tapa mode), and ``trace_s`` in place of ``lower_s`` and
    ``compile_s``.

In tapa mode the first rank of each stage is traced (stages differ: the
first holds the embedding, the last the head) and the largest peak is
reported.  Serving cells run the baseline, as the reference's do.

Usage (no GPU needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh pod [--mode baseline|tapa]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.distributed.sharding import plan_cell, refined_layout
from repro_torch.distributed.taskgraph import SHAPES, ShapeCell
from repro_torch.kernels import shape_only
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.collective_analysis import collective_summary
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.model import lm

# long_500k needs sub-quadratic attention: run for SSM/hybrid and the
# sliding-window-dominant gemmas, as the reference does
LONG_OK = {"zamba2-7b", "rwkv6-1.6b", "gemma2-27b", "gemma3-12b"}
#: the production meshes' shapes (``make_production_mesh``)
MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}


def cells_for(arch: str) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_OK:
        out.append("long_500k")
    return out


# ---------------------------------------------------------------------------
# operations and live bytes
# ---------------------------------------------------------------------------

class FlopCounter(TorchDispatchMode):
    """The FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts (its
    registry of formulas, the kernels' shape-only op among them), without
    its module tracker, whose hooks on the modules' outputs keep every
    layer's outputs alive until the backward and so change what a step
    holds.  ``total``; ``by_op`` {op name: FLOPs}."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.total += n
            name = str(func._overloadpacket)
            self.by_op[name] = self.by_op.get(name, 0) + n
        return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class ByteTracker(TorchDispatchMode):
    """Live bytes of the storages on one device type: each storage is
    counted from the op that makes it (or from ``track``) until it is
    freed (a ``weakref.finalize`` on it), once however many views share
    it.  ``peak`` is the most live after any op; ``accessed`` sums every
    op's tensor operands' and results' bytes."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.live = self.peak = self.accessed = 0
        self._sizes: dict[int, int] = {}

    def track(self, tree) -> int:
        """Count the storages of the tensors in ``tree`` (a step's
        arguments); returns the bytes newly counted."""
        before = self.live
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t)
        self.peak = max(self.peak, self.live)
        return self.live - before

    def _add(self, t) -> None:
        if t.device.type != self.device_type:
            return
        s = t.untyped_storage()
        key = s._cdata
        if key in self._sizes:
            return
        self._sizes[key] = n = s.nbytes()
        self.live += n
        weakref.finalize(s, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    @staticmethod
    def keys(tree) -> set:
        """The storages of the tensors in ``tree``."""
        return {t.untyped_storage()._cdata for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)}

    def bytes_of(self, keys) -> int:
        """Bytes of the counted storages among ``keys``."""
        return sum(self._sizes.get(k, 0) for k in keys)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.accessed += _nbytes(t)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        self.peak = max(self.peak, self.live)
        return out


# ---------------------------------------------------------------------------
# one traced step
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """This process as rank ``rank`` of a fake process group of ``world``
    ranks: collectives return at once (the runtime sends none on meta
    tensors anyway); groups and meshes are made as on the real one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        collectives.clear_axes()
        dist.destroy_process_group()


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    return tree


def trace(step, args, *, device_type: str = "meta") -> dict:
    """Call ``step(*args)`` once under ``FlopCounter``, the collectives'
    recorder and a ``ByteTracker`` of ``device_type``; the
    record's numbers (see the module's docstring) and the recorded
    schedule (``records``)."""
    tracker = ByteTracker(device_type)
    arg_tensors = [_tensors(a) for a in args]
    arg_bytes = tracker.track(arg_tensors)
    arg_keys = tracker.keys(arg_tensors)
    shape_only.reset()
    t0 = time.perf_counter()
    with collectives.recording() as records, FlopCounter() as fc, tracker:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    out_keys = tracker.keys([_tensors(o) for o in out])
    out_bytes = tracker.bytes_of(out_keys)
    alias = tracker.bytes_of(out_keys & arg_keys)
    total = fc.total
    kernel_flops = int(sum(shape_only.flops.values()))
    return {
        "flops": float(total), "aten_flops": float(total - kernel_flops),
        "kernel_flops": float(kernel_flops),
        "kernels": {n: {"launches": c, "flops": float(shape_only.flops[n])}
                    for n, c in shape_only.calls.items()},
        "bytes_accessed": float(tracker.accessed),
        "arg_bytes": int(arg_bytes), "out_bytes": int(out_bytes),
        "alias_bytes": int(alias),
        "temp_bytes": int(tracker.peak - arg_bytes - (out_bytes - alias)),
        "peak_bytes_per_device": int(tracker.peak),
        "trace_s": trace_s, "records": records}


def stand_ins(step, cell: ShapeCell):
    """The step's arguments as meta tensors (no memory): this rank's
    shards of the whole model's parameters, its optimizer state and the
    global batch; or its shards, its cache (a decode cell's at position S
    - 1, the last step of an S-token context) and the tokens."""
    cfg = step.cfg
    whole = lm.LM(cfg, "meta")
    params = step.shard(whole)
    del whole
    if isinstance(step, steps_mod.TrainStep):
        batch = {k: v.to("meta") if isinstance(v, torch.Tensor) else
                 {e: t.to("meta") for e, t in v.items()}
                 for k, v in step.args[2].items()}
        return params, step.init_opt(params), batch
    extra = steps_mod.input_specs(cfg, cell).get("extra")
    cache = step.init_cache(params, cell.global_batch, cell.seq_len,
                            extra=extra)
    if cell.kind == "decode":
        cache["pos"] = cell.seq_len - 1
    return params, cache, step.args[2].to("meta")


def beyond_reference(step, params, opt=None) -> int:
    """Bytes of ``params`` (a rank's ``LM``) and of their optimizer state
    ``opt`` held beyond the reference's flat-column sharding: a tp-split
    attention leaf's piece is held by ``share`` ranks, so (1 - 1 / share)
    of its bytes and of its state's are more than the reference's 1 /
    tp."""
    tp = step.ranks.tp.size
    if tp == 1:
        return 0
    named = dict(params.named_parameters())
    specs = step.specs(named)
    states = opt["v"] if opt else {}
    if opt and "m" in opt:
        states = {n: {"m": opt["m"][n], "v": opt["v"][n]} for n in opt["m"]}
    total = 0.0
    for n, p in named.items():
        if tpar._attn_leaf(n) is None or \
                steps_mod._shard_dim(specs[n], step.tp_axis) is None:
            continue
        share = tpar.share(step.cfg, n, tp)
        held = _nbytes(p) + sum(_nbytes(t) for t in tree_leaves(
            states.get(n, {})) if isinstance(t, torch.Tensor))
        total += held * (1 - 1 / share)
    return int(total)


def run_cell(arch: str, shape: str, mesh_kind: str, mode: str,
             out_dir: str | None = None, seed: int = 0) -> dict:
    """Trace one cell (see the module's docstring); prints the
    reference's ``dryrun,...`` line and writes the JSON to ``out_dir``."""
    cfg = configs.get(arch)
    cell = SHAPES[shape]
    mesh_shape = MESHES[mesh_kind]
    world = int(np.prod(mesh_shape))
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "mode": mode,
           "chips": world, "stand_ins": "meta"}
    plan, ranks = None, [0]
    if cell.kind != "train":
        rec["mode"] = mode = "baseline"   # serving runs the baseline
    elif mode == "tapa":
        plan = plan_cell(cfg, shape, mesh_shape, seed=seed, mode="tapa")
        rec["plan"] = {"n_stages": plan.n_stages,
                       "stage_slots": plan.stage_slots,
                       "boundary_depth": plan.boundary_depth,
                       "crossing_cost": plan.crossing_cost}
        layout, _ = refined_layout(np.arange(world).reshape(mesh_shape),
                                   plan)
        ranks = [int(layout[s].reshape(-1)[0]) for s in range(plan.n_stages)]
    best = None
    for rank in ranks:
        with fake_group(world, rank):
            mesh = make_production_mesh(multi_pod=mesh_kind == "multipod",
                                        device_type="cpu")
            if cell.kind != "train":
                step = steps_mod.build_baseline_serve(cfg, mesh, cell,
                                                      device="meta")
            elif mode == "tapa":
                step = steps_mod.build_tapa_train(cfg, mesh, cell, plan=plan,
                                                  device="meta")
            else:
                step = steps_mod.build_baseline_train(cfg, mesh, cell,
                                                      device="meta")
            args = stand_ins(step, cell)
            beyond = beyond_reference(step, args[0], args[1] if isinstance(
                step, steps_mod.TrainStep) else None)
            got = trace(step, args)
        got["rank"] = rank
        got["beyond_ref_bytes"] = beyond
        if best is None or got["peak_bytes_per_device"] > \
                best["peak_bytes_per_device"]:
            best = got
        rec.setdefault("trace_s", 0.0)
        rec["trace_s"] += got["trace_s"]
    records = best.pop("records")
    best.pop("trace_s")
    rec.update(best)
    rec["traced_ranks"] = ranks
    rec["collectives"] = coll = collective_summary(
        records, pod_size=256 if mesh_kind == "multipod" else 1 << 30)
    print(f"dryrun,{arch},{shape},{mesh_kind},{mode},"
          f"flops={rec['flops']:.3e},"
          f"peakGB={rec['peak_bytes_per_device'] / 1e9:.2f},"
          f"collMB_ici={coll['ici_bytes'] / 1e6:.1f},"
          f"collMB_dcn={coll['dcn_bytes'] / 1e6:.1f},"
          f"beyondGB={rec['beyond_ref_bytes'] / 1e9:.3f},"
          f"trace={rec['trace_s']:.0f}s", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}__{mode}"
                          ".json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=list(MESHES))
    ap.add_argument("--mode", default="baseline", choices=["baseline", "tapa"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if not args.all:
        run_cell(args.arch, args.shape, args.mesh, args.mode, args.out,
                 args.seed)
        return 0
    ok = fail = 0
    for arch in configs.ARCHS:
        for shape in cells_for(arch):
            fn = os.path.join(args.out, f"{arch}__{shape}__{args.mesh}__"
                              f"{args.mode}.json")
            if args.skip_existing and os.path.exists(fn):
                ok += 1
                continue
            try:
                run_cell(arch, shape, args.mesh, args.mode, args.out,
                         args.seed)
                ok += 1
            except Exception as e:
                if not isinstance(e, (NotImplementedError, ValueError)):
                    traceback.print_exc()
                first = (str(e).splitlines() or [""])[0]
                print(f"dryrun,{arch},{shape},{args.mesh},{args.mode},"
                      f"FAILED {type(e).__name__}: {first}", flush=True)
                fail += 1
    print(f"dryrun,SUMMARY,{args.mesh},{args.mode},ok={ok},fail={fail}")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
