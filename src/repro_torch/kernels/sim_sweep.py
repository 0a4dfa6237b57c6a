"""``sim_sweep``: the padded dataflow sweep of ``simulate_batch(backend=
"torch")``.

Counterpart of ``repro/kernels/sim_sweep.py`` (``_sweep``, a ``jax.jit``
``lax.while_loop``, and ``simulate_padded_jax``).  For tensors on the CPU
the wrapper runs the plain version, ``ref.sim_sweep_ref``, which advances
every row in lockstep.  For CUDA tensors it launches the kernel of
``csrc/sim_sweep.cu``, one block per job row, or raises: there is no
fallback.  Each launch adds one to ``sim_sweep.launches``.

The kernel reports each row's count of active iterations; a row is active
over a prefix of the cycles, so their maximum is the lockstep count
``steps`` of the reference.  The kernel skips each row's phantom columns:
``n_streams`` / ``n_tasks`` are one past the row's last real stream /
task column.

Nothing here compiles per shape, so the reference's compile-cache
bookkeeping (``_bucket``, ``sweep_cache_stats``, the ``sim.jit_cache``
counter group) has no counterpart.  Everything runs in int32: callers
check ``fits_int32`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from ..obs import trace as _trace
from . import ref
from .padded_batch import PaddedBatch

# int32-safety threshold: keeping every knob below 2**30 leaves headroom
# for the sums the sweep forms (t + ii, pushes - pops) inside int32.
_SAFE_MAX = 1 << 30


def fits_int32(jobs, firings: int, max_cycles: int) -> bool:
    """True when every quantity the sweep computes stays inside int32:
    cycle indices, firing counts, FIFO capacities and latencies."""
    if firings >= _SAFE_MAX or max_cycles >= _SAFE_MAX:
        return False
    for j in jobs:
        for d in (j.latency, j.extra_capacity, j.ii):
            if d and any(abs(int(x)) >= _SAFE_MAX for x in d.values()):
                return False
        if any(int(s.depth) >= _SAFE_MAX for s in j.graph.streams):
            return False
    return True


def _row_extent(mask: torch.Tensor) -> torch.Tensor:
    """(V, N) bool -> (V,) int32: one past each row's last True column."""
    V, N = mask.shape
    if N == 0:
        return torch.zeros(V, dtype=torch.int32, device=mask.device)
    cols = torch.arange(1, N + 1, dtype=torch.int32, device=mask.device)
    return torch.where(mask, cols, 0).amax(dim=1).to(torch.int32)


def sim_sweep(lat: torch.Tensor, cap: torch.Tensor, ii: torch.Tensor,
              task_active: torch.Tensor, counted: torch.Tensor,
              cons: torch.Tensor, prod: torch.Tensor, H: int,
              firings: int, max_cycles: int):
    """Run every job row of a padded batch to completion.

    Arguments and results as ``ref.sim_sweep_ref``: lat, cap, cons, prod
    (V, S) int32, ii (V, T) int32, task_active and counted (V, T) bool,
    all on one device; returns ``(cycles, dead, fired, steps)`` with
    ``steps`` an int.
    """
    args = (lat, cap, ii, task_active, counted, cons, prod)
    if lat.device.type == "cpu":
        return ref.sim_sweep_ref(*args, H, firings, max_cycles)
    from . import _build

    dev = lat.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError(f"sim_sweep: every input must lie on one CUDA "
                         f"device, got {[str(a.device) for a in args]}")
    V, S = lat.shape
    T = ii.shape[1]
    for name, a, shape, dtype in (
            ("lat", lat, (V, S), torch.int32),
            ("cap", cap, (V, S), torch.int32),
            ("cons", cons, (V, S), torch.int32),
            ("prod", prod, (V, S), torch.int32),
            ("ii", ii, (V, T), torch.int32),
            ("task_active", task_active, (V, T), torch.bool),
            ("counted", counted, (V, T), torch.bool)):
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"sim_sweep: {name} must be {dtype} of shape "
                             f"{shape}, got {a.dtype} {tuple(a.shape)}")
    if H < 1 or max(firings, max_cycles, H) >= _SAFE_MAX:
        raise ValueError(f"sim_sweep: H, firings and max_cycles must lie "
                         f"in int32's safe range, got H={H}, firings="
                         f"{firings}, max_cycles={max_cycles}")
    cycles = torch.empty(V, dtype=torch.int32, device=dev)
    dead = torch.empty(V, dtype=torch.int32, device=dev)
    fired = torch.empty((V, T), dtype=torch.int32, device=dev)
    row_steps = torch.empty(V, dtype=torch.int32, device=dev)
    if V == 0:
        return cycles, dead.bool(), fired, 0
    lat, cap, ii, cons, prod = (a.contiguous() for a in
                                (lat, cap, ii, cons, prod))
    # bit 0: the task may fire; bit 1: it counts towards completion
    flags = (task_active.to(torch.uint8)
             | (counted.to(torch.uint8) << 1)).contiguous()
    n_streams = _row_extent((cons < T) | (prod < T))
    n_tasks = _row_extent(task_active | counted)
    lib = _build.load("sim_sweep")
    with torch.cuda.device(dev):
        per_row = lib.sim_sweep_scratch(S, T, H)
        if per_row < 0:
            _build.check(-per_row, "sim_sweep")
        scratch = torch.empty(max(V * per_row, 1), dtype=torch.int32,
                              device=dev)
        err = lib.sim_sweep_fwd(
            lat.data_ptr(), cap.data_ptr(), cons.data_ptr(), prod.data_ptr(),
            ii.data_ptr(), flags.data_ptr(), n_streams.data_ptr(),
            n_tasks.data_ptr(), V, S, T, H, firings, max_cycles,
            cycles.data_ptr(), dead.data_ptr(), fired.data_ptr(),
            row_steps.data_ptr(), scratch.data_ptr(), per_row,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sim_sweep")
    sim_sweep.launches += 1
    return cycles, dead.bool(), fired, int(row_steps.max())


sim_sweep.launches = 0


def padded_tensors(pb: PaddedBatch, device) -> tuple:
    """The layout's arrays as the sweep's int32 / bool tensors on
    ``device``: (lat, cap, ii, task_active, counted, cons, prod)."""
    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)) \
            .to(device)

    def flag(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=bool)) \
            .to(device)

    return (i32(pb.lat), i32(pb.cap), i32(pb.ii), flag(pb.task_active),
            flag(pb.counted), i32(pb.cons), i32(pb.prod))


def simulate_padded_torch(pb: PaddedBatch, *, firings: int, max_cycles: int,
                          device):
    """Run one canonical padded batch through the sweep on ``device``.

    Returns ``(cycles, dead, fired, steps)`` as host arrays and an int, in
    the batch's (V, T*) shape: feed them to ``PaddedBatch.unpack``."""
    with _trace.span("sim_sweep", batch=pb.V, device=str(device)):
        cycles, dead, fired, steps = sim_sweep(
            *padded_tensors(pb, device), pb.H, firings, max_cycles)
        return (cycles.cpu().numpy(), dead.cpu().numpy(),
                fired.cpu().numpy(), steps)
