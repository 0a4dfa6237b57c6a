"""``sim_sweep``: the padded dataflow sweep of ``simulate_batch(backend=
"torch")``.

Counterpart of ``repro/kernels/sim_sweep.py`` (``_sweep``, a ``jax.jit``
``lax.while_loop``, and ``simulate_padded_jax``).  For tensors on the CPU
the wrapper runs the plain version, ``ref.sim_sweep_ref``, which advances
every row in lockstep.  For CUDA tensors it launches the kernel of
``csrc/sim_sweep.cu`` once, or raises: there is no fallback.  Each launch
adds one to ``sim_sweep.launches``.

Before the launch the host reads each row's real extent and ring depth
from the tensors (``row_shapes``: one past the row's last real stream /
task column, its largest latency + 1; one copy to the host) and builds
the kernel's work list (``schedule``):
each row gets a group of warps sized to its work, one warp where the row
fits it, and the groups are packed longest first into blocks of
``WARPS`` warps.  The kernel reports each row's count of active
iterations; a row is active over a prefix of the cycles, so their maximum
is the lockstep count ``steps`` of the reference.

Nothing here compiles per shape, so the reference's compile-cache
bookkeeping (``_bucket``, ``sweep_cache_stats``, the ``sim.jit_cache``
counter group) has no counterpart.  Everything runs in int32: callers
check ``fits_int32`` first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs import trace as _trace
from . import ref
from .padded_batch import PaddedBatch

# int32-safety threshold: keeping every knob below 2**30 leaves headroom
# for the sums the sweep forms (t + ii, pushes - pops) inside int32.
_SAFE_MAX = 1 << 30


def fits_int32(jobs, firings: int, max_cycles: int) -> bool:
    """True when every quantity the sweep computes stays inside int32
    (cycle indices, firing counts, FIFO capacities and latencies) and no
    latency knob is below 0, which the kernel's rings cannot hold; the
    same answer for the card and the CPU.  Each distinct graph's FIFO
    depths are checked once."""
    if firings >= _SAFE_MAX or max_cycles >= _SAFE_MAX:
        return False
    seen: set[int] = set()
    for j in jobs:
        if j.latency and min(j.latency.values()) < 0:
            return False
        for d in (j.latency, j.extra_capacity, j.ii):
            if d and (max(d.values()) >= _SAFE_MAX
                      or min(d.values()) <= -_SAFE_MAX):
                return False
        if id(j.graph) not in seen:
            seen.add(id(j.graph))
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


#: warps of a block, and the streams and tasks a thread keeps in registers
#: (``WARPS`` and ``PER_THREAD`` of ``csrc/sim_sweep.cu``)
WARPS, PER_THREAD = 16, 2
#: bytes of shared memory a block's rows may take; each row may take its
#: warps' share, and its ring, or its flags too, go to global scratch past it
BLOCK_SMEM = 96 * 1024
#: ints of a stream's and of a task's state past a thread's registers
#: (``Stream`` and ``Task`` of ``csrc/sim_sweep.cu``, which asserts them)
STREAM_INTS, TASK_INTS = 9, 5
#: ``Row`` of ``csrc/sim_sweep.cu``: a job row's place in the launch (56
#: bytes, asserted there)
ROW = np.dtype([("ring", "<i8"), ("flags", "<i8"), ("spill", "<i8"),
                ("v", "<i4"), ("w0", "<i4"), ("warps", "<i4"),
                ("n_streams", "<i4"), ("n_tasks", "<i4"), ("depth", "<i4"),
                ("ring_shared", "<i4"), ("flags_shared", "<i4")])


@dataclasses.dataclass
class Plan:
    """The kernel's work list for one launch."""

    #: ``ROW`` records in launch order, longest rows first
    rows: np.ndarray
    #: (blocks * WARPS,) int32: each warp's index into ``rows``, -1 idle
    warp_row: np.ndarray
    #: dynamic shared memory of a block, bytes
    smem: int
    #: ints of global scratch
    scratch: int

    @property
    def blocks(self) -> int:
        return len(self.warp_row) // WARPS


def schedule(n_streams, n_tasks, depth) -> Plan:
    """The work list of one launch from each row's real streams, real tasks
    and ring depth ((V,) each).

    A row of at most ``PER_THREAD * 32`` streams and tasks is a warp row;
    a larger one gets the fewest warps, a power of two up to ``WARPS``, in
    which a thread holds at most ``PER_THREAD`` of each (a thread of a row
    beyond 1,024 holds the rest in global scratch).  Rows are ordered
    longest first, so the powers of two fill each block exactly before the
    next opens.  A row's flags (a byte pair a task, fired and stalled, and
    one for the sentinel) and its ring (``depth * n_streams + 1`` ints) take
    shared memory up to its warps' share of ``BLOCK_SMEM``; past it the
    ring, then the flags too, go to global scratch."""
    n_s = np.asarray(n_streams, dtype=np.int64)
    n_t = np.asarray(n_tasks, dtype=np.int64)
    depth = np.asarray(depth, dtype=np.int64)
    if (depth * n_s >= 1 << 29).any():
        raise ValueError("sim_sweep: a row's ring (latency x streams) "
                         "reaches 2**29 ints")
    size = np.maximum(n_s, n_t)
    need = np.maximum(1, -(-size // (32 * PER_THREAD)))
    warps = np.ones_like(need)
    while (grow := (warps < need) & (warps < WARPS)).any():
        warps = np.where(grow, 2 * warps, warps)
    order = np.argsort(-size, kind="stable")
    w, n_s, n_t, depth = warps[order], n_s[order], n_t[order], depth[order]
    first = np.cumsum(w) - w          # first warp over the whole launch
    block = first // WARPS
    total = int(w.sum())
    warp_row = np.full(-(-total // WARPS) * WARPS, -1, dtype=np.int32)
    warp_row[:total] = np.repeat(np.arange(len(w), dtype=np.int32), w)

    # a (fired, stalled) byte pair a task and one for the sentinel, in
    # ints; the ring and one slot more, which the thread slots past the
    # row's streams write
    flags, ring = (n_t + 2) // 2, depth * n_s + 1
    share = BLOCK_SMEM // 4 * w // WARPS
    flags_shared = flags <= share
    ring_shared = flags_shared & (flags + ring <= share)
    kept = PER_THREAD * 32 * w
    spill = STREAM_INTS * np.maximum(n_s - kept, 0) \
        + TASK_INTS * np.maximum(n_t - kept, 0)
    # global scratch of a row: [ring][flags][spill], the parts not shared
    glob = np.where(ring_shared, 0, ring) + np.where(flags_shared, 0, flags) \
        + spill
    base = np.cumsum(glob) - glob
    # shared memory of a block: its rows' [flags][ring], one after another
    sh = np.where(flags_shared, flags, 0) + np.where(ring_shared, ring, 0)
    csh = np.cumsum(sh) - sh
    soff = csh - csh[np.searchsorted(block, block)]

    rows = np.zeros(len(w), dtype=ROW)
    rows["v"] = order
    rows["w0"] = first % WARPS
    rows["warps"] = w
    rows["n_streams"], rows["n_tasks"], rows["depth"] = n_s, n_t, depth
    rows["flags"] = np.where(flags_shared, soff,
                             base + np.where(ring_shared, 0, ring))
    rows["ring"] = np.where(ring_shared, soff + flags, base)
    rows["spill"] = base + glob - spill
    rows["ring_shared"], rows["flags_shared"] = ring_shared, flags_shared
    smem = 4 * int(np.bincount(block, weights=sh).max(initial=0)) \
        if len(w) else 0
    return Plan(rows=rows, warp_row=warp_row, smem=smem,
                scratch=int(glob.sum()))


def row_shapes(lat: torch.Tensor, task_active: torch.Tensor,
               counted: torch.Tensor, cons: torch.Tensor,
               prod: torch.Tensor) -> tuple:
    """Each row's real streams and tasks (one past its last real column)
    and ring depth (its largest latency + 1) as host arrays; raises for a
    latency below 0."""
    V, S = lat.shape
    T = task_active.shape[1]
    n_s = _row_extent((cons < T) | (prod < T))
    n_t = _row_extent(task_active | counted)
    if S:
        inside = torch.arange(S, device=lat.device)[None, :] < n_s[:, None]
        lat_in = torch.where(inside, lat, 0)
        top, low = lat_in.amax(dim=1), lat_in.amin(dim=1)
    else:
        top = low = torch.zeros(V, dtype=torch.int32, device=lat.device)
    n_s, n_t, top, low = torch.stack([n_s, n_t, top.to(torch.int32),
                                      low.to(torch.int32)]).cpu().numpy()
    if (low < 0).any():
        raise ValueError("sim_sweep: a latency below 0")
    return n_s, n_t, top + 1


def sim_sweep(lat: torch.Tensor, cap: torch.Tensor, ii: torch.Tensor,
              task_active: torch.Tensor, counted: torch.Tensor,
              cons: torch.Tensor, prod: torch.Tensor, H: int,
              firings: int, max_cycles: int):
    """Run every job row of a padded batch to completion.

    Arguments and results as ``ref.sim_sweep_ref``: lat, cap, cons, prod
    (V, S) int32, ii (V, T) int32, task_active and counted (V, T) bool,
    all on one device; returns ``(cycles, dead, fired, steps)`` with
    ``steps`` an int.  Raises for a real stream's latency below 0, on
    either device.
    """
    args = (lat, cap, ii, task_active, counted, cons, prod)
    if lat.device.type == "cpu":
        row_shapes(lat, task_active, counted, cons, prod)
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
    plan = schedule(*row_shapes(lat, task_active, counted, cons, prod))
    meta = torch.from_numpy(np.concatenate(
        [plan.rows.view(np.uint8), plan.warp_row.view(np.uint8)])).to(dev)
    lib = _build.load("sim_sweep")
    with torch.cuda.device(dev):
        scratch = torch.empty(max(plan.scratch, 1), dtype=torch.int32,
                              device=dev)
        err = lib.sim_sweep_fwd(
            lat.data_ptr(), cap.data_ptr(), cons.data_ptr(), prod.data_ptr(),
            ii.data_ptr(), flags.data_ptr(), meta.data_ptr(),
            meta.data_ptr() + plan.rows.nbytes, plan.blocks, S, T, firings,
            max_cycles, cycles.data_ptr(), dead.data_ptr(), fired.data_ptr(),
            row_steps.data_ptr(), scratch.data_ptr(), plan.smem,
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
