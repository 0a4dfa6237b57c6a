"""A CPU model of ``csrc/sim_sweep.cu``'s cycle schedule, and its host work
list, against the reference sweep.

The kernel cannot run here, so ``_kernel_model`` walks each job row as the
kernel does, in NumPy: the row's real extent and ring depth from
``sim_sweep.row_shapes``; each stream with its own ring of ``lat + 1``
slots (slot-major, one slot pointer advanced by an add and a compare, the
next slot read before the current one is written); a (fired, stalled)
flag pair a task, and a sentinel pair for consumer / producer columns past
the row's tasks; stall flags stored as 1 instead of counted; and the two
barriers a cycle: pass 1 applies the last cycle's firings and sets this
cycle's stall flags, barrier A tests the last cycle quiet, pass 2 fires,
barrier B tests the next cycle done; the done test before the horizon,
and both before the quiet test.  The model must equal
``ref.sim_sweep_ref`` and the reference's jitted ``simulate_padded_jax``
bit for bit, ``steps`` included, on the inputs ``test_torch_sim_sweep.py``
uses.  ``schedule`` must place every real row exactly once, longest first,
as a warp row only where the row fits one warp, and keep the block's
shared memory and scratch disjoint.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_sim import (edge_jobs, paper_jobs, port_job, port_obs_isolation,
                        random_mixed_jobs, streamless_jobs)

import repro.core as rcore
from repro.kernels.padded_batch import build_padded_batch as r_build
from repro.kernels.sim_sweep import simulate_padded_jax
import repro_torch.core as pcore
from repro_torch.kernels import ref
from repro_torch.kernels import sim_sweep as ss
from repro_torch.kernels.padded_batch import build_padded_batch

assert port_obs_isolation  # the autouse fixture, imported to apply here

KERNEL = Path(ss.__file__).parent / "csrc" / "sim_sweep.cu"


def _struct_bytes(name):
    """Bytes of ``struct name`` of the kernel's source, from its fields
    (``int`` and ``long long`` only; none of them needs padding)."""
    body = re.search(r"struct %s \{(.*?)\};" % name, KERNEL.read_text(),
                     re.S).group(1)
    size = {"int": 4, "long long": 8}
    total = 0
    for decl in body.split(";"):
        decl = re.sub(r"//.*", "", decl).strip()
        if decl:
            kind, names = re.fullmatch(r"(long long|int) (.*)", decl,
                                       re.S).groups()
            total += size[kind] * len(names.split(","))
    return total


def _walk_row(lat, cap, cons, prod, ii, flags, n_s, n_t, depth, firings,
              max_cycles):
    """One row as the kernel walks it; every (n_s,) / (n_t,) vector lane is
    one stream's / task's registers."""
    cons = np.minimum(cons[:n_s], n_t)
    prod = np.minimum(prod[:n_s], n_t)
    cap = cap[:n_s]
    may_fire, counted = (flags[:n_t] & 1) != 0, (flags[:n_t] & 2) != 0
    ii = ii[:n_t]
    # the ring: slot j of stream s at j * n_s + s; the slot written next,
    # and each stream's first and last slot
    ring = np.zeros(depth * n_s, dtype=np.int64)
    first = np.arange(n_s)
    last = first + n_s * lat[:n_s]
    at = first.copy()
    pops = np.zeros(n_s, dtype=np.int64)
    pushes = np.zeros(n_s, dtype=np.int64)
    vis = np.zeros(n_s, dtype=np.int64)
    # a (fired, stalled) pair a task, and the sentinel's at n_t
    pair = np.zeros((n_t + 1, 2), dtype=np.int64)
    fired = np.zeros(n_t, dtype=np.int64)
    next_free = np.zeros(n_t, dtype=np.int64)
    not_done = bool((counted & (0 < firings)).any())     # the first barrier
    busy_tasks, steps, t = False, 0, 0
    while True:
        if not not_done:
            return t, False, fired, steps
        if t == max_cycles:
            return t, True, fired, steps
        # pass 1: the last cycle's pops, pushes and ring; this cycle's stalls
        # every read first: the fired bytes, the ring's next slot
        nxt = np.where(at == last, first, at + n_s)
        fc, fp, nv = pair[cons, 0], pair[prod, 0], ring[nxt]
        p, q = pops + fc, pushes + fp
        flight = (p < q) & (vis <= p)
        pops, pushes = p, q
        ring[at] = q
        vis = np.where(first == last, q, nv)     # latency 0: its one slot
        at = nxt
        pair[cons[vis <= p], 1] = 1
        pair[prod[q - p >= cap], 1] = 1
        # barrier A: the last cycle quiet
        if not (busy_tasks or flight.any()) and t > 0:
            return t, True, fired, steps
        steps += 1
        # pass 2: firing; one store sets fired and clears stalled
        c = may_fire & (fired < firings) & (next_free <= t) \
            & (pair[:n_t, 1] == 0)
        pair[:n_t, 0], pair[:n_t, 1] = c, 0
        fired += c
        next_free = np.where(c, t + ii, next_free)
        busy_tasks = bool(c.any() or (next_free > t).any())
        # barrier B: the next cycle done
        not_done = bool((counted & (fired < firings)).any())
        t += 1


def _kernel_model(lat, cap, ii, task_active, counted, cons, prod, H,
                  firings, max_cycles):
    """``sim_sweep``'s results as the kernel computes them, rows in the
    launch order of its work list; ``steps`` the maximum over rows."""
    plan = ss.schedule(*ss.row_shapes(lat, task_active, counted, cons,
                                      prod))
    flags = (task_active.to(torch.uint8)
             | (counted.to(torch.uint8) << 1)).numpy()
    lat, cap, ii, cons, prod = (a.numpy().astype(np.int64) for a in
                                (lat, cap, ii, cons, prod))
    V, T = ii.shape
    cycles = np.zeros(V, dtype=np.int32)
    dead = np.zeros(V, dtype=bool)
    fired = np.zeros((V, T), dtype=np.int32)
    steps = 0
    for r in plan.rows:
        v, n_t = int(r["v"]), int(r["n_tasks"])
        cyc, dd, fr, n = _walk_row(
            lat[v], cap[v], cons[v], prod[v], ii[v], flags[v],
            int(r["n_streams"]), n_t, int(r["depth"]), firings, max_cycles)
        cycles[v], dead[v], fired[v, :n_t] = cyc, dd, fr
        steps = max(steps, n)
    return (torch.from_numpy(cycles), torch.from_numpy(dead),
            torch.from_numpy(fired), steps)


def _hold(ref_jobs, firings, max_cycles=None):
    """The model == ``sim_sweep_ref`` == the reference's jitted sweep, on
    the port's layout of ``ref_jobs`` (and the reference's own)."""
    max_cycles = max_cycles or firings * 64 + 10_000
    pb = build_padded_batch([port_job(j) for j in ref_jobs])
    args = ss.padded_tensors(pb, "cpu")
    got = _kernel_model(*args, pb.H, firings, max_cycles)
    want = ref.sim_sweep_ref(*args, pb.H, firings, max_cycles)
    jx = simulate_padded_jax(r_build(ref_jobs), firings=firings,
                             max_cycles=max_cycles)
    # the jitted sweep's arrays keep its power-of-two buckets
    jx = (np.asarray(jx[0])[:pb.V], np.asarray(jx[1])[:pb.V],
          np.asarray(jx[2])[:pb.V, :pb.T], jx[3])
    for a, b, c in zip(got[:3], want[:3], jx[:3]):
        assert np.array_equal(a.numpy(), b.numpy())
        assert np.array_equal(a.numpy(), c)
    assert got[3] == want[3] == int(jx[3])
    return pb, got


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_model_equals_the_sweep_on_random_mixed_batches(seed):
    _hold(random_mixed_jobs(seed), 25)


@pytest.mark.parametrize("firings", [0, 1, 7, 30])
def test_model_equals_the_sweep_on_edge_cases(firings):
    """Deadlock, control streams, detached tasks, stream-less tasks, II > 1
    and firings 0, mixed with random graphs in one batch."""
    _, got = _hold(edge_jobs(rcore) + random_mixed_jobs(firings + 1),
                   firings)
    if firings:
        assert bool(got[1][2]) and bool(got[1][3])   # zero FIFO, dead loop


def test_model_equals_the_sweep_with_no_data_stream():
    _hold(streamless_jobs(rcore), 9)


def _plan(pb):
    """The work list as the wrapper reads it from the tensors."""
    lat, _, _, active, counted, cons, prod = ss.padded_tensors(pb, "cpu")
    return ss.schedule(*ss.row_shapes(lat, active, counted, cons, prod))


def test_scratch_sizes_are_the_kernels_structs():
    """The host sizes each row's spill with the kernel's own ``Stream`` and
    ``Task`` and reads the work list as its ``Row``; the kernel asserts the
    same sizes when it compiles."""
    assert _struct_bytes("Stream") == 4 * ss.STREAM_INTS == 36
    assert _struct_bytes("Task") == 4 * ss.TASK_INTS == 20
    assert _struct_bytes("Row") == ss.ROW.itemsize == 56
    assert "sizeof(Stream) == 9 * 4 && sizeof(Task) == 5 * 4" in \
        KERNEL.read_text()


def test_model_equals_the_sweep_on_a_deep_ring():
    """A 4,000-cycle latency: one stream's ring of 4,001 slots, past a warp
    row's share of shared memory."""
    jobs = edge_jobs(rcore, long_latency=4000)
    pb, got = _hold(jobs, 3)
    row = pb.perm.index(len(jobs) - 1)
    assert int(got[0][row]) > 4000
    deep = _plan(pb).rows
    deep = deep[deep["v"] == row][0]
    assert deep["depth"] == 4001 and not deep["ring_shared"]


@pytest.mark.parametrize("cut", ["at", "before", "early"])
def test_model_at_the_horizon(cut):
    """max_cycles where the slowest job finishes (done there), one before
    (truncated) and at 5: the horizon test after the done test."""
    jobs = edge_jobs(rcore) + random_mixed_jobs(77)
    full = rcore.simulate_batch(jobs, firings=12, backend="numpy")
    last = max(r.cycles for r in full if not r.deadlocked)
    horizon = {"at": last, "before": last - 1, "early": 5}[cut]
    _hold(jobs, 12, max_cycles=horizon)


def test_model_equals_the_sweep_on_the_paper_designs():
    """One variant of each of the 48 rows: warp rows and block rows of 2-16
    warps in one launch."""
    pb, _ = _hold(paper_jobs(rcore, seed=3, variants=1), 6)
    assert set(_plan(pb).rows["warps"].tolist()) == {1, 2, 4, 8, 16}


@pytest.mark.parametrize("which", ["mixed", "paper", "long-chain"])
def test_work_list(which):
    """Every real row once, longest first; a warp row only where the row
    fits one warp (at most PER_THREAD streams and tasks a lane), a wider
    row the fewest warps that hold it (up to a block), inside one block;
    each warp of a block in at most one row; shared memory and scratch
    regions disjoint and inside their sizes."""
    if which == "mixed":
        jobs = [port_job(j) for j in random_mixed_jobs(3, n=(6, 9))
                + edge_jobs(rcore, 50)]
    elif which == "paper":
        jobs = paper_jobs(pcore, seed=1)
    else:   # a row past a block's registers: its surplus in scratch
        g = pcore.TaskGraph("long")
        for i in range(1500):
            g.add_task(pcore.Task(f"t{i}"))
        for i in range(1499):
            g.add_stream(pcore.Stream(f"s{i}", f"t{i}", f"t{i + 1}"))
        jobs = [pcore.SimJob(g), port_job(random_mixed_jobs(1)[0])]
    pb = build_padded_batch(jobs)
    plan = _plan(pb)
    rows = plan.rows
    assert sorted(rows["v"].tolist()) == list(range(pb.V))
    n_s = pb.stream_active.sum(axis=1)[rows["v"]]
    n_t = pb.task_active.sum(axis=1)[rows["v"]]
    assert (rows["n_streams"] == n_s).all() and (rows["n_tasks"] == n_t).all()
    size = np.maximum(n_s, n_t)
    assert (np.diff(size) <= 0).all()                       # longest first
    lanes = ss.PER_THREAD * 32
    w = rows["warps"]
    assert ((w == 1) == (size <= lanes)).all()
    assert ((size <= lanes * w) | (w == ss.WARPS)).all()
    assert ((w == 1) | (size > lanes * w // 2)).all()
    assert (rows["w0"] + w <= ss.WARPS).all()
    # each warp slot of the launch in one row, at the row's own warps
    for j, r in enumerate(rows):
        mine = np.flatnonzero(plan.warp_row == j)
        first = (np.cumsum(w) - w)[j]
        assert mine.tolist() == list(range(first, first + r["warps"]))
        assert first % ss.WARPS == r["w0"]
    assert (plan.warp_row[int(w.sum()):] == -1).all()
    # shared parts of a block's rows, and scratch parts, disjoint; a row's
    # spill holds its surplus streams, then tasks, at the kernel's strides
    spans = {}
    scratch = []
    stream_ints, task_ints = _struct_bytes("Stream") // 4, \
        _struct_bytes("Task") // 4
    for j, r in enumerate(rows):
        flags, ring = (int(r["n_tasks"]) + 2) // 2, \
            int(r["depth"]) * int(r["n_streams"]) + 1
        kept = lanes * int(r["warps"])
        spill = stream_ints * max(int(r["n_streams"]) - kept, 0) + \
            task_ints * max(int(r["n_tasks"]) - kept, 0)
        block = int((np.cumsum(w) - w)[j]) // ss.WARPS
        for part, n, shared in (("flags", flags, r["flags_shared"]),
                                ("ring", ring, r["ring_shared"])):
            if shared:
                spans.setdefault(block, []).append((int(r[part]), n))
            else:
                scratch.append((int(r[part]), n))
        scratch.append((int(r["spill"]), spill))
        assert r["flags_shared"] or not r["ring_shared"]
    for parts in list(spans.values()) + [scratch]:
        parts = sorted(p for p in parts if p[1])
        for (a, n), (b, _) in zip(parts, parts[1:]):
            assert a + n <= b
    for parts in spans.values():
        assert sum(n for _, n in parts) * 4 <= plan.smem <= ss.BLOCK_SMEM
    assert all(a + n <= plan.scratch for a, n in scratch)
    if which == "long-chain":
        assert rows[0]["warps"] == ss.WARPS
        # 475 streams of 9 ints and 476 tasks of 5 past 1,024 registers;
        # the ring and flags of both rows in shared memory
        assert lanes * ss.WARPS == 1024
        assert plan.scratch == 9 * 475 + 5 * 476


def test_row_shapes_refuse_a_negative_latency():
    """The kernel's rings hold latencies of 0 and more: the wrapper refuses
    a latency below 0 on the CPU as on the card."""
    pb = build_padded_batch([port_job(j) for j in random_mixed_jobs(2)])
    args = list(ss.padded_tensors(pb, "cpu"))
    lat, _, _, active, counted, cons, prod = args
    lat[0, 0] = -1
    with pytest.raises(ValueError, match="below 0"):
        ss.row_shapes(lat, active, counted, cons, prod)
    with pytest.raises(ValueError, match="below 0"):
        ss.sim_sweep(*args, pb.H, 5, 1000)


def test_simulate_batch_takes_a_negative_latency_to_numpy():
    """``fits_int32`` says no to a latency below 0 for either device:
    backend "torch" raises, backend "auto" runs the NumPy sweep, whose
    results equal the reference's."""
    rjobs = random_mixed_jobs(4, n=(3, 4))
    name = next(s.name for s in rjobs[1].graph.streams if not s.control)
    rjobs[1].latency[name] = -1
    pjobs = [port_job(j) for j in rjobs]
    assert not ss.fits_int32(pjobs, 9, 1000)
    with pytest.raises(ValueError, match="below 0"):
        pcore.simulate_batch(pjobs, firings=9, backend="torch", device="cpu")
    pcore.reset_engine_counts()
    with pytest.warns(UserWarning, match="NumPy"):
        got = pcore.simulate_batch(pjobs, firings=9, device="cpu")
    assert pcore.engine_counts()["fallback"] == 1
    want = rcore.simulate_batch(rjobs, firings=9, backend="numpy")
    assert [(r.cycles, r.fired, r.deadlocked, r.steps) for r in got] == \
        [(r.cycles, r.fired, r.deadlocked, r.steps) for r in want]


def test_model_takes_phantom_columns_inside_a_row():
    """A stream column inside a row's extent whose consumer and producer are
    the padding's sentinel reads the kernel's sentinel flag and stays inert,
    as the reference's sentinel column does."""
    jobs = [port_job(j) for j in random_mixed_jobs(8, n=(3, 5))]
    pb = build_padded_batch(jobs)
    lat, cap, ii, active, counted, cons, prod = ss.padded_tensors(pb, "cpu")
    S = pb.S
    pad = lambda a, x: torch.cat([a, torch.full((pb.V, 1), x,    # noqa: E731
                                               dtype=a.dtype)], 1)
    lat, cap = pad(lat, 2), pad(cap, 0)
    cons, prod = pad(cons, pb.T), pad(prod, pb.T)
    # move the phantom column in front of the last real stream of row 0
    n0 = int(pb.stream_active[0].sum())
    order = list(range(n0 - 1)) + [S] + list(range(n0 - 1, S))
    lat, cap, cons, prod = (a[:, order] for a in (lat, cap, cons, prod))
    args = (lat, cap, ii, active, counted, cons, prod)
    got = _kernel_model(*args, pb.H + 2, 20, 5000)
    want = ref.sim_sweep_ref(*args, pb.H + 2, 20, 5000)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3]
