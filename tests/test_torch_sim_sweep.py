"""The port's simulator backends against the reference, on the CPU.

``repro_torch.core.simulate_batch(backend="torch", device="cpu")`` runs
``kernels/ref.py::sim_sweep_ref``, the plain version of the CUDA kernel
``csrc/sim_sweep.cu``; it must equal the reference's ``backend="jax"``
(CPU JAX) and ``backend="numpy"`` exactly: cycles, fired, deadlocked and
``steps``.  A plain-torch model of the kernel's walk (each row alone, to
its own end, over its real columns only; ``steps`` as the maximum) must
equal the lockstep sweep.  Also: ``max_bytes`` chunking, the int32 guard,
the device rule and the engine counters.
"""
import warnings

import numpy as np
import pytest
import torch
from _propcheck import given, settings, strategies as st
from _torch_sim import (edge_jobs, key, paper_jobs, port_job,
                        port_obs_isolation, random_mixed_jobs,
                        streamless_jobs)

import repro.core as rcore
import repro_torch.core as pcore
from repro_torch.kernels import ref
from repro_torch.kernels import sim_sweep as ss
from repro_torch.kernels.padded_batch import build_padded_batch

assert port_obs_isolation  # the autouse fixture, imported to apply here


def _port(jobs, firings, **kw):
    return pcore.simulate_batch(jobs, firings=firings, device="cpu", **kw)


def _three_way(ref_jobs, firings, max_cycles=None, port_jobs=None):
    """torch(cpu) == reference jax == reference numpy, exactly."""
    port_jobs = port_jobs or [port_job(j) for j in ref_jobs]
    got = _port(port_jobs, firings, backend="torch", max_cycles=max_cycles)
    jx = rcore.simulate_batch(ref_jobs, firings=firings, backend="jax",
                              max_cycles=max_cycles)
    npy = rcore.simulate_batch(ref_jobs, firings=firings, backend="numpy",
                               max_cycles=max_cycles)
    assert all(r.engine == "torch-padded" for r in got)
    assert [key(r) for r in got] == [key(r) for r in jx]
    assert [key(r) for r in got] == [key(r) for r in npy]
    return got


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 99_999))
def test_torch_sweep_equals_jax_and_numpy_on_random_mixed_batches(seed):
    jobs = random_mixed_jobs(seed)
    got = _three_way(jobs, 25)
    ev = rcore.simulate_batch(jobs, firings=25, backend="event")
    assert [r.cycles for r in got] == [r.cycles for r in ev]


@pytest.mark.parametrize("firings", [0, 1, 7, 30])
def test_torch_sweep_equals_jax_and_numpy_on_edge_cases(firings):
    """Deadlock (tokenless loop, zero-capacity FIFO), control streams,
    detached tasks, stream-less tasks and II > 1, mixed with random
    graphs in one padded batch."""
    jobs = edge_jobs(rcore) + random_mixed_jobs(firings + 1)
    got = _three_way(jobs, firings)
    if firings:
        dead = {j.graph.name: r.deadlocked for j, r in zip(jobs, got)}
        assert dead["loop"] and dead["zero"] and not dead["loop2"]


def test_torch_sweep_equals_jax_and_numpy_with_no_data_stream():
    """S* = 0: every job of the batch is stream-less or control-only."""
    got = _three_way(streamless_jobs(rcore), 9)
    assert all(not r.deadlocked for r in got)


def test_torch_sweep_equals_jax_and_numpy_on_a_deep_ring():
    """A latency of 4,000 cycles: the ring the card keeps in global
    memory."""
    jobs = edge_jobs(rcore, long_latency=4000)
    got = _three_way(jobs, 3)
    assert got[-1].cycles > 4000 and not got[-1].deadlocked


@pytest.mark.parametrize("cut", ["at", "before", "early"])
def test_torch_sweep_at_the_horizon(cut):
    """Cut at ``max_cycles``: exactly where the slowest job finishes (done
    there, not dead), one cycle before it (truncated, so dead), and at 5
    cycles, which cuts most jobs."""
    jobs = edge_jobs(rcore) + random_mixed_jobs(77)
    full = rcore.simulate_batch(jobs, firings=12, backend="numpy")
    last = max(r.cycles for r in full if not r.deadlocked)
    horizon = {"at": last, "before": last - 1, "early": 5}[cut]
    got = _three_way(jobs, 12, max_cycles=horizon)
    assert all(r.cycles <= horizon for r in got)
    slowest = [g for g, f in zip(got, full)
               if f.cycles == last and not f.deadlocked]
    assert slowest
    if cut != "early":
        assert all(r.cycles == horizon for r in slowest)
        assert all(r.deadlocked == (cut == "before") for r in slowest)


def test_torch_sweep_on_the_paper_designs():
    """One seeded variant of each (design, device) row of the paper's
    suites: 48 jobs, padded to cnn_13x16's 480 tasks and 905 streams."""
    ref_jobs = paper_jobs(rcore, seed=3, variants=1)
    port_jobs = paper_jobs(pcore, seed=3, variants=1)
    assert len(port_jobs) == 48
    got = _port(port_jobs, 6, backend="torch")
    npy = rcore.simulate_batch(ref_jobs, firings=6, backend="numpy")
    assert [key(r) for r in got] == [key(r) for r in npy]


def _per_row_walk(lat, cap, ii, task_active, counted, cons, prod, H,
                  firings, max_cycles):
    """A model of ``csrc/sim_sweep.cu``'s walk: each row alone, over its
    real columns only (``n_streams`` / ``n_tasks``, the wrapper's
    ``_row_extent``), phantom consumers and producers at the row's own
    sentinel, run to its own end; ``steps`` is the maximum over rows."""
    V, S = lat.shape
    T = ii.shape[1]
    n_s = ss._row_extent((cons < T) | (prod < T))
    n_t = ss._row_extent(task_active | counted)
    cycles = torch.empty(V, dtype=torch.int32)
    dead = torch.empty(V, dtype=torch.bool)
    fired = torch.zeros((V, T), dtype=torch.int32)
    steps = 0
    for v in range(V):
        s, t = int(n_s[v]), int(n_t[v])
        row = slice(v, v + 1)
        cyc, dd, fr, n = ref.sim_sweep_ref(
            lat[row, :s], cap[row, :s], ii[row, :t],
            task_active[row, :t], counted[row, :t],
            cons[row, :s].clamp(max=t), prod[row, :s].clamp(max=t), H,
            firings, max_cycles)
        cycles[v], dead[v], fired[v, :t] = cyc[0], dd[0], fr[0]
        steps = max(steps, n)
    return cycles, dead, fired, steps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_per_row_walk_equals_lockstep(seed):
    """Each row run alone to its own end, ``steps`` as the maximum of the
    rows' active iterations, equals the lockstep sweep: a row is active
    over a prefix of the cycles."""
    jobs = [port_job(j) for j in random_mixed_jobs(seed, n=(3, 7))
            + edge_jobs(rcore)]
    pb = build_padded_batch(jobs)
    args = ss.padded_tensors(pb, "cpu")
    for firings, max_cycles in ((15, 10_000), (15, 9), (0, 50)):
        lock = ref.sim_sweep_ref(*args, pb.H, firings, max_cycles)
        walk = _per_row_walk(*args, pb.H, firings, max_cycles)
        for a, b in zip(lock[:3], walk[:3]):
            assert torch.equal(a, b)
        assert lock[3] == walk[3]


def test_row_extent_skips_only_phantom_columns():
    jobs = [port_job(j) for j in random_mixed_jobs(9, n=(4, 6))]
    pb = build_padded_batch(jobs)
    _, _, _, active, counted, cons, prod = ss.padded_tensors(pb, "cpu")
    n_s = ss._row_extent((cons < pb.T) | (prod < pb.T))
    n_t = ss._row_extent(active | counted)
    assert n_s.tolist() == pb.stream_active.sum(axis=1).tolist()
    assert n_t.tolist() == pb.task_active.sum(axis=1).tolist()
    empty = torch.zeros((3, 0), dtype=torch.bool)
    assert ss._row_extent(empty).tolist() == [0, 0, 0]


def test_chunking_gives_the_same_results_and_counts_one_sweep_a_chunk():
    jobs = [port_job(j) for j in random_mixed_jobs(5)]
    whole = _port(jobs, 15, backend="torch")
    pcore.reset_engine_counts()
    chunked = _port(jobs, 15, backend="torch", max_bytes=1)
    assert pcore.engine_counts()["torch"] == len(jobs)
    assert [key(r)[:3] for r in whole] == [key(r)[:3] for r in chunked]


def test_auto_resolves_to_torch_and_a_lone_job_to_the_event_engine():
    jobs = [port_job(j) for j in random_mixed_jobs(11)]
    pcore.reset_engine_counts()
    out = _port(jobs, 10)
    assert all(r.engine == "torch-padded" for r in out)
    assert pcore.engine_counts() == {"event": 0, "cycle": 0, "numpy": 0,
                                     "torch": 1, "fallback": 0}
    lone = _port(jobs[:1], 10)
    assert lone[0].engine == "event"
    forced = _port(jobs[:1], 10, backend="torch")
    assert forced[0].engine == "torch-padded"
    assert key(forced[0])[:3] == key(lone[0])[:3]


def test_int32_guard():
    """``torch`` raises past the int32 range; ``auto`` warns, degrades to
    NumPy and counts one fallback, as the reference does."""
    jobs = [port_job(j) for j in random_mixed_jobs(2)]
    with pytest.raises(ValueError, match="int32"):
        _port(jobs, 10, max_cycles=1 << 31, backend="torch")
    big = [pcore.SimJob(j.graph, latency=j.latency, ii=j.ii,
                        extra_capacity={s.name: 1 << 30
                                        for s in j.graph.streams})
           for j in jobs]
    with pytest.raises(ValueError, match="int32"):
        _port(big, 10, backend="torch")
    pcore.reset_engine_counts()
    with pytest.warns(UserWarning, match="int32"):
        out = _port(jobs, 10, max_cycles=1 << 31)
    assert all(r.engine.startswith("numpy") for r in out)
    counts = pcore.engine_counts()
    assert counts["fallback"] == 1 and counts["numpy"] == 1
    assert counts["torch"] == 0


def test_no_card_raises_unless_the_host_is_asked_for(monkeypatch):
    """With no CUDA device, a call that did not pass ``device="cpu"``
    raises; it never carries on on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = [port_job(j) for j in random_mixed_jobs(4)]
    for backend in ("auto", "torch", "numpy", "event"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcore.simulate_batch(jobs, firings=5, backend=backend)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcore.simulate_batch(jobs[:1], firings=5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pcore.simulate_batch(jobs, firings=5, device="meta")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _port(jobs, 5)[0].engine == "torch-padded"


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    """``sim_sweep`` on CPU tensors is ``sim_sweep_ref``, and it counts no
    launch; the layout's tensors are int32 / bool."""
    jobs = [port_job(j) for j in random_mixed_jobs(6)]
    pb = build_padded_batch(jobs)
    args = ss.padded_tensors(pb, "cpu")
    assert [a.dtype for a in args] == [torch.int32] * 3 + [torch.bool] * 2 \
        + [torch.int32] * 2
    before = ss.sim_sweep.launches
    got = ss.sim_sweep(*args, pb.H, 20, 5000)
    want = ref.sim_sweep_ref(*args, pb.H, 20, 5000)
    assert ss.sim_sweep.launches == before
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3]
    cycles, dead, fired, steps = ss.simulate_padded_torch(
        pb, firings=20, max_cycles=5000, device="cpu")
    assert isinstance(cycles, np.ndarray) and steps == want[3]
    assert np.array_equal(fired, want[2].numpy())
