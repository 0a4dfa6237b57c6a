"""The port's single-run engines and batch layout against the reference.

``repro_torch.core.simulate`` (event and cycle engines, ``StreamProfile``s,
the ``check=`` pre-flight gate) and ``repro_torch.kernels.padded_batch``
(``build_padded_batch`` and ``PaddedBatch.unpack``) on the same seeded
random graphs and on the paper's designs as the reference, exactly.
"""
import dataclasses
import random

import numpy as np
import pytest
from _propcheck import given, settings, strategies as st
from _torch_sim import (edge_jobs, key, paper_jobs, port_graph, port_job,
                        port_obs_isolation, random_mixed_jobs,
                        streamless_jobs)

import repro.core as rcore
import repro_torch.core as pcore
from repro.corpus import random_graph
from repro.kernels.padded_batch import build_padded_batch as r_build
from repro_torch.kernels.padded_batch import build_padded_batch as p_build

assert port_obs_isolation  # the autouse fixture, imported to apply here


def _knobs(rng, g):
    lat = {s.name: rng.randint(0, 4) for s in g.streams}
    extra = {s.name: rng.choice([0, 0, 2, 2 * lat[s.name]])
             for s in g.streams}
    ii = {n: rng.randint(1, 4) for n in g.tasks}
    return dict(latency=lat, extra_capacity=extra, ii=ii)


def _profiles(res):
    if res.profiles is None:
        return None
    return {n: dataclasses.asdict(p) for n, p in res.profiles.items()}


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 99_999))
def test_engines_and_profiles_equal_the_reference(seed):
    rng = random.Random(seed)
    g = random_graph(rng, allow_cycle=bool(seed % 2))
    kw = _knobs(rng, g)
    pg = port_graph(g)
    for engine in ("event", "cycle"):
        want = rcore.simulate(g, firings=25, engine=engine, **kw)
        got = pcore.simulate(pg, firings=25, engine=engine, **kw)
        assert key(got) == key(want)
        assert got.engine == want.engine
    want = rcore.simulate(g, firings=25, profile=True, **kw)
    got = pcore.simulate(pg, firings=25, profile=True, **kw)
    assert _profiles(got) == _profiles(want)


@pytest.mark.parametrize("i", range(10))
def test_engines_on_the_edge_cases_equal_the_reference(i):
    rjob, pjob = edge_jobs(rcore, 40)[i], edge_jobs(pcore, 40)[i]
    kw = dict(latency=rjob.latency, extra_capacity=rjob.extra_capacity,
              ii=rjob.ii)
    for engine, firings, horizon in (("event", 9, None), ("cycle", 9, None),
                                     ("event", 9, 8), ("cycle", 0, None)):
        want = rcore.simulate(rjob.graph, firings=firings, engine=engine,
                              max_cycles=horizon, **kw)
        got = pcore.simulate(pjob.graph, firings=firings, engine=engine,
                             max_cycles=horizon, **kw)
        assert key(got) == key(want)
    want = rcore.simulate(rjob.graph, firings=9, profile=True, **kw)
    got = pcore.simulate(pjob.graph, firings=9, profile=True, **kw)
    assert _profiles(got) == _profiles(want)


def test_engine_errors_and_headroom_equal_the_reference():
    g = port_graph(random_graph(random.Random(1)))
    with pytest.raises(ValueError, match="profile=True requires"):
        pcore.simulate(g, firings=3, engine="cycle", profile=True)
    with pytest.raises(ValueError, match="unknown engine"):
        pcore.simulate(g, firings=3, engine="warp")
    with pytest.raises(ValueError, match="unknown backend"):
        pcore.simulate_batch([g, g], firings=3, backend="jax", device="cpu")
    lat = {"a": 3, "b": 0}
    assert pcore.pipeline_headroom(lat) == rcore.pipeline_headroom(lat)


def test_check_gate_equals_the_reference():
    """``check="raise"`` raises the analyzer's error with its report;
    ``"warn"`` warns and runs; a bad mode is refused."""
    from repro.analysis import StaticAnalysisError as RErr
    from repro_torch.analysis import StaticAnalysisError as PErr

    rjob, pjob = edge_jobs(rcore)[3], edge_jobs(pcore)[3]   # the dead loop
    with pytest.raises(RErr) as rexc:
        rcore.simulate(rjob.graph, firings=5, check="raise")
    with pytest.raises(PErr) as pexc:
        pcore.simulate(pjob.graph, firings=5, check="raise")
    assert str(pexc.value) == str(rexc.value)
    assert pexc.value.report.codes() == rexc.value.report.codes()
    with pytest.raises(PErr):
        pcore.simulate_batch([pjob, pjob], firings=5, check="raise",
                             device="cpu")
    with pytest.warns(UserWarning, match="static analysis"):
        got = pcore.simulate_batch([pjob, pjob], firings=5, check="warn",
                                   device="cpu")
    assert all(r.deadlocked for r in got)
    with pytest.raises(ValueError, match="check must be"):
        pcore.simulate(pjob.graph, firings=5, check="loud")


def _layout(pb):
    """A ``PaddedBatch`` as plain data."""
    out = {}
    for f in dataclasses.fields(pb):
        v = getattr(pb, f.name)
        if f.name == "groups":
            v = [{k: (x.tolist() if isinstance(x, np.ndarray) else x)
                  for k, x in dataclasses.asdict(gr).items()} for gr in v]
        elif isinstance(v, np.ndarray):
            v = (v.dtype.str, v.tolist())
        out[f.name] = v
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_padded_layout_equals_the_reference(seed):
    rjobs = random_mixed_jobs(seed) + edge_jobs(rcore, 30)
    pjobs = [port_job(j) for j in rjobs]
    rb, pb = r_build(rjobs), p_build(pjobs)
    assert _layout(pb) == _layout(rb)
    V, T = pb.V, pb.T
    rng = np.random.default_rng(seed)
    cycles = rng.integers(0, 99, V)
    dead = rng.random(V) < 0.5
    fired = rng.integers(0, 9, (V, T))
    got = pb.unpack(cycles, dead, fired, 7, "torch-padded")
    want = rb.unpack(cycles, dead, fired, 7, "torch-padded")
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


def test_padded_layout_of_the_paper_designs_equals_the_reference():
    """Two variants of each of the 48 rows: 28 topology groups padded to
    cnn_13x16's 480 tasks and 905 streams, ring depth 6."""
    rb = r_build(paper_jobs(rcore, seed=1))
    pb = p_build(paper_jobs(pcore, seed=1))
    assert (pb.V, pb.T, pb.S, pb.H, len(pb.groups)) == (96, 480, 905, 6, 28)
    assert _layout(pb) == _layout(rb)


def _port_jobs_sharing(rjobs):
    """The port's jobs of ``rjobs``, sharing a graph object exactly where
    the reference's jobs share one."""
    graphs = {}
    out = []
    for j in rjobs:
        g = graphs.get(id(j.graph))
        if g is None:
            g = graphs[id(j.graph)] = port_graph(j.graph)
        out.append(pcore.SimJob(g, latency=j.latency,
                                extra_capacity=j.extra_capacity, ii=j.ii))
    return out


def _layout_case(name):
    """Reference jobs for the layout cases ``_Model`` used to resolve
    implicitly, one job at a time."""
    rng = random.Random(sum(map(ord, name)))
    J = rcore.SimJob
    if name == "control-and-unknown-knobs":
        jobs = []
        for g in [e.graph for e in edge_jobs(rcore)] + \
                [random_graph(rng) for _ in range(4)]:
            names = [s.name for s in g.streams] + ["nope", "s999"]
            jobs.append(J(g, latency={n: rng.randint(0, 4) for n in names},
                          extra_capacity={n: rng.randint(0, 3)
                                          for n in names},
                          ii={n: rng.randint(1, 3)
                              for n in list(g.tasks) + ["ghost"]}))
        return jobs
    if name == "one-graph-object":
        g = random_graph(rng)
        return [J(g, **_knobs(rng, g)) for _ in range(6)] + [J(g)]
    if name == "equal-topologies-apart":
        a, b = (random_graph(random.Random(7)) for _ in range(2))
        c = random_graph(rng)
        assert a is not b
        return [J(a, **_knobs(rng, a)), J(c, **_knobs(rng, c)),
                J(b, **_knobs(rng, b)), J(a, **_knobs(rng, a))]
    if name == "no-knobs":
        g, h = random_graph(rng), random_graph(rng)
        return [J(g), J(h, latency={}, extra_capacity={}, ii={}),
                J(g, latency=None, ii={})]
    if name == "no-data-stream":
        return [J(e.graph, ii=e.ii) for e in streamless_jobs(rcore)] + \
            [J(rcore.TaskGraph("empty"))]
    # two streams of one name, which add_stream accepts with its checks
    # on: a knob of that name sets both, and the reference resolves both
    # to the last one's ends and depth
    b = rcore.TaskGraphBuilder("twins")
    b.stream("x", depth=3)
    b.stream("y", depth=1)
    b.invoke("P", outs=["x", "y"])
    b.invoke("C", ins=["x", "y"])
    g = b.build()
    g.add_stream(rcore.Stream(name="x", src="P", dst="C", depth=5))
    return [J(g, latency={"x": 2}, extra_capacity={"x": 1, "y": 4}),
            J(g), J(random_graph(rng))]


@pytest.mark.parametrize("name", [
    "control-and-unknown-knobs", "one-graph-object",
    "equal-topologies-apart", "no-knobs", "no-data-stream",
    "streams-of-one-name"])
def test_padded_layout_of_edge_cases_equals_the_reference(name):
    """The port builds each topology group's columns once and walks only
    each job's own knobs; its layout and ``unpack`` must equal the
    reference's, which resolves every job through ``_Model``."""
    rjobs = _layout_case(name)
    pjobs = _port_jobs_sharing(rjobs)
    rb, pb = r_build(rjobs), p_build(pjobs)
    assert _layout(pb) == _layout(rb)
    rng = np.random.default_rng(len(name))
    V, T = pb.V, pb.T
    cycles = rng.integers(0, 99, V)
    dead = rng.random(V) < 0.5
    fired = rng.integers(0, 9, (V, T))
    got = pb.unpack(cycles, dead, fired, 3, "torch-padded")
    want = rb.unpack(cycles, dead, fired, 3, "torch-padded")
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    # and the simulation of the same jobs, through the port's layout
    res = pcore.simulate_batch(pjobs, firings=7, backend="torch",
                               device="cpu")
    ref_res = rcore.simulate_batch(rjobs, firings=7, backend="numpy")
    assert [key(r) for r in res] == [key(r) for r in ref_res]
