"""Shared inputs of the ``test_torch_sim_*`` parity tests: the same graphs
and jobs built in the reference package ``repro`` and in the port
``repro_torch``, from numpy / ``random`` seeds, and the port's obs
isolation."""
import dataclasses
import random

import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as pcore
from repro.corpus import random_graph

def port_graph(g):
    """A reference ``TaskGraph`` rebuilt as the port's, field for field."""
    out = pcore.TaskGraph(g.name)
    for t in g.tasks.values():
        out.add_task(pcore.Task(**dataclasses.asdict(t)))
    for s in g.streams:
        out.add_stream(pcore.Stream(**dataclasses.asdict(s)), validate=False)
    return out


def port_job(j):
    return pcore.SimJob(port_graph(j.graph), latency=j.latency,
                        extra_capacity=j.extra_capacity, ii=j.ii)


def key(r):
    """What every engine must agree on, bit for bit."""
    return r.cycles, r.fired, r.deadlocked, r.steps


def random_mixed_jobs(seed: int, n=(2, 6)):
    """Reference ``SimJob``s over independent random topologies (cycles,
    detached sinks, control streams, zero-capacity FIFOs) with random
    latency, headroom and II knobs, as ``tests/test_simulate_event.py``
    draws them."""
    rng = random.Random(seed)
    jobs = []
    for _ in range(rng.randint(*n)):
        g = random_graph(rng, allow_cycle=True)
        lat = {s.name: rng.randint(0, 4) for s in g.streams}
        extra = {s.name: rng.choice([0, 0, 2, 2 * lat[s.name]])
                 for s in g.streams}
        ii = {t: rng.randint(1, 4) for t in g.tasks}
        jobs.append(rcore.SimJob(g, latency=lat, extra_capacity=extra, ii=ii))
    return jobs


def _chain(core, name, depth, control=False, detached=False):
    g = core.TaskGraph(name)
    g.add_task(core.Task("P"))
    g.add_task(core.Task("C", detached=detached))
    g.add_stream(core.Stream(name="s", src="P", dst="C", width=8,
                             depth=depth, control=control), validate=False)
    return g


def _loop(core, name, control):
    """The tokenless two-task loop of ``repro.analysis``'s doctest; closed
    through a control stream it is safe."""
    b = core.TaskGraphBuilder(name)
    b.stream("ab")
    b.stream("ba", control=control)
    b.invoke("A", ins=["ba"], outs=["ab"])
    b.invoke("B", ins=["ab"], outs=["ba"])
    return b.build()


def _lonely(core, name, n):
    """Tasks with no stream at all."""
    g = core.TaskGraph(name)
    for i in range(n):
        g.add_task(core.Task(f"T{i}"))
    return g


def _fork(core, name):
    """A producer feeding a consumer and a detached monitor."""
    b = core.TaskGraphBuilder(name)
    b.stream("a", depth=2)
    b.stream("m", depth=1)
    b.invoke("P", outs=["a", "m"])
    b.invoke("C", ins=["a"])
    b.invoke("Mon", ins=["m"], detach=True)
    return b.build()


def edge_jobs(core, long_latency=None):
    """The edge cases the kernel is held to, as ``core``'s jobs: a
    producer-consumer with II > 1 and latency, a zero-capacity FIFO
    (deadlock), the tokenless loop (deadlock) and its control-closed twin,
    control-only and stream-less graphs, detached tasks, and (when
    ``long_latency`` is given) a stream whose latency makes a deep ring."""
    J = core.SimJob
    jobs = [
        J(_chain(core, "pc", 2), latency={"s": 3},
          extra_capacity={"s": 6}, ii={"C": 2}),
        J(_chain(core, "pc", 2), ii={"P": 3}),
        J(_chain(core, "zero", 0), latency={"s": 1}),
        J(_loop(core, "loop", control=False)),
        J(_loop(core, "loop2", control=True)),
        J(_chain(core, "ctl", 2, control=True)),
        J(_chain(core, "det", 1, detached=True), latency={"s": 2}),
        J(_lonely(core, "solo", 3), ii={"T1": 4}),
        J(_fork(core, "fork"), latency={"a": 2, "m": 1}),
    ]
    if long_latency:
        jobs.append(J(_chain(core, "deep", 2), latency={"s": long_latency},
                      extra_capacity={"s": 2 * long_latency}))
    return jobs


def streamless_jobs(core):
    """A batch with no data stream at all (S* = 0)."""
    J = core.SimJob
    return [J(_lonely(core, "solo", 3), ii={"T1": 4}),
            J(_chain(core, "ctl", 2, control=True), ii={"C": 2}),
            J(_lonely(core, "one", 1))]


def paper_jobs(core, seed=0, variants=2):
    """``variants`` seeded variants of each (design, device) row of the
    paper's suites: latency 0-4 on ~30 % of the data streams,
    ``pipeline_headroom`` as extra capacity, II = 2 on ~5 % of the
    tasks."""
    from importlib import import_module
    bench = import_module(core.__name__.split(".")[0] + ".fpga.benchmarks")
    rng = np.random.default_rng(seed)
    jobs = []
    for _name, _board, g in bench.autobridge_suite() + bench.hbm_suite():
        data = [s.name for s in g.streams if not s.control]
        for _ in range(variants):
            lat = {s: int(rng.integers(0, 5)) for s in data
                   if rng.random() < 0.3}
            ii = {t: 2 for t in g.tasks if rng.random() < 0.05}
            jobs.append(core.SimJob(
                g, latency=lat, extra_capacity=core.pipeline_headroom(lat),
                ii=ii))
    return jobs


@pytest.fixture(autouse=True)
def port_obs_isolation():
    """The port's own registry and trace buffer, restored after each test
    (``conftest.py`` isolates the reference's)."""
    from repro_torch.obs import metrics, trace

    snap = metrics.snapshot()
    was_enabled = trace.enabled()
    saved = trace.drain()
    try:
        yield
    finally:
        metrics.restore(snap)
        trace.clear()
        trace.attach("")
        if was_enabled:
            trace.enable()
        else:
            trace.disable()
        trace.absorb(saved)
