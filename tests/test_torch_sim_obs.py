"""The port's observability layer (``repro_torch.obs``) against the
reference's: after one traced ``simulate_batch`` run (backends ``event``
and ``numpy``), the counter groups and their values, the span names and
their nesting and ``validate_chrome``'s verdict are the reference's; the
registry's snapshot / delta / merge semantics and the
``python -m repro_torch.obs`` command line too."""
import contextlib
import json
import os
import subprocess
import sys

import pytest
from _torch_sim import port_job, port_obs_isolation, random_mixed_jobs

import repro.analysis as ran
import repro.core as rcore
import repro.obs as robs
import repro_torch.analysis as pan
import repro_torch.core as pcore
import repro_torch.obs as pobs

assert port_obs_isolation  # the autouse fixture, imported to apply here
assert ran and pan  # each registers its "analysis" counter group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _groups(obs, rename=None):
    """Every counter group of ``obs``'s registry with its values; the
    reference's jax engine key under the port's name."""
    out = {}
    for name, entry in obs.metrics.snapshot().items():
        if entry["kind"] == "group":
            out[name] = {(rename or {}).get(k, k): v
                         for k, v in entry["values"].items()}
    return out


def _spans(obs):
    """(name, parent's name, args) of every span, in order."""
    evs = obs.trace.events()
    names = {e["id"]: e["name"] for e in evs}
    return [(e["name"], names.get(e["parent"]), e["args"]) for e in evs]


def _traced_run(core, obs, jobs, backend, check):
    obs.trace.enable(clear=True)
    core.reset_engine_counts()
    kw = {"device": "cpu"} if core is pcore else {}
    with obs.trace.span("round", n=len(jobs)):
        with obs.trace.span("round.sim"):
            out = core.simulate_batch(jobs, firings=12, backend=backend,
                                      check=check, **kw)
    doc = obs.trace.to_chrome()
    obs.trace.disable()
    return out, doc


@pytest.mark.parametrize("check", [None, "warn"])
@pytest.mark.parametrize("backend", ["event", "numpy"])
def test_traced_run_counters_and_spans_equal_the_reference(backend, check):
    rjobs = random_mixed_jobs(21)
    pjobs = [port_job(j) for j in rjobs]
    robs.metrics.reset(("analysis",))
    pobs.metrics.reset(("analysis",))
    def warns():
        return pytest.warns(UserWarning, match="static analysis") if check \
            else contextlib.nullcontext()

    with warns():
        rout, rdoc = _traced_run(rcore, robs, rjobs, backend, check)
    with warns():
        pout, pdoc = _traced_run(pcore, pobs, pjobs, backend, check)
    assert [r.cycles for r in pout] == [r.cycles for r in rout]
    port, ref = _groups(pobs), _groups(robs, rename={"jax": "torch"})
    assert set(port) <= set(ref)
    assert {"sim.engine", "analysis"} <= set(port)
    assert {g: ref[g] for g in port} == port
    assert _spans(pobs) == _spans(robs)
    assert pobs.trace.validate_chrome(pdoc) == \
        robs.trace.validate_chrome(rdoc) == []
    strip = [(e["ph"], e["name"]) for e in pdoc["traceEvents"]
             if e["ph"] != "M"]
    assert strip == [(e["ph"], e["name"]) for e in rdoc["traceEvents"]
                     if e["ph"] != "M"]


def test_torch_backend_traces_its_sweep_under_the_batch_span():
    pjobs = [port_job(j) for j in random_mixed_jobs(3)]
    pobs.trace.enable(clear=True)
    pcore.simulate_batch(pjobs, firings=5, backend="torch", device="cpu")
    pobs.trace.disable()
    spans = _spans(pobs)
    assert [(n, p) for n, p, _ in spans] == [("simulate.batch", None),
                                             ("sim_sweep", "simulate.batch")]
    assert spans[0][2] == {"backend": "torch", "jobs": len(pjobs),
                           "firings": 5}
    assert spans[1][2] == {"batch": len(pjobs), "device": "cpu"}
    assert pobs.trace.validate_chrome(pobs.trace.to_chrome()) == []


def _drive(metrics):
    """The same registry traffic through either package's registry."""
    reg = metrics.Registry()
    g = reg.group("demo", {"hits": 0, "misses": 0})
    c, h, ga = reg.counter("c"), reg.histogram("h"), reg.gauge("g")
    g["hits"] += 2
    c.inc(3, backend="x")
    h.observe(1.5, kind="a")
    before = reg.snapshot()
    g["misses"] += 1
    c.inc(1, backend="y")
    h.observe(4.0, kind="a")
    ga.set(7, pool="p")
    delta = reg.delta(before)
    other = metrics.Registry()
    other.group("demo", {"hits": 0, "misses": 0})
    other.counter("c")
    other.histogram("h")
    other.merge(delta)
    other.merge(delta)
    reg.restore(before)
    return (reg.snapshot(), delta, other.snapshot(), sorted(reg.names()),
            metrics.parse_label_key("backend=x,tier=disk"))


def test_registry_semantics_equal_the_reference():
    assert _drive(pobs.metrics) == _drive(robs.metrics)


def test_bench_block_and_command_line_equal_the_reference(tmp_path):
    """The command line over each package's own trace file (the port has
    no BENCH block: nothing of it reads one)."""
    paths = {}
    for name, obs in (("ref", robs), ("port", pobs)):
        obs.trace.enable(clear=True)
        for i in range(3):
            with obs.trace.span("outer", i=i), obs.trace.span("inner"):
                pass
        paths[name] = tmp_path / f"{name}.json"
        obs.trace.write_chrome(str(paths[name]))
        obs.trace.disable()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for cmd in ("validate", "summarize"):
        outs = []
        for name, module in (("ref", "repro.obs"),
                             ("port", "repro_torch.obs")):
            out = subprocess.run(
                [sys.executable, "-m", module, cmd, str(paths[name])],
                env=env, capture_output=True, text=True, timeout=120)
            outs.append((out.returncode, out.stdout.splitlines()[:1]
                         if cmd == "validate" else
                         [line.split()[0] for line in out.stdout.splitlines()
                          if line.strip()][:3]))
        assert outs[0] == outs[1], cmd
    bad = {"traceEvents": [{"ph": "E", "pid": 1, "tid": 1, "ts": 0,
                            "name": "x"}]}
    assert pobs.trace.validate_chrome(bad) == robs.trace.validate_chrome(bad)
    assert pobs.trace.validate_chrome(bad)
    assert json.loads(paths["port"].read_text())["traceEvents"]
