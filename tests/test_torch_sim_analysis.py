"""The port's static dataflow verifier (``repro_torch.analysis``) against
the reference's: ``analyze()`` reports (codes, severities, subjects,
messages, ``min_cycles``, the repetition vector, firing bounds) on both of
the paper's suites and on seeded random graphs, its counters, and the
``python -m repro_torch.analysis`` command line."""
import json
import os
import random
import subprocess
import sys

import pytest
from _propcheck import given, settings, strategies as st
from _torch_sim import edge_jobs, port_graph, port_obs_isolation

import repro.analysis as ran
import repro.core as rcore
import repro.fpga as rfpga
import repro_torch.analysis as pan
import repro_torch.core as pcore
import repro_torch.fpga as pfpga
from repro.corpus import random_graph

assert port_obs_isolation  # the autouse fixture, imported to apply here

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _report(rep, graph):
    return (rep.as_dict(), rep.ok, rep.deadlock, rep.min_cycles,
            rep.repetition, sorted(rep.codes()),
            {t: rep.firing_bound(t) for t in graph.tasks},
            rep.summary(), rep.error_summary())


def _rows(bench):
    return bench.autobridge_suite() + bench.hbm_suite()


@pytest.mark.parametrize("firings", [None, 200])
def test_reports_on_the_paper_suites_equal_the_reference(firings):
    ref_rows, port_rows = _rows(rfpga.benchmarks), _rows(pfpga.benchmarks)
    for (name, board, rg), (_, _, pg) in zip(ref_rows, port_rows):
        want = ran.analyze(rg, grid=rfpga.grid_for(board), firings=firings)
        got = pan.analyze(pg, grid=pfpga.grid_for(board), firings=firings)
        assert _report(got, pg) == _report(want, rg), name


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 99_999))
def test_reports_on_random_graphs_equal_the_reference(seed):
    rng = random.Random(seed)
    g = random_graph(rng, allow_cycle=True)
    lat = {s.name: rng.randint(0, 4) for s in g.streams}
    extra = {s.name: rng.choice([0, 0, 2]) for s in g.streams}
    ii = {t: rng.randint(1, 3) for t in g.tasks}
    kw = dict(latency=lat, extra_capacity=extra, ii=ii, firings=20)
    pg = port_graph(g)
    assert _report(pan.analyze(pg, **kw), pg) == \
        _report(ran.analyze(g, **kw), g)
    assert pan.firing_bounds(pg, extra_capacity=extra) == \
        ran.firing_bounds(g, extra_capacity=extra)
    assert pan.repetition_vector(pg) == ran.repetition_vector(g)
    assert pan.min_cycles_bound(pg, firings=20, latency=lat, ii=ii) == \
        ran.min_cycles_bound(g, firings=20, latency=lat, ii=ii)


@pytest.mark.parametrize("passes", [("structure",), ("deadlock", "rates")])
def test_edge_cases_and_counters_equal_the_reference(passes):
    ran.reset_analysis_counts()
    pan.reset_analysis_counts()
    for rj, pj in zip(edge_jobs(rcore, 9), edge_jobs(pcore, 9)):
        want = ran.analyze(rj.graph, extra_capacity=rj.extra_capacity,
                           firings=7, passes=passes)
        got = pan.analyze(pj.graph, extra_capacity=pj.extra_capacity,
                          firings=7, passes=passes)
        assert _report(got, pj.graph) == _report(want, rj.graph)
    assert pan.analysis_counts() == ran.analysis_counts()
    with pytest.raises(ValueError, match="unknown analysis pass"):
        pan.analyze(edge_jobs(pcore)[0].graph, passes=("speed",))


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", module, *args], env=env,
                         capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout


def test_command_line_equals_the_reference():
    args = ("page_rank", "cnn_13x2", "--json", "--firings", "50")
    rc, got = _cli("repro_torch.analysis", *args)
    rc_ref, want = _cli("repro.analysis", *args)
    assert (rc, json.loads(got)) == (rc_ref, json.loads(want))
    assert _cli("repro_torch.analysis", "--list")[1] == \
        _cli("repro.analysis", "--list")[1]
