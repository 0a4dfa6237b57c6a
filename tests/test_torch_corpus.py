"""The port's generated corpus (``repro_torch.corpus``) against the
reference's (``repro.corpus``): the same ``(family, seed)`` gives the same
graph, simulation knobs and sha256 fingerprint in both packages, and
``run_differential(device="cpu")`` gives the reference's counters, with
``torch_checked`` (the sweep's plain version against the NumPy oracle,
``steps`` included) in place of ``jax_checked``."""
import dataclasses
import random

import pytest
from _torch_sim import port_graph, port_obs_isolation

import repro.corpus as rcorpus
import repro_torch.corpus as pcorpus

assert port_obs_isolation  # the autouse fixture, imported to apply here

SEEDS = (0, 7, 1234)


def _graph_data(g):
    return (g.name, [dataclasses.asdict(t) for t in g.tasks.values()],
            [dataclasses.asdict(s) for s in g.streams])


@pytest.mark.parametrize("family", sorted(rcorpus.FAMILIES))
def test_designs_and_fingerprints_equal_the_reference(family):
    assert pcorpus.FAMILIES[family] == pcorpus.CorpusSpec(
        **dataclasses.asdict(rcorpus.FAMILIES[family]))
    for seed in SEEDS:
        want = rcorpus.generate_design(seed, rcorpus.FAMILIES[family])
        got = pcorpus.generate_design(seed, pcorpus.FAMILIES[family])
        assert got.fingerprint == want.fingerprint
        assert (got.name, got.latency, got.extra_capacity, got.ii,
                got.firings) == (want.name, want.latency,
                                 want.extra_capacity, want.ii, want.firings)
        assert _graph_data(got.graph) == _graph_data(want.graph)
        # the fingerprint is of content: the reference's graph rebuilt
        # field for field in the port hashes the same
        assert pcorpus.graph_fingerprint(port_graph(want.graph)) == \
            want.fingerprint


def test_sample_corpus_and_random_graph_equal_the_reference():
    assert [d.fingerprint for d in pcorpus.sample_corpus("wide", 5, seed=3)] \
        == [d.fingerprint for d in rcorpus.sample_corpus("wide", 5, seed=3)]
    assert pcorpus.CLEAN_FAMILIES == rcorpus.CLEAN_FAMILIES
    for cycle in (False, True):
        got = pcorpus.random_graph(random.Random(11), allow_cycle=cycle)
        want = rcorpus.random_graph(random.Random(11), allow_cycle=cycle)
        assert _graph_data(got) == _graph_data(want)


def _counters(rep):
    out = rep.counters()
    out.pop("jax_checked", None)
    out.pop("torch_checked", None)
    return out


def test_differential_on_a_mixed_corpus_equals_the_reference():
    """Every stage of the oracle table, the search identity with two
    workers and the surrogate check included."""
    def corpus(mod):
        designs = []
        for fam in ("dag", "hbm"):
            designs += mod.sample_corpus(fam, 4)
        return designs + mod.sample_corpus("fuzz", 8)

    kw = dict(floorplan_limit=8, search_designs=1, check_surrogate=True)
    want = rcorpus.run_differential(corpus(rcorpus), **kw)
    got = pcorpus.run_differential(corpus(pcorpus), device="cpu", **kw)
    assert got.ok, got.mismatches
    assert _counters(got) == _counters(want)
    assert got.torch_checked == got.designs == 16
    assert (got.searches_checked, got.surrogate_checked) == (1, 1)
    assert got.feasible > 0 and got.infeasible > 0


def test_differential_flags_a_torch_mismatch(monkeypatch):
    """A wrong torch result is a recorded mismatch of the torch row."""
    from repro_torch.corpus import differential

    real = differential.simulate_batch

    def wrong(jobs, *, backend, **kw):
        out = real(jobs, backend=backend, **kw)
        if backend == "torch":
            out[0] = dataclasses.replace(out[0], steps=out[0].steps + 1)
        return out

    monkeypatch.setattr(differential, "simulate_batch", wrong)
    rep = pcorpus.run_differential(pcorpus.sample_corpus("fuzz", 3),
                                   floorplan_limit=0, device="cpu")
    assert not rep.ok and rep.torch_checked == 3
    assert len(rep.mismatches) == 1
    assert rep.mismatches[0].startswith("[torch] fuzz-00000")
