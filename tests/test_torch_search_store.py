"""Crash safety of the port's search stack (``repro_torch.search.store``,
``.pool``, ``.faults``) against the reference's, and the port's isolation
from what the reference writes.

* the ``DiskFloorplanStore`` round trip, a torn write (``FaultPlan``)
  quarantined on reopen, and the store's own blob magic;
* a checkpointed ``search_until_converged`` SIGKILLed between rounds (a
  real subprocess, as ``tests/test_robustness.py`` runs it) resumes bit for
  bit, equal to the uninterrupted run and to the reference's; the
  journal's config names the package and not the device;
* a store and a journal the reference wrote: a subprocess that imports
  only the port quarantines the blobs, refuses the journal, never
  unpickles either, and ends with no ``repro`` or ``jax`` module loaded;
* the worker pool under seeded faults (crash, hang, poison, infeasible)
  gives the reference's counters and cache entries, also under
  ``REPRO_POOL_CTX=spawn``; no worker reaches ``simulate_batch``.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest
from _torch_sim import chain_graph, port_obs_isolation

import repro.core as rcore
import repro.search as rsearch
import repro_torch.core as pcore
import repro_torch.search as psearch
from repro_torch.search import faults, pool, store

assert port_obs_isolation  # the autouse fixture, imported to apply here

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _grid(core):
    return core.SlotGrid("g", rows=2, cols=2, base_capacity={"LUT": 400},
                         max_util=1.0)


def _points(search):
    return [search.SearchPoint(seed=s, max_util=u)
            for s in (0, 1) for u in (0.8, 0.9, 1.0)]


def _converge_kwargs(core):
    return dict(space=core.SearchSpace(utils=(0.7, 0.85, 1.0)), rounds=3,
                points_per_round=6, sim_firings=50)


def _sim(core):
    return {} if core is rcore else {"device": "cpu"}


def _fingerprint(res):
    return sorted(
        (dataclasses.astuple(c.point), c.fmax, c.plan.area_overhead,
         tuple(sorted(c.plan.floorplan.placement.items())),
         c.sim.cycles if c.sim else None)
        for c in res.frontier)


def _child_env(plan=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop(faults.ENV_VAR, None)
    if plan is not None:
        env[faults.ENV_VAR] = json.dumps(plan.as_dict())
    return env


# ---- the disk store ------------------------------------------------------

def test_store_round_trip_serves_solves_without_resolving(tmp_path):
    g = chain_graph(pcore)
    first = psearch.DiskFloorplanStore(tmp_path)
    plan = pcore.autobridge(g, _grid(pcore), max_util=0.9, cache=first)
    assert first.disk_entries() >= 1
    assert (tmp_path / "entries").exists()
    blob = next((tmp_path / "entries").glob("*.fp")).read_bytes()
    assert blob.startswith(b"RTS1") and not blob.startswith(b"RFS1")
    pcore.reset_floorplan_counts()
    again = psearch.DiskFloorplanStore(tmp_path)
    plan2 = pcore.autobridge(chain_graph(pcore), _grid(pcore), max_util=0.9,
                             cache=again)
    assert pcore.floorplan_counts()["solved"] == 0
    assert again.disk_hits >= 1 and again.quarantined == 0
    assert plan2.floorplan.placement == plan.floorplan.placement
    assert plan2.depth == plan.depth


def test_torn_write_is_quarantined_on_reopen(tmp_path):
    with faults.install(psearch.FaultPlan(torn_write=1.0), env=False):
        s = psearch.DiskFloorplanStore(tmp_path)
        pcore.autobridge(chain_graph(pcore), _grid(pcore), max_util=0.9,
                         cache=s)
    n = s.disk_entries()
    assert n >= 1 and psearch.fault_counts()["torn_write"] == n
    reopened = psearch.DiskFloorplanStore(tmp_path)
    assert reopened.quarantined == n and reopened.disk_entries() == 0
    assert len(list((tmp_path / "quarantine").glob("*.corrupt"))) == n
    assert psearch.store_counts()["quarantined"] == n
    # the run stays right: the solve re-runs
    plan = pcore.autobridge(chain_graph(pcore), _grid(pcore), max_util=0.9,
                            cache=reopened)
    assert plan.floorplan is not None


def test_key_digest_equals_the_reference():
    rkey = rcore.initial_floorplan_key(chain_graph(rcore), _grid(rcore),
                                       max_util=0.9, seed=1)
    pkey = pcore.initial_floorplan_key(chain_graph(pcore), _grid(pcore),
                                       max_util=0.9, seed=1)
    assert psearch.key_digest(pkey) == rsearch.key_digest(rkey)


# ---- checkpoint and resume -----------------------------------------------

_CHILD = textwrap.dedent("""
    import sys
    from repro_torch.core import SearchSpace, SlotGrid, TaskGraphBuilder
    from repro_torch.search import search_until_converged

    def chain(n=4, width=64, lut=100):
        b = TaskGraphBuilder("chain")
        for i in range(n - 1):
            b.stream(f"s{i}", width=width)
        for i in range(n):
            b.invoke(f"K{i}", area={"LUT": lut},
                     ins=[f"s{i - 1}"] if i > 0 else [],
                     outs=[f"s{i}"] if i < n - 1 else [])
        return b.build()

    grid = SlotGrid("g", rows=2, cols=2, base_capacity={"LUT": 400},
                    max_util=1.0)
    res = search_until_converged(chain(), grid,
                                 space=SearchSpace(utils=(0.7, 0.85, 1.0)),
                                 rounds=3, points_per_round=6,
                                 sim_firings=50, checkpoint=sys.argv[1],
                                 device="cpu")
    print(f"done rounds_run={res.rounds_run}")
""")


def test_sigkill_between_rounds_then_resume_is_bit_identical(tmp_path):
    ckpt = tmp_path / "ckpt"
    victim = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ckpt)],
        env=_child_env(psearch.FaultPlan(kill_after_round=0)),
        capture_output=True, text=True, timeout=120)
    assert victim.returncode == -signal.SIGKILL, victim.stderr
    assert (ckpt / "state_r0000.pkl").exists()
    config = json.loads((ckpt / "config.json").read_text())
    assert config["package"] == "repro_torch" and "device" not in config

    resumed = pcore.search_until_converged(
        chain_graph(pcore), _grid(pcore), checkpoint=ckpt, device="cpu",
        **_converge_kwargs(pcore))
    assert resumed.resumed_rounds == 1
    clean = pcore.search_until_converged(
        chain_graph(pcore), _grid(pcore), device="cpu",
        **_converge_kwargs(pcore))
    ref = rcore.search_until_converged(chain_graph(rcore), _grid(rcore),
                                       **_converge_kwargs(rcore))
    for other in (clean, ref):
        assert _fingerprint(resumed) == _fingerprint(other)
        assert resumed.hypervolumes == other.hypervolumes
        assert (resumed.rounds_run, resumed.converged) == \
            (other.rounds_run, other.converged)


def test_checkpoint_refuses_different_arguments_and_replays(tmp_path):
    ckpt = tmp_path / "ckpt"
    kw = _converge_kwargs(pcore)
    first = pcore.search_until_converged(chain_graph(pcore), _grid(pcore),
                                         checkpoint=ckpt, device="cpu", **kw)
    pcore.reset_floorplan_counts()
    again = pcore.search_until_converged(chain_graph(pcore), _grid(pcore),
                                         checkpoint=ckpt, device="cpu", **kw)
    assert pcore.floorplan_counts()["solved"] == 0
    assert again.resumed_rounds == first.rounds_run
    assert _fingerprint(again) == _fingerprint(first)
    with pytest.raises(ValueError, match="config mismatch"):
        pcore.search_until_converged(chain_graph(pcore), _grid(pcore),
                                     checkpoint=ckpt, device="cpu",
                                     **(kw | {"rounds": 4}))


# ---- what the reference wrote --------------------------------------------

_PROBE = textwrap.dedent("""
    import json, os, pickle, sys
    loads = []
    real = pickle.loads
    pickle.loads = lambda *a, **k: loads.append(1) or real(*a, **k)
    from repro_torch.core import SearchSpace, SlotGrid, TaskGraphBuilder
    from repro_torch.search import (DiskFloorplanStore, SearchJournal,
                                    search_until_converged, store_counts)

    store_dir, ckpt = sys.argv[1], sys.argv[2]
    out = {}
    s = DiskFloorplanStore(store_dir)
    out["store"] = [s.quarantined, s.disk_entries()]
    try:
        SearchJournal(ckpt, config={})
    except ValueError as e:
        out["journal"] = str(e)
    os.remove(os.path.join(ckpt, "config.json"))
    j = SearchJournal(ckpt, config={"x": 1})
    out["state"] = j.load_latest()
    out["corrupt"] = sorted(p for p in os.listdir(ckpt)
                            if p.endswith(".corrupt"))
    out["counts"] = store_counts()
    out["loads"] = len(loads)
    out["bad"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(json.dumps(out))
""")


def test_reference_store_and_journal_are_never_unpickled(tmp_path):
    rstore = rsearch.DiskFloorplanStore(tmp_path / "store")
    rcore.autobridge(chain_graph(rcore), _grid(rcore), max_util=0.9,
                     cache=rstore)
    n = rstore.disk_entries()
    ckpt = tmp_path / "ckpt"
    rcore.search_until_converged(chain_graph(rcore), _grid(rcore),
                                 checkpoint=ckpt, rounds=2,
                                 points_per_round=2, sim_firings=20)
    states = sorted(p.name for p in ckpt.glob("state_r*.pkl"))
    assert n >= 1 and states
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(tmp_path / "store"), str(ckpt)],
        env=_child_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["store"] == [n, 0]          # every blob quarantined
    assert "'repro'" in got["journal"] and "repro_torch" in got["journal"]
    assert got["state"] is None
    assert got["corrupt"] == [s + ".corrupt" for s in states]
    assert got["counts"]["quarantined"] == n + len(states)
    assert got["loads"] == 0               # nothing was unpickled
    assert got["bad"] == []


def test_port_blob_reads_as_foreign_to_the_reference(tmp_path):
    pstore = psearch.DiskFloorplanStore(tmp_path)
    pcore.autobridge(chain_graph(pcore), _grid(pcore), max_util=0.9,
                     cache=pstore)
    n = pstore.disk_entries()
    assert rsearch.DiskFloorplanStore(tmp_path).quarantined == n


# ---- the worker pool -----------------------------------------------------

def _warm(core, search, plan, **kw):
    cache = core.FloorplanCache()
    with search.install_faults(plan):
        search.reset_fault_counts()
        stats = search.warm_floorplan_cache(chain_graph(core), _grid(core),
                                            _points(search), cache=cache,
                                            jobs=2, **kw)
        injected = search.fault_counts()
    return cache, stats, injected


def _same_entries(rcache, pcache):
    def rows(cache, search):
        return sorted(
            (search.key_digest(k), kind,
             sorted(v.placement.items()) if kind == "ok" else v)
            for k, (kind, v) in cache._entries.items())
    assert rows(pcache, psearch) == rows(rcache, rsearch)


_DETERMINISTIC = ("dispatched", "merged", "worker_solves",
                  "worker_infeasible", "static_skipped", "quarantined")


@pytest.mark.parametrize("case", ["crash", "hang", "poison"])
def test_pool_under_faults_gives_the_reference_counters(case):
    kw = {"backoff_s": 0.01}
    if case == "crash":
        mk = lambda s: s.FaultPlan(seed=1, worker_crash=1.0)  # noqa: E731
    elif case == "hang":
        mk = lambda s: s.FaultPlan(seed=2, worker_hang=1.0,  # noqa: E731
                                   hang_s=60.0)
        kw["timeout_s"] = 1.0
    else:
        mk = lambda s: s.FaultPlan(seed=5, worker_crash=1.0,  # noqa: E731
                                   attempts=99)
        kw["crash_limit"] = 2
    rc, rstats, rinj = _warm(rcore, rsearch, mk(rsearch), **kw)
    pc, pstats, pinj = _warm(pcore, psearch, mk(psearch), **kw)
    pick = lambda st: {f: getattr(st, f) for f in _DETERMINISTIC}  # noqa
    assert pick(pstats) == pick(rstats)
    _same_entries(rc, pc)
    if case == "poison":
        # a poison point faults on every retry: how many retries a crash
        # charges depends on which workers were running, so only the
        # verdicts are deterministic
        assert pstats.quarantined == len(_points(psearch))
        assert pinj["worker_crash"] >= 2 * len(_points(psearch))
    else:
        # transient faults fire on a point's first dispatch only
        assert pinj == rinj
        assert pstats.merged == pstats.dispatched == 6
        assert pstats.pool_rebuilds >= 1 and pstats.quarantined == 0
    if case == "hang":
        assert pstats.timed_out >= 1


def test_pool_infeasible_points_give_the_reference_counters():
    out = []
    for core, search in ((rcore, rsearch), (pcore, psearch)):
        tiny = core.SlotGrid("tiny", rows=1, cols=2,
                             base_capacity={"LUT": 10}, max_util=1.0)
        search.reset_pool_counts()
        core.reset_floorplan_counts()
        res = core.explore_design_space(
            chain_graph(core, n=5, lut=1000), tiny,
            space=core.SearchSpace(utils=(0.5, 1.0)), jobs=2,
            **_sim(core))
        assert res.frontier == []
        out.append((search.pool_counts(), core.floorplan_counts(),
                    [c.error for c in res.candidates]))
    assert out[1] == out[0]
    assert out[1][0]["worker_infeasible"] == 2


def test_pool_runs_under_spawn(monkeypatch):
    monkeypatch.setenv("REPRO_POOL_CTX", "spawn")
    assert pool._mp_context().get_start_method() == "spawn"
    cache = pcore.FloorplanCache()
    stats = psearch.warm_floorplan_cache(chain_graph(pcore), _grid(pcore),
                                         _points(psearch)[:2], cache=cache,
                                         jobs=2)
    assert stats.merged == stats.dispatched == 2
    monkeypatch.delenv("REPRO_POOL_CTX")
    ref = rcore.FloorplanCache()
    rsearch.warm_floorplan_cache(chain_graph(rcore), _grid(rcore),
                                 _points(rsearch)[:2], cache=ref, jobs=2)
    _same_entries(ref, cache)


def _simulating_autobridge(graph, grid, **kw):
    """A solve that (wrongly) scores throughput inside the worker."""
    pcore.simulate_batch([pcore.SimJob(graph)] * 2, firings=5, device="cpu")


@pytest.mark.parametrize("where", ["in-process", "forked worker"])
def test_no_worker_reaches_simulate_batch(where, monkeypatch):
    monkeypatch.setattr(pool, "autobridge", _simulating_autobridge)
    if where == "in-process":
        with pytest.raises(RuntimeError, match="search pool worker"):
            pool._solve_point(chain_graph(pcore), _grid(pcore),
                              pool._point_kwargs(_points(psearch)[0]), {})
    else:
        monkeypatch.setenv("REPRO_POOL_CTX", "fork")
        with pytest.raises(RuntimeError, match="search pool worker"):
            psearch.warm_floorplan_cache(chain_graph(pcore), _grid(pcore),
                                         _points(psearch)[:1],
                                         cache=pcore.FloorplanCache(),
                                         jobs=2)
    # outside a worker the guard is off again
    pcore.simulate_batch([pcore.SimJob(chain_graph(pcore))] * 2, firings=5,
                         device="cpu")


def test_store_magic_differs_from_the_reference():
    assert store._MAGIC != rsearch.store._MAGIC
    assert len(store._MAGIC) == len(rsearch.store._MAGIC)
