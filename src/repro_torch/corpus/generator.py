"""Seeded task-graph generator and corpus sampling.

One design = one ``(family, seed)`` pair: ``generate_design`` derives a
private ``random.Random(f"corpus:{family}:{seed}")`` (string seeding is
stable across processes and Python hash randomization), draws a graph
from the family's ``CorpusSpec`` distributions plus the per-design
simulation knobs (latency / extra capacity / II / wave size), and stamps
the result with a content fingerprint — a sha256 digest over the graph's
canonical serialization, so any change to tasks, streams, widths, depths,
or ``meta`` annotations shows up as a new identity in bench reports and
cache keys.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import random

from repro_torch.core import SimJob
from repro_torch.core.graph import Stream, Task, TaskGraph

from .spec import FAMILIES, CorpusSpec


def graph_fingerprint(graph: TaskGraph) -> str:
    """Stable 16-hex-digit content identity of a task graph.

    sha256 over the canonical JSON serialization of every task (name,
    sorted area vector, kind, detached, pin, sorted meta) and every stream
    (name, endpoints, width, depth, control, sorted meta) — independent of
    Python hash randomization and of construction order for tasks (streams
    are order-significant: the list is part of the graph's identity).
    """
    payload = {
        "name": graph.name,
        "tasks": sorted(
            [t.name, sorted(t.area.items()), t.kind, t.detached,
             list(t.pinned) if t.pinned else None, sorted(t.meta.items())]
            for t in graph.tasks.values()),
        "streams": [
            [s.name, s.src, s.dst, s.width, s.depth, s.control,
             sorted(s.meta.items())]
            for s in graph.streams],
    }
    digest = hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()
    return digest[:16]


@dataclasses.dataclass
class CorpusDesign:
    """One generated design: the graph plus its simulation knobs."""
    graph: TaskGraph
    family: str
    seed: int
    fingerprint: str
    latency: dict[str, int]
    extra_capacity: dict[str, int]
    ii: dict[str, int]
    firings: int

    @property
    def name(self) -> str:
        return f"{self.family}-{self.seed:05d}"

    def sim_job(self) -> SimJob:
        return SimJob(self.graph, latency=dict(self.latency),
                      extra_capacity=dict(self.extra_capacity),
                      ii=dict(self.ii))


def generate_graph(rng: random.Random, spec: CorpusSpec) -> TaskGraph:
    """One task graph drawn from ``spec``'s distributions.

    Layered construction: every layer-N task draws a uniform fan-in from
    layer N-1 (reconvergence), plus the spec's skip / feedback edges and
    appended HBM-bound IO tasks.  Streams are added with
    ``validate=False`` so specs whose ``depth_choices`` include 0 can
    generate the zero-capacity FIFOs the broken-graph tests need (clean
    families keep depths >= 1 and stay free of structure errors).
    """
    g = TaskGraph(f"{spec.family}")
    layers: list[list[str]] = []
    nid = 0
    for li in range(rng.randint(*spec.layers)):
        layer = []
        for _ in range(rng.randint(*spec.tasks_per_layer)):
            name = f"t{nid}"
            nid += 1
            area: dict[str, float] = {}
            if spec.lut_range[1] > 0:
                area["LUT"] = float(rng.randint(*spec.lut_range))
            g.add_task(Task(name=name, area=area,
                            detached=(li > 0 and
                                      rng.random() < spec.detached_prob)))
            layer.append(name)
        layers.append(layer)

    sid = 0

    def stream(src: str, dst: str, depth: int, *,
               control: bool = False) -> None:
        nonlocal sid
        width = rng.choice(spec.width_choices)
        meta: dict = {}
        if (not control and spec.rate_prob
                and rng.random() < spec.rate_prob):
            # equal producer/consumer tokens-per-firing: multi-rate intent
            # annotated, balance equations consistent by construction
            rate = width * rng.choice(spec.rate_choices)
            meta = {"rate_src": rate, "rate_dst": rate}
        g.add_stream(Stream(name=f"e{sid}", src=src, dst=dst, width=width,
                            depth=depth, control=control, meta=meta),
                     validate=False)
        sid += 1

    for li in range(1, len(layers)):
        for dst in layers[li]:
            for src in rng.sample(layers[li - 1],
                                  rng.randint(1, len(layers[li - 1]))):
                stream(src, dst, rng.choice(spec.depth_choices),
                       control=(rng.random() < spec.control_prob))
    if len(layers) >= 3 and rng.random() < spec.skip_prob:
        # reconvergent skip edge across the whole graph
        stream(layers[0][0], layers[-1][0], rng.choice(spec.depth_choices))
    if rng.random() < spec.cycle_prob:
        # feedback edge: a *data* feedback closes a tokenless dependency
        # cycle (deadlock fodder for the differential); a *control* one
        # models the phase-handshake closure real designs use
        stream(layers[-1][0], layers[0][0], rng.choice(spec.cycle_depths),
               control=(rng.random() < spec.cycle_control_prob))

    for i in range(rng.randint(*spec.hbm_io_tasks)):
        # HBM-bound IO task: demands hbm_channels (a hard slot resource on
        # U280-like grids), alternating reader / writer
        name = f"io{i}"
        area = {"hbm_channels": rng.choice(spec.hbm_channel_choices)}
        if spec.lut_range[1] > 0:
            area["LUT"] = float(rng.randint(*spec.lut_range))
        g.add_task(Task(name=name, area=area, meta={"hbm_io": True}))
        depth = max(spec.depth_choices)
        if i % 2 == 0:
            stream(name, rng.choice(layers[0]), depth)
        else:
            stream(rng.choice(layers[-1]), name, depth)
    return g


def generate_design(seed: int, spec: CorpusSpec) -> CorpusDesign:
    """The design of one ``(family, seed)`` pair — fully deterministic,
    independent of generation order and of the process's hash seed."""
    rng = random.Random(f"corpus:{spec.family}:{seed}")
    g = generate_graph(rng, spec)
    lat = {s.name: rng.randint(*spec.latency_range) for s in g.streams}
    extra = {}
    for s in g.streams:
        e = rng.choice(spec.extra_choices)
        extra[s.name] = 2 * lat[s.name] if e < 0 else e
    ii = {n: rng.randint(*spec.ii_range) for n in g.tasks}
    firings = rng.randint(*spec.firings_range)
    return CorpusDesign(graph=g, family=spec.family, seed=seed,
                        fingerprint=graph_fingerprint(g), latency=lat,
                        extra_capacity=extra, ii=ii, firings=firings)


def sample_corpus(spec: CorpusSpec | str, n: int, *,
                  seed: int = 0) -> list[CorpusDesign]:
    """``n`` designs of one family, seeds ``seed .. seed + n - 1``.

    Accepts a spec or a ``FAMILIES`` name.  Sampling is embarrassingly
    indexable — design ``i`` only depends on ``(family, seed + i)`` — so
    CI's pinned seed set and the nightly's larger one overlap exactly on
    the shared prefix.
    """
    if isinstance(spec, str):
        spec = FAMILIES[spec]
    return [generate_design(seed + i, spec) for i in range(n)]


def random_graph(rng: random.Random, allow_cycle: bool = False,
                 spec: CorpusSpec | None = None) -> TaskGraph:
    """Drop-in replacement for the tests' historical ``_random_graph``
    helpers: a ``fuzz``-family graph drawn from ``rng`` (layered DAG,
    zero-depth FIFOs, control streams, detached sinks, skip edges, and —
    with ``allow_cycle`` — an occasional feedback edge that may close a
    tokenless dependency cycle)."""
    if spec is None:
        spec = FAMILIES["fuzz"]
    if not allow_cycle:
        spec = dataclasses.replace(spec, cycle_prob=0.0)
    return generate_graph(rng, spec)
