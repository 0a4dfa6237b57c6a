"""Corpus specification: the knobs of the seeded task-graph generator.

A ``CorpusSpec`` is a frozen bundle of distribution knobs — topology
(layer/task counts, fan-in, skip/feedback edges), stream properties
(depth, width, control probability, SDF rate annotations), task
properties (detached probability, LUT area, HBM-bound IO tasks) and the
per-design simulation knob ranges (latency, headroom, II, wave size).
``FAMILIES`` names the presets the benchmark suite and CI sweep; the
``fuzz`` family keeps the deliberately-broken coverage (zero-capacity
FIFOs, tokenless data cycles, detached sinks) that the simulator and
analysis property tests rely on, while every other family generates
lint-clean designs (zero ``repro_torch.analysis`` structure errors).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """Distribution knobs of one corpus family.

    All ``*_range`` fields are inclusive ``(lo, hi)`` integer ranges; all
    ``*_choices`` fields are uniform-choice tuples (repeat a value to
    weight it).  Probabilities are per-opportunity.
    """
    #: family tag (also the graph-name prefix and part of the design seed)
    family: str = "dag"

    # -- topology ----------------------------------------------------------
    layers: tuple[int, int] = (2, 4)
    tasks_per_layer: tuple[int, int] = (1, 3)
    #: each layer-N task draws its fan-in uniformly from 1..len(layer N-1)
    #: (full reconvergence possible); these knobs add the non-layered edges
    skip_prob: float = 0.7          # reconvergent first->last skip edge
    cycle_prob: float = 0.0         # feedback edge closing a cycle
    cycle_depths: tuple[int, ...] = (0, 1, 2)
    cycle_control_prob: float = 0.0  # feedback edge demoted to control

    # -- streams -----------------------------------------------------------
    depth_choices: tuple[int, ...] = (1, 2, 3, 4)
    width_choices: tuple[float, ...] = (32.0,)
    control_prob: float = 0.1
    #: probability a data stream carries SDF ``meta`` rate annotations
    #: (``rate_src`` / ``rate_dst``); rates are drawn per-stream with equal
    #: producer/consumer tokens-per-firing, so the balance equations stay
    #: consistent by construction (no R001 diagnostics)
    rate_prob: float = 0.0
    rate_choices: tuple[int, ...] = (1, 2, 4)

    # -- tasks -------------------------------------------------------------
    detached_prob: float = 0.1      # non-source layers only
    #: per-task LUT area range; (0, 0) means empty area vectors (the fuzz
    #: family — floorplan-trivial, simulator-focused)
    lut_range: tuple[int, int] = (0, 0)
    #: number of HBM-bound IO tasks appended to the graph; each demands
    #: ``hbm_channels`` area and alternates reader (feeds the first layer)
    #: / writer (drains the last layer)
    hbm_io_tasks: tuple[int, int] = (0, 0)
    hbm_channel_choices: tuple[float, ...] = (1.0, 2.0)

    # -- per-design simulation knobs --------------------------------------
    latency_range: tuple[int, int] = (0, 4)
    #: extra-capacity choices; the ``-1`` sentinel means "full pipeline
    #: headroom", i.e. ``2 * latency`` of that stream
    extra_choices: tuple[int, ...] = (0, 0, 2, -1)
    ii_range: tuple[int, int] = (1, 4)
    firings_range: tuple[int, int] = (10, 30)


#: the named corpus families.  ``fuzz`` mirrors the historical ad-hoc
#: ``_random_graph`` test helpers (zero-depth FIFOs, data-cycle deadlocks,
#: detached sinks — broken on purpose); the rest are lint-clean and carry
#: areas so the floorplanner has real work.
FAMILIES: dict[str, CorpusSpec] = {
    "fuzz": CorpusSpec(
        family="fuzz",
        depth_choices=(0, 1, 2, 3),
        cycle_prob=0.5,
        cycle_control_prob=0.2,
    ),
    "dag": CorpusSpec(
        family="dag",
        layers=(3, 5),
        tasks_per_layer=(1, 3),
        width_choices=(16.0, 32.0, 64.0),
        lut_range=(50, 400),
        detached_prob=0.0,
    ),
    "cyclic": CorpusSpec(
        family="cyclic",
        layers=(3, 4),
        cycle_prob=1.0,
        cycle_depths=(2, 3, 4),
        cycle_control_prob=1.0,     # control-closed: cycles, no deadlock
        lut_range=(50, 300),
        detached_prob=0.0,
    ),
    "sdf": CorpusSpec(
        family="sdf",
        layers=(2, 4),
        rate_prob=1.0,
        width_choices=(8.0, 32.0),
        lut_range=(50, 300),
    ),
    "wide": CorpusSpec(
        family="wide",
        layers=(2, 3),
        tasks_per_layer=(3, 6),
        skip_prob=0.9,
        width_choices=(64.0, 128.0, 256.0),
        lut_range=(100, 600),
        detached_prob=0.0,
    ),
    "hbm": CorpusSpec(
        family="hbm",
        layers=(2, 3),
        tasks_per_layer=(1, 3),
        lut_range=(50, 300),
        hbm_io_tasks=(2, 6),
        hbm_channel_choices=(1.0, 2.0, 4.0),
        detached_prob=0.0,
    ),
}

#: the lint-clean families (what the CI corpus gate sweeps); ``fuzz`` is
#: excluded on purpose — it generates broken graphs for the simulator and
#: analysis differential, not floorplannable designs.
CLEAN_FAMILIES: tuple[str, ...] = ("dag", "cyclic", "sdf", "wide", "hbm")
