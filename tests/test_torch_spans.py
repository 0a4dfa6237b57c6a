"""The phase spans of the training step and of the serving call
(``launch/train.py::train_step``, ``launch/serve.py::generate``), on the
CPU at granite-8b's reduced configuration.

Under ``torch.profiler`` each records its root span with its phases as
children, in order, on the profiler's clock: within 50 µs of the
profiler's user annotation of the same name.  With no profiler running
and ``obs.trace`` off nothing records.  The spans pass
``validate_chrome``.  CUDA events cannot be made here, so the device
interval (``dev_ms``) is held with stand-in events: the buffer's readers
resolve it, and it stays out of the Chrome export's ``args``."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.launch import serve, train
from repro_torch.model import lm
from repro_torch.obs import trace
from repro_torch.optim import adamw_init

#: the root span of each path and its phases, in order
PHASES = {"train": ("train.step", ["train.forward", "train.backward",
                                   "train.optimizer"]),
          "serve": ("serve.generate", ["serve.prefill", "serve.decode"])}
#: how far a span's ends may lie from the profiler's annotation's
CLOCK_NS = 50_000


@pytest.fixture(autouse=True)
def _own_buffer():
    """Each test starts with an empty buffer and tracing off; the state
    before it comes back after."""
    was, saved = trace.enabled(), trace.drain()
    trace.disable()
    try:
        yield
    finally:
        trace.clear()
        if was:
            trace.enable()
        trace.absorb(saved)


@pytest.fixture(scope="module")
def paths():
    """One call of each path, on tiny shapes: a training step, a serving
    call of 2 prompts x 8 ids and 2 greedy tokens."""
    cfg = configs.get_reduced("granite-8b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    params.requires_grad_(True)
    opt = adamw_init(dict(params.named_parameters()))
    served = lm.init_params(cfg, seed=1, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    prompts = serve.make_prompts(cfg, 2, 8, torch.device("cpu"))
    return {"train": lambda: train.train_step(params, cfg, opt, tokens, 1e-3),
            "serve": lambda: serve.generate(served, cfg, prompts, 2)}


def _profiled(fn):
    """(spans, {name: (start, end) ns}) of ``fn`` under a CPU profile: the
    span records and the profiler's user annotations."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    notes = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    return trace.drain(), notes


@pytest.fixture(scope="module")
def profiled(paths):
    """Each path profiled twice; the second run's spans and annotations
    (the first opens the profiler's annotations for the first time)."""
    was, saved = trace.enabled(), trace.drain()
    trace.disable()
    out = {}
    for kind, fn in paths.items():
        _profiled(fn)
        out[kind] = _profiled(fn)
    if was:
        trace.enable()
    trace.absorb(saved)
    return out


@pytest.mark.parametrize("kind", sorted(PHASES))
def test_phases_are_the_root_spans_children_in_order(profiled, kind):
    spans, _ = profiled[kind]
    root, phases = PHASES[kind]
    assert [e["name"] for e in spans] == [root] + phases
    assert spans[0]["parent"] is None
    assert all(e["parent"] == spans[0]["id"] for e in spans[1:])
    assert all(e["dur_ns"] is not None and "dev_ms" not in e for e in spans)
    ends = [e["t_ns"] + e["dur_ns"] for e in spans]
    assert all(spans[0]["t_ns"] <= e["t_ns"] and end <= ends[0]
               for e, end in zip(spans[1:], ends[1:]))
    assert all(a <= b["t_ns"] for a, b in zip(ends[1:], spans[2:]))


@pytest.mark.parametrize("kind", sorted(PHASES))
def test_spans_sit_on_the_profilers_clock(profiled, kind):
    spans, notes = profiled[kind]
    for e in spans:
        start, end = notes[e["name"]]
        assert abs(e["t_ns"] - start) < CLOCK_NS, e["name"]
        assert abs(e["t_ns"] + e["dur_ns"] - end) < CLOCK_NS, e["name"]


@pytest.mark.parametrize("kind", sorted(PHASES))
def test_spans_pass_validate_chrome(profiled, kind):
    spans, _ = profiled[kind]
    doc = trace.to_chrome(spans)
    assert trace.validate_chrome(doc) == []
    assert [ev["name"] for ev in doc["traceEvents"] if ev["ph"] == "B"] == \
        [PHASES[kind][0]] + PHASES[kind][1]


@pytest.mark.parametrize("kind", sorted(PHASES))
def test_nothing_records_without_a_profiler(paths, kind):
    paths[kind]()
    assert trace.events() == []


@pytest.mark.parametrize("kind", sorted(PHASES))
def test_enable_records_the_same_spans_without_a_profiler(paths, kind):
    trace.enable()
    paths[kind]()
    trace.disable()
    root, phases = PHASES[kind]
    assert [e["name"] for e in trace.events()] == [root] + phases


class _Event:
    """A stand-in for ``torch.cuda.Event``: recorded at a host time."""

    def __init__(self, ms: float):
        self.ms, self.waited = ms, False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, other: "_Event") -> float:
        assert other.waited
        return other.ms - self.ms


@pytest.mark.parametrize("reader", ["events", "drain", "to_chrome"])
def test_device_events_resolve_to_dev_ms_when_the_buffer_is_read(
        monkeypatch, reader):
    clock = iter([1.0, 3.5, 4.0, 9.25])
    monkeypatch.setattr(trace, "_device_event", lambda: _Event(next(clock)))
    trace.enable()
    with trace.span("outer", n=1):
        with trace.span("inner"):
            pass
    trace.disable()
    if reader == "to_chrome":
        doc = trace.to_chrome()
        assert all("dev_ms" not in ev.get("args", {})
                   for ev in doc["traceEvents"])
        json.dumps(doc)
    spans = trace.drain() if reader == "drain" else trace.events()
    assert {e["name"]: e["dev_ms"] for e in spans} == {"outer": 8.25,
                                                       "inner": 0.5}
    assert all(e["args"].keys() <= {"n"} for e in spans)
