"""The six metrics that read the program's phase spans
(``{forward,backward,optimizer}_ms.train``, ``prefill_ms.serve``,
``{prefill,decode}_idle_pct.serve``), each on a hand-made trace and
hand-made span records, against the value worked by hand; each is left
out where the window's root spans are not one a traced unit, or where the
spans lie outside the window."""
from __future__ import annotations

import pytest

from portbench import harness
from portbench.devtrace import Op, Trace
from repro_torch.obs import trace

#: window 1,000-10,000 ns, 2 steps: forward, backward and optimizer of
#: step 1 read 10, 20, 30 ms, of step 2 12, 24, 36; a third step before
#: the window reads 99 each and does not count
TRAIN = [("train.step", None, 1_100, 4_000, 60.0),
         ("train.forward", 1, 1_100, 1_000, 10.0),
         ("train.backward", 1, 2_100, 2_000, 20.0),
         ("train.optimizer", 1, 4_100, 1_000, 30.0),
         ("train.step", None, 5_200, 4_000, 72.0),
         ("train.forward", 5, 5_200, 1_000, 12.0),
         ("train.backward", 5, 6_200, 2_000, 24.0),
         ("train.optimizer", 5, 8_200, 1_000, 36.0),
         ("train.step", None, 100, 800, 99.0),
         ("train.forward", 9, 100, 200, 99.0),
         ("train.backward", 9, 300, 200, 99.0),
         ("train.optimizer", 9, 500, 200, 99.0)]
#: window 0-100,000 ns, 2 calls, prefill 18 and 19 ms on the device
SERVE = [("serve.generate", None, 1_000, 40_000, 40.0),
         ("serve.prefill", 1, 2_000, 20_000, 18.0),
         ("serve.decode", 1, 22_000, 18_000, 20.0),
         ("serve.generate", None, 50_000, 40_000, 41.0),
         ("serve.prefill", 4, 51_000, 20_000, 19.0),
         ("serve.decode", 4, 71_000, 18_000, 21.0)]
#: the device's operations: the prefills covered 18,500 and 19,000 of
#: 20,000 ns each (two overlapping kernels in the first); the decodes
#: 4,000 and 12,000 of 18,000 each (the last kernel runs 500 ns past its
#: span); one operation between the calls
DEVICE = [(2_500, 12_000), (11_000, 21_000), (51_000, 70_000),
          (23_000, 25_000), (30_000, 32_000), (72_000, 75_000),
          (80_000, 89_500), (45_000, 46_000)]
#: each metric's value worked by hand: the means of the spans' dev_ms in
#: the window; idle 1 - 37,500 / 40,000 and 1 - 16,000 / 36,000
EXPECTED = {"forward_ms.train": 11.0, "backward_ms.train": 22.0,
            "optimizer_ms.train": 33.0, "prefill_ms.serve": 18.5,
            "prefill_idle_pct.serve": 6.25,
            "decode_idle_pct.serve": 100 * (1 - 16_000 / 36_000)}


def _records(rows, tag: str):
    """Span records as ``obs.trace`` keeps them; a parent is given by its
    row (1-based)."""
    return [{"id": f"{tag}-{i}", "name": name,
             "parent": None if p is None else f"{tag}-{p}",
             "pid": 1, "tid": 1, "t_ns": t, "dur_ns": d, "end_seq": i,
             "args": {}, "dev_ms": ms}
            for i, (name, p, t, d, ms) in enumerate(rows, 1)]


def _reading(name: str, units: int = 2, shift: int = 0) -> harness.Reading:
    kind = name.rsplit(".", 1)[1]
    ops = [Op("k", a, b) for a, b in DEVICE] if kind == "serve" else \
        [Op("k", 1_200, 9_000)]
    start, end = (0, 100_000) if kind == "serve" else (1_000, 10_000)
    tr = Trace(ops, [], start + shift, end + shift, units)
    return harness.Reading(kind, {}, {}, 1.0, 10, trace=tr)


@pytest.fixture(autouse=True)
def spans():
    """The hand-made spans in the program's span buffer, for this test
    only."""
    saved = trace.drain()
    trace.absorb(_records(TRAIN, "t") + _records(SERVE, "s"))
    try:
        yield
    finally:
        trace.clear()
        trace.absorb(saved)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_span_metric_reads_the_value_worked_by_hand(name):
    value = harness.metric_reader(name)(_reading(name))
    assert value == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("case", ["units", "outside", "no spans", "kind"])
def test_each_span_metric_is_left_out_without_its_spans(name, case):
    r = _reading(name, units=3 if case == "units" else 2,
                 shift=200_000 if case == "outside" else 0)
    if case == "no spans":
        trace.clear()
    if case == "kind":
        r.kind = "train" if r.kind == "serve" else "serve"
    assert harness.metric_reader(name)(r) is None
