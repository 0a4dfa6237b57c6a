"""The port's task graphs, device grids and the paper's designs
(``repro_torch.core.graph``, ``core.devicegrid``, ``fpga``) against the
reference's: the same tasks, areas, streams, widths, depths and control
flags for every design of ``autobridge_suite()`` and ``hbm_suite()``, and
the same slot grids for every device."""
import dataclasses

import pytest
from _torch_sim import port_obs_isolation

import repro.core as rcore
import repro.fpga as rfpga
import repro_torch.core as pcore
import repro_torch.fpga as pfpga
from repro.fpga import benchmarks as rbench
from repro_torch.fpga import benchmarks as pbench

assert port_obs_isolation  # the autouse fixture, imported to apply here


def _graph(g):
    """Everything a graph holds, as plain data."""
    return (g.name,
            [dataclasses.asdict(t) for t in g.tasks.values()],
            [dataclasses.asdict(s) for s in g.streams],
            {n: [s.name for s in g.in_streams(n)] for n in g.tasks},
            {n: [s.name for s in g.out_streams(n)] for n in g.tasks},
            g.total_area())


SUITES = ("autobridge_suite", "hbm_suite")


@pytest.mark.parametrize("suite", SUITES)
def test_suites_equal_the_reference(suite):
    ref, port = getattr(rbench, suite)(), getattr(pbench, suite)()
    assert [(n, b) for n, b, _ in port] == [(n, b) for n, b, _ in ref]
    for (_, _, rg), (_, _, pg) in zip(ref, port):
        assert isinstance(pg, pcore.TaskGraph)
        assert _graph(pg) == _graph(rg)


def test_the_paper_designs_count_48_rows():
    rows = pbench.autobridge_suite() + pbench.hbm_suite()
    assert len(rows) == 48
    sizes = {n: (g.num_tasks, g.num_streams) for n, _, g in rows}
    assert max(s for _, s in sizes.values()) == sizes["cnn_13x16"][1]


@pytest.mark.parametrize("use_async", [False, True])
@pytest.mark.parametrize("builder,args", [
    ("stencil", (3,)), ("cnn", (4,)), ("gaussian", (12,)),
    ("bucket_sort", ()), ("page_rank", ()), ("genome", (8,)),
    ("sasa", (2,)), ("spmm", ()), ("spmv", (20,)),
])
def test_design_builders_equal_the_reference(builder, args, use_async):
    rg = getattr(rbench, builder)(*args, use_async=use_async)
    pg = getattr(pbench, builder)(*args, use_async=use_async)
    assert _graph(pg) == _graph(rg)


def _grid(grid):
    return dataclasses.asdict(grid)


@pytest.mark.parametrize("name", sorted(rfpga.DEVICE_GRIDS))
def test_device_grids_equal_the_reference(name):
    rg, pg = rfpga.grid_for(name), pfpga.grid_for(name)
    assert isinstance(pg, pcore.SlotGrid)
    assert _grid(pg) == _grid(rg)
    assert pg.slots() == rg.slots()
    assert pg.resource_keys() == rg.resource_keys()
    assert pg.hbm_slots() == rg.hbm_slots()
    assert pg.total_hbm_channels() == rg.total_hbm_channels()
    for a in rg.slots():
        assert pg.capacity(*a) == rg.capacity(*a)
        for b in rg.slots():
            assert pg.crossing_weight(a, b) == rg.crossing_weight(a, b)
            assert pg.crossing_depth(a, b) == rg.crossing_depth(a, b)
            assert pg.crossing_delay_ns(a, b) == rg.crossing_delay_ns(a, b)


@pytest.mark.parametrize("knobs", [
    dict(row_weight=2.0), dict(col_weight=0.5, depth_scale=1.5)])
def test_grid_knobs_equal_the_reference(knobs):
    for name in ("u250", "u280"):
        rg = rfpga.grid_for(name).with_knobs(**knobs)
        pg = pfpga.grid_for(name).with_knobs(**knobs)
        assert _grid(pg) == _grid(rg)
    assert _grid(pfpga.u280_grid().with_hbm_binding(0.25)) == \
        _grid(rfpga.u280_grid().with_hbm_binding(0.25))
    assert _grid(pfpga.tpu_pod_grid()) == _grid(rfpga.tpu_pod_grid())
    assert pfpga.U280_HBM_CHANNELS == rfpga.U280_HBM_CHANNELS


def test_builder_and_graph_checks_equal_the_reference():
    """The builder's round-robin ``count=N`` instances and its refusals."""
    def build(core):
        b = core.TaskGraphBuilder("VecAdd")
        a = b.streams("a", n=4, width=32)
        c = b.streams("c", n=4, width=32)
        b.invoke("Load", area={"LUT": 900}, outs=a, count=4)
        b.invoke("Add", area={"LUT": 300, "DSP": 1}, ins=a, outs=c, count=4)
        b.invoke("Store", area={"LUT": 700}, ins=c, count=4)
        return b.build()

    assert _graph(build(pcore)) == _graph(build(rcore))
    for core in (rcore, pcore):
        g = core.TaskGraph("bad")
        g.add_task(core.Task("A"))
        with pytest.raises(ValueError, match="self-loop"):
            g.add_stream(core.Stream("s", "A", "A"))
        with pytest.raises(ValueError, match="unknown task"):
            g.add_stream(core.Stream("s", "A", "B"))
