"""The port's execution plan (``repro_torch.distributed``: the models'
task graphs and their floorplans onto a mesh) against the JAX package's,
on the CPU, exactly.

Every (arch, shape cell, mesh) that ``tests/test_distributed.py`` plans:
zamba2-7b's and whisper-tiny's task graphs at train_4k, and the TAPA plans
of granite-8b, zamba2-7b and arctic-480b at train_4k on (2, 16, 16);
besides, every architecture's task graph at every shape cell, every
architecture's plan on that mesh, a 2-D mesh and the baseline plan.
Both sides run the same ``autobridge`` (the port's is held to the
reference's in ``tests/test_torch_floorplan.py``), so plans agree field
for field: stage slots, boundary depths, crossing cost, ``plan_summary``.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.distributed import taskgraph as jtaskgraph  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding, taskgraph  # noqa: E402
from _torch_sim import port_obs_isolation  # noqa: E402

assert port_obs_isolation  # the autouse fixture, imported to apply here


def _graph(g):
    """A task graph as plain data: tasks with their areas, streams."""
    return ({n: (t.name, dict(t.area)) for n, t in g.tasks.items()},
            [(s.name, s.src, s.dst, s.width) for s in g.streams], g.name)


def test_shape_cells_and_param_bytes_match():
    assert {k: dataclasses.asdict(v) for k, v in taskgraph.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jtaskgraph.SHAPES.items()}
    assert taskgraph.OPT_BYTES == jtaskgraph.OPT_BYTES
    for arch in jconfigs.ARCHS:
        assert taskgraph.group_param_bytes(configs.get(arch)) == \
            jtaskgraph.group_param_bytes(jconfigs.get(arch))


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_arch_taskgraph_matches_reference(arch):
    for cell in jtaskgraph.SHAPES:
        for micro in (4096, 517):
            want = jtaskgraph.arch_taskgraph(
                jconfigs.get(arch), jtaskgraph.SHAPES[cell],
                micro_tokens=micro)
            got = taskgraph.arch_taskgraph(
                configs.get(arch), taskgraph.SHAPES[cell],
                micro_tokens=micro)
            assert _graph(got) == _graph(want), (arch, cell, micro)


def test_arch_taskgraph_families():
    """``tests/test_distributed.py::test_arch_taskgraph_families`` on the
    port: zamba2's x0 skip stream into every group, whisper's frontend."""
    cfg = configs.get("zamba2-7b")
    g = taskgraph.arch_taskgraph(cfg, taskgraph.SHAPES["train_4k"],
                                 micro_tokens=4096)
    x0 = [s for s in g.streams if s.name.startswith("x0_")]
    assert len(x0) == cfg.n_layers // len(cfg.layer_pattern)
    g = taskgraph.arch_taskgraph(configs.get("whisper-tiny"),
                                 taskgraph.SHAPES["train_4k"],
                                 micro_tokens=4096)
    assert "frontend" in g.tasks


#: (arch, cell, mesh, mode): the plans of tests/test_distributed.py, then
#: the other architectures on the same mesh, a 2-D mesh, the baseline
PLANS = ([(a, "train_4k", (2, 16, 16), "tapa")
          for a in ("granite-8b", "zamba2-7b", "arctic-480b")]
         + [(a, "train_4k", (2, 16, 16), "tapa")
            for a in jconfigs.ARCHS
            if a not in ("granite-8b", "zamba2-7b", "arctic-480b")]
         + [("granite-8b", "prefill_32k", (16, 16), "tapa"),
            ("granite-moe-3b-a800m", "decode_32k", (2, 8, 16), "tapa"),
            ("granite-8b", "train_4k", (2, 16, 16), "baseline")])


@pytest.mark.parametrize("arch,cell,mesh,mode", PLANS,
                         ids=lambda v: str(v).replace(" ", ""))
def test_plan_cell_matches_reference(arch, cell, mesh, mode):
    want = jsharding.plan_cell(jconfigs.get(arch), cell, mesh, mode=mode)
    got = sharding.plan_cell(configs.get(arch), cell, mesh, mode=mode)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    n_groups = configs.get(arch).n_layers // len(
        configs.get(arch).layer_pattern)
    assert got.n_stages * got.groups_per_stage == n_groups
    assert len(got.boundary_depth) == got.n_stages - 1
    assert all(d >= 1 for d in got.boundary_depth)
