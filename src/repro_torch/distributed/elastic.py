"""Elastic re-meshing and fault tolerance.

The port's copy of ``repro/distributed/elastic.py``: the same replanning,
on ``repro_torch.core.autobridge``.

Failure path = the paper's own feedback loop reused: when a slot (pod
slice or chip group) is lost, rebuild the slot grid with the surviving
slots and *re-run the floorplanner* — the task graph does not change, only
the device model.  The new plan compiles into new shardings; restoring a
checkpoint onto them is the distributed runtime's, which the port does not
have yet.

Straggler mitigation: a persistently slow stage bounds throughput in a
synchronous pipeline.  The floorplanner's compute-balance constraint (the
per-slot flops capacity, §4.2's utilization limit) keeps stages even by
construction; at runtime we detect skew from per-stage step-time telemetry
and trigger a re-floorplan with that slot's flops capacity derated —
mitigation by re-placement rather than by asynchrony, keeping the
deterministic schedule.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.core import InfeasibleError, autobridge
from .sharding import TpuPlan, tpu_slotgrid
from .taskgraph import SHAPES, arch_taskgraph


@dataclasses.dataclass
class ClusterState:
    pods: int
    data: int
    model: int
    #: slots (row, col) currently marked failed
    failed_slots: frozenset = frozenset()
    #: per-slot compute derating (1.0 = healthy), from straggler telemetry
    derate: dict | None = None


def replan(cfg: ArchConfig, cell_name: str, state: ClusterState, *,
           col_slots: int = 4, n_micro: int = 8, seed: int = 0) -> TpuPlan:
    """Re-run the co-optimization against the degraded device model."""
    cell = SHAPES[cell_name]
    n_groups = cfg.n_layers // len(cfg.layer_pattern)
    micro_tokens = max(cell.global_batch // n_micro, 1) * \
        (cell.seq_len if cell.kind != "decode" else 1)
    graph = arch_taskgraph(cfg, cell, micro_tokens=micro_tokens)
    grid = tpu_slotgrid(state.pods, state.data, state.model,
                        col_slots=col_slots)
    # failed slots lose all capacity; stragglers lose flops headroom
    for slot in state.failed_slots:
        grid.slot_caps.setdefault(slot, {}).update(
            {k: 0.0 for k in grid.base_capacity})
    total_flops = sum(t.area.get("flops", 0.0) for t in graph.tasks.values())
    n_ok = state.pods * col_slots - len(state.failed_slots)
    if n_ok <= 0:
        raise InfeasibleError("no surviving slots")
    grid.base_capacity["flops"] = total_flops / n_ok / 0.72
    for slot, frac in (state.derate or {}).items():
        caps = grid.slot_caps.setdefault(slot, {})
        caps["flops"] = grid.base_capacity["flops"] * frac

    plan = None
    err = None
    for util in (0.9, 0.95, 1.0):
        try:
            plan = autobridge(graph, grid, max_util=util, seed=seed,
                              n_starts=6)
            break
        except InfeasibleError as e:
            err = e
            grid.base_capacity["flops"] *= 1.4
    if plan is None:
        raise err
    order = []
    for i in range(n_groups):
        slot = plan.floorplan.placement[f"group{i}"]
        if not order or order[-1] != slot:
            order.append(slot)
    n_stages = len(order)
    while n_groups % n_stages:
        n_stages -= 1
    order = order[:n_stages]
    depths = [max(grid.crossing_depth(order[i], order[i + 1]), 1)
              for i in range(n_stages - 1)]
    return TpuPlan(mode="tapa", n_stages=n_stages,
                   groups_per_stage=n_groups // n_stages, stage_slots=order,
                   boundary_depth=depths,
                   tp=state.model // col_slots,
                   crossing_cost=plan.floorplan.cost,
                   plan_summary=plan.summary())
