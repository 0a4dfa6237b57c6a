"""Floorplan -> TPU execution plan, the planning half.

The port's copy of ``repro/distributed/sharding.py`` without
``refined_mesh``, which builds a device mesh and belongs to the
distributed runtime.  The production mesh is viewed as a TAPA slot grid:
rows = pods (DCN boundaries, expensive), cols = model-axis subgroups (ICI
boundaries).  The same autobridge co-optimization that floorplans FPGA
designs assigns layer-group tasks to slots; the result is a stage order
over the slots and per-stage-boundary buffer depths (pipelining + latency
balancing) that become skew slots in the pipeline schedule.

Baseline plan (= the "default Vivado flow"): no floorplan — every layer
sharded over the full model axis (max-TP "packed" GSPMD) with ZeRO-1 DP.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.core import Boundary, InfeasibleError, SlotGrid, autobridge
from .taskgraph import SHAPES, ShapeCell, arch_taskgraph

HBM_PER_CHIP = 16e9          # v5e
DCN_WEIGHT = 4.0             # pod-boundary crossing cost vs 1 ICI hop


def tpu_slotgrid(pods: int, data: int, model: int, *, col_slots: int = 4,
                 max_util: float = 0.9) -> SlotGrid:
    """Slot grid over the mesh: (pods) x (col_slots) slots, each owning
    data * (model/col_slots) chips."""
    chips_per_slot = data * (model // col_slots)
    cap = {
        "hbm_bytes": chips_per_slot * HBM_PER_CHIP,
        "flops": float("inf"),      # replaced per-graph (balance knob)
        "io_channels": 4.0,
    }
    return SlotGrid(
        f"tpu_{pods}x{data}x{model}", rows=pods, cols=col_slots,
        base_capacity=cap,
        row_boundaries=[Boundary(weight=DCN_WEIGHT, pipeline_depth=2,
                                 delay_ns=0.0) for _ in range(pods - 1)],
        col_boundaries=[Boundary(weight=1.0, pipeline_depth=1, delay_ns=0.0)
                        for _ in range(col_slots - 1)],
        max_util=max_util)


@dataclasses.dataclass
class TpuPlan:
    mode: str                          # "tapa" | "baseline"
    n_stages: int
    groups_per_stage: int
    #: slot (row, col) occupied by each stage, in chain order
    stage_slots: list[tuple[int, int]]
    #: skew (buffer depth) of each stage boundary, len n_stages-1
    boundary_depth: list[int]
    tp: int                            # chips on the model axis per stage
    crossing_cost: float
    plan_summary: dict | None = None


def plan_arch(cfg: ArchConfig, cell: ShapeCell, *, pods: int, data: int,
              model: int, col_slots: int = 4, n_micro: int = 8,
              seed: int = 0) -> TpuPlan:
    """Run the TAPA co-optimization for (arch x shape x mesh)."""
    n_groups = cfg.n_layers // len(cfg.layer_pattern)
    micro_tokens = max(cell.global_batch // n_micro, 1) * \
        (cell.seq_len if cell.kind != "decode" else 1)
    graph = arch_taskgraph(cfg, cell, micro_tokens=micro_tokens)
    grid = tpu_slotgrid(pods, data, model, col_slots=col_slots)
    # compute-balance knob: per-slot flops capacity (paper's max_util)
    total_flops = sum(t.area.get("flops", 0.0)
                      for t in graph.tasks.values())
    n_slots = pods * col_slots
    grid.base_capacity["flops"] = total_flops / n_slots / 0.72

    plan = None
    for util in (0.9, 0.95, 1.0):
        try:
            plan = autobridge(graph, grid, max_util=util, seed=seed,
                              n_starts=6)
            break
        except InfeasibleError:
            # loosen compute balance before giving up
            grid.base_capacity["flops"] *= 1.5
    if plan is None:
        plan = autobridge(graph, grid, max_util=1.0, seed=seed, n_starts=6)

    # stages = slots visited by the chain, in group order
    order: list[tuple[int, int]] = []
    for i in range(n_groups):
        slot = plan.floorplan.placement[f"group{i}"]
        if not order or order[-1] != slot:
            order.append(slot)
    # regularize to uniform stage sizes (stacked-scan pipeline needs it)
    n_stages = len(order)
    while n_groups % n_stages:
        n_stages -= 1
    order = order[:n_stages]
    depths = []
    for i in range(n_stages - 1):
        a, b = order[i], order[i + 1]
        d = grid.crossing_depth(a, b)
        depths.append(max(d, 1))
    return TpuPlan(mode="tapa", n_stages=n_stages,
                   groups_per_stage=n_groups // n_stages,
                   stage_slots=order, boundary_depth=depths,
                   tp=model // col_slots, crossing_cost=plan.floorplan.cost,
                   plan_summary=plan.summary())


def baseline_plan(cfg: ArchConfig, *, pods: int, data: int,
                  model: int) -> TpuPlan:
    n_groups = cfg.n_layers // len(cfg.layer_pattern)
    return TpuPlan(mode="baseline", n_stages=1, groups_per_stage=n_groups,
                   stage_slots=[(0, 0)], boundary_depth=[], tp=model,
                   crossing_cost=0.0)


def plan_cell(cfg: ArchConfig, cell_name: str, mesh_shape: tuple[int, ...],
              *, seed: int = 0, mode: str = "tapa") -> TpuPlan:
    cell = SHAPES[cell_name]
    if len(mesh_shape) == 2:
        pods, (data, model) = 1, mesh_shape
    else:
        pods, data, model = mesh_shape
    if mode == "baseline":
        return baseline_plan(cfg, pods=pods, data=data, model=model)
    return plan_arch(cfg, cell, pods=pods, data=data, model=model, seed=seed)
