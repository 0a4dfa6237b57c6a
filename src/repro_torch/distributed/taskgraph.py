"""Architecture -> TAPA task graph (the TPU side of the paper's front-end).

The port's copy of ``repro/distributed/taskgraph.py``: the same graph,
built on ``repro_torch.core``.

A model is a task-parallel dataflow program: layer groups are tasks
communicating through activation streams; zamba2's shared attention block
and arctic's dense-residual-beside-MoE create the reconvergent paths the
latency balancer exists for; embedding/data-in and loss/readout tasks pin
to the ingest/egress ends of the mesh like HBM IO modules.

Resource model (per task):
  hbm_bytes — parameters + optimizer state (AdamW 10 B/param, Adafactor
              2.6 B/param) + activation working set per microbatch
  flops     — 6 * active params (per-token compute proxy; keeps stages
              compute-balanced, the paper's per-slot utilization limit)
Stream widths are activation bytes per microbatch crossing between groups.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.core import Stream, Task, TaskGraph

OPT_BYTES = {"adamw": 10.0, "adafactor": 2.6}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def group_param_bytes(cfg: ArchConfig) -> tuple[float, float]:
    """(total_bytes, active_bytes) of ONE layer-group's params (bf16)."""
    per_layer_total = (cfg.param_count() - cfg.vocab * cfg.d_model *
                       (1 if cfg.tie_embeddings else 2)) / cfg.n_layers
    per_layer_active = (cfg.active_param_count() - cfg.vocab * cfg.d_model *
                        (1 if cfg.tie_embeddings else 2)) / cfg.n_layers
    g = len(cfg.layer_pattern)
    return per_layer_total * g * 2.0, per_layer_active * g * 2.0


def arch_taskgraph(cfg: ArchConfig, cell: ShapeCell, *,
                   micro_tokens: int) -> TaskGraph:
    """Build the flattened task graph: data_in -> embed -> group_0 ... ->
    head -> loss_out, plus skip/side streams per family."""
    g = TaskGraph(f"{cfg.name}:{cell.name}")
    n_groups = cfg.n_layers // len(cfg.layer_pattern)
    act_w = float(micro_tokens * cfg.d_model * 2)     # bytes per microbatch
    opt_mult = OPT_BYTES[cfg.optimizer] / 2.0 if cell.kind == "train" else 1.0

    emb_bytes = cfg.vocab * cfg.d_model * 2.0 * opt_mult
    gp_total, gp_active = group_param_bytes(cfg)
    act_bytes = micro_tokens * cfg.d_model * 2.0 * len(cfg.layer_pattern) \
        * (4 if cell.kind == "train" else 1)

    g.add_task(Task("data_in", area={"io_channels": 1.0}))
    g.add_task(Task("embed", area={"hbm_bytes": emb_bytes,
                                   "flops": 0.0}))
    for i in range(n_groups):
        g.add_task(Task(f"group{i}", area={
            "hbm_bytes": gp_total * opt_mult + act_bytes,
            "flops": 6.0 * gp_active / 2.0,
        }))
    g.add_task(Task("head", area={
        "hbm_bytes": 0.0 if cfg.tie_embeddings else emb_bytes,
        "flops": 2.0 * cfg.vocab * cfg.d_model}))
    g.add_task(Task("loss_out", area={"io_channels": 1.0}))

    g.add_stream(Stream("tokens", "data_in", "embed", width=micro_tokens * 4))
    prev = "embed"
    for i in range(n_groups):
        g.add_stream(Stream(f"act{i}", prev, f"group{i}", width=act_w))
        prev = f"group{i}"
    g.add_stream(Stream(f"act{n_groups}", prev, "head", width=act_w))
    g.add_stream(Stream("loss", "head", "loss_out", width=4))

    # family-specific side streams (reconvergent paths)
    if "H" in cfg.layer_pattern:
        # zamba2: embeddings broadcast into every H group (skip stream)
        for i in range(n_groups):
            g.add_stream(Stream(f"x0_{i}", "embed", f"group{i}",
                                width=act_w))
    if cfg.family in ("vlm", "audio"):
        g.add_task(Task("frontend", area={
            "hbm_bytes": cfg.frontend_dim * cfg.d_model * 2.0 * opt_mult,
            "io_channels": 1.0}))
        # memory feeds every cross-attention group
        for i in range(n_groups):
            if "X" in cfg.layer_pattern:
                g.add_stream(Stream(
                    f"mem_{i}", "frontend", f"group{i}",
                    width=float(cfg.frontend_tokens * cfg.d_model * 2)))
    return g
