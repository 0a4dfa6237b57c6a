"""repro_torch.core — the paper's contribution: task-parallel dataflow
graphs, coarse-grained floorplanning co-optimized with compilation,
throughput-safe latency balancing, the timing model, and the dataflow
simulator, with ``simulate_batch`` (and so ``Plan.verify_throughput``) on
the card.

Counterpart of ``repro.core``.  The names it re-exports from the
design-space search, which the port does not have yet, raise
``NotImplementedError`` naming the item of ``ROADMAP.md``'s port queue
that brings them.
"""
from .autobridge import (FloorplanCache, Plan, autobridge, floorplan_counts,
                         initial_floorplan_key, merge_floorplan_counts,
                         reset_floorplan_counts)
from .balance import BalanceResult, CycleError, balance_graph, balance_latencies
from .devicegrid import Boundary, SlotGrid
from .floorplan import Floorplan, floorplan
from .fmax_model import PhysicalModel, TimingReport, analyze_timing, packed_placement
from .graph import Stream, Task, TaskGraph, TaskGraphBuilder
from .ilp import InfeasibleError
from .pipelining import PipelineAssignment, assign_pipelining
from .simulate import (SimJob, SimResult, StreamProfile, engine_counts,
                       pipeline_headroom, reset_engine_counts, simulate,
                       simulate_batch)

_SEARCH = "port queue item 5d (search and corpus)"

#: name re-exported by ``repro.core`` -> the ROADMAP item that brings it
_PENDING = dict.fromkeys((
    "BackendSweep", "Candidate", "ConvergedSearch", "DeferredSearch",
    "DiskFloorplanStore", "FaultPlan", "Interval", "SearchJournal",
    "SearchPoint", "SearchResult", "SearchSpace",
    "best_candidate", "explore_design_space", "explore_floorplans",
    "gather_sim_jobs", "hypervolume", "measure_backend_speedup",
    "pareto_frontier", "pareto_indices", "pool_simulations",
    "prepare_design_space", "scatter_sim_results",
    "search_until_converged", "sweep_backends",
    "timed_pool_simulations"), _SEARCH)

__all__ = [
    "FloorplanCache", "Plan", "autobridge", "floorplan_counts",
    "initial_floorplan_key", "merge_floorplan_counts",
    "reset_floorplan_counts",
    "BalanceResult", "CycleError", "balance_graph",
    "balance_latencies", "Boundary", "SlotGrid", "Floorplan", "floorplan",
    "Stream", "Task", "TaskGraph", "TaskGraphBuilder", "InfeasibleError",
    "PipelineAssignment", "assign_pipelining",
    "PhysicalModel", "TimingReport", "analyze_timing", "packed_placement",
    "SimJob", "SimResult", "StreamProfile", "engine_counts",
    "pipeline_headroom", "reset_engine_counts", "simulate", "simulate_batch",
]


def __getattr__(name: str):
    if name in _PENDING:
        raise NotImplementedError(
            f"repro_torch.core.{name} is not ported yet: see ROADMAP.md, "
            f"{_PENDING[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
