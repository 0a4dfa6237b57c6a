"""repro_torch.core — the paper's contribution: task-parallel dataflow
graphs, coarse-grained floorplanning co-optimized with compilation,
throughput-safe latency balancing, the timing model, and the dataflow
simulator, with ``simulate_batch`` (and so ``Plan.verify_throughput``) on
the card.

Counterpart of ``repro.core``.  The design-space search names
(``explore_design_space``, ``search_until_converged``, ``SearchSpace``,
...) live in ``repro_torch.search`` and are re-exported here lazily
(PEP 562): the search package imports this package's submodules, so an
eager import would be circular.
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

#: names re-exported from ``repro_torch.search`` (resolved lazily via
#: ``__getattr__`` below to break the core <-> search import cycle)
_SEARCH_EXPORTS = (
    "BackendSweep", "Candidate", "ConvergedSearch", "DeferredSearch",
    "DiskFloorplanStore", "FaultPlan", "Interval", "SearchJournal",
    "SearchPoint", "SearchResult", "SearchSpace",
    "best_candidate", "explore_design_space", "explore_floorplans",
    "gather_sim_jobs", "hypervolume", "measure_backend_speedup",
    "pareto_frontier", "pareto_indices", "pool_simulations",
    "prepare_design_space", "scatter_sim_results", "search_until_converged",
    "sweep_backends", "timed_pool_simulations",
)

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
    *_SEARCH_EXPORTS,
]


def __getattr__(name: str):
    if name in _SEARCH_EXPORTS:
        import repro_torch.search as _search
        return getattr(_search, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SEARCH_EXPORTS))
