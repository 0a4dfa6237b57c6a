"""repro_torch.search — the design-space search subsystem (public entry point).

Everything the co-optimization search offers lives here:

* ``space``     — ``SearchSpace``/``SearchPoint``/``Interval``: the joint
                  knob axes, grid/random sampling, frontier refinement;
* ``pareto``    — non-domination and the exact hypervolume indicator;
* ``engine``    — ``explore_design_space`` (one-shot batched search),
                  ``search_until_converged`` (refine -> search loop),
                  ``sweep_backends`` (one-call multi-device sweeps) and the
                  deferred-scoring plumbing (``DeferredSearch``);
* ``pool``      — the process-pool execution layer: parallel cold ILP
                  solves with mergeable caches/counters (``jobs=``), with
                  per-future timeouts, crash recovery and poison-point
                  quarantine built in;
* ``store``     — crash-consistent persistence: the content-addressed
                  ``DiskFloorplanStore`` and the per-round checkpoint
                  journal behind ``search_until_converged(checkpoint=)``;
* ``faults``    — the seeded deterministic fault-injection harness the
                  robustness tests and the CI chaos job drive;
* ``surrogate`` — response-surface-guided round proposals (``proposer=``).

``repro_torch.core.explorer`` re-exports this module's names for backward
compatibility; new code should import from ``repro_torch.search``.

Counterpart of ``repro.search``, with the same names.  The search's
throughput scoring runs ``simulate_batch`` on the card (the ``sim_sweep``
kernel) unless a call passes ``device="cpu"``; the rest is host code, as
in the reference, and gives the reference's results bit for bit.  The
package imports torch, NumPy and the port, never ``jax`` or ``repro``.
"""
from .engine import (BackendSweep, Candidate, ConvergedSearch,
                     DeferredSearch, SearchResult, best_candidate,
                     explore_design_space, explore_floorplans,
                     gather_sim_jobs, measure_backend_speedup,
                     pareto_frontier, pool_simulations,
                     prepare_design_space, scatter_sim_results,
                     search_until_converged, sweep_backends,
                     timed_pool_simulations)
from .faults import (FaultPlan, fault_counts, install as install_faults,
                     reset_fault_counts)
from .pareto import hypervolume, objective_vector, pareto_indices
from .pool import (PoolStats, pool_counts, reset_pool_counts,
                   warm_floorplan_cache)
from .space import DEFAULT_UTILS, Interval, SearchPoint, SearchSpace
from .store import (DiskFloorplanStore, SearchJournal, key_digest,
                    reset_store_counts, store_counts)
from .surrogate import (ResponseSurface, SurrogateProposer, UniformProposer,
                        make_proposer)

__all__ = [
    "BackendSweep", "Candidate", "ConvergedSearch", "DeferredSearch",
    "SearchResult", "best_candidate", "explore_design_space",
    "explore_floorplans", "gather_sim_jobs", "measure_backend_speedup",
    "pareto_frontier", "pool_simulations", "prepare_design_space",
    "scatter_sim_results", "search_until_converged", "sweep_backends",
    "timed_pool_simulations",
    "hypervolume", "objective_vector", "pareto_indices",
    "PoolStats", "pool_counts", "reset_pool_counts", "warm_floorplan_cache",
    "DEFAULT_UTILS", "Interval", "SearchPoint", "SearchSpace",
    "FaultPlan", "fault_counts", "install_faults", "reset_fault_counts",
    "DiskFloorplanStore", "SearchJournal", "key_digest",
    "reset_store_counts", "store_counts",
    "ResponseSurface", "SurrogateProposer", "UniformProposer",
    "make_proposer",
]
