"""Surrogate-guided round proposals (ROADMAP "smarter round proposals").

``search_until_converged`` historically refined *uniformly* around the
incumbent frontier: every round drew ``points_per_round`` points from the
zoomed space with no regard for what the already-scored points say about
the response surface.  The surrogate proposer closes that gap with the
cheapest model that can rank candidates:

* a **quadratic ridge response surface** over the continuous knob axes
  (max_util, row/col weight, depth_scale — full degree-2 polynomial
  features), fit to the already-evaluated points' objective vectors
  (fmax, -buffer area, -simulated cycles) with ``numpy.linalg.lstsq`` on a
  Tikhonov-augmented system;
* a companion **feasibility surface** fit on ALL evaluated points (target
  1.0 for feasible, 0.0 for infeasible) that discounts candidates the
  model expects to be unroutable;
* **predicted-hypervolume-improvement ranking**: an oversampled uniform
  pool is drawn from the refined space, each candidate's predicted
  objective vector is scored by how much hypervolume it would add to the
  incumbent frontier (times its clipped feasibility probability), and the
  top ``n`` are proposed.

When the fit is underdetermined (fewer feasible samples than active
polynomial features) the proposer degrades to the pool's first ``n`` draws,
which are *exactly* the uniform proposer's draws for the same seed — the
fallback is bit-identical to uniform, never worse.

Everything is deterministic: seeded sampling, ``lstsq`` and stable sorting
introduce no run-to-run variance.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..obs import trace as _trace
from .pareto import hypervolume, objective_vector
from .space import SearchPoint, SearchSpace

#: the numeric knob axes the response surface is fit over (seed is
#: categorical and deliberately excluded — the model averages over it)
FEATURE_AXES = ("max_util", "row_weight", "col_weight", "depth_scale")

#: Tikhonov weight of the augmented least-squares rows — small enough to
#: never fight the data, large enough to keep near-collinear quadratic
#: features from exploding the extrapolation
RIDGE = 1e-6


def _raw_features(points: Sequence[SearchPoint]) -> np.ndarray:
    """Degree-2 polynomial feature matrix: bias, linear, squares, pairs."""
    x = np.array([[getattr(p, ax) for ax in FEATURE_AXES] for p in points],
                 dtype=float)
    cols = [np.ones(len(points))]
    d = x.shape[1]
    for i in range(d):
        cols.append(x[:, i])
    for i in range(d):
        cols.append(x[:, i] * x[:, i])
    for i in range(d):
        for j in range(i + 1, d):
            cols.append(x[:, i] * x[:, j])
    return np.stack(cols, axis=1)


@dataclasses.dataclass
class ResponseSurface:
    """Quadratic ridge fit, one output column per target dimension.

    ``fit`` returns False (and ``predict`` raises) when the system is
    underdetermined — fewer samples than *active* features, where a
    feature is active if it varies across the training points (axes pinned
    to a single value contribute nothing and are dropped, so a pure
    max-util search only needs a handful of samples to become fittable).
    """
    ridge: float = RIDGE
    _theta: np.ndarray | None = None
    _active: np.ndarray | None = None

    def fit(self, points: Sequence[SearchPoint],
            targets: np.ndarray) -> bool:
        X = _raw_features(points)
        # bias stays; any other column constant across samples is inactive
        spread = X.max(axis=0) - X.min(axis=0)
        active = spread > 1e-12
        active[0] = True
        Xa = X[:, active]
        if Xa.shape[0] < int(active.sum()):
            self._theta = None
            return False
        y = np.asarray(targets, dtype=float)
        if y.ndim == 1:
            y = y[:, None]
        # Tikhonov augmentation: [X; sqrt(l)*I] theta = [y; 0]
        lam = np.sqrt(self.ridge) * np.eye(Xa.shape[1])
        A = np.vstack([Xa, lam])
        b = np.vstack([y, np.zeros((Xa.shape[1], y.shape[1]))])
        self._theta, *_ = np.linalg.lstsq(A, b, rcond=None)
        self._active = active
        return True

    def predict(self, points: Sequence[SearchPoint]) -> np.ndarray:
        if self._theta is None:
            raise RuntimeError("ResponseSurface.predict before a good fit")
        return _raw_features(points)[:, self._active] @ self._theta


class UniformProposer:
    """Today's behavior, as a named strategy: uniform seeded draws from the
    (already refined) working space.  The bit-identity anchor every other
    proposer's fallback must match."""
    name = "uniform"

    def propose(self, space: SearchSpace, frontier: Sequence,
                evaluated: Sequence, n: int, *, seed: int = 0,
                ref: tuple | None = None) -> list[SearchPoint]:
        return space.sample(n, seed=seed)


class SurrogateProposer:
    """Response-surface-guided proposals (module docstring has the story).

    ``oversample`` controls the candidate pool: ``oversample * n`` uniform
    draws are ranked and the top ``n`` proposed.  A slice of the proposals
    (``explore_fraction``) is always taken verbatim from the uniform draws
    so the model can never fully starve exploration — model-guided search
    with zero exploration famously locks onto early artifacts."""
    name = "surrogate"

    def __init__(self, *, oversample: int = 8,
                 explore_fraction: float = 0.25, ridge: float = RIDGE):
        self.oversample = max(int(oversample), 2)
        self.explore_fraction = min(max(explore_fraction, 0.0), 1.0)
        self.ridge = ridge

    def propose(self, space: SearchSpace, frontier: Sequence,
                evaluated: Sequence, n: int, *, seed: int = 0,
                ref: tuple | None = None) -> list[SearchPoint]:
        with _trace.span("search.propose", proposer=self.name, n=n):
            return self._propose(space, frontier, evaluated, n,
                                 seed=seed, ref=ref)

    def _propose(self, space: SearchSpace, frontier: Sequence,
                 evaluated: Sequence, n: int, *, seed: int = 0,
                 ref: tuple | None = None) -> list[SearchPoint]:
        # the uniform proposal is drawn EXACTLY as UniformProposer draws it
        # (not pool[:n]: a discrete space's oversampled pool degenerates to
        # grid order, which is not what sample(n) returns), so the
        # underdetermined fallback is bit-identical to proposer="uniform"
        uniform = space.sample(n, seed=seed)
        pool = space.sample(self.oversample * n, seed=seed)
        feas = [c for c in evaluated
                if c.point is not None and c.plan is not None
                and c.report is not None and c.report.routed]
        scored_all = [c for c in evaluated if c.point is not None]
        obj = ResponseSurface(ridge=self.ridge)
        if not feas or not obj.fit([c.point for c in feas],
                                   np.array([objective_vector(c)
                                             for c in feas])):
            return uniform           # underdetermined -> uniform fallback
        feasibility = ResponseSurface(ridge=self.ridge)
        have_feas_model = len(scored_all) > len(feas) and feasibility.fit(
            [c.point for c in scored_all],
            np.array([1.0 if c.plan is not None else 0.0
                      for c in scored_all]))

        front_vecs = [objective_vector(c) for c in frontier
                      if c.plan is not None and c.report is not None]
        if ref is None:
            vecs = [objective_vector(c) for c in feas]
            ref = tuple(min(v[i] for v in vecs) - 1.0 for i in range(3))
        base_hv = hypervolume(front_vecs, ref)

        pred = obj.predict(pool)
        p_feas = np.ones(len(pool))
        if have_feas_model:
            p_feas = np.clip(feasibility.predict(pool)[:, 0], 0.0, 1.0)
        scores = np.array([
            max(hypervolume(front_vecs + [tuple(v)], ref) - base_hv, 0.0)
            for v in pred]) * p_feas

        seen = {c.point for c in scored_all}
        # stable ranking: score desc, then pool order — fully deterministic
        order = sorted(range(len(pool)),
                       key=lambda i: (-scores[i], i))
        n_explore = int(round(self.explore_fraction * n))
        picks: list[SearchPoint] = []
        chosen: set[SearchPoint] = set()
        for p in uniform[:n_explore]:          # exploration slice first
            if p not in chosen:
                chosen.add(p)
                picks.append(p)
        for i in order:                        # then the model's ranking
            if len(picks) >= n:
                break
            p = pool[i]
            if p in chosen or p in seen:
                continue
            chosen.add(p)
            picks.append(p)
        for p in pool:                         # pad if dedup starved us
            if len(picks) >= n:
                break
            if p not in chosen:
                chosen.add(p)
                picks.append(p)
        return picks


def make_proposer(spec) -> UniformProposer | SurrogateProposer:
    """Resolve the ``proposer=`` knob: a name ("uniform" | "surrogate") or
    any object with a ``propose`` method (passed through)."""
    if hasattr(spec, "propose"):
        return spec
    if spec == "uniform":
        return UniformProposer()
    if spec == "surrogate":
        return SurrogateProposer()
    raise ValueError(f"unknown proposer {spec!r} "
                     f"(expected 'uniform', 'surrogate' or an object "
                     f"with a .propose method)")
