"""Pareto-frontier primitives shared by every search engine.

Vector-level only: non-domination over maximized objective tuples
(``pareto_indices``) and the exact hypervolume indicator the converging
search watches (``hypervolume``).  Candidate-level pruning — which
candidates are feasible, what their objective vector is — lives in
``repro_torch.search.engine``.
"""
from __future__ import annotations

from typing import Sequence


def objective_vector(c) -> tuple[float, float, float]:
    """The maximized objective vector of a feasible candidate — the ONE
    definition of the search's Pareto axes: (fmax, -area overhead,
    -simulated cycles).  Shared by the engine's frontier pruning, the
    hypervolume trajectory and the surrogate's training targets, so the
    axes cannot silently drift apart."""
    return (c.report.fmax_mhz, -c.plan.area_overhead,
            -(c.sim.cycles if c.sim is not None else 0))


def pareto_indices(vectors: Sequence[tuple]) -> list[int]:
    """Indices of non-dominated vectors; every objective is maximized.

    ``a`` dominates ``b`` iff ``a >= b`` element-wise with at least one
    strict inequality — so points with *identical* vectors never dominate
    each other and are all kept (tie handling)."""
    keep = []
    for i, vi in enumerate(vectors):
        dominated = False
        for j, vj in enumerate(vectors):
            if j == i:
                continue
            if (all(a >= b for a, b in zip(vj, vi))
                    and any(a > b for a, b in zip(vj, vi))):
                dominated = True
                break
        if not dominated:
            keep.append(i)
    return keep


def hypervolume(vectors: Sequence[tuple], ref: Sequence[float]) -> float:
    """Exact hypervolume of a maximized point set w.r.t. reference ``ref``.

    The dominated volume between ``ref`` and the points — the standard
    Pareto-frontier quality indicator ``search_until_converged`` watches.
    Points are clipped to ``ref`` (a point at or below the reference on an
    axis contributes zero extent there), so the indicator is monotone under
    adding points.  Exact recursive slicing: fine for the tens-of-points
    frontiers this search produces, any dimensionality.

    >>> hypervolume([(2.0, 2.0)], (0.0, 0.0))
    4.0
    >>> hypervolume([(2.0, 1.0), (1.0, 2.0)], (0.0, 0.0))
    3.0
    >>> hypervolume([(2.0, 1.0), (1.0, 2.0), (1.5, 1.5)], (0.0, 0.0))
    3.25
    >>> hypervolume([], (0.0, 0.0))
    0.0
    """
    ref = tuple(ref)
    pts = [tuple(max(v, r) for v, r in zip(p, ref)) for p in vectors]
    pts = [p for p in pts if any(v > r for v, r in zip(p, ref))]

    def hv(points: list[tuple], r: tuple) -> float:
        if not points:
            return 0.0
        if len(r) == 1:
            return max(p[0] for p in points) - r[0]
        # slice along the last axis, top slab first; each slab's area is the
        # (d-1)-dim hypervolume of every point reaching that high or higher
        points = sorted(points, key=lambda p: -p[-1])
        vol = 0.0
        for i, p in enumerate(points):
            lo = points[i + 1][-1] if i + 1 < len(points) else r[-1]
            thick = p[-1] - lo
            if thick > 0:
                vol += thick * hv([q[:-1] for q in points[:i + 1]], r[:-1])
        return vol

    return hv(pts, ref)
