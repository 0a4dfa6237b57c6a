"""Search-space definition: the joint co-optimization knob axes.

The paper's §6.3 sweeps a single per-slot max-utilization knob; the search
subsystem generalizes that into a *joint* space

    seed x max_util x row/col boundary weight x pipeline depth scale

where every numeric axis is either a tuple of discrete values or a
continuous ``Interval(lo, hi)``.  ``SearchSpace`` enumerates, samples and
refines this space; the engines in ``repro_torch.search.engine`` consume the
resulting ``SearchPoint`` lists.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Sequence

#: the paper's §6.3 max-util sweep (Table 10)
DEFAULT_UTILS = (0.55, 0.60, 0.65, 0.70, 0.75, 0.80, 0.85)


@dataclasses.dataclass(frozen=True)
class SearchPoint:
    """One joint knob configuration."""
    seed: int = 0
    max_util: float = 0.70
    row_weight: float = 1.0
    col_weight: float = 1.0
    depth_scale: float = 1.0
    #: HBM channel-to-slot binding tilt (``SlotGrid.with_hbm_binding``);
    #: 0.5 = the device's symmetric default binding.  Only meaningful on
    #: grids with HBM slots — everywhere else any value is a no-op.
    hbm_split: float = 0.5

    @property
    def floorplan_key(self) -> tuple:
        """Axes the floorplan depends on.  ``depth_scale`` only affects
        pipelining/balancing, so depth variants share one floorplan."""
        return (self.seed, self.max_util, self.row_weight, self.col_weight,
                self.hbm_split)


@dataclasses.dataclass(frozen=True)
class Interval:
    """A continuous numeric axis ``[lo, hi]`` for ``SearchSpace``.

    Anywhere a ``SearchSpace`` axis accepts a tuple of discrete values it
    also accepts an ``Interval``; sampling then draws uniformly from the
    range via the seeded RNG, and ``refine`` *narrows* the range around the
    Pareto frontier's values instead of halving a grid pitch.

    >>> iv = Interval(0.6, 0.9)
    >>> iv.lo, iv.hi, round(iv.span, 2)
    (0.6, 0.9, 0.3)
    >>> Interval(0.7, 0.7).span
    0.0
    """
    lo: float
    hi: float

    def __post_init__(self):
        if not (self.lo <= self.hi):
            raise ValueError(f"Interval needs lo <= hi, got {self}")

    @property
    def span(self) -> float:
        return self.hi - self.lo

    def clamp(self, v: float) -> float:
        return min(max(v, self.lo), self.hi)


def _is_interval(axis) -> bool:
    return isinstance(axis, Interval)


def _draw_axis(axis, rng: random.Random):
    """One value from a discrete tuple (choice) or ``Interval`` (uniform)."""
    if _is_interval(axis):
        return rng.uniform(axis.lo, axis.hi)
    return axis[rng.randrange(len(axis))]


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Axis values of the joint search.

    Each numeric axis (``utils``, ``row_weights``, ``col_weights``,
    ``depth_scales``) is either a tuple of discrete values or a continuous
    ``Interval(lo, hi)``; ``seeds`` is always discrete (it is categorical).
    ``grid_points`` enumerates the full cartesian product of a fully
    discrete space; ``sample`` draws points without replacement — uniform
    over the product for discrete axes, uniform over the range for
    continuous ones.

    >>> space = SearchSpace(seeds=(0, 1), utils=(0.6, 0.7))
    >>> space.size
    4
    >>> [(p.seed, p.max_util) for p in space.grid_points()]
    [(0, 0.6), (0, 0.7), (1, 0.6), (1, 0.7)]
    >>> cont = SearchSpace(utils=Interval(0.6, 0.9))
    >>> cont.size
    inf
    >>> pts = cont.sample(4, seed=7)
    >>> len(pts) == len(set(pts)) == 4
    True
    >>> all(0.6 <= p.max_util <= 0.9 for p in pts)
    True
    >>> pts == cont.sample(4, seed=7)      # seeded, fully deterministic
    True
    """
    seeds: tuple[int, ...] = (0,)
    utils: tuple[float, ...] | Interval = DEFAULT_UTILS
    row_weights: tuple[float, ...] | Interval = (1.0,)
    col_weights: tuple[float, ...] | Interval = (1.0,)
    depth_scales: tuple[float, ...] | Interval = (1.0,)
    #: HBM channel-binding tilt axis (``SlotGrid.with_hbm_binding``); the
    #: single default value keeps the device's symmetric binding and adds
    #: nothing to the product — sweep e.g. ``(0.25, 0.5, 0.75)`` (or an
    #: ``Interval``) on HBM boards to make channel binding a search axis.
    hbm_splits: tuple[float, ...] | Interval = (0.5,)

    def _axes(self) -> tuple:
        return (self.seeds, self.utils, self.row_weights, self.col_weights,
                self.depth_scales, self.hbm_splits)

    @property
    def continuous(self) -> bool:
        """True when any axis is an ``Interval`` (the space is infinite)."""
        return any(_is_interval(ax) for ax in self._axes())

    @property
    def size(self) -> int | float:
        """Number of grid points (``math.inf`` for continuous spaces)."""
        if self.continuous:
            return math.inf
        return (len(self.seeds) * len(self.utils) * len(self.row_weights)
                * len(self.col_weights) * len(self.depth_scales)
                * len(self.hbm_splits))

    def _decode(self, idx: int) -> SearchPoint:
        """Mixed-radix decode of a flat product index (hbm_split fastest,
        seed slowest — matches ``itertools.product`` order)."""
        axes = self._axes()
        vals = []
        for ax in reversed(axes):
            idx, r = divmod(idx, len(ax))
            vals.append(ax[r])
        h, d, c, w, u, s = vals
        return SearchPoint(seed=s, max_util=u, row_weight=w, col_weight=c,
                           depth_scale=d, hbm_split=h)

    def grid_points(self) -> list[SearchPoint]:
        if self.continuous:
            raise ValueError(
                "grid enumeration needs discrete axes; this space has "
                "Interval axes — use sample()/refine() (random mode)")
        return [SearchPoint(seed=s, max_util=u, row_weight=rw, col_weight=cw,
                            depth_scale=d, hbm_split=h)
                for s, u, rw, cw, d, h in itertools.product(
                    self.seeds, self.utils, self.row_weights,
                    self.col_weights, self.depth_scales, self.hbm_splits)]

    def sample(self, n: int, *, seed: int = 0) -> list[SearchPoint]:
        """``n`` distinct points drawn uniformly from the space (the whole
        grid, in grid order, when the space is discrete and ``n >= size``).

        Continuous axes draw ``uniform(lo, hi)`` per point from the seeded
        RNG, so samples are deterministic and almost surely distinct; the
        draw loop retries collisions (possible when a continuous space also
        has small discrete axes) a bounded number of times."""
        if not self.continuous:
            if n >= self.size:
                return self.grid_points()
            rng = random.Random(seed)
            return [self._decode(i) for i in rng.sample(range(self.size), n)]
        rng = random.Random(seed)
        # the default single-valued hbm axis must not consume randomness:
        # samples from spaces that don't sweep the binding stay bit-identical
        # to the pre-hbm-axis draws (the converged-search trajectories and
        # the uniform-vs-surrogate anchors depend on that stream)
        hbm_degenerate = (not _is_interval(self.hbm_splits)
                          and len(self.hbm_splits) == 1)
        pts: list[SearchPoint] = []
        seen: set[SearchPoint] = set()
        for _ in range(20 * n + 100):
            if len(pts) >= n:
                break
            pt = SearchPoint(seed=_draw_axis(self.seeds, rng),
                             max_util=_draw_axis(self.utils, rng),
                             row_weight=_draw_axis(self.row_weights, rng),
                             col_weight=_draw_axis(self.col_weights, rng),
                             depth_scale=_draw_axis(self.depth_scales, rng),
                             hbm_split=(self.hbm_splits[0] if hbm_degenerate
                                        else _draw_axis(self.hbm_splits,
                                                        rng)))
            if pt not in seen:
                seen.add(pt)
                pts.append(pt)
        return pts

    def refined(self, frontier: Sequence) -> "SearchSpace":
        """The zoomed space around a frontier's knob values.

        Each *discrete* numeric axis keeps the frontier's values plus the
        midpoints toward the adjacent values of this space's axis — halving
        the grid pitch around every winner.  Each *continuous*
        (``Interval``) axis narrows to the frontier values' envelope padded
        by a quarter of *this* space's span (clamped into it), so repeated
        ``space = space.refined(frontier)`` shrinks the ranges
        geometrically around the winners — ``search_until_converged``
        compounds the zoom exactly this way.  Seeds are restricted to those
        the frontier used.  An empty frontier returns the space unchanged."""
        pts = [getattr(c, "point", c) for c in frontier]
        pts = [p for p in pts if p is not None]
        if not pts:
            return self

        def hood(axis, values: set):
            if _is_interval(axis):
                pad = axis.span / 4
                return Interval(axis.clamp(min(values) - pad),
                                axis.clamp(max(values) + pad))
            out = set(values)
            sv = sorted(set(axis) | set(values))
            for v in values:
                i = sv.index(v)
                if i > 0:
                    out.add((v + sv[i - 1]) / 2)
                if i + 1 < len(sv):
                    out.add((v + sv[i + 1]) / 2)
            return tuple(sorted(out))

        return SearchSpace(
            seeds=tuple(sorted({p.seed for p in pts})),
            utils=hood(self.utils, {p.max_util for p in pts}),
            row_weights=hood(self.row_weights, {p.row_weight for p in pts}),
            col_weights=hood(self.col_weights, {p.col_weight for p in pts}),
            depth_scales=hood(self.depth_scales,
                              {p.depth_scale for p in pts}),
            hbm_splits=hood(self.hbm_splits, {p.hbm_split for p in pts}))

    def refine(self, frontier: Sequence, n: int, *,
               seed: int = 0) -> list[SearchPoint]:
        """Adaptive refinement: ``n`` points sampled from the *neighborhood*
        of the frontier's knob values (ROADMAP "zoom into the frontier") —
        ``self.refined(frontier).sample(n)``.  Sampling reuses the
        ``sample`` plumbing (distinct, uniform, deterministic), so
        ``refine`` composes with repeated zooming:
        ``space.refine(res.frontier, 32)`` then search those points via
        ``explore_design_space(points=...)``, and so on.  An empty frontier
        degrades to plain sampling of this space."""
        pts = [getattr(c, "point", c) for c in frontier]
        if not any(p is not None for p in pts):
            return self.sample(n, seed=seed)
        return self.refined(frontier).sample(n, seed=seed)
