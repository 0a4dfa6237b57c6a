"""Coarse-grained device model: a grid of slots (paper §4.1).

A device (FPGA die stack or TPU mesh) is viewed as an R x C grid of *slots*
delimited by physical barriers — die boundaries / IP columns on FPGA, pod
(DCN) boundaries / ICI subgroup boundaries on TPU.  Each slot carries a
resource capacity vector; each boundary carries a crossing *weight* (the
relative cost of a wire/stream crossing it) and a default *pipeline depth*
(registers or microbatch buffer slots inserted per crossing).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Boundary:
    """One grid line between adjacent rows or columns."""
    weight: float = 1.0          # cost multiplier for the floorplan objective
    pipeline_depth: int = 2      # regs / buffer slots inserted per crossing
    delay_ns: float = 2.0        # unpipelined physical delay (fmax model)


@dataclasses.dataclass
class SlotGrid:
    name: str
    rows: int
    cols: int
    #: capacity of one slot (uniform) or per-slot overrides in ``slot_caps``.
    base_capacity: dict[str, float]
    #: per-slot capacity overrides keyed by (row, col); e.g. HBM channels
    #: only exist in row 0 slots (paper §6.2: channels as a slot resource).
    slot_caps: dict[tuple[int, int], dict[str, float]] = dataclasses.field(
        default_factory=dict)
    #: boundaries between rows (len rows-1) and cols (len cols-1).
    row_boundaries: list[Boundary] = dataclasses.field(default_factory=list)
    col_boundaries: list[Boundary] = dataclasses.field(default_factory=list)
    #: maximum utilization ratio applied to every capacity (paper §4.2 (3));
    #: the multi-floorplan explorer sweeps this knob (paper §6.3).
    max_util: float = 0.7

    def __post_init__(self):
        if not self.row_boundaries:
            self.row_boundaries = [Boundary() for _ in range(self.rows - 1)]
        if not self.col_boundaries:
            self.col_boundaries = [Boundary() for _ in range(self.cols - 1)]
        assert len(self.row_boundaries) == self.rows - 1
        assert len(self.col_boundaries) == self.cols - 1

    # -- capacities --------------------------------------------------------
    def resource_keys(self) -> set[str]:
        keys = set(self.base_capacity)
        for caps in self.slot_caps.values():
            keys.update(caps)
        return keys

    def capacity(self, row: int, col: int,
                 max_util: float | None = None) -> dict[str, float]:
        # Every resource known anywhere on the grid is materialized in every
        # slot: a slot that does not own the resource has capacity 0 (e.g.
        # hbm_channels only exist in boundary-adjacent slots, paper §6.2).
        cap = {k: 0.0 for k in self.resource_keys()}
        cap.update(self.base_capacity)
        cap.update(self.slot_caps.get((row, col), {}))
        u = self.max_util if max_util is None else max_util
        # hard resources (hbm_channels, ddr_channels, ...) are integral
        # units, not subject to the utilization head-room knob.
        return {k: (v if k.startswith("hard_") or k.endswith("_channels")
                    else v * u) for k, v in cap.items()}

    def slots(self) -> list[tuple[int, int]]:
        return [(r, c) for r in range(self.rows) for c in range(self.cols)]

    def with_knobs(self, *, row_weight: float = 1.0, col_weight: float = 1.0,
                   depth_scale: float = 1.0) -> "SlotGrid":
        """A copy of the grid with co-optimization knobs applied (the joint
        design-space search axes beyond max-util, paper §6.3 generalized):

        * ``row_weight`` / ``col_weight`` scale the crossing cost of row/col
          boundaries in the floorplan objective — the *ratio* trades die
          (SLR) crossings against column crossings;
        * ``depth_scale`` scales every boundary's inserted pipeline depth
          (more registers shorten routed segments at the cost of buffer
          area and fill/drain skew).  Nonzero depths stay >= 1.

        Physical delays (``delay_ns``) are device properties and are never
        scaled.  With all knobs at 1.0 the grid is returned unchanged."""
        if row_weight == 1.0 and col_weight == 1.0 and depth_scale == 1.0:
            return self

        def scaled(bs: list[Boundary], w: float) -> list[Boundary]:
            return [Boundary(weight=b.weight * w,
                             pipeline_depth=(max(1, round(b.pipeline_depth
                                                          * depth_scale))
                                             if b.pipeline_depth else 0),
                             delay_ns=b.delay_ns)
                    for b in bs]

        return dataclasses.replace(
            self,
            row_boundaries=scaled(self.row_boundaries, row_weight),
            col_boundaries=scaled(self.col_boundaries, col_weight))

    def hbm_slots(self) -> list[tuple[int, int]]:
        """Slots that expose ``hbm_channels`` capacity, in slot order."""
        return [s for s in self.slots()
                if self.slot_caps.get(s, {}).get("hbm_channels", 0) > 0]

    def total_hbm_channels(self) -> float:
        """Total HBM channels across the grid (0 for DDR-only devices)."""
        return sum(self.slot_caps.get(s, {}).get("hbm_channels", 0.0)
                   for s in self.slots())

    def with_hbm_binding(self, split: float) -> "SlotGrid":
        """A copy with the device's HBM channels re-bound across the
        channel-bearing slots (the search axis behind
        ``SearchSpace.hbm_splits``).

        Physically the channel *stacks* are fixed, but the platform's
        channel-to-slot binding — which pseudo-channels the shell routes
        into which slot's crossbar — is a build-time choice.  ``split``
        tilts the per-slot channel shares linearly across the channel
        slots (in slot order): the first share is proportional to
        ``split``, the last to ``1 - split``, with the total channel count
        conserved.  ``split = 0.5`` is the symmetric default binding and
        returns the grid unchanged; designs whose IO tasks crowd one side
        of the die use other splits to buy feasibility (TAPA §6.2's
        channels-as-a-slot-resource model made searchable).

        Grids without HBM slots (or with a single one) are returned
        unchanged for any split."""
        if not 0.0 <= split <= 1.0:
            raise ValueError(f"hbm split must be in [0, 1], got {split!r}")
        slots = self.hbm_slots()
        if len(slots) < 2 or split == 0.5:
            return self
        total = self.total_hbm_channels()
        k = len(slots)
        raw = [split + (1.0 - 2.0 * split) * i / (k - 1) for i in range(k)]
        norm = sum(raw)
        caps = {s: dict(c) for s, c in self.slot_caps.items()}
        for s, w in zip(slots, raw):
            caps[s]["hbm_channels"] = total * w / norm
        if caps == self.slot_caps:
            return self
        return dataclasses.replace(self, slot_caps=caps)

    # -- distances ---------------------------------------------------------
    def crossing_weight(self, a: tuple[int, int], b: tuple[int, int]) -> float:
        """Weighted Manhattan distance: sum of boundary weights crossed.

        With unit weights this is exactly the paper's cost
        |r_a - r_b| + |c_a - c_b| (Formula 1)."""
        (r0, c0), (r1, c1) = a, b
        w = 0.0
        for r in range(min(r0, r1), max(r0, r1)):
            w += self.row_boundaries[r].weight
        for c in range(min(c0, c1), max(c0, c1)):
            w += self.col_boundaries[c].weight
        return w

    def crossing_depth(self, a: tuple[int, int], b: tuple[int, int]) -> int:
        """Total pipeline depth for a stream between slots a and b
        (paper §7.1: 'for each boundary crossing we add two levels')."""
        (r0, c0), (r1, c1) = a, b
        d = 0
        for r in range(min(r0, r1), max(r0, r1)):
            d += self.row_boundaries[r].pipeline_depth
        for c in range(min(c0, c1), max(c0, c1)):
            d += self.col_boundaries[c].pipeline_depth
        return d

    def crossing_delay_ns(self, a: tuple[int, int], b: tuple[int, int]) -> float:
        (r0, c0), (r1, c1) = a, b
        d = 0.0
        for r in range(min(r0, r1), max(r0, r1)):
            d += self.row_boundaries[r].delay_ns
        for c in range(min(c0, c1), max(c0, c1)):
            d += self.col_boundaries[c].delay_ns
        return d
