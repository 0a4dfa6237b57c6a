"""Device grids for multi-backend sweeps: the paper's two boards (§2.3,
§7.1) plus TPU-pod-shaped grids for cross-device comparisons.

  * Alveo U250: 4 dies (SLRs) stacked vertically, DDR/IO column in the
    middle -> 2 cols x 4 rows = 8 slots.  Totals (paper footnote 2):
    5376 BRAM18K, 12288 DSP48E, 3456K FF, 1728K LUT.
  * Alveo U280: 3 dies + HBM (32 channels) along the bottom edge ->
    2 cols x 3 rows = 6 slots.  Totals (footnote 3): 4032 BRAM18K,
    9024 DSP48E, 2607K FF, ~1303K LUT (the footnote's "434K" is the
    per-slot FF figure; we use the physical 1303K total).

Boundary delays: SLR (die) crossings carry the large interposer penalty;
the middle IO column detours routes with a smaller penalty (paper §2.3).
"""
from __future__ import annotations

from repro_torch.core import Boundary, SlotGrid

def _DIE() -> Boundary:
    """Vertical die boundary: expensive; 2 register levels per crossing."""
    return Boundary(weight=1.0, pipeline_depth=2, delay_ns=2.4)


def _IOCOL() -> Boundary:
    """The middle IO/DDR column: cheaper but real."""
    return Boundary(weight=1.0, pipeline_depth=2, delay_ns=1.6)


def u250_grid(max_util: float = 0.70, ddr_channels_per_row: int = 1) -> SlotGrid:
    rows, cols = 4, 2
    cap = {
        "LUT": 1728e3 / (rows * cols),
        "FF": 3456e3 / (rows * cols),
        "BRAM": 5376 / (rows * cols),
        "DSP": 12288 / (rows * cols),
        "URAM": 1280 / (rows * cols),
    }
    # one DDR controller per die, adjacent to the middle column (col 0
    # side); each controller exposes multiple AXI ports via the platform
    # interconnect
    slot_caps = {(r, 0): {"ddr_channels": 4.0 * ddr_channels_per_row}
                 for r in range(rows)}
    return SlotGrid("U250", rows=rows, cols=cols, base_capacity=cap,
                    slot_caps=slot_caps,
                    row_boundaries=[_DIE() for _ in range(rows - 1)],
                    col_boundaries=[_IOCOL() for _ in range(cols - 1)],
                    max_util=max_util)


#: total HBM pseudo-channels on the U280's bottom edge (paper §2.3/§6.2);
#: promoted from the ad-hoc constant in ``benchmarks/hbm_opts.py`` so the
#: channel-math (e.g. BRAM saved by async channel IO = channels x per-port
#: buffer) lives next to the grid that owns the channels.
U280_HBM_CHANNELS = 32


def u280_grid(max_util: float = 0.70, hbm_split: float = 0.5) -> SlotGrid:
    """The U280 grid; ``hbm_split`` tilts the 32-channel HBM binding
    across the two bottom slots (``SlotGrid.with_hbm_binding``) — 0.5 is
    the symmetric platform default of 16 channels per slot."""
    rows, cols = 3, 2
    cap = {
        "LUT": 1303e3 / (rows * cols),
        "FF": 2607e3 / (rows * cols),
        "BRAM": 4032 / (rows * cols),
        "DSP": 9024 / (rows * cols),
        "URAM": 960 / (rows * cols),
    }
    # 32 HBM channels across the bottom row (16 per bottom slot);
    # 2 DDR DIMMs near the top die
    hbm_per_slot = U280_HBM_CHANNELS / 2
    slot_caps = {(0, 0): {"hbm_channels": hbm_per_slot},
                 (0, 1): {"hbm_channels": hbm_per_slot},
                 (2, 0): {"ddr_channels": 4.0},
                 (2, 1): {"ddr_channels": 4.0}}
    grid = SlotGrid("U280", rows=rows, cols=cols, base_capacity=cap,
                    slot_caps=slot_caps,
                    row_boundaries=[_DIE() for _ in range(rows - 1)],
                    col_boundaries=[_IOCOL() for _ in range(cols - 1)],
                    max_util=max_util)
    return grid.with_hbm_binding(hbm_split)


def _ICI() -> Boundary:
    """Intra-pod ICI hop: cheap, one buffer stage per crossing."""
    return Boundary(weight=0.5, pipeline_depth=1, delay_ns=1.0)


def _DCN() -> Boundary:
    """Pod-slice (DCN) split: expensive and deep."""
    return Boundary(weight=2.0, pipeline_depth=4, delay_ns=3.2)


def tpu_pod_grid(rows: int = 4, cols: int = 2,
                 max_util: float = 0.70) -> SlotGrid:
    """A TPU-pod-shaped grid for ``sweep_backends`` cross-device studies:
    ``rows x cols`` chip groups, row boundaries are ICI hops (cheap,
    shallow) and column boundaries are pod-slice/DCN splits (expensive,
    deep) — the same coarse slot/boundary abstraction the paper applies to
    SLRs, re-parameterized to a pod topology.

    Capacities reuse the FPGA resource vocabulary, scaled up so the paper's
    benchmark graphs sweep unchanged across U250/U280/pod grids; every chip
    group faces its own HBM stack (``hbm_channels`` in every slot)."""
    cap = {
        "LUT": 2400e3 / (rows * cols),
        "FF": 4800e3 / (rows * cols),
        "BRAM": 7168 / (rows * cols),
        "DSP": 16384 / (rows * cols),
        "URAM": 1792 / (rows * cols),
    }
    slot_caps = {(r, c): {"hbm_channels": 8.0}
                 for r in range(rows) for c in range(cols)}
    return SlotGrid(f"TPUpod{rows}x{cols}", rows=rows, cols=cols,
                    base_capacity=cap, slot_caps=slot_caps,
                    row_boundaries=[_ICI() for _ in range(rows - 1)],
                    col_boundaries=[_DCN() for _ in range(cols - 1)],
                    max_util=max_util)


#: named device-grid factories for one-call multi-device sweeps
#: (``sweep_backends(graph, {name: grid_for(name) for name in ...})``)
DEVICE_GRIDS = {
    "u250": u250_grid,
    "u280": u280_grid,
    #: channel-aware U280 variants: the HBM binding tilted toward the
    #: left/right bottom slot (SearchSpace(hbm_splits=...) searches the
    #: same axis continuously; these are the named extreme points)
    "u280_hbm_left": lambda max_util=0.70: u280_grid(
        max_util=max_util, hbm_split=0.75),
    "u280_hbm_right": lambda max_util=0.70: u280_grid(
        max_util=max_util, hbm_split=0.25),
    "tpu_pod_4x2": tpu_pod_grid,
    "tpu_pod_2x2": lambda max_util=0.70: tpu_pod_grid(
        rows=2, cols=2, max_util=max_util),
    "tpu_pod_8x4": lambda max_util=0.70: tpu_pod_grid(
        rows=8, cols=4, max_util=max_util),
}


def grid_for(name: str, **kwargs) -> SlotGrid:
    """Instantiate a registered device grid by name.

    Grid factories are cheap and stateless; the expensive per-grid work (the
    floorplan ILPs of a sweep) is memoized by ``repro_torch.core.FloorplanCache``,
    keyed by the grid's shape/capacities/boundary weights — so two calls
    producing equal grids share cached floorplans automatically.

    >>> from repro_torch.fpga import grid_for
    >>> grid_for("u250").rows, grid_for("u250").cols
    (4, 2)
    >>> grid_for("tpu_pod_8x4", max_util=0.8).name
    'TPUpod8x4'
    """
    try:
        factory = DEVICE_GRIDS[name]
    except KeyError:
        raise KeyError(f"unknown device grid {name!r}; "
                       f"known: {sorted(DEVICE_GRIDS)}") from None
    return factory(**kwargs)
