"""FPGA-side reproduction: devices (U250/U280/TPU-pod shapes) and the
paper's benchmarks."""
from .archs import (DEVICE_GRIDS, U280_HBM_CHANNELS, grid_for, tpu_pod_grid,
                    u250_grid, u280_grid)
from . import benchmarks

__all__ = ["DEVICE_GRIDS", "U280_HBM_CHANNELS", "grid_for", "tpu_pod_grid",
           "u250_grid", "u280_grid", "benchmarks"]
