"""Floorplan-aware pipelining (paper §5 + §5.3).

Every cross-slot stream gets ``pipeline_depth`` register levels per boundary
crossed (paper default: 2).  The physical realization differs per target:

  * FPGA: almost-full FIFOs whose interface signals are registered
    (paper Fig. 10), so added depth never changes functionality;
  * TPU: extra microbatch buffer slots on the inter-stage channel, realized
    as double/triple-buffered ``ppermute`` sends that overlap compute.

The returned latency map feeds the balancer; ``lat + balance`` is the final
depth of every stream.
"""
from __future__ import annotations

import dataclasses

from .floorplan import Floorplan
from .graph import TaskGraph


@dataclasses.dataclass
class PipelineAssignment:
    #: inserted pipelining latency per stream (from crossings)
    lat: dict[str, int]
    #: extra FIFO depth per stream to keep the producer from stalling while
    #: tokens are in flight (depth >= lat, almost-full headroom)
    extra_depth: dict[str, int]
    #: register-area overhead  sum(lat * width)
    reg_area: float


def assign_pipelining(graph: TaskGraph, fp: Floorplan) -> PipelineAssignment:
    lat: dict[str, int] = {}
    extra: dict[str, int] = {}
    area = 0.0
    for s in graph.streams:
        a, b = fp.placement[s.src], fp.placement[s.dst]
        d = fp.grid.crossing_depth(a, b)
        lat[s.name] = d
        # almost-full FIFOs must absorb the in-flight tokens: grow capacity
        # by the round-trip latency (paper Fig. 10)
        extra[s.name] = 2 * d
        area += d * s.width
    return PipelineAssignment(lat=lat, extra_depth=extra, reg_area=area)
