"""Task-parallel dataflow graph IR — the TAPA programming model (paper §3).

A program is a set of *tasks* (vertices) communicating through unidirectional
*streams* (edges).  Tasks are hierarchical: a parent task instantiates child
tasks and the streams that connect them (``task().invoke(...)``, Listing 1 of
the paper).  We keep the same vocabulary:

  * ``Task``     — one instantiated task (an FSM/RTL module on FPGA; a model
                   subgraph on TPU).  Carries a resource/area vector.
  * ``Stream``   — a FIFO channel with a *width* (bits on FPGA, bytes per
                   microbatch on TPU) and a *depth* (capacity).
  * ``TaskGraph``— the flattened graph handed to the floorplanner.

The builder API mirrors TAPA's C++ interface closely enough that the paper's
benchmarks (stencil chains, CNN grids, crossbars, ...) read like Listing 1.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Iterable, Mapping

# Resource vectors are plain dicts: {"LUT": 1200, "BRAM": 4, ...} on FPGA,
# {"flops": ..., "hbm_bytes": ..., "hbm_channels": 1} on TPU.  Missing keys
# mean zero.
Area = Mapping[str, float]


def area_add(a: Area, b: Area) -> dict[str, float]:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + v
    return out


def area_scale(a: Area, s: float) -> dict[str, float]:
    return {k: v * s for k, v in a.items()}


def area_leq(a: Area, b: Area, *, slack: float = 0.0) -> bool:
    """True if a <= b element-wise (keys missing from b are unconstrained
    unless present in a with positive value and b defines the resource)."""
    for k, v in a.items():
        if k in b and v > b[k] + slack:
            return False
    return True


@dataclasses.dataclass
class Task:
    name: str
    area: dict[str, float] = dataclasses.field(default_factory=dict)
    #: "leaf" tasks compute; "parent" tasks only instantiate children and are
    #: flattened away before floorplanning.
    kind: str = "leaf"
    #: detached tasks (task().invoke<detach>()) never join the parent; they
    #: are placement-wise identical but excluded from termination analysis.
    detached: bool = False
    #: optional hard location constraint: (row, col) slot that this task must
    #: occupy (e.g. an IO module that must sit next to its HBM channel).
    pinned: tuple[int, int] | None = None
    #: module-level metadata (layer index, HLS latency, ...)
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Stream:
    name: str
    src: str
    dst: str
    #: channel width: bits (FPGA) or bytes per microbatch (TPU).
    width: float = 32.0
    #: user-declared FIFO capacity (stream<T, depth>); pipelining may deepen.
    depth: int = 2
    #: control streams carry per-phase handshakes (EoT, commands, status),
    #: not per-datum tokens: they tolerate arbitrary latency, so they are
    #: pipelined but excluded from throughput balancing (and they may close
    #: dependency cycles without forcing co-location).
    control: bool = False
    meta: dict = dataclasses.field(default_factory=dict)


class TaskGraph:
    """Flattened task graph: what the floorplanner and balancer consume."""

    def __init__(self, name: str = "top"):
        self.name = name
        self.tasks: dict[str, Task] = {}
        self.streams: list[Stream] = []
        self._out: dict[str, list[int]] = defaultdict(list)
        self._in: dict[str, list[int]] = defaultdict(list)

    # -- construction -----------------------------------------------------
    def add_task(self, task: Task) -> Task:
        if task.name in self.tasks:
            raise ValueError(f"duplicate task {task.name!r}")
        self.tasks[task.name] = task
        return task

    def add_stream(self, stream: Stream, *, validate: bool = True) -> Stream:
        """Attach a stream; rejects malformed ones at construction time.

        ``validate=False`` is the escape hatch for tests that deliberately
        build broken graphs (self-loops, zero-capacity FIFOs) — the static
        verifier (``repro_torch.analysis``) flags such pre-existing graphs with
        the same conditions as error diagnostics."""
        if stream.src not in self.tasks or stream.dst not in self.tasks:
            raise ValueError(
                f"stream {stream.name!r} connects unknown task "
                f"({stream.src!r} -> {stream.dst!r})")
        if validate:
            if stream.src == stream.dst:
                raise ValueError(
                    f"stream {stream.name!r} is a self-loop on "
                    f"{stream.src!r}")
            if stream.width <= 0:
                raise ValueError(
                    f"stream {stream.name!r} has non-positive width "
                    f"{stream.width!r}")
            if stream.depth <= 0:
                raise ValueError(
                    f"stream {stream.name!r} has non-positive depth "
                    f"{stream.depth!r} (its producer could never write)")
        idx = len(self.streams)
        self.streams.append(stream)
        self._out[stream.src].append(idx)
        self._in[stream.dst].append(idx)
        return stream

    # -- queries ----------------------------------------------------------
    def out_streams(self, task: str) -> list[Stream]:
        return [self.streams[i] for i in self._out[task]]

    def in_streams(self, task: str) -> list[Stream]:
        return [self.streams[i] for i in self._in[task]]

    def total_area(self) -> dict[str, float]:
        tot: dict[str, float] = {}
        for t in self.tasks.values():
            tot = area_add(tot, t.area)
        return tot

    def edge_list(self) -> list[tuple[str, str, float]]:
        return [(s.src, s.dst, s.width) for s in self.streams]

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    @property
    def num_streams(self) -> int:
        return len(self.streams)

    def validate(self) -> None:
        """Each stream has exactly one producer and one consumer by
        construction; check the graph is sane (no self-loop streams —
        the paper's model forbids a task streaming to itself)."""
        for s in self.streams:
            if s.src == s.dst:
                raise ValueError(f"stream {s.name!r} is a self-loop on {s.src!r}")

    def __repr__(self) -> str:  # pragma: no cover
        return (f"TaskGraph({self.name!r}, tasks={self.num_tasks}, "
                f"streams={self.num_streams})")


class TaskGraphBuilder:
    """TAPA-style hierarchical builder (paper Listing 1).

    Example::

        b = TaskGraphBuilder("VecAdd")
        a = b.streams("str_a", n=4, width=32)
        bb = b.streams("str_b", n=4, width=32)
        c = b.streams("str_c", n=4, width=32)
        b.invoke("Load", area={"LUT": 900}, outs=a, count=4)
        b.invoke("Load", area={"LUT": 900}, outs=bb, count=4)
        b.invoke("Add", area={"LUT": 300, "DSP": 1}, ins=a + bb, outs=c, count=4)
        b.invoke("Store", area={"LUT": 700}, ins=c, count=4)
        g = b.build()

    ``count=N`` mirrors ``invoke<N>``: N task instances, with stream lists
    distributed round-robin across instances (the common SIMD pattern).
    """

    def __init__(self, name: str = "top"):
        self.graph = TaskGraph(name)
        self._stream_defs: dict[str, Stream] = {}
        self._pending: list[Stream] = []
        self._instance_count: dict[str, int] = defaultdict(int)

    def stream(self, name: str, *, width: float = 32.0, depth: int = 2,
               control: bool = False) -> str:
        if name in self._stream_defs:
            raise ValueError(f"duplicate stream {name!r}")
        s = Stream(name=name, src="", dst="", width=width, depth=depth,
                   control=control)
        self._stream_defs[name] = s
        return name

    def streams(self, prefix: str, *, n: int, width: float = 32.0,
                depth: int = 2, control: bool = False) -> list[str]:
        return [self.stream(f"{prefix}[{i}]", width=width, depth=depth,
                            control=control)
                for i in range(n)]

    def invoke(self, fn: str, *, area: Area | None = None,
               ins: Iterable[str] = (), outs: Iterable[str] = (),
               count: int = 1, detach: bool = False,
               pinned: tuple[int, int] | None = None,
               meta: dict | None = None,
               area_fn: Callable[[int], Area] | None = None) -> list[str]:
        """Instantiate ``count`` instances of task function ``fn``.

        Stream name lists in ``ins``/``outs`` are split round-robin across
        the instances (len must be a multiple of count).  Returns instance
        names.
        """
        ins, outs = list(ins), list(outs)
        names = []
        for i in range(count):
            idx = self._instance_count[fn]
            self._instance_count[fn] += 1
            inst = f"{fn}_{idx}" if (count > 1 or idx > 0) else fn
            a = dict(area_fn(i) if area_fn is not None else (area or {}))
            self.graph.add_task(Task(name=inst, area=a, detached=detach,
                                     pinned=pinned, meta=dict(meta or {})))
            names.append(inst)
        for lst, role in ((ins, "dst"), (outs, "src")):
            if not lst:
                continue
            if len(lst) % count:
                raise ValueError(
                    f"invoke({fn!r}): {len(lst)} streams not divisible by count={count}")
            per = len(lst) // count
            for i, inst in enumerate(names):
                for sname in lst[i * per:(i + 1) * per]:
                    s = self._stream_defs[sname]
                    setattr(s, role, inst)
        return names

    def build(self) -> TaskGraph:
        for s in self._stream_defs.values():
            if not s.src or not s.dst:
                raise ValueError(
                    f"stream {s.name!r} missing "
                    f"{'producer' if not s.src else 'consumer'}")
            self.graph.add_stream(s)
        self.graph.validate()
        return self.graph
