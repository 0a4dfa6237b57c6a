"""Canonical padded batch layout shared by the array simulator backends.

Counterpart of ``repro/kernels/padded_batch.py``.  ``simulate_batch``'s
padded ragged-batch engines (NumPy and torch) both
consume the layout built here: jobs grouped by topology signature, every
group padded to the batch-max (T*, S*) task/stream shape, with explicit
masks that keep the padding inert.

Phantom-mask invariants (property-tested for the reference in
``tests/test_padded_batch.py``):

* **phantom tasks never fire** — columns ``>= group.T`` have
  ``task_active`` False, so the firing rule masks them out, and ``counted``
  False, so they are vacuously done in the termination/deadlock checks;
* **phantom streams never stall a real task** — columns ``>= group.S``
  are attached to no real task: their ``cons``/``prod`` entries point at
  the sentinel task index ``T*`` (one past the last real column), their
  per-group incidence matrices carry no row for them, and their capacity
  is zero only for *themselves* (nothing reads it).

Both backends therefore produce exactly the per-job results of an
unpadded event simulation; only the array shapes are shared.

The builder lives in ``repro_torch.kernels`` because the padded sweep is
the simulator's hot path: the torch backend (``repro_torch.kernels.
sim_sweep``) hands this layout to a kernel that gives each job row a
group of warps sized to it.
"""

from __future__ import annotations

import dataclasses
from itertools import repeat

import numpy as np


@dataclasses.dataclass
class PaddedGroup:
    """One topology group's index structures and padded-row placement.

    Rows ``[r0, r1)`` of the batch arrays belong to this group; its real
    tasks/streams occupy the first ``T``/``S`` columns and the remaining
    columns up to the batch-max (T*, S*) are phantom padding."""

    r0: int
    r1: int
    #: task names, in column order
    names: list[str]
    #: data-stream names, in column order
    snames: list[str]
    T: int
    S: int
    #: producer/consumer task column per real stream, shape (S,)
    prod: np.ndarray
    cons: np.ndarray
    #: incidence matrices stream -> task (real streams only), shape (S, T)
    a_in: np.ndarray
    a_out: np.ndarray
    #: per-task real input/output stream counts, shape (T,)
    indeg: np.ndarray
    outdeg: np.ndarray


@dataclasses.dataclass
class PaddedBatch:
    """The canonical padded layout of one ``simulate_batch`` call."""

    #: batch size and padded dims: jobs, batch-max tasks/streams, ring depth
    V: int
    T: int
    S: int
    H: int
    #: padded row -> original job index (row v's results go to perm[v])
    perm: list[int]
    groups: list[PaddedGroup]
    #: per-job knob arrays, phantom columns zeroed (ii: ones), (V, S)/(V, T)
    lat: np.ndarray
    cap: np.ndarray
    ii: np.ndarray
    #: real-task mask / real-and-non-detached mask, (V, T) bool
    task_active: np.ndarray
    counted: np.ndarray
    #: real-stream mask, (V, S) bool
    stream_active: np.ndarray
    #: flat per-job consumer/producer task columns, (V, S); phantom streams
    #: carry the sentinel index ``T`` (one past the last real task column)
    cons: np.ndarray
    prod: np.ndarray

    def unpack(self, cycles, dead, fired, steps: int, engine: str) -> list:
        """Distribute padded per-row results back into ``SimResult``s in
        the original job order (inverse of the grouping permutation)."""
        from repro_torch.core.simulate import SimResult

        cycles = np.asarray(cycles).tolist()
        dead = np.asarray(dead, dtype=bool).tolist()
        fired = np.asarray(fired)
        steps = int(steps)
        out = [None] * self.V
        for g in self.groups:
            names = g.names
            for v, row in zip(range(g.r0, g.r1),
                              fired[g.r0:g.r1, :g.T].tolist()):
                out[self.perm[v]] = SimResult(
                    cycles=int(cycles[v]),
                    fired=dict(zip(names, row)),
                    deadlocked=dead[v],
                    steps=steps,
                    engine=engine,
                )
        return out


def _knob_cells(rows, dicts, names):
    """(row, column, value) arrays of every knob in ``dicts`` (a dict or
    None per row of ``rows``) whose name is one of ``names``, the columns;
    other names are ignored.  ``TaskGraph.add_stream`` accepts a stream
    name twice (it checks ends, width and depth), and ``_Model`` resolves
    a knob by name, so a knob sets every column of its name."""
    col = {n: i for i, n in enumerate(names)}    # the last column of a name
    keys, vals, counts = [], [], []
    for d in dicts:
        if d:
            keys.extend(d)
            vals.extend(d.values())
        counts.append(len(d) if d else 0)
    r = np.repeat(np.asarray(rows, dtype=np.int64), counts)
    c = np.fromiter(map(col.get, keys, repeat(-1, len(keys))),
                    dtype=np.int64, count=len(keys))
    keep = c >= 0
    # values of ignored names are never read, as _Model never reads them
    x = np.array(vals, dtype=object)[keep].astype(np.int64)
    r, c = r[keep], c[keep]
    for i, n in enumerate(names if len(col) < len(names) else ()):
        if col[n] != i:            # an earlier column of a repeated name
            hit = c == col[n]
            r, x = np.concatenate([r, r[hit]]), np.concatenate([x, x[hit]])
            c = np.concatenate([c, np.full(int(hit.sum()), i)])
    return r, c, x


def build_padded_batch(jobs) -> PaddedBatch:
    """Group ``SimJob``s by topology signature and build the canonical
    padded (V, T*, S*) layout both array backends consume.

    Each group's index structures (task and data-stream columns, producer
    and consumer columns, FIFO depths, the detached mask) are built once,
    from its first graph, as ``core.simulate._Model`` resolves them; each
    job then contributes only its own ``latency``, ``extra_capacity`` and
    ``ii`` entries.  Knobs that name a control stream or nothing in the
    graph are ignored, as ``_Model`` ignores them."""
    # imported here: repro_torch.core.simulate imports this module lazily,
    # so a top-level import back into it would be circular at load time
    from repro_torch.core.simulate import _topology_signature

    # a signature is hashed once per distinct graph object, not per job
    of_graph: dict[int, list[int]] = {}
    members: dict[tuple, list[int]] = {}
    for v, j in enumerate(jobs):
        mem = of_graph.get(id(j.graph))
        if mem is None:
            mem = members.setdefault(_topology_signature(j.graph), [])
            of_graph[id(j.graph)] = mem
        mem.append(v)
    perm = [v for mem in members.values() for v in mem]

    groups: list[PaddedGroup] = []
    depths, detached = [], []
    r0 = 0
    for mem in members.values():
        graph = jobs[mem[0]].graph
        names = list(graph.tasks)
        data = [s for s in graph.streams if not s.control]
        snames = [s.name for s in data]
        T, S = len(names), len(snames)
        tidx = {n: i for i, n in enumerate(names)}
        # by name, as _Model keys them: the last stream of a name wins
        producer = {s.name: s.src for s in data}
        consumer = {s.name: s.dst for s in data}
        depth = {s.name: int(s.depth) for s in data}
        prod = np.array([tidx[producer[s]] for s in snames], dtype=np.int64)
        cons = np.array([tidx[consumer[s]] for s in snames], dtype=np.int64)
        a_in = np.zeros((S, T), dtype=np.int64)
        a_out = np.zeros((S, T), dtype=np.int64)
        a_in[np.arange(S), cons] = 1
        a_out[np.arange(S), prod] = 1
        groups.append(
            PaddedGroup(
                r0=r0,
                r1=r0 + len(mem),
                names=names,
                snames=snames,
                T=T,
                S=S,
                prod=prod,
                cons=cons,
                a_in=a_in,
                a_out=a_out,
                indeg=np.bincount(cons, minlength=T),
                outdeg=np.bincount(prod, minlength=T),
            )
        )
        depths.append([depth[s] for s in snames])
        detached.append([graph.tasks[n].detached for n in names])
        r0 += len(mem)

    V = len(jobs)
    T = max((g.T for g in groups), default=0)
    S = max((g.S for g in groups), default=0)

    lat = np.zeros((V, S), dtype=np.int64)
    cap = np.zeros((V, S), dtype=np.int64)
    ii = np.ones((V, T), dtype=np.int64)
    task_active = np.zeros((V, T), dtype=bool)
    counted = np.zeros((V, T), dtype=bool)
    stream_active = np.zeros((V, S), dtype=bool)
    # phantom streams attach to the sentinel task column T: gathers through
    # them read the all-zero sentinel, so they can never gate or be gated
    cons = np.full((V, S), T, dtype=np.int64)
    prod = np.full((V, S), T, dtype=np.int64)
    for g, depth, det in zip(groups, depths, detached):
        r0, r1, gT, gS = g.r0, g.r1, g.T, g.S
        rows = range(r0, r1)
        mine = [jobs[perm[v]] for v in rows]
        if gS:
            cap[r0:r1, :gS] = depth
            r, c, x = _knob_cells(rows, (j.latency for j in mine), g.snames)
            lat[r, c] = x
            r, c, x = _knob_cells(rows, (j.extra_capacity for j in mine),
                                  g.snames)
            cap[r, c] += x
        if gT:
            r, c, x = _knob_cells(rows, (j.ii for j in mine), g.names)
            ii[r, c] = x
            counted[r0:r1, :gT] = ~np.array(det, dtype=bool)
        task_active[r0:r1, :gT] = True
        stream_active[r0:r1, :gS] = True
        cons[r0:r1, :gS] = g.cons
        prod[r0:r1, :gS] = g.prod

    H = int(lat.max(initial=0)) + 2
    return PaddedBatch(
        V=V,
        T=T,
        S=S,
        H=H,
        perm=perm,
        groups=groups,
        lat=lat,
        cap=cap,
        ii=ii,
        task_active=task_active,
        counted=counted,
        stream_active=stream_active,
        cons=cons,
        prod=prod,
    )
