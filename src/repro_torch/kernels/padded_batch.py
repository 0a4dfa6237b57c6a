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
sim_sweep``) hands this layout to one CUDA block per job row.
"""

from __future__ import annotations

import dataclasses

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

        out = [None] * self.V
        for g in self.groups:
            for v in range(g.r0, g.r1):
                out[self.perm[v]] = SimResult(
                    cycles=int(cycles[v]),
                    fired={n: int(fired[v, i]) for i, n in enumerate(g.names)},
                    deadlocked=bool(dead[v]),
                    steps=int(steps),
                    engine=engine,
                )
        return out


def build_padded_batch(jobs) -> PaddedBatch:
    """Group ``SimJob``s by topology signature and build the canonical
    padded (V, T*, S*) layout both array backends consume."""
    # imported here: repro_torch.core.simulate imports this module lazily,
    # so a top-level import back into it would be circular at load time
    from repro_torch.core.simulate import _Model, _topology_signature

    sig_cache: dict[int, tuple] = {}
    members: dict[tuple, list[int]] = {}
    for v, j in enumerate(jobs):
        sig = sig_cache.get(id(j.graph))
        if sig is None:
            sig = _topology_signature(j.graph)
            sig_cache[id(j.graph)] = sig
        members.setdefault(sig, []).append(v)
    perm = [v for mem in members.values() for v in mem]
    models = [
        _Model(jobs[v].graph, jobs[v].latency, jobs[v].extra_capacity, jobs[v].ii)
        for v in perm
    ]

    groups: list[PaddedGroup] = []
    r0 = 0
    for mem in members.values():
        m0 = models[r0]
        names = m0.names
        snames = [s.name for s in m0.data]
        T, S = len(names), len(snames)
        tidx = {n: i for i, n in enumerate(names)}
        prod = np.array([tidx[m0.producer[s]] for s in snames], dtype=np.int64)
        cons = np.array([tidx[m0.consumer[s]] for s in snames], dtype=np.int64)
        a_in = np.zeros((S, T), dtype=np.int64)
        a_out = np.zeros((S, T), dtype=np.int64)
        for si in range(S):
            a_in[si, cons[si]] = 1
            a_out[si, prod[si]] = 1
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
                indeg=a_in.sum(axis=0),
                outdeg=a_out.sum(axis=0),
            )
        )
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
    for g in groups:
        r0, r1, gT, gS = g.r0, g.r1, g.T, g.S
        for v in range(r0, r1):
            m = models[v]
            if gS:
                lat[v, :gS] = [m.lat[s] for s in g.snames]
                cap[v, :gS] = [m.cap[s] for s in g.snames]
            if gT:
                ii[v, :gT] = [m.ii[n] for n in g.names]
                counted[v, :gT] = [not m.detached[n] for n in g.names]
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
