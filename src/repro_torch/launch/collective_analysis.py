"""Collective bytes of a traced step (for the roofline).

Counterpart of ``repro/launch/hlo_analysis.py``.  The JAX package parses
the compiled HLO for its collectives; the port records them where they are
issued (``distributed.collectives.recording``): each record holds the HLO
op's name (all-reduce, all-gather, reduce-scatter, all-to-all,
collective-permute), its result's bytes, and its replica groups of global
ranks or, for a permute, its (source, target) pairs.  ``collective_summary``
sums them with the reference's ring model, ICI against DCN by whether a
group or pair crosses a pod boundary (rank // pod_size).
"""
from __future__ import annotations


def collective_summary(records, *, pod_size: int) -> dict:
    """Ring-model wire bytes per device, ICI vs DCN classified:
    {"ici_bytes", "dcn_bytes", "ops": {op: count}, "count"}, as the
    reference's ``collective_summary`` gives them for the same
    collectives.  A group of one rank moves nothing and is not counted."""
    out = {"ici_bytes": 0.0, "dcn_bytes": 0.0, "ops": {}, "count": 0}
    for rec in records:
        op, size = rec["op"], rec["bytes"]
        if op == "collective-permute":
            pairs = rec.get("pairs", [])
            crosses = any(a // pod_size != b // pod_size for a, b in pairs)
            wire = float(size)
        else:
            groups = rec.get("groups") or []
            n = len(groups[0]) if groups else 1
            if n <= 1:
                continue
            crosses = any(len({d // pod_size for d in g}) > 1
                          for g in groups)
            if op == "all-reduce":
                wire = 2.0 * size * (n - 1) / n
            elif op == "all-gather":
                wire = float(size) * (n - 1) / n   # size = gathered result
            else:  # reduce-scatter (result is the scattered piece), a2a
                wire = float(size) * (n - 1)
        key = "dcn_bytes" if crosses else "ici_bytes"
        out[key] += wire
        out["ops"][op] = out["ops"].get(op, 0) + 1
        out["count"] += 1
    return out
