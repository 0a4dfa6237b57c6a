"""Unified observability layer: metrics registry + structured tracing.

``repro_torch.obs`` is the single place the stack's telemetry lives:

* :mod:`repro_torch.obs.metrics` — a process-wide :class:`~repro_torch.obs.metrics.Registry`
  of counter groups and labelled instruments with generic
  snapshot/delta/merge/restore semantics.  Every legacy ``*_counts()``
  surface (engine, floorplan, ilp, analysis, pool, store, faults,
  sweep-cache) is now a view over this registry, and the worker pool
  ships one registry delta home instead of three bespoke merges.
* :mod:`repro_torch.obs.trace` — nestable spans with cross-process parent
  tokens, Chrome/Perfetto ``trace_event`` export, and the ``sim.obs``
  BENCH block that ``check_regression.py`` gates.

Command line (``python -m repro_torch.obs``)::

    python -m repro_torch.obs summarize trace.json   # top-N wall-time table
    python -m repro_torch.obs validate trace.json    # schema gate, exit 1 on error

Quick tour — count something, trace something, export:

>>> from repro_torch import obs
>>> snap = obs.metrics.snapshot()           # isolate the doctest
>>> misses = obs.metrics.counter("doc.cache")
>>> misses.inc(3, kind="miss")
>>> misses.value(kind="miss")
3
>>> obs.trace.enable(clear=True)
>>> with obs.trace.span("doc.step", n=1):
...     pass
>>> doc = obs.trace.to_chrome()
>>> [e["ph"] for e in doc["traceEvents"] if e["ph"] != "M"]
['B', 'E']
>>> obs.trace.validate_chrome(doc)
[]
>>> obs.trace.disable(); obs.metrics.restore(snap)
"""

import os as _os

from . import metrics, trace

__all__ = ["metrics", "trace", "bench_obs_block"]


def bench_obs_block(total_wall_s: float, trace_path: str | None = None,
                    ) -> dict:
    """The driver-side exit glue: compute the ``sim.obs`` BENCH payload
    and, when a ``--trace`` path was given, export the Perfetto JSON next
    to the BENCH JSON and record its basename as ``trace_file`` (the
    regression gate resolves it relative to the BENCH file)."""
    block = trace.bench_block(total_wall_s)
    if trace_path:
        trace.write_chrome(trace_path)
        block["trace_file"] = _os.path.basename(trace_path)
    return block
