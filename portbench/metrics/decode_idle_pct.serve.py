"""decode_idle_pct.serve: the share of the program's ``serve.decode`` spans
(the greedy decode steps to their last synchronize) that no device
operation covers: their host intervals inside the device-only traced
window, less the union of the window's device operations over them, as
``Trace.busy`` takes it.  Left out unless the window holds one root span
``serve.generate`` per traced call.  Source: the program's span; moves
``serve_tokens_per_s``."""
from repro_torch.obs import trace

SPAN, ROOT = "serve.decode", "serve.generate"


def read(r):
    if r.kind != "serve" or r.trace is None or not r.trace.device:
        return None
    t = r.trace
    spans = [e for e in trace.events() if e["dur_ns"] is not None
             and t.start <= e["t_ns"] and e["t_ns"] + e["dur_ns"] <= t.end]
    if sum(e["name"] == ROOT and not e["parent"] for e in spans) != t.units:
        return None
    parts = [(e["t_ns"], e["t_ns"] + e["dur_ns"]) for e in spans
             if e["name"] == SPAN]
    if len(parts) != t.units:
        return None
    busy = t.busy()
    covered = sum(max(0, min(b, d) - max(a, c))
                  for a, b in parts for c, d in busy)
    return 100 * (1 - covered / sum(b - a for a, b in parts))
