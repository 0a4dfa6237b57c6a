"""idle_pct.serve: the share of the traced ``generate`` calls' span that
no device operation covers (the union of their intervals, not the sum of
their times).  Source: the device trace; moves ``serve_tokens_per_s``."""


def read(r):
    if r.kind != "serve" or r.trace is None or not r.trace.device:
        return None
    return 100 * (1 - r.trace.busy_s / r.trace.span_s)
