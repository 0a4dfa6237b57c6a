"""launches_per_call.serve: kernels launched on the device a ``generate``
call, from the traced calls (copies and fills not counted).  Source: the
device trace; moves ``serve_tokens_per_s``."""


def read(r):
    if r.kind != "serve" or r.trace is None:
        return None
    n = len(r.trace.kernels())
    return n / r.trace.units if n else None
