"""mfu.serve: model FLOPs of the window's ``generate`` calls over their
host time, as a share of the H100's bf16 peak.  Model FLOPs: 2 x the
weights a position multiplies x positions, plus 4 D a (query, key) pair
(``costs.serve_call_flops``: the prefill, its head at the last position,
and each decode step over the cache it has).  Source: the untraced
window's host clock; moves ``serve_tokens_per_s``."""
from portbench import costs


def read(r):
    if r.kind != "serve" or not r.units:
        return None
    tr = r.traffic
    flops = costs.serve_call_flops(r.model, tr["batch"], tr["prompt_len"],
                                   tr["gen"])
    return 100 * flops * r.units / r.window_s / costs.PEAK_BF16_FLOPS
