"""attn_roofline.serve: the least time of a ``generate`` call's attention
(``kernels/flash_attention.py``: every layer's causal prefill over B x P
positions, then each decode step's query over the cache it has;
``costs.attention_fwd``, the larger of operations and bytes) over the
device time of the attention kernels, from the traced calls.  Source: the
device trace; moves ``serve_tokens_per_s``."""
import re

from portbench import costs

#: the port's attention kernels, prefill and decode
KERNELS = re.compile(r"\b(flash_fwd_\w+|decode_partial|decode_combine)\b")


def read(r):
    if r.kind != "serve" or r.trace is None:
        return None
    s, n = r.trace.time_of(lambda name: KERNELS.search(name) is not None)
    if not n:
        return None
    m, tr = r.model, r.traffic
    B, P, H = tr["batch"], tr["prompt_len"], m["n_heads"]
    call = costs.bound_s(*costs.attention_fwd(
        m, B, P, costs.causal_pairs(B, P, H), P))
    for j in range(tr["gen"]):
        kv = P + j + 1
        call += costs.bound_s(*costs.attention_fwd(m, B, 1, B * H * kv, kv))
    return 100 * call * m["n_layers"] * r.trace.units / s
