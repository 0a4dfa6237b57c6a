"""attn_roofline.train: the least time of a training step's attention
(``kernels/flash_attention.py``: every layer's causal forward and its
backward over B x (S + 1) positions; ``costs.attention_fwd`` and
``attention_bwd``, the larger of operations and bytes) over the device
time of the attention kernels, from the traced steps.  Source: the device
trace; moves ``train_tokens_per_s``."""
import re

from portbench import costs

#: the port's attention kernels, forward and backward
KERNELS = re.compile(r"\b(flash_fwd_\w+|flash_bwd_\w+|decode_partial|"
                     r"decode_combine)\b")


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    s, n = r.trace.time_of(lambda name: KERNELS.search(name) is not None)
    if not n:
        return None
    m, tr = r.model, r.traffic
    B, S = tr["batch"], tr["seq"] + 1
    pairs = costs.causal_pairs(B, S, m["n_heads"])
    per_layer = costs.bound_s(*costs.attention_fwd(m, B, S, pairs, S)) \
        + costs.bound_s(*costs.attention_bwd(m, B, S, pairs))
    return 100 * per_layer * m["n_layers"] * r.trace.units / s
