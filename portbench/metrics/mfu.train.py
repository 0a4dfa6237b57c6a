"""mfu.train: model FLOPs of the window's training steps over their host
time, as a share of the H100's bf16 peak.  Model FLOPs: 6 x the weights a
token multiplies (every layer's and the tied head's) x the B x (S + 1)
positions a step feeds, plus the causal attention's products forward and
backward, nothing recomputed (``costs.train_model_flops``).  Source: the
untraced window's host clock; moves ``train_tokens_per_s``."""
from portbench import costs


def read(r):
    if r.kind != "train" or not r.units:
        return None
    tr = r.traffic
    flops = costs.train_model_flops(r.model, tr["batch"], tr["seq"] + 1)
    return 100 * flops * r.units / r.window_s / costs.PEAK_BF16_FLOPS
