"""optimizer_ms.train: device milliseconds a traced training step of the
program's span ``train.optimizer`` (the zero fills, the clip, AdamW and
the reset of ``.grad``): the mean of its ``dev_ms`` (CUDA events at its
ends) over the spans whose host interval lies inside the device-only
traced window.  Left out unless the window holds one root span
``train.step`` per traced step.  Source: the program's span; moves
``train_tokens_per_s``."""
from repro_torch.obs import trace

SPAN, ROOT = "train.optimizer", "train.step"


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    t = r.trace
    spans = [e for e in trace.events() if e["dur_ns"] is not None
             and t.start <= e["t_ns"] and e["t_ns"] + e["dur_ns"] <= t.end]
    if sum(e["name"] == ROOT and not e["parent"] for e in spans) != t.units:
        return None
    ms = [e["dev_ms"] for e in spans if e["name"] == SPAN and "dev_ms" in e]
    return sum(ms) / len(ms) if len(ms) == t.units else None
