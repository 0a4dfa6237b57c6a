"""launches_per_step.train: kernels launched on the device a training
step, from the traced steps (copies and fills not counted).  Source: the
device trace; moves ``train_tokens_per_s``."""


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    n = len(r.trace.kernels())
    return n / r.trace.units if n else None
