"""elementwise_ms.train: device milliseconds a training step of PyTorch's
own elementwise and reduction kernels (AdamW's and the clip's f32 passes,
casts, norms, activations, residuals, the loss), from the traced steps.
Source: the device trace; moves ``train_tokens_per_s``."""
import re

#: PyTorch's elementwise and reduction kernels, by the names CUDA gives
KERNELS = re.compile(r"at::native::.*(elementwise|reduce_kernel)")


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    s, n = r.trace.time_of(lambda name: KERNELS.search(name) is not None)
    return 1e3 * s / r.trace.units if n else None
