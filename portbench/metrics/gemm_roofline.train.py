"""gemm_roofline.train: the least time of a training step's dense
products (``torch.matmul``: the attention projections, the dense MLP or
the MoE router, the tied head; each forward product and its dX and dW) at
the bf16 peak, over the device time of cuBLAS's kernels, from the traced
steps.  Work from shapes (``costs.train_gemm_flops``).  Source: the
device trace; moves ``train_tokens_per_s``."""
import re

from portbench import costs

#: cuBLAS's kernels, by the names CUDA gives them on Hopper
KERNELS = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitKreduce")


def _is_gemm(name: str) -> bool:
    return KERNELS.search(name) is not None and "at::native" not in name


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    s, n = r.trace.time_of(_is_gemm)
    if not n:
        return None
    tr = r.traffic
    flops = costs.train_gemm_flops(r.model, tr["batch"], tr["seq"] + 1)
    return 100 * flops * r.trace.units / costs.PEAK_BF16_FLOPS / s
