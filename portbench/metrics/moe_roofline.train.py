"""moe_roofline.train: the least time of a training step's MoE kernels
(``kernels/moe_gmm.py``: the plan and the three grouped matmuls with their
dX and dW; ``kernels/burst_gather.py``: the dispatch's gather and its
gradient, and the embedding's, which runs the same kernels and cannot be
told apart by name) over their device time, from the traced steps.  Work
from shapes (``costs.moe_layer_bounds_s``, ``embedding_bounds_s``).
Source: the device trace; moves ``train_tokens_per_s``."""
import re

from portbench import costs

#: the grouped matmul's, its plan's and the gather's kernels
KERNELS = re.compile(
    r"\b(gmm_wgmma|gmm_dx_wgmma|gmm_dw_wgmma|gmm_f32_kernel|gmm_wmma_kernel|"
    r"gmm_dw_f32_kernel|gmm_dw_wmma_kernel|plan_kernel|burst_vec|bwd_sort|"
    r"bwd_chunk_sort|bwd_merge|bwd_write)\b")


def read(r):
    m = r.model
    if r.kind != "train" or r.trace is None or not m.get("n_experts"):
        return None
    s, n = r.trace.time_of(lambda name: KERNELS.search(name) is not None)
    if not n:
        return None
    tr = r.traffic
    T = tr["batch"] * (tr["seq"] + 1)
    step = m["n_layers"] * costs.moe_layer_bounds_s(m, T, True) \
        + costs.embedding_bounds_s(m, T, True)
    return 100 * step * r.trace.units / s
