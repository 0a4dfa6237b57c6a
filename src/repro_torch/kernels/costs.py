"""What each kernel of the port costs: its operations, and the least time
an H100 takes for a given count of operations and bytes.

One place for the reckonings that ``chip_smoke.py``'s bound rows and the
dry run's FLOP counts (``repro_torch.launch.dryrun``, through the kernels'
shape-only ops) both read.  A count is of what the inputs need: the
attention's (query, key) pairs that its masks let through, the scans'
steps, the grouped matmul's routed rows.
"""
from __future__ import annotations

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
#: outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: streaming multiprocessors of an H100 SXM: the split-KV decode plans its
#: grid (and sizes its scratch) by them, also where no card is asked
H100_SMS = 132
#: f32 operations of a scan's forward per state element and step: mamba2
#: 5 (decay, the dt x B update, the add, the C product's multiply-add),
#: rwkv6 7 (the u bonus, the products with r and k v, the decay's update)
MAMBA2_FWD, RWKV6_FWD = 5, 7
#: the same of their backward: mamba2 12 (the state's step 3, the gradient
#: g 2, its sums against B and h_{t-1} 4, its products into dB and dC 2,
#: the carry 1), rwkv6 15 (the state's step 3, G's sums against v and
#: S_{t-1} and dy's against S_{t-1} 6, the dv term 3, the carry 3)
MAMBA2_BWD, RWKV6_BWD = 12, 15


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the larger of ``flops`` at the bf16
    tensor-core peak and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def attention_pairs(B: int, Sq: int, Skv: int, Hq: int, *, causal=True,
                    window=None, q_offset=0, kv_len=None) -> int:
    """The (query, key) pairs of an attention call that its masks let
    through, over every batch row and query head: key j of query i (at
    position q_offset + i) where j <= it (causal), j > it - window, and j
    < kv_len.  A (B,) tensor for ``q_offset`` or ``kv_len`` counts as its
    largest entry (the host does not read the card's values)."""
    p = _most(q_offset, 0) + np.arange(Sq, dtype=np.int64)
    limit = Skv if kv_len is None else min(Skv, _most(kv_len, Skv))
    hi = np.minimum(limit, p + 1) if causal else np.full(Sq, limit)
    lo = np.maximum(0, p - window + 1) if window is not None else 0
    return B * Hq * int(np.maximum(0, hi - lo).sum())


def _most(value, default) -> int:
    if value is None:
        return default
    if hasattr(value, "numel"):
        return default
    return int(value)


def attention_flops(pairs: int, D: int) -> int:
    """The forward: q k^T and p v, 2 D each a pair."""
    return 4 * D * pairs


def attention_bwd_flops(pairs: int, D: int) -> int:
    """The backward's five products (the scores again, dV, dP, dQ, dK),
    2 D each a pair."""
    return 2 * 5 * D * pairs


def mamba2_flops(x_numel: int, N: int, backward: bool = False) -> int:
    """f32 operations of the SSD scan over x (B, S, H, P) with state N."""
    return (MAMBA2_BWD if backward else MAMBA2_FWD) * x_numel * N


def rwkv6_flops(r_numel: int, D: int, backward: bool = False) -> int:
    """f32 operations of the WKV scan over r (B, S, H, D)."""
    return (RWKV6_BWD if backward else RWKV6_FWD) * r_numel * D


def gmm_flops(T: int, K: int, N: int, backward: bool = False) -> int:
    """The grouped matmul's 2 T K N; its backward's dX and dW twice
    that."""
    return (4 if backward else 2) * T * K * N


def gather_bwd_flops(dout_numel: int) -> int:
    """The gather's gradient: one add an element of dout."""
    return dout_numel
