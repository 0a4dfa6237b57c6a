"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes of each operation the benchmark reads, from shapes alone.

A frozen copy of the formulas of ``repro_torch/kernels/costs.py`` that the
benchmark needs (peaks, causal (query, key) pairs, the attention's and
the grouped matmul's operations), with the bytes each operation must move
and the model FLOPs of a step.  It imports nothing of the program, so a
change to the program cannot move the yardstick.

``m`` is a configuration's ``model`` dict (``configs/<name>.json``).
"""
from __future__ import annotations

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16, F32, I32 = 2, 4, 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card takes: the larger of ``flops`` at the
    bf16 tensor-core peak and ``nbytes`` at the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def vocab_padded(m: dict) -> int:
    """Embedding rows, padded to a multiple of 256 as the program pads
    them (the pad rows' logits are masked)."""
    return -(-m["vocab"] // 256) * 256


def causal_pairs(B: int, S: int, H: int) -> int:
    """(query, key) pairs a causal attention over S positions lets
    through, over every batch row and query head."""
    return B * H * S * (S + 1) // 2


# ---------------------------------------------------------------------------
# attention (kernels/flash_attention.py)
# ---------------------------------------------------------------------------

def attention_fwd(m: dict, B: int, Sq: int, pairs: int, kv_rows: int):
    """(flops, bytes) of one attention forward: q k^T and p v, 2 D each a
    pair; q and o (B, Sq, H, D), k and v (B, kv_rows, Hkv, D) in bf16, the
    row log-sum-exp in f32."""
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    flops = 4 * D * pairs
    nbytes = (2 * B * Sq * H * D + 2 * B * kv_rows * Hkv * D) * BF16 \
        + B * Sq * H * F32
    return flops, nbytes


def attention_bwd(m: dict, B: int, S: int, pairs: int):
    """(flops, bytes) of one attention backward: its five products (the
    scores again, dV, dP, dQ, dK), 2 D each a pair; q, k, v, o, do, the
    log-sum-exp read, dq, dk, dv written."""
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    flops = 10 * D * pairs
    nbytes = (3 * B * S * H * D + 2 * B * S * Hkv * D) * BF16 \
        + (B * S * H * D + 2 * B * S * Hkv * D) * BF16 + B * S * H * F32
    return flops, nbytes


# ---------------------------------------------------------------------------
# dense products (torch.matmul: cuBLAS)
# ---------------------------------------------------------------------------

def layer_matmul_params(m: dict) -> int:
    """Weights a token multiplies in one layer: the attention's four
    projections, and the MLP's three or the router and top_k experts'
    three."""
    d, q, kv = m["d_model"], m["n_heads"] * m["head_dim"], \
        m["n_kv_heads"] * m["head_dim"]
    att = d * (q + 2 * kv) + q * d
    if m.get("n_experts"):
        return att + d * m["n_experts"] + m["top_k"] * 3 * d * m["moe_d_ff"]
    return att + 3 * d * m["d_ff"]


def dense_fwd_flops(m: dict, tokens: int, head_tokens: int) -> int:
    """Forward FLOPs of the products ``torch.matmul`` runs: the attention
    projections (and the router) of every layer and the MLP of a dense
    layer for ``tokens`` tokens, and the tied head over the padded vocab
    for ``head_tokens``."""
    d, q, kv = m["d_model"], m["n_heads"] * m["head_dim"], \
        m["n_kv_heads"] * m["head_dim"]
    per = d * (q + 2 * kv) + q * d
    per += d * m["n_experts"] if m.get("n_experts") else 3 * d * m["d_ff"]
    return 2 * tokens * per * m["n_layers"] \
        + 2 * head_tokens * d * vocab_padded(m)


def train_gemm_flops(m: dict, B: int, S: int) -> int:
    """A training step's ``torch.matmul`` FLOPs: each forward product and
    its two backward products (dX, dW)."""
    return 3 * dense_fwd_flops(m, B * S, B * S)


# ---------------------------------------------------------------------------
# the MoE layer (kernels/moe_gmm.py, kernels/burst_gather.py)
# ---------------------------------------------------------------------------

def gmm(rows: int, K: int, N: int, E: int, backward: bool = False):
    """(flops, bytes) of a grouped matmul over ``rows`` routed rows with E
    expert matrices (K, N) in bf16: forward x, w read and y written; the
    backward's dX and dW, dy, x and w read, dx and dw written."""
    if not backward:
        return 2 * rows * K * N, (rows * K + E * K * N + rows * N) * BF16
    return 4 * rows * K * N, \
        (2 * rows * N + rows * K + E * K * N
         + rows * K + E * K * N) * BF16


def gather(rows: int, width: int, table_rows: int, backward: bool = False):
    """(flops, bytes) of a bf16 row gather of ``rows`` ids out of a
    (table_rows, width) table: forward the rows read and written with
    their int32 ids; backward dout read, one add an element, and the whole
    table's gradient written."""
    if not backward:
        return 0, 2 * rows * width * BF16 + rows * I32
    return rows * width, (rows * width + table_rows * width) * BF16 \
        + rows * I32


def moe_layer_bounds_s(m: dict, tokens: int, backward: bool) -> float:
    """Least seconds of one MoE layer's kernels for ``tokens`` tokens: the
    plan over the T k ids, the dispatch gather, the three grouped matmuls
    (up, gate: d -> f; down: f -> d); with ``backward`` their gradients
    too."""
    d, f, E = m["d_model"], m["moe_d_ff"], m["n_experts"]
    rows = tokens * m["top_k"]
    parts = [(0, rows * I32 + (E + 1) * I32),
             gather(rows, d, tokens),
             gmm(rows, d, f, E), gmm(rows, d, f, E), gmm(rows, f, d, E)]
    if backward:
        parts += [gather(rows, d, tokens, True),
                  gmm(rows, d, f, E, True), gmm(rows, d, f, E, True),
                  gmm(rows, f, d, E, True)]
    return sum(bound_s(fl, nb) for fl, nb in parts)


def embedding_bounds_s(m: dict, tokens: int, backward: bool) -> float:
    """Least seconds of the embedding's gather (and its gradient into the
    whole padded table)."""
    d, V = m["d_model"], vocab_padded(m)
    s = bound_s(*gather(tokens, d, V))
    if backward:
        s += bound_s(*gather(tokens, d, V, True))
    return s


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------

def train_model_flops(m: dict, B: int, S: int) -> int:
    """Model FLOPs of one training step over B x S positions: 6 x the
    weights a token multiplies (every layer's, and the tied head over the
    padded vocab) x tokens, plus the causal attention's products forward
    (4 D a pair) and backward (8 D a pair), nothing recomputed."""
    T = B * S
    per_token = m["n_layers"] * layer_matmul_params(m) \
        + m["d_model"] * vocab_padded(m)
    pairs = causal_pairs(B, S, m["n_heads"])
    return 6 * per_token * T + 12 * m["head_dim"] * pairs * m["n_layers"]


def serve_call_flops(m: dict, B: int, P: int, gen: int) -> int:
    """Model FLOPs of one ``generate`` call: a prefill of B x P positions
    (the head at the last position only) and ``gen`` decode steps, each a
    position over the cache it has: 2 x the weights a token multiplies x
    tokens, plus 4 D a (query, key) pair."""
    L, D, H = m["n_layers"], m["head_dim"], m["n_heads"]
    layer, head = layer_matmul_params(m), m["d_model"] * vocab_padded(m)
    flops = 2 * B * P * L * layer + 2 * B * head \
        + 4 * D * causal_pairs(B, P, H) * L
    for j in range(gen):
        flops += 2 * B * (L * layer + head) + 4 * D * B * H * (P + j + 1) * L
    return flops
