"""Plain PyTorch reference of the granite configurations: dense (llama
blocks) and MoE (top-k routed gated experts), their next-token loss, and
their forward over a served sequence.

Float32 throughout, TF32 off (``strict_f32``), no kernel, cache or
batching of the program.  It follows the published llama / granite block
and the program's stated conventions: RMSNorm (eps 1e-6, an f32 weight),
rotary embeddings over the whole head in two halves (theta from the
configuration), grouped KV heads (query head h reads KV head h // (H /
Hkv)), causal softmax attention at scale 1/sqrt(D), the gated SiLU MLP,
a tied head over the padded vocabulary whose pad rows are left out, and
for MoE a softmax router in f32, top-k renormalised (floor 1e-9), the
experts' outputs weighted by it, and the load-balance loss E * sum_e
(share routed to e * mean probability of e) added at ``aux_loss_coef`` a
layer.  Granite 3.0's scalars (``attention_multiplier`` in place of
1/sqrt(D), ``embedding_multiplier``, ``residual_multiplier``,
``logits_scaling``) apply where the configuration gives them.

Leaves are a dict by the names of ``portbench.weights.leaves``.  ``prec``
is ``F32`` or ``FP8`` (``precision.py``): every product of weights or
activations goes through ``prec.mm``.  Training checkpoints each layer,
so that a step of the benchmark's full-size cells fits beside the
reference's own f32 state.  It imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6


def strict_f32() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rmsnorm(x, w):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * w


def rope_tables(S: int, D: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope(x, cos, sin):
    """x (B, S, H, D): rotate the pairs (x_i, x_{i + D/2})."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(P, pre, m, x, cos, sin, prec):
    B, S, d = x.shape
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = prec.mm(x, P[pre + "attn.wq"]).view(B, S, H, D)
    k = prec.mm(x, P[pre + "attn.wk"]).view(B, S, Hkv, D)
    v = prec.mm(x, P[pre + "attn.wv"]).view(B, S, Hkv, D)
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    g = H // Hkv
    q = q.transpose(1, 2) * m.get("attention_multiplier", D ** -0.5)
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    s = prec.mm(q, k.transpose(-1, -2))                      # (B, H, S, S)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(s.masked_fill(causal, float("-inf")), dim=-1)
    o = prec.mm(p, v).transpose(1, 2).reshape(B, S, H * D)
    return prec.mm(o, P[pre + "attn.wo"])


def mlp(P, pre, x, prec):
    return prec.mm(F.silu(prec.mm(x, P[pre + "mlp.w_gate"]))
                   * prec.mm(x, P[pre + "mlp.w_up"]), P[pre + "mlp.w_down"])


def moe(P, pre, m, x, prec):
    """-> (y, aux): the routed experts' weighted sum and the layer's
    load-balance loss."""
    B, S, d = x.shape
    E, k = m["n_experts"], m["top_k"]
    xf = x.reshape(B * S, d)
    probs = torch.softmax(xf @ P[pre + "moe.router"], dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    y = torch.zeros_like(xf)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    wu, wg, wd = P[pre + "moe.w_up"], P[pre + "moe.w_gate"], \
        P[pre + "moe.w_down"]
    for e in range(E):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        counts[e] = tok.numel()
        if tok.numel() == 0:
            continue
        xe = xf[tok]
        h = F.silu(prec.mm(xe, wg[e])) * prec.mm(xe, wu[e])
        y = y.index_add(0, tok, prec.mm(h, wd[e]) * top_p[tok, slot, None])
    aux = E * torch.sum(counts / (B * S) * probs.mean(0))
    return y.view(B, S, d), aux


def layer(P, i, m, x, cos, sin, prec):
    """Layer i: -> (x, aux)."""
    pre, r = f"layers.{i}.", m.get("residual_multiplier", 1.0)
    x = x + r * attention(P, pre, m, rmsnorm(x, P[pre + "ln_attn.w"]), cos,
                          sin, prec)
    h = rmsnorm(x, P[pre + "ln_mlp.w"])
    if m.get("n_experts"):
        y, aux = moe(P, pre, m, h, prec)
    else:
        y, aux = mlp(P, pre, h, prec), x.new_zeros(())
    return x + r * y, aux


def hidden(P, m, tokens, prec, *, remat: bool):
    """tokens (B, S) -> (final hidden states before the last norm, summed
    aux)."""
    S = tokens.shape[1]
    cos, sin = rope_tables(S, m["head_dim"], m["rope_theta"], tokens.device)
    x = F.embedding(tokens, P["embed"]) * m.get("embedding_multiplier", 1.0)
    aux = x.new_zeros(())
    for i in range(m["n_layers"]):
        if remat:
            x, a = checkpoint(layer, P, i, m, x, cos, sin, prec,
                              use_reentrant=False)
        else:
            x, a = layer(P, i, m, x, cos, sin, prec)
        aux = aux + a
    return x, aux


def logits(P, m, x, prec):
    """Head over the real vocabulary (the pad rows' logits are masked in
    the program, and left out here)."""
    return prec.mm(rmsnorm(x, P["ln_f.w"]), P["embed"][:m["vocab"]].T) \
        / m.get("logits_scaling", 1.0)


def loss(P, m, tokens, prec, *, rows=None):
    """Next-token cross entropy over tokens (B, S + 1) plus 0.01 x the
    summed aux.  ``rows``: the number of (flattened) targets the mean
    takes, all by default (a fault that drops half the batch passes
    fewer)."""
    x, aux = hidden(P, m, tokens, prec, remat=True)
    lg = logits(P, m, x[:, :-1], prec)
    ce = torch.logsumexp(lg, -1) - torch.gather(
        lg, -1, tokens[:, 1:, None])[..., 0]
    ce = ce.reshape(-1)
    if rows is not None:
        ce = ce[:rows]
    return ce.mean() + m.get("aux_loss_coef", 0.0) * aux


@torch.no_grad()
def served_logits(P, m, seqs, P_len: int, prec, block: int = 4):
    """seqs (N, P_len + gen): each prompt with its served tokens.  ->
    (N, gen, vocab) f32: the logits at positions P_len - 1 .. P_len + gen
    - 2, the ones that chose each served token, over the whole sequence
    at once, ``block`` sequences at a time."""
    gen = seqs.shape[1] - P_len
    out = []
    for b in range(0, seqs.shape[0], block):
        x, _ = hidden(P, m, seqs[b:b + block], prec, remat=False)
        out.append(logits(P, m, x[:, P_len - 1:P_len - 1 + gen], prec))
    return torch.cat(out)
