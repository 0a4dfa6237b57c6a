"""Plain PyTorch versions of the kernels on the serving path.

Counterpart of ``repro/kernels/ref.py`` (``attention_ref``,
``mamba2_scan_ref``, ``rwkv6_scan_ref``, ``burst_gather_ref``,
``moe_gmm_ref``), with the same signatures and layouts.  They are the
semantics contract: the CUDA kernels in ``csrc/`` are held to them on the
card, and the wrappers run them for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch


def _per_batch(value, B: int, device) -> torch.Tensor:
    """An int or a (B,) tensor -> a (B,) int64 tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int64).reshape(-1) \
            .expand(B)
    return torch.full((B,), int(value), dtype=torch.int64, device=device)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: int | None = None,
                  softcap: float | None = None,
                  scale: float | None = None,
                  q_offset: int | torch.Tensor = 0,
                  kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention with grouped KV heads.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0] (decode: cache length), an int
    or a (B,) tensor.  ``kv_len``: optional valid KV length, an int or a
    (B,) tensor (ragged decode batches).  Returns (B, Sq, Hq, D) in q.dtype.
    Rows with no valid key give zeros.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale

    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)       # (B, Hq, Sq, Skv)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap

    qpos = (_per_batch(q_offset, B, q.device)[:, None]
            + torch.arange(Sq, device=q.device)[None, :])[:, :, None]
    kpos = torch.arange(Skv, device=q.device)[None, None, :]
    mask = torch.ones((B, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < _per_batch(kv_len, B, q.device)[:, None, None]
    mask = mask[:, None]                                    # (B, 1, Sq, Skv)
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def mamba2_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B_: torch.Tensor, C: torch.Tensor,
                    state: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD recurrence (Mamba-2), sequential, in f32.

    x: (B, S, H, P) input heads; dt: (B, S, H) positive step sizes (post-
    softplus); A: (H,) negative decay rates; B_, C: (B, S, N), shared by
    all heads; state: (B, H, P, N) initial state (None = zeros).  Returns
    (y (B, S, H, P) in x.dtype, final state (B, H, P, N) in f32).

      h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t
    """
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    xf, dtf, Bf, Cf, Af = (a.float() for a in (x, dt, B_, C, A))
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])              # (B, H)
        dx = dtf[:, t][..., None] * xf[:, t]                    # (B, H, P)
        upd = dx[..., None] * Bf[:, t][:, None, None, :]        # (B, H, P, N)
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y.to(x.dtype), h


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV recurrence with data-dependent decay, sequential, in f32.

    r, k, v: (B, S, H, D); w: (B, S, H, D) decay in (0, 1); u: (H, D)
    bonus; state: (B, H, D_k, D_v) (None = zeros), the decay on the key
    axis.  Returns (y (B, S, H, D) in r.dtype, final state in f32).

      y_t = r_t . (S + diag(u) k_t^T v_t) ;  S = diag(w_t) S + k_t^T v_t
    """
    B, S, H, D = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    s = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    ys = []
    for t in range(S):
        kv = kf[:, t][..., :, None] * vf[:, t][..., None, :]    # (B, H, D, D)
        ys.append(torch.einsum("bhd,bhde->bhe", rf[:, t],
                               s + uf[None, :, :, None] * kv))
        s = wf[:, t][..., :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else rf.new_zeros(r.shape)
    return y.to(r.dtype), s


def burst_gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``table`` at ``idx``: table (R, D), idx (N,) -> (N, D).

    Indices must lie in [0, R).  ``jnp.take`` in the JAX reference wraps
    negative indices and fills out-of-range rows with NaN; this version
    raises on both (``torch.index_select``), and the model only passes
    token ids below the vocabulary size.
    """
    return torch.index_select(table, 0, idx)


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor,
                group_ids: torch.Tensor) -> torch.Tensor:
    """Grouped matmul: row i of the output is ``x[i] @ w[group_ids[i]]``.

    x: (T, K); w: (E, K, N); group_ids: (T,) integer, in any order ->
    (T, N) in x.dtype, accumulated in f32.  A row whose id lies outside
    [0, E) is zero, as ``one_hot`` makes it in the JAX reference.  Written
    as a loop over the experts present: the reference's one-hot einsum
    would be T x E x K x N.
    """
    T = x.shape[0]
    E, _, N = w.shape
    ids = group_ids.to(torch.int64)
    out = torch.zeros((T, N), dtype=torch.float32, device=x.device)
    for e in torch.unique(ids[(ids >= 0) & (ids < E)]).tolist():
        rows = torch.nonzero(ids == e).squeeze(1)
        out[rows] = x[rows].float() @ w[e].float()
    return out.to(x.dtype)
