"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro/kernels/ref.py`` (``attention_ref``,
``mamba2_scan_ref``, ``rwkv6_scan_ref``, ``burst_gather_ref``,
``moe_gmm_ref``, and ``_sweep`` of ``repro/kernels/sim_sweep.py`` as
``sim_sweep_ref``), with the same signatures and layouts.  They are the
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


def attention_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  window: int | None = None, softcap: float | None = None,
                  scale: float | None = None,
                  q_offset: int | torch.Tensor = 0,
                  kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """The log-sum-exp over the valid keys of each row of
    ``attention_ref``'s scores (scaled, softcapped, masked alike): (B, Sq,
    Hq) f32, -inf for a row with no valid key.  The port's own (the JAX
    package's ref returns no lse); a context-parallel cache merges the
    ranks' slices of the keys by it."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    scale = (D ** -0.5) if scale is None else scale
    kf = k.float().repeat_interleave(Hq // Hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
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
    logits = logits.masked_fill(~mask[:, None], -torch.inf)
    return torch.logsumexp(logits, dim=-1).transpose(1, 2)


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


def sim_sweep_ref(lat: torch.Tensor, cap: torch.Tensor, ii: torch.Tensor,
                  task_active: torch.Tensor, counted: torch.Tensor,
                  cons: torch.Tensor, prod: torch.Tensor, H: int,
                  firings: int, max_cycles: int):
    """The padded dataflow sweep: every job row to completion, one
    synchronous cycle per iteration, all rows in lockstep.

    A transcription of ``repro/kernels/sim_sweep.py::_sweep`` in torch
    ops.  lat, cap, cons, prod: (V, S) int32; ii: (V, T) int32;
    task_active, counted: (V, T) bool; phantom streams carry the sentinel
    task column T in ``cons``/``prod``; H is the push-history ring depth
    (``PaddedBatch.H``).  Returns ``(cycles, dead, fired, steps)``:
    (V,) int32, (V,) bool, (V, T) int32 and the int count of lockstep
    iterations in which some row was active.
    """
    V, S = lat.shape
    T = ii.shape[1]
    dev, i32 = lat.device, torch.int32
    hist = torch.zeros((V, S, H), dtype=i32, device=dev)
    pops = torch.zeros((V, S), dtype=i32, device=dev)
    pushes = torch.zeros((V, S), dtype=i32, device=dev)
    fired = torch.zeros((V, T), dtype=i32, device=dev)
    next_free = torch.zeros((V, T), dtype=i32, device=dev)
    active = torch.ones(V, dtype=torch.bool, device=dev)
    out_cycles = torch.full((V,), max_cycles, dtype=i32, device=dev)
    out_dead = torch.zeros(V, dtype=torch.bool, device=dev)
    cons, prod = cons.long(), prod.long()
    sent = torch.zeros((V, 1), dtype=i32, device=dev)
    steps = 0

    def all_done():
        # phantom and detached tasks are vacuously done
        return ((fired >= firings) | ~counted).all(dim=1)

    for t in range(max_cycles):
        newly = active & all_done()
        out_cycles = torch.where(newly, t, out_cycles)
        out_dead &= ~newly
        active &= ~newly
        if not bool(active.any()):
            break
        steps += 1

        # firing rule against the state produced by cycles < t
        if S:
            look = torch.remainder(t - 1 - lat, H).long()
            vis = hist.gather(2, look[:, :, None])[:, :, 0]
            tok_ok = vis > pops
            space_ok = (pushes - pops) < cap
            in_bad = torch.zeros((V, T + 1), dtype=i32, device=dev)
            in_bad.scatter_add_(1, cons, (~tok_ok).to(i32))
            out_bad = torch.zeros((V, T + 1), dtype=i32, device=dev)
            out_bad.scatter_add_(1, prod, (~space_ok).to(i32))
            in_ok, out_ok = in_bad[:, :T] == 0, out_bad[:, :T] == 0
        else:
            in_ok = out_ok = torch.ones((V, T), dtype=torch.bool, device=dev)
        can = (active[:, None] & task_active & (fired < firings)
               & (next_free <= t) & in_ok & out_ok)
        can_i = can.to(i32)
        fired += can_i
        next_free = torch.where(can, t + ii, next_free)
        if S:
            can_pad = torch.cat([can_i, sent], dim=1)
            pops += can_pad.gather(1, cons)
            pushes += can_pad.gather(1, prod)
            hist[:, :, t % H] = pushes

        progressed = can.any(dim=1)
        # post-update in-flight check at cycle t: vis from the cycle
        # start, pops/pushes after the update
        if S:
            tok_flight = ((pops < pushes) & (vis <= pops)).any(dim=1)
        else:
            tok_flight = torch.zeros(V, dtype=torch.bool, device=dev)
        ii_flight = (next_free > t).any(dim=1)
        quiet = active & ~progressed & ~tok_flight & ~ii_flight
        out_cycles = torch.where(quiet, t + 1, out_cycles)
        out_dead = torch.where(quiet, ~all_done(), out_dead)
        active &= ~quiet
    # rows still active at the horizon: truncated (or done exactly there)
    out_cycles = torch.where(active, max_cycles, out_cycles)
    out_dead = torch.where(active, ~all_done(), out_dead)
    return out_cycles, out_dead, fired, steps
