"""The backward of the two scans on the CPU: ``mamba2_scan_bwd`` and
``rwkv6_scan_bwd`` (their plain versions, autograd through ``ref.py``, and
autograd through the wrappers) against ``jax.vjp`` of the JAX package's
``repro.kernels.ref`` on the same numpy-seeded inputs; and a plain-torch
model of each sequential CUDA kernel's schedule (``csrc/scan_bwd.cuh``:
for ``mamba2_bwd_scan`` device checkpoints every ``BW_K1`` steps, shared
ones every ``BW_K2``; for ``rwkv6_bwd_scan`` device checkpoints every
``RB_K``; the registers' reverse walk, the lanes' butterfly and the
fixed-order sums across rows, warps and blocks, each partial at its offset
of the wrapper's scratch) against the plain backward.  The kernels themselves
run only on the card, where ``chip_smoke.py`` holds them to the plain
versions.

Tolerances: f32 gradients within 1e-5 of the largest entry of each (the
same f32 math summed in other orders); bf16 within
``tests/test_kernels.py``'s 2e-2 (each gradient is an f32 sum rounded once
to bf16 by both frameworks).
"""
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _scan_bwd  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import rwkv6_scan as r6  # noqa: E402

CSRC = Path(m2.__file__).parent / "csrc"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_REL = 1e-5
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_grads(got, want, dtype, names):
    """f32 gradients (those of f32 inputs in the bf16 cases too) within
    ``F32_REL`` of their largest entry, bf16 ones at ``BF16_TOL``."""
    for name, g, w in zip(names, got, want, strict=True):
        f32 = dtype == "float32" or g.dtype == torch.float32
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.isfinite(g).all(), name
        if f32:
            lim = F32_REL * max(float(np.abs(w).max(initial=0.0)), 1e-30)
            err = float(np.abs(g - w).max(initial=0.0))
            assert err <= lim, f"{name}: {err:.3e} > {lim:.3e}"
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **BF16_TOL)


# ---- mamba2 ---------------------------------------------------------------

#: (B, S, H, P, N), a state going in, a final-state gradient
M2_CASES = {
    "s1": ((2, 1, 3, 8, 4), True, True),
    "no-state": ((1, 13, 2, 16, 16), False, False),
    "s70-ragged": ((1, 70, 2, 40, 24), True, True),
    "n72-p33": ((1, 20, 1, 33, 72), True, False),
}
M2_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dstate0")


def _m2_inputs(seed, shape, dtype, state, dstate):
    """numpy-seeded inputs as the model passes them: x, B, C in ``dtype``,
    dt after softplus and A < 0 in f32; then dy in ``dtype`` and dstate
    f32; each as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    Bsz, S, H, P, N = shape
    f32 = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    x, Bm, Cm = f32(Bsz, S, H, P), f32(Bsz, S, N), f32(Bsz, S, N)
    dt = np.log1p(np.exp(f32(Bsz, S, H))).astype(np.float32)
    A = -np.exp(f32(H)).astype(np.float32)
    h0 = f32(Bsz, H, P, N) if state else np.zeros((Bsz, H, P, N), np.float32)
    dy = f32(Bsz, S, H, P)
    dh = f32(Bsz, H, P, N) if dstate else None
    arrays = (x, dt, A, Bm, Cm, h0, dy)
    typed = [dtype, "float32", "float32", dtype, dtype, "float32", dtype]
    j = [jnp.asarray(a, JDT[d]) for a, d in zip(arrays, typed)]
    t = [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrays, typed)]
    return j, t, dh


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(M2_CASES))
def test_mamba2_plain_backward_matches_jax_vjp(case, dtype):
    """``mamba2_scan_bwd`` on the CPU, and autograd through the
    ``mamba2_scan`` wrapper, against ``jax.vjp`` of
    ``repro.kernels.ref.mamba2_scan_ref``."""
    shape, state, dstate = M2_CASES[case]
    j, t, dh = _m2_inputs(7, shape, dtype, state, dstate)
    dh_j = jnp.zeros(j[5].shape, jnp.float32) if dh is None else \
        jnp.asarray(dh)
    _, vjp = jax.vjp(jref.mamba2_scan_ref, *j[:6])
    want = vjp((j[6], dh_j))
    st = t[5] if state else None
    got = m2.mamba2_scan_bwd(*t[:5], st, t[6],
                             None if dh is None else torch.from_numpy(dh))
    _assert_grads(got, want, dtype, M2_NAMES)
    # autograd through the wrapper (the model's route on the CPU)
    leaves = [a.clone().requires_grad_(True) for a in t[:6]]
    y, h = m2.mamba2_scan(*leaves)
    outs = [(y, t[6])] + ([] if dh is None else
                          [(h, torch.from_numpy(dh))])
    torch.autograd.backward([o for o, _ in outs], [c for _, c in outs])
    _assert_grads([a.grad for a in leaves], want, dtype, M2_NAMES)


# ---- rwkv6 ----------------------------------------------------------------

#: (B, S, H, D), a state going in, a final-state gradient, decay
R6_CASES = {
    "s1": ((2, 1, 3, 16), True, True, "normal"),
    "no-state": ((1, 13, 2, 16), False, False, "normal"),
    "s70-ragged": ((1, 70, 2, 40), True, True, "normal"),
    "d72": ((1, 20, 1, 72), True, False, "normal"),
    "w-zeros": ((2, 19, 2, 24), True, True, "zeros"),
}
R6_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")


def _r6_inputs(seed, shape, dtype, state, dstate, decay="normal"):
    """r, k, v, w = exp(-exp(z)) (a third of it exactly 0 for "zeros"), u,
    state; then dy and dstate; as (jax arrays, torch tensors), r, k, v, w
    and dy in ``dtype``."""
    rng = np.random.default_rng(seed)
    B, S, H, D = shape
    f32 = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    r, k, v = (f32(B, S, H, D) for _ in range(3))
    w = np.exp(-np.exp(f32(B, S, H, D))).astype(np.float32)
    if decay == "zeros":
        w[rng.random(w.shape) < 1 / 3] = 0.0
    u = 0.3 * f32(H, D)
    s0 = f32(B, H, D, D) if state else np.zeros((B, H, D, D), np.float32)
    dy = f32(B, S, H, D)
    ds = f32(B, H, D, D) if dstate else None
    arrays = (r, k, v, w, u, s0, dy)
    typed = [dtype] * 4 + ["float32", "float32", dtype]
    j = [jnp.asarray(a, JDT[d]) for a, d in zip(arrays, typed)]
    t = [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrays, typed)]
    return j, t, ds


def _r6_check(j, t, ds, state, dtype):
    ds_j = jnp.zeros(j[5].shape, jnp.float32) if ds is None else \
        jnp.asarray(ds)
    _, vjp = jax.vjp(jref.rwkv6_scan_ref, *j[:6])
    want = vjp((j[6], ds_j))
    got = r6.rwkv6_scan_bwd(*t[:5], t[5] if state else None, t[6],
                            None if ds is None else torch.from_numpy(ds))
    _assert_grads(got, want, dtype, R6_NAMES)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(R6_CASES))
def test_rwkv6_plain_backward_matches_jax_vjp(case, dtype):
    """``rwkv6_scan_bwd`` on the CPU, and autograd through the
    ``rwkv6_scan`` wrapper, against ``jax.vjp`` of
    ``repro.kernels.ref.rwkv6_scan_ref``; exact zeros of w among them."""
    shape, state, dstate, decay = R6_CASES[case]
    j, t, ds = _r6_inputs(9, shape, dtype, state, dstate, decay)
    if decay == "zeros":
        assert int((t[3] == 0).sum()) > 100
    want = _r6_check(j, t, ds, state, dtype)
    leaves = [a.clone().requires_grad_(True) for a in t[:6]]
    y, s = r6.rwkv6_scan(*leaves)
    outs = [(y, t[6])] + ([] if ds is None else [(s, torch.from_numpy(ds))])
    torch.autograd.backward([o for o, _ in outs], [c for _, c in outs])
    _assert_grads([a.grad for a in leaves], want, dtype, R6_NAMES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_plain_backward_at_strong_decay(dtype):
    """ROADMAP's strong-decay input (numpy seed 165, shape (2, 64, 3, 16),
    where the Pallas forward overflows to NaN), with w shifted as
    ``chip_smoke.py``'s "strong" decay: finite and equal to JAX's."""
    rng = np.random.default_rng(165)
    B, S, H, D = 2, 64, 3, 16
    f32 = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    r, k, v = (f32(B, S, H, D) for _ in range(3))
    z = f32(B, S, H, D)
    u, s0 = 0.3 * f32(H, D), f32(B, H, D, D)
    dy, ds = f32(B, S, H, D), f32(B, H, D, D)
    for w in (np.exp(-np.exp(z)), np.exp(-np.exp(z + 3.0))):
        arrays = (r, k, v, w.astype(np.float32), u, s0, dy)
        typed = [dtype] * 4 + ["float32", "float32", dtype]
        j = [jnp.asarray(a, JDT[d]) for a, d in zip(arrays, typed)]
        t = [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrays, typed)]
        _r6_check(j, t, ds, True, dtype)


# ---- models of the kernels' schedule --------------------------------------

def _cuh(name):
    text = (CSRC / "scan_bwd.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_schedule_constants_are_the_kernels():
    """The wrappers size the scratch, and the models below walk, with the
    constants of ``csrc/scan_bwd.cuh``."""
    assert _cuh("BW_NT") == _scan_bwd.THREADS
    assert _cuh("BW_G") == _scan_bwd.LANES
    assert _scan_bwd.ROWS == _scan_bwd.THREADS // _scan_bwd.LANES
    assert _cuh("BW_K1") == _scan_bwd.CHECKPOINT
    assert _cuh("BW_K2") == _scan_bwd.SUB
    assert _scan_bwd.CHECKPOINT % _scan_bwd.SUB == 0
    # rwkv6_bwd_scan's: 8 lanes a row of the same 32 rows a block, a
    # checkpoint every RB_K steps, RB_CH steps a stage of the ring
    assert _cuh("RB_NT") == _scan_bwd.R6_THREADS
    assert _cuh("RB_G") == _scan_bwd.R6_LANES
    assert _scan_bwd.R6_THREADS // _scan_bwd.R6_LANES == _scan_bwd.ROWS
    assert _cuh("RB_K") == _scan_bwd.R6_CHECKPOINT
    assert _cuh("RB_CH") == _scan_bwd.R6_CHUNK
    assert _scan_bwd.R6_CHUNK % _scan_bwd.R6_CHECKPOINT == 0
    for src in ("mamba2_scan.cu", "rwkv6_scan.cu"):
        assert '#include "scan_bwd.cuh"' in (CSRC / src).read_text()


class _Layout:
    """A block's (ROWS, 4 L NV) state as a kernel holds it, L lanes a row:
    lane g of row r (thread L r + g) owns register i at column 4 (g + L (i
    // 4)) + i % 4; the device checkpoints and the scratch as flat f32 with
    the kernel's offsets, each float marked when written.  By default
    ``mamba2_bwd_scan``'s (16 lanes, 512 threads, NV 1 up to 64 columns);
    ``r6=True`` ``rwkv6_bwd_scan``'s (8 lanes, 256 threads, NV 2 up to 64
    columns, else 4)."""

    def __init__(self, cols, floats, r6=False):
        if r6:
            L, T = _scan_bwd.R6_LANES, _scan_bwd.R6_THREADS
            self.nv = 2 if cols <= 64 else 4
        else:
            L, T = _scan_bwd.LANES, _scan_bwd.THREADS
            self.nv = 1 if cols <= 64 else 2
        assert T // L == _scan_bwd.ROWS
        self.lanes = L
        self.E, self.NC = 4 * self.nv, 4 * L * self.nv
        self.cols = torch.tensor([[4 * (g + L * (i // 4)) + i % 4
                                   for i in range(self.E)] for g in range(L)])
        # offset in a checkpoint slot ([NV][T] float4) of (row, col)
        slot = torch.empty((_scan_bwd.ROWS, self.NC), dtype=torch.long)
        for r in range(_scan_bwd.ROWS):
            for c in range(self.NC):
                g, j, e = (c // 4) % L, c // (4 * L), c % 4
                slot[r, c] = (j * T + L * r + g) * 4 + e
        self.slot = slot
        self.scratch = torch.full((floats,), float("nan"))
        self.written = torch.zeros(floats, dtype=torch.bool)

    def put(self, offsets, values):
        assert int(offsets.min()) >= 0 and int(offsets.max()) < \
            self.scratch.numel()
        self.scratch[offsets.reshape(-1)] = values.reshape(-1).float()
        self.written[offsets.reshape(-1)] = True

    def get(self, offsets):
        assert bool(self.written[offsets.reshape(-1)].all())
        return self.scratch[offsets]

    def row_sum(self, prod):
        """(..., NC) -> (...): each lane's registers in order, then the
        butterfly over the L lanes (xor L / 2, ..., 2, 1); lane 0's
        value."""
        L = self.lanes
        acc = torch.zeros(prod.shape[:-1] + (L,))
        for i in range(self.E):
            acc = acc + prod[..., self.cols[:, i]]
        lanes = torch.arange(L)
        m = L // 2
        while m:
            acc = acc + acc[..., lanes ^ m]
            m //= 2
        return acc[..., 0]


def _block_sum(v, dim):
    """Rows of a block summed as the kernel does: the two rows of a warp
    (v[2w] + v[2w + 1]), then the warps in order."""
    v = v.movedim(dim, 0)
    acc = torch.zeros_like(v[0])
    for w in range(v.shape[0] // 2):
        acc = acc + (v[2 * w] + v[2 * w + 1])
    return acc


def _chunks(S, fwd, ckpt_put, ckpt_get, reverse_step):
    """The walk of ``mamba2_bwd_scan`` / ``rwkv6_bwd_scan``: the forward pass
    writing the state before each chunk of K1 steps; then, chunk by chunk
    from the last, the states before each sub-chunk of K2 steps, and each
    sub-chunk's states kept as its reverse walk needs them.
    ``reverse_step(t, h_prev, h_t)``."""
    K1, K2 = _scan_bwd.CHECKPOINT, _scan_bwd.SUB
    nck = -(-S // K1)
    st = fwd(None, None)
    for c in range(nck):
        ckpt_put(c, st)
        if c < nck - 1:
            for t in range(c * K1, (c + 1) * K1):
                st = fwd(st, t)
    for c in reversed(range(nck)):
        t0, t1 = c * K1, min(S, (c + 1) * K1)
        nsub = -(-(t1 - t0) // K2)
        st, sub = ckpt_get(c), []
        for s in range(nsub):
            sub.append(st)
            if s < nsub - 1:
                for t in range(t0 + s * K2, t0 + (s + 1) * K2):
                    st = fwd(st, t)
        for s in reversed(range(nsub)):
            ts, n = t0 + s * K2, min(K2, t1 - t0 - s * K2)
            hist, st = [], sub[s]
            for k in range(n):
                st = fwd(st, ts + k)
                hist.append(st)
            for k in reversed(range(n)):
                reverse_step(ts + k, hist[k - 1] if k else sub[s], hist[k])


def _block_sum4(v, dim):
    """Rows of a block summed as ``rwkv6_bwd_scan`` does: the four rows of
    a warp by shuffles, ((v[4w] + v[4w + 1]) + (v[4w + 2] + v[4w + 3])),
    then the warps in order."""
    v = v.movedim(dim, 0)
    acc = torch.zeros_like(v[0])
    for w in range(v.shape[0] // 4):
        acc = acc + ((v[4 * w] + v[4 * w + 1]) + (v[4 * w + 2] + v[4 * w + 3]))
    return acc


def _pieces(S, fwd, ckpt_put, ckpt_get, reverse_step):
    """The walk of ``rwkv6_bwd_scan``: the forward pass writing the state
    before each piece of K steps to device memory; then, piece by piece
    from the last, the piece's states stepped again from its checkpoint and
    kept as its reverse walk needs them.  ``reverse_step(t, h_prev)``."""
    K = _scan_bwd.R6_CHECKPOINT
    npc = -(-S // K)
    st = fwd(None, None)
    for pc in range(npc):
        ckpt_put(pc, st)
        if pc < npc - 1:
            for t in range(pc * K, (pc + 1) * K):
                st = fwd(st, t)
    for pc in reversed(range(npc)):
        ts, n = pc * K, min(K, S - pc * K)
        h0 = ckpt_get(pc)
        hist, st = [], h0
        for k in range(n):
            st = fwd(st, ts + k)
            hist.append(st)
        for k in reversed(range(n)):
            reverse_step(ts + k, hist[k - 1] if k else h0)


def _pad(a, dim, size):
    pad = [0, 0] * (a.dim() - 1 - dim % a.dim()) + [0, size - a.shape[dim]]
    return torch.nn.functional.pad(a, pad)


def mamba2_bwd_model(x, dt, A, B_, C, state, dy, dstate):
    """``mamba2_bwd_scan`` then ``mamba2_bwd_sum`` in plain torch, every
    block at once: (dx, ddt, dA, dB, dC, dstate0) in the kernel's dtypes."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    R = _scan_bwd.ROWS
    nsl = _scan_bwd.slices(P)
    lay = _Layout(N, m2.bwd_scratch_floats(Bsz, S, H, P, N))
    NC = lay.NC
    rows = lambda a: _pad(a.float(), -1, nsl * R).unflatten(-1, (nsl, R))  # noqa: E731
    xs, dys = rows(x), rows(dy)                      # (B, S, H, nsl, R)
    Bs, Cs = _pad(B_.float(), -1, NC), _pad(C.float(), -1, NC)
    dtf, Af = dt.float(), A.float()

    def state_blocks(s):                              # -> (B, H, nsl, R, NC)
        if s is None:
            return torch.zeros((Bsz, H, nsl, R, NC))
        s = _pad(_pad(s.float(), -1, NC), -2, nsl * R)
        return s.unflatten(-2, (nsl, R))

    grid = Bsz * H * nsl
    nck = -(-S // _scan_bwd.CHECKPOINT)
    blk = torch.arange(grid).reshape(Bsz, H, nsl)
    slot_floats = lay.nv * _scan_bwd.THREADS * 4

    def ck_off(c):
        return (blk * nck + c)[..., None, None] * slot_floats + lay.slot

    ck_floats = _scan_bwd.checkpoint_floats(grid, S, N)
    part = Bsz * S * H * nsl
    dB_off, dC_off = ck_floats, ck_floats + part * N
    ddt_off, dA_off = ck_floats + 2 * part * N, ck_floats + part * (2 * N + 1)
    q = (torch.arange(H)[:, None] * nsl + torch.arange(nsl))   # (H, nsl)
    nbh = H * nsl

    def fwd(st, t):
        if st is None:
            return state_blocks(state)
        d = dtf[:, t]
        decay = torch.exp(d * Af)
        dxv = d[..., None, None] * xs[:, t]
        return st * decay[..., None, None, None] + \
            dxv[..., None] * Bs[:, t][:, None, None, None, :]

    carry = state_blocks(dstate)
    dA_acc = torch.zeros((Bsz, H, nsl, R))
    dx = torch.zeros((Bsz, S, H, nsl, R))

    def reverse_step(t, hprev, hcur):
        nonlocal carry, dA_acc
        d = dtf[:, t][..., None, None]
        decay = torch.exp(dtf[:, t] * Af)[..., None, None]
        xp, dyp = xs[:, t], dys[:, t]
        gv = dyp[..., None] * Cs[:, t][:, None, None, None, :] + carry
        sgb = lay.row_sum(gv * Bs[:, t][:, None, None, None, :])
        sgh = lay.row_sum(gv * hprev)
        pb = gv * (d * xp)[..., None]
        pc = hcur * dyp[..., None]
        carry = decay[..., None] * gv
        dx[:, t] = d * sgb
        dA_acc = dA_acc + d * decay * sgh
        ddt_rows = xp * sgb + Af[:, None, None] * decay * sgh
        bt = torch.arange(Bsz)[:, None, None] * S + t
        base = (bt * nbh + q)[..., None] * N + torch.arange(N)
        lay.put(dB_off + base, _block_sum(pb, 3)[..., :N])
        lay.put(dC_off + base, _block_sum(pc, 3)[..., :N])
        lay.put(ddt_off + bt * nbh + q, _block_sum(ddt_rows, 3))

    _chunks(S, fwd, lambda c, st: lay.put(ck_off(c), st),
            lambda c: lay.get(ck_off(c)), reverse_step)
    acc = torch.zeros((Bsz, H, nsl))
    for r in range(R):
        acc = acc + dA_acc[..., r]
    lay.put(dA_off + blk, acc)
    assert bool(lay.written.all()), "a float of the scratch is never written"
    # mamba2_bwd_sum: the partials in block order
    sums = []
    for off in (dB_off, dC_off):
        p = lay.get(off + torch.arange(part * N)).reshape(Bsz, S, nbh, N)
        acc = torch.zeros((Bsz, S, N))
        for j in range(nbh):
            acc = acc + p[:, :, j]
        sums.append(acc.to(x.dtype))
    p = lay.get(ddt_off + torch.arange(part)).reshape(Bsz, S, H, nsl)
    ddt = torch.zeros((Bsz, S, H))
    for j in range(nsl):
        ddt = ddt + p[..., j]
    p = lay.get(dA_off + torch.arange(grid)).reshape(Bsz, H, nsl)
    dA = torch.zeros(H)
    for b in range(Bsz):
        for j in range(nsl):
            dA = dA + p[b, :, j]
    dx = dx.flatten(-2)[..., :P].to(x.dtype)
    ds0 = carry.flatten(2, 3)[:, :, :P, :N]
    return dx, ddt, dA, sums[0], sums[1], ds0


def rwkv6_bwd_model(r, k, v, w, u, state, dy, dstate):
    """``rwkv6_bwd_scan`` then ``rwkv6_bwd_sum`` in plain torch, every block
    at once: (dr, dk, dv, dw, du, dstate0) in the kernel's dtypes.  The
    walk is ``_pieces`` (a checkpoint every ``R6_CHECKPOINT`` steps); v_t
    . dy_t is summed once a step (``vdy``); a step's dv sums each warp's
    four rows, then the warps in order (``_block_sum4``), then
    ``rwkv6_bwd_sum`` the slices of a head in order.  (The kernel's staging
    of 64 steps at a time and its writes of a piece's dv, dr, dk and dw at
    the piece's end move the same numbers.)"""
    B, S, H, D = r.shape
    R = _scan_bwd.ROWS
    nsl = _scan_bwd.slices(D)
    lay = _Layout(D, r6.bwd_scratch_floats(B, S, H, D), r6=True)
    NC = lay.NC
    rows = lambda a: _pad(a.float(), -1, nsl * R).unflatten(-1, (nsl, R))  # noqa: E731
    rs, ks, ws = rows(r), rows(k), rows(w)            # (B, S, H, nsl, R)
    vs, dys = _pad(v.float(), -1, NC), _pad(dy.float(), -1, NC)
    us = _pad(u.float(), -1, nsl * R).unflatten(-1, (nsl, R))  # (H, nsl, R)

    def state_blocks(s):
        if s is None:
            return torch.zeros((B, H, nsl, R, NC))
        s = _pad(_pad(s.float(), -1, NC), -2, nsl * R)
        return s.unflatten(-2, (nsl, R))

    grid = B * H * nsl
    npc = -(-S // _scan_bwd.R6_CHECKPOINT)
    blk = torch.arange(grid).reshape(B, H, nsl)
    slot_floats = lay.nv * _scan_bwd.R6_THREADS * 4

    def ck_off(pc):
        return (blk * npc + pc)[..., None, None] * slot_floats + lay.slot

    dv_off = _scan_bwd.r6_checkpoint_floats(grid, S, D)
    du_off = dv_off + B * S * H * nsl * D

    def col(a, t):                                    # (B, H, 1, 1, NC)
        return a[:, t][:, :, None, None, :]

    def fwd(st, t):
        if st is None:
            return state_blocks(state)
        return ws[:, t][..., None] * st + ks[:, t][..., None] * col(vs, t)

    def vdy(t):
        """v_t . dy_t, (B, H), as the kernel sums it once a step: lane l's
        products at columns l + 32 m in order, then a butterfly over the
        warp's 32 lanes; lane 0's value."""
        prod = (vs[:, t] * dys[:, t]).unflatten(-1, (lay.nv, 32))
        acc = torch.zeros(prod.shape[:-2] + (32,))
        for m in range(lay.nv):
            acc = acc + prod[..., m, :]
        lanes = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[..., lanes ^ o]
        return acc[..., 0]

    carry = state_blocks(dstate)
    du_acc = torch.zeros((B, H, nsl, R))
    dr, dk, dw = (torch.zeros((B, S, H, nsl, R)) for _ in range(3))

    def reverse_step(t, hprev):
        nonlocal carry, du_acc
        ri, ki, wi = rs[:, t], ks[:, t], ws[:, t]
        G = carry
        sdv = vdy(t)[:, :, None, None]
        sgv = lay.row_sum(G * col(vs, t))
        sdh = lay.row_sum(col(dys, t) * hprev)
        sgh = lay.row_sum(G * hprev)
        pv = ki[..., None] * (G + (us * ri)[..., None] * col(dys, t))
        carry = ri[..., None] * col(dys, t) + wi[..., None] * G
        dr[:, t] = sdh + us * ki * sdv
        dk[:, t] = sgv + us * ri * sdv
        dw[:, t] = sgh
        du_acc = du_acc + ri * ki * sdv
        base = (((torch.arange(B)[:, None, None] * S + t) * H
                 + torch.arange(H)[:, None]) * nsl + torch.arange(nsl))
        lay.put(dv_off + base[..., None] * D + torch.arange(D),
                _block_sum4(pv, 3)[..., :D])

    _pieces(S, fwd, lambda pc, st: lay.put(ck_off(pc), st),
            lambda pc: lay.get(ck_off(pc)), reverse_step)
    lay.put(du_off + torch.arange(B * H * D).reshape(B, H, D),
            du_acc.flatten(-2)[..., :D])
    p = lay.get(dv_off + torch.arange(B * S * H * nsl * D)).reshape(
        B, S, H, nsl, D)
    dv = torch.zeros((B, S, H, D))
    for j in range(nsl):
        dv = dv + p[:, :, :, j]
    p = lay.get(du_off + torch.arange(B * H * D)).reshape(B, H, D)
    du = torch.zeros((H, D))
    for b in range(B):
        du = du + p[b]
    assert bool(lay.written.all()), "a float of the scratch is never written"
    cut = lambda a: a.flatten(-2)[..., :D].to(r.dtype)  # noqa: E731
    ds0 = carry.flatten(2, 3)[:, :, :D, :D]
    return cut(dr), cut(dk), dv.to(r.dtype), cut(dw), du, ds0


#: (B, S, H, P or D, N), dtype: several chunks with a ragged last one and
#: a ragged sub-chunk, two slices of rows, 8 registers a lane (N > 64), and
#: S = 0 (the JAX ref cannot scan 0 steps; the plain backward can)
MODEL_CASES = {
    "s150-two-slices": ((2, 150, 2, 40, 24), "float32"),
    "s9-n72": ((1, 9, 2, 16, 72), "float32"),
    "s64": ((1, 64, 1, 8, 8), "float32"),
    "s67-bf16": ((1, 67, 2, 33, 16), "bfloat16"),
    "s0": ((1, 0, 2, 8, 8), "float32"),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_mamba2_bwd_schedule_model_matches_the_plain_backward(case):
    (Bsz, S, H, P, N), dtype = MODEL_CASES[case]
    _, t, dh = _m2_inputs(21, (Bsz, S, H, P, N), dtype, True, True)
    dh = torch.from_numpy(dh)
    got = mamba2_bwd_model(*t[:6], t[6], dh)
    want = m2.mamba2_scan_bwd(*t[:6], t[6], dh)
    _assert_grads(got, want, dtype, M2_NAMES)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_rwkv6_bwd_schedule_model_matches_the_plain_backward(case):
    (B, S, H, D, _), dtype = MODEL_CASES[case]
    _, t, ds = _r6_inputs(22, (B, S, H, D), dtype, True, True, "zeros")
    ds = torch.from_numpy(ds)
    got = rwkv6_bwd_model(*t[:6], t[6], ds)
    want = r6.rwkv6_scan_bwd(*t[:6], t[6], ds)
    _assert_grads(got, want, dtype, R6_NAMES)
