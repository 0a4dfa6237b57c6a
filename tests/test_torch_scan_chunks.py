"""The chunked scan kernels' arithmetic, on the CPU.

On the card, bf16 ``mamba2_scan`` with at least ``m2.CHUNK`` steps runs
``mamba2_chunked`` (``csrc/mamba2_scan.cu``): the chunked dual form on the
tensor cores, one block per slice of ``CK_PS`` rows of P, each non-bf16
operand entering its product as a bf16 hi + lo pair; ``rwkv6_scan`` with
at least ``r6.CHUNK`` steps runs ``rwkv6_chunked`` (``csrc/rwkv6_scan.cu``):
chunks of ``RT`` steps in f32, one block per slice of ``JS`` value columns,
the decay between steps as pairwise differences of the log-decay cumsum
with w clamped at 1e-30.  No CUDA kernel runs here, so this file holds a
plain-torch model of each chunk walk, with its constants read from the
sources, against the JAX package's ``ref`` and its Pallas kernels in
interpret mode (``chunk=16``, as ``tests/test_torch_ssm_kernels.py`` runs
them), from numpy-seeded inputs, at the tolerances of
``tests/test_kernels.py``: y 2e-5 in f32 (2e-4 for rwkv6), 2e-2 in bf16;
the f32 state 1e-4, 3e-2 from bf16 inputs.  Where the Pallas rwkv6 kernel
overflows to NaN (ROADMAP.md, Faults) the model is held to the ref only,
and must be finite there.
"""
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba2_scan import mamba2_scan as jax_mamba2  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import rwkv6_scan as r6  # noqa: E402

CSRC = Path(m2.__file__).parent / "csrc"


def _const(name, source):
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


M_T, M_PS = _const("CK_T", "mamba2_scan.cu"), _const("CK_PS", "mamba2_scan.cu")
R_T, R_JS = _const("RT", "rwkv6_scan.cu"), _const("JS", "rwkv6_scan.cu")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Y_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
         "bfloat16": dict(rtol=2e-2, atol=2e-2)}
RWKV_F32_Y_TOL = dict(rtol=2e-4, atol=2e-4)
STATE_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _bf16(a):
    return a.to(torch.bfloat16).float()


def _split(a):
    """An f32 operand as the kernel feeds it to a bf16 product: hi =
    bf16(a) and lo = bf16(a - hi), summed back (``split2`` in the source)."""
    hi = _bf16(a)
    return hi + _bf16(a - hi)


def mamba2_chunk_model(x, dt, A, B_, C, state=None, *, T=M_T, PS=M_PS,
                       rounding=None):
    """``mamba2_chunked`` in plain torch: slices of PS rows of P, each
    walking chunks of T steps with its (PS, N) state carried in f32:

      y     = exp(s_t) (C @ state^T) + (G o exp(s_t - s_tau) dt_tau) @ x
      state = exp(s_T) state + (dt x o exp(s_T - s_tau))^T @ B

    with G = C B^T on tau <= t and s the chunk-local cumsum of dt A.
    ``rounding`` is how a non-bf16 operand enters a product: ``_split`` (the
    kernel's hi + lo), ``_bf16`` (one rounding to nearest) or None (f32, no
    rounding); by default ``_split`` for bf16 x and None for f32."""
    if rounding is None and x.dtype == torch.bfloat16:
        rounding = _split
    rnd = rounding or (lambda a: a)
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    xf, Bf, Cf, dtf, Af = (t.float() for t in (x, B_, C, dt, A))
    h0 = torch.zeros((Bsz, H, P, N)) if state is None else state.float()
    y = torch.zeros((Bsz, S, H, P))
    hout = torch.empty((Bsz, H, P, N))
    for p0 in range(0, P, PS):
        ps = slice(p0, min(P, p0 + PS))
        h = h0[:, :, ps].clone()
        for c0 in range(0, S, T):
            ts = slice(c0, min(S, c0 + T))
            n = ts.stop - c0
            s = torch.cumsum(dtf[:, ts] * Af, 1)                # (B, n, H)
            G = torch.einsum("btk,bsk->bts", Cf[:, ts], Bf[:, ts])
            low = torch.tril(torch.ones((n, n), dtype=torch.bool))
            diff = s[:, :, None] - s[:, None]                  # (B, t, tau, H)
            dec = torch.exp(torch.where(low[None, :, :, None], diff,
                                        -torch.inf))
            M = rnd(G[..., None] * dec * dtf[:, ts][:, None])
            yc = torch.einsum("btsh,bshp->bthp", M, xf[:, ts, :, ps])
            yc = yc + torch.exp(s)[..., None] * torch.einsum(
                "btk,bhpk->bthp", Cf[:, ts], rnd(h))
            y[:, ts, :, ps] = yc
            sT = s[:, -1]                                      # (B, H)
            dd = rnd((dtf[:, ts] * torch.exp(sT[:, None] - s))[..., None]
                     * xf[:, ts, :, ps])
            h = h * torch.exp(sT)[..., None, None] + torch.einsum(
                "bshp,bsk->bhpk", dd, Bf[:, ts])
        hout[:, :, ps] = h
    return y.to(x.dtype), hout


def rwkv6_chunk_model(r, k, v, w, u, state=None, *, T=R_T, JS=R_JS):
    """``rwkv6_chunked`` in plain torch: slices of JS value columns, each
    walking chunks of T steps in f32 with its (D, JS) state carried, c the
    inclusive cumsum of log(max(w, 1e-30)):

      A[t, tau] = sum_i r_t k_tau exp(c_{t-1} - c_tau)  (tau < t, <= 0)
      A[t, t]   = sum_i r_t u k_t
      y_t       = (r_t o exp(c_{t-1})) @ S + sum_{tau <= t} A[t, tau] v_tau
      S         = exp(c_T) o S + (k o exp(c_T - c))^T @ v

    No exponent is positive, and none is of -c alone."""
    B, S, H, D = r.shape
    rf, kf, vf, uf = (t.float() for t in (r, k, v, u))
    lw = torch.log(torch.clamp(w.float(), min=1e-30))
    s0 = torch.zeros((B, H, D, D)) if state is None else state.float()
    y = torch.zeros((B, S, H, D))
    sout = torch.empty((B, H, D, D))
    for j0 in range(0, D, JS):
        js = slice(j0, min(D, j0 + JS))
        St = s0[..., js].clone()
        for c0 in range(0, S, T):
            ts = slice(c0, min(S, c0 + T))
            n = ts.stop - c0
            c = torch.cumsum(lw[:, ts], 1)                     # (B, n, H, D)
            cprev = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], 1)
            strict = torch.tril(torch.ones((n, n), dtype=torch.bool), -1)
            pair = torch.where(strict[None, :, :, None, None],
                               cprev[:, :, None] - c[:, None], -torch.inf)
            assert bool((pair <= 0).all())
            Am = torch.einsum("bthd,bshd,btshd->btsh", rf[:, ts], kf[:, ts],
                              torch.exp(pair))
            bonus = (rf[:, ts] * uf * kf[:, ts]).sum(-1)        # (B, n, H)
            Am = Am + torch.diag_embed(bonus.transpose(1, 2)).permute(
                0, 2, 3, 1)
            y[:, ts, :, js] = torch.einsum(
                "btsh,bshj->bthj", Am, vf[:, ts, :, js]) + torch.einsum(
                "bthd,bhdj->bthj", rf[:, ts] * torch.exp(cprev), St)
            cT = c[:, -1]                                       # (B, H, D)
            St = torch.exp(cT)[..., None] * St + torch.einsum(
                "bshd,bshj->bhdj", kf[:, ts] * torch.exp(cT[:, None] - c),
                vf[:, ts, :, js])
        sout[..., js] = St
    return y.to(r.dtype), sout


def _pair(a, dtype):
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(
        TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _mamba2_inputs(seed, S, P, N, dtype, with_state, B=1, H=2):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    x, Bm, Cm = (_pair(a, dtype) for a in (f32(B, S, H, P), f32(B, S, N),
                                           f32(B, S, N)))
    dt = _pair(np.log1p(np.exp(f32(B, S, H))), "float32")     # softplus
    A = _pair(-np.exp(f32(H)), "float32")
    state = _pair(f32(B, H, P, N), "float32") if with_state else (None, None)
    return tuple(tuple(t[i] for t in (x, dt, A, Bm, Cm, state))
                 for i in (0, 1))


def _rwkv6_inputs(seed, S, D, dtype, with_state, B=1, H=2, w=None):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    r, k, v = (_pair(f32(B, S, H, D), dtype) for _ in range(3))
    if w is None:
        w = np.exp(-np.exp(f32(B, S, H, D)))                  # decay in (0, 1)
    w = _pair(w, dtype)
    u = _pair(0.3 * f32(H, D), "float32")
    state = _pair(f32(B, H, D, D), "float32") if with_state else (None, None)
    return tuple(tuple(t[i] for t in (r, k, v, w, u, state)) for i in (0, 1))


def _assert_scan(got, want, dtype, y_tol, y_where=True):
    (y, s), (wy, ws) = got, want
    assert tuple(y.shape) == tuple(wy.shape)
    assert tuple(s.shape) == tuple(ws.shape)
    assert np.isfinite(_np(y)).all() and np.isfinite(_np(s)).all()
    np.testing.assert_allclose(_np(y)[y_where], _np(wy)[y_where], **y_tol)
    np.testing.assert_allclose(_np(s), _np(ws), **STATE_TOL[dtype])


def _pallas_rwkv6_defined(w, y, chunk=16):
    """Where the Pallas rwkv6 kernel's y is defined: it turns NaN over a
    chunk of a (batch, head) whose chunk-local log-decay cumsum falls below
    -log(FLT_MAX) (ROADMAP.md, Faults).  Checks that every NaN lies in such
    a chunk and returns the mask of the rest."""
    lw = np.log(np.maximum(_np(w).astype(np.float64), 1e-30))
    B, S, H, D = lw.shape
    nc = -(-S // chunk)
    lw = np.pad(lw, ((0, 0), (0, nc * chunk - S), (0, 0), (0, 0)))
    cmin = np.cumsum(lw.reshape(B, nc, chunk, H, D), axis=2).min(axis=(2, 4))
    overflow = np.repeat(cmin < -np.log(np.finfo(np.float32).max), chunk,
                         axis=1)[:, :S, :, None]
    nan = ~np.isfinite(_np(y))
    assert not (nan & ~overflow).any()
    return ~np.broadcast_to(overflow, nan.shape)


M_LENGTHS = [1, M_T - 1, M_T, M_T + 1, 2 * M_T + 3]
R_LENGTHS = [1, R_T - 1, R_T, R_T + 1, 2 * R_T + 3]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("P,N", [(16, 16), (24, 40), (64, 64), (80, 16)])
@pytest.mark.parametrize("S", M_LENGTHS)
def test_mamba2_chunk_model_matches_jax_ref_and_pallas(S, P, N, with_state):
    """Chunks of CK_T steps, whole and ragged, and slices of CK_PS rows of P
    (a ragged second at P = 80), in bf16: the chunked kernel takes bf16
    only, f32 going to the sequential one (``m2.schedule``)."""
    dtype = "bfloat16"
    jargs, targs = _mamba2_inputs(1000 * S + P + N, S, P, N, dtype,
                                  with_state)
    got = mamba2_chunk_model(*targs)
    _assert_scan(got, jref.mamba2_scan_ref(*jargs), dtype, Y_TOL[dtype])
    _assert_scan(got, jax_mamba2(*jargs, chunk=16, interpret=True), dtype,
                 Y_TOL[dtype])


def test_mamba2_one_bf16_rounding_is_not_enough():
    """Why the kernel splits its operands: with one bf16 rounding of M, the
    state and the two dt x products, some y of a model-sized chunk walk fall
    outside the 2e-2 tolerance, which the hi + lo split meets."""
    jargs, targs = _mamba2_inputs(7, 256, 64, 64, "bfloat16", False, B=1,
                                  H=8)
    want = _np(jref.mamba2_scan_ref(*jargs)[0])
    tol = Y_TOL["bfloat16"]

    def outside(rounding):
        y = _np(mamba2_chunk_model(*targs, rounding=rounding)[0])
        return int((np.abs(y - want) > tol["atol"] + tol["rtol"]
                    * np.abs(want)).sum())

    assert outside(_bf16) > 0
    assert outside(_split) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("D", [16, 24, 64])
@pytest.mark.parametrize("S", R_LENGTHS)
def test_rwkv6_chunk_model_matches_jax_ref_and_pallas(S, D, with_state,
                                                      dtype):
    """Chunks of RT steps, whole and ragged, and slices of JS value columns
    (two at D = 64)."""
    jargs, targs = _rwkv6_inputs(1000 * S + D, S, D, dtype, with_state)
    got = rwkv6_chunk_model(*targs)
    y_tol = RWKV_F32_Y_TOL if dtype == "float32" else Y_TOL[dtype]
    _assert_scan(got, jref.rwkv6_scan_ref(*jargs), dtype, y_tol)
    pallas = jax_rwkv6(*jargs, chunk=16, interpret=True)
    _assert_scan(got, pallas, dtype, y_tol,
                 y_where=_pallas_rwkv6_defined(jargs[3], pallas[0]))


def test_rwkv6_chunk_model_is_finite_at_strong_decay():
    """The ROADMAP Faults input (seed 165, shape (2, 64, 3, 16)), whose
    chunk-local log-decay cumsum falls below -88.7: the Pallas kernel's
    exp(-c) overflows there, the model's pairwise exponents do not."""
    rng = np.random.default_rng(165)
    B, S, H, D = 2, 64, 3, 16
    f32 = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    r, k, v = (f32(B, S, H, D) for _ in range(3))
    w = np.exp(-np.exp(f32(B, S, H, D)))
    u, s0 = 0.3 * f32(H, D), f32(B, H, D, D)
    jargs = tuple(jnp.asarray(a) for a in (r, k, v, w, u, s0))
    targs = tuple(torch.from_numpy(a) for a in (r, k, v, w, u, s0))
    pallas = jax_rwkv6(*jargs, chunk=16, interpret=True)
    assert not np.isfinite(_np(pallas[0])).all()
    got = rwkv6_chunk_model(*targs)
    _assert_scan(got, jref.rwkv6_scan_ref(*jargs), "float32", RWKV_F32_Y_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_chunk_model_is_finite_at_zero_decay(dtype):
    """w = exp(-exp(z)) is exactly 0 once z > ~4.5: log(0) would give
    -inf - -inf = NaN; the clamp at 1e-30 keeps it finite and within the
    tolerance of the sequential ref, which multiplies by the 0."""
    rng = np.random.default_rng(11)
    w = np.exp(-np.exp(rng.standard_normal((1, 2 * R_T + 3, 2, 24),
                                           dtype=np.float32)))
    w[:, ::3, :, ::2] = 0.0
    w[:, 5] = 0.0
    jargs, targs = _rwkv6_inputs(12, 2 * R_T + 3, 24, dtype, True, w=w)
    assert int((targs[3] == 0).sum()) > 100
    got = rwkv6_chunk_model(*targs)
    y_tol = RWKV_F32_Y_TOL if dtype == "float32" else Y_TOL[dtype]
    _assert_scan(got, jref.rwkv6_scan_ref(*jargs), dtype, y_tol)


def test_rwkv6_pair_exponents_are_products_of_the_clamped_decays():
    """The kernel forms each exp(c_{t-1} - c_tau) as the running product of
    max(w, 1e-30) over tau < s < t, on the FMA pipes: the same number, to
    f32 rounding, with zeros and strong decays among the w."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(np.exp(-np.exp(2 * rng.standard_normal(
        (R_T, 8), dtype=np.float32))))
    w[3, :4] = 0.0
    wc = torch.clamp(w, min=1e-30)
    c = torch.cumsum(torch.log(wc.double()), 0)
    for tau in range(R_T):
        prod = torch.ones(8)
        for t in range(tau + 1, R_T):
            want = torch.exp(c[t - 1] - c[tau]).float()
            torch.testing.assert_close(prod, want, rtol=1e-5, atol=1e-38)
            prod = prod * wc[t]


def test_schedule_and_constants():
    """The chunk lengths the wrappers schedule by are the sources', and
    each dtype and S takes the kernel the source notes name."""
    assert m2.CHUNK == M_T and r6.CHUNK == R_T
    # P = 80 and the served D = 64 span more than one slice
    assert 80 > M_PS and 64 > R_JS
    bf, f32 = torch.bfloat16, torch.float32
    assert m2.schedule(bf, 512) == "chunked"
    assert m2.schedule(bf, M_T) == "chunked"
    assert m2.schedule(bf, M_T - 1) == m2.schedule(bf, 1) == "sequential"
    assert m2.schedule(f32, 512) == m2.schedule(f32, 1) == "sequential"
    for dtype in (bf, f32):
        assert r6.schedule(dtype, 512) == r6.schedule(dtype, R_T) \
            == "chunked"
        assert r6.schedule(dtype, R_T - 1) == r6.schedule(dtype, 1) \
            == r6.schedule(dtype, 0) == "sequential"
