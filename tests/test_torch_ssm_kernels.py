"""The port's plain scans vs the JAX package, on the CPU.

The same numpy inputs go to ``repro.kernels.ref``, to the Pallas kernels
in interpret mode (``chunk=16``, as ``tests/test_kernels.py`` runs them)
and to the port's wrappers, which for CPU tensors run the plain PyTorch
versions.  Tolerances are those of ``tests/test_kernels.py``: on y 2e-5 in
f32 and 2e-2 in bf16 (one bf16 rounding of outputs of magnitude ~1), with
2e-4 for rwkv6's y in f32 against the chunked Pallas form, whose rescaled
f32 sums drift a few 1e-5; on the f32 state 1e-4, and 3e-2 when the
inputs were bf16.
"""
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as r6  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Y_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
         "bfloat16": dict(rtol=2e-2, atol=2e-2)}
STATE_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}
#: rwkv6's y in f32 against the chunked Pallas form (tests/test_kernels.py)
RWKV_PALLAS_F32_Y_TOL = dict(rtol=2e-4, atol=2e-4)
LENGTHS = [1, 33, 64]


def _pair(a, dtype):
    """One numpy f32 array as (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(
        TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _mamba2_inputs(S, dtype, with_state, B=2, H=3, P=16, N=16):
    rng = np.random.default_rng(S + 100 * with_state)
    f32 = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    x, Bm, Cm = (_pair(a, dtype) for a in (f32(B, S, H, P), f32(B, S, N),
                                           f32(B, S, N)))
    dt = np.log1p(np.exp(f32(B, S, H)))                     # softplus
    A = -np.exp(f32(H))
    f32_args = [_pair(a, "float32") for a in (dt, A)]
    state = _pair(f32(B, H, P, N), "float32") if with_state else (None, None)
    jargs = (x[0], f32_args[0][0], f32_args[1][0], Bm[0], Cm[0], state[0])
    targs = (x[1], f32_args[0][1], f32_args[1][1], Bm[1], Cm[1], state[1])
    return jargs, targs


def _rwkv6_inputs(S, dtype, with_state, B=2, H=3, D=16):
    rng = np.random.default_rng(S + 100 * with_state + 1)
    f32 = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    r, k, v = (_pair(f32(B, S, H, D), dtype) for _ in range(3))
    w = _pair(np.exp(-np.exp(f32(B, S, H, D))), dtype)     # decay in (0, 1)
    u = _pair(0.3 * f32(H, D), "float32")
    state = _pair(f32(B, H, D, D), "float32") if with_state else (None, None)
    jargs = (r[0], k[0], v[0], w[0], u[0], state[0])
    targs = (r[1], k[1], v[1], w[1], u[1], state[1])
    return jargs, targs


def _assert_scan(got, want, dtype, y_tol=None, y_where=True):
    (y, s), (wy, ws) = got, want
    assert y.dtype == TDT[dtype] and s.dtype == torch.float32
    assert tuple(y.shape) == tuple(wy.shape)
    assert tuple(s.shape) == tuple(ws.shape)
    np.testing.assert_allclose(_np(y)[y_where], _np(wy)[y_where],
                               **(y_tol or Y_TOL[dtype]))
    np.testing.assert_allclose(_np(s), _np(ws), **STATE_TOL[dtype])


def _pallas_rwkv6_defined(w, y, chunk=16):
    """Where the Pallas rwkv6 kernel's y is defined.

    Its chunked form rescales k by exp(-c), c the chunk-local cumulative
    log decay of a channel, which overflows f32 once c < -log(FLT_MAX)
    (about -88.7): y then turns NaN over the whole chunk of that (batch,
    head).  That is a fault of the JAX package's kernel (ROADMAP.md,
    Faults), not of the recurrence.  Returns a mask of y's positions and
    checks that every NaN lies in such a chunk."""
    lw = np.log(_np(w).astype(np.float64))                  # (B, S, H, D)
    B, S, H, D = lw.shape
    nc = -(-S // chunk)
    lw = np.pad(lw, ((0, 0), (0, nc * chunk - S), (0, 0), (0, 0)))
    cmin = np.cumsum(lw.reshape(B, nc, chunk, H, D), axis=2).min(axis=(2, 4))
    overflow = np.repeat(cmin < -np.log(np.finfo(np.float32).max), chunk,
                         axis=1)[:, :S, :, None]            # (B, S, H, 1)
    nan = ~np.isfinite(_np(y))
    assert not (nan & ~overflow).any()
    return ~np.broadcast_to(overflow, nan.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_scan_matches_jax_ref_and_pallas(dtype, S, with_state):
    jargs, targs = _mamba2_inputs(S, dtype, with_state)
    got = ops.mamba2_scan(*targs)
    _assert_scan(got, jref.mamba2_scan_ref(*jargs), dtype)
    _assert_scan(got, jax_mamba2(*jargs, chunk=16, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_scan_matches_jax_ref_and_pallas(dtype, S, with_state):
    jargs, targs = _rwkv6_inputs(S, dtype, with_state)
    got = ops.rwkv6_scan(*targs)
    _assert_scan(got, jref.rwkv6_scan_ref(*jargs), dtype)
    pallas = jax_rwkv6(*jargs, chunk=16, interpret=True)
    _assert_scan(got, pallas, dtype,
                 RWKV_PALLAS_F32_Y_TOL if dtype == "float32" else None,
                 y_where=_pallas_rwkv6_defined(jargs[3], pallas[0]))


def test_mamba2_scan_takes_the_models_strided_slices():
    """The model passes x, B and C as slices of one projection; the plain
    version, like the kernel, takes them with any strides."""
    _, (x, dt, A, Bm, Cm, state) = _mamba2_inputs(33, "bfloat16", True)
    fused = torch.cat([x.flatten(2), Bm, Cm], dim=-1)
    xs, Bs, Cs = torch.split(fused, [x[0, 0].numel(), 16, 16], dim=-1)
    assert not xs.is_contiguous()
    got = ops.mamba2_scan(xs.unflatten(2, x.shape[2:]), dt, A, Bs, Cs, state)
    want = ops.mamba2_scan(x, dt, A, Bm, Cm, state)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_kernel_wrappers_refuse_head_sizes_above_128():
    """The kernels take head and state sizes up to 128 and say so before
    they would launch; the check runs off the CPU (here on the meta
    device), where the wrapper would otherwise go to the kernel."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="up to 128"):
        m2.mamba2_scan(torch.empty((1, 4, 2, 256), **meta),
                       torch.empty((1, 4, 2), **meta),
                       torch.empty((2,), **meta),
                       torch.empty((1, 4, 64), **meta),
                       torch.empty((1, 4, 64), **meta))
    with pytest.raises(ValueError, match="up to 128"):
        m2.mamba2_scan(torch.empty((1, 4, 2, 64), **meta),
                       torch.empty((1, 4, 2), **meta),
                       torch.empty((2,), **meta),
                       torch.empty((1, 4, 160), **meta),
                       torch.empty((1, 4, 160), **meta))
    r = torch.empty((1, 4, 2, 192), **meta)
    with pytest.raises(ValueError, match="up to 128"):
        r6.rwkv6_scan(r, r, r, r, torch.empty((2, 192), **meta))
    with pytest.raises(ValueError, match="has shape"):
        r6.rwkv6_scan(r, r, r, r, torch.empty((2, 64), **meta))
    assert m2.mamba2_scan.launches == r6.rwkv6_scan.launches == 0
