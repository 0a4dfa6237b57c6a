"""Plain versions of the port's kernels vs the JAX package, on the CPU.

The same numpy inputs go to ``repro.kernels.ref``, to the Pallas kernels
in interpret mode, and to the port's wrappers (which, for CPU tensors, run
the plain PyTorch versions).  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in bf16 (one bf16 rounding of
outputs of magnitude ~1).  The gather is exact.
"""
import functools

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.burst_gather import burst_gather as jax_gather  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    decode_attention as jax_decode, flash_attention as jax_flash)
from repro_torch.kernels import burst_gather as bg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as r6  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the JAX ref, jitted: one compile per call site instead of one per op
_jref = jax.jit(jref.attention_ref, static_argnames=(
    "causal", "window", "softcap", "scale", "q_offset"))


def _pair(rng, shape, dtype):
    """One standard-normal numpy array as (jax array, torch tensor)."""
    a = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(seed, B, Sq, Skv, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    return (_pair(rng, (B, Sq, Hq, D), dtype),
            _pair(rng, (B, Skv, Hkv, D), dtype),
            _pair(rng, (B, Skv, Hkv, D), dtype))


VARIANTS = {
    "causal": lambda S: dict(causal=True),
    "window": lambda S: dict(causal=True, window=max(4, S // 3)),
    "softcap": lambda S: dict(causal=True, softcap=20.0),
    "full": lambda S: dict(causal=False),
}


SHAPES = [
    # (B, Sq, Skv, Hq, Hkv, D), as in tests/test_kernels.py
    (1, 16, 16, 2, 2, 16),     # MHA
    (2, 48, 48, 4, 2, 24),     # GQA
    (1, 33, 33, 4, 1, 64),     # non-tile-aligned S, MQA
]


@functools.lru_cache(maxsize=None)
def _sweep_case(shape, dtype):
    """Inputs of one (shape, dtype) and the JAX ref's output for every
    variant, from one jitted call (one compile instead of four)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(sum(shape), *shape, dtype)
    outs = jax.jit(lambda q, k, v: {
        name: jref.attention_ref(q, k, v, **kw(shape[1]))
        for name, kw in VARIANTS.items()})(jq, jk, jv)
    return (tq, tk, tv), {name: _np(o) for name, o in outs.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_attention_matches_jax_ref(dtype, shape, variant):
    (tq, tk, tv), want = _sweep_case(shape, dtype)
    got = ops.attention(tq, tk, tv, **VARIANTS[variant](shape[1]))
    np.testing.assert_allclose(_np(got), want[variant], **TOL[dtype])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_attention_matches_pallas(variant):
    """Against the Pallas kernel in interpret mode, in the serving dtype
    (tests/test_kernels.py holds Pallas to the JAX ref over the sweep)."""
    shape = SHAPES[1]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(sum(shape), *shape, "bfloat16")
    kw = VARIANTS[variant](shape[1])
    np.testing.assert_allclose(
        _np(ops.attention(tq, tk, tv, **kw)),
        _np(jax_flash(jq, jk, jv, interpret=True, **kw)), **TOL["bfloat16"])


def test_attention_kv_len_and_offset():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, 2, 8, 32, 2, 2, 16, "float32")
    kv_len = np.array([20, 32], np.int32)
    got = ops.attention(tq, tk, tv, causal=True, q_offset=12,
                        kv_len=torch.from_numpy(kv_len))
    want = _jref(jq, jk, jv, causal=True, q_offset=12,
                 kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    # a per-batch q_offset, against the Pallas kernel that takes one
    q_off = np.array([3, 12], np.int32)
    got = ops.attention(tq, tk, tv, causal=True, window=6,
                        q_offset=torch.from_numpy(q_off),
                        kv_len=torch.from_numpy(kv_len))
    want = jax_flash(jq, jk, jv, causal=True, window=6,
                     q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len),
                     interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype,softcap", [("float32", None),
                                           ("bfloat16", 20.0)])
def test_decode_matches_jax(dtype, softcap):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, 1, 64, 4, 2, 32, dtype)
    kv_len = np.array([40, 64], np.int32)
    got = _np(ops.attention(tq, tk, tv, causal=False, softcap=softcap,
                            q_offset=63, kv_len=torch.from_numpy(kv_len)))
    jkw = dict(softcap=softcap, q_offset=63, kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(
        got, _np(_jref(jq, jk, jv, causal=False, **jkw)),
        **TOL[dtype])
    np.testing.assert_allclose(
        got, _np(jax_decode(jq, jk, jv, interpret=True, **jkw)),
        **TOL[dtype])


def test_decode_keeps_window_and_causal_of_the_ref():
    """The Pallas decode drops ``window``; the port is held to the ref."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 2, 1, 64, 4, 1, 16, "float32")
    kw = dict(causal=True, window=16, q_offset=50)
    got = fa.decode_attention(tq, tk, tv, kv_len=60, **kw)
    want = _jref(jq, jk, jv, kv_len=jnp.array([60, 60]), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_rows_with_no_valid_key_are_zero():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 2, 4, 16, 2, 2, 8, "float32")
    kv_len = np.array([0, 5], np.int32)
    got = ops.attention(tq, tk, tv, causal=False,
                        kv_len=torch.from_numpy(kv_len))
    want = _jref(jq, jk, jv, causal=False, kv_len=jnp.asarray(kv_len))
    assert torch.isfinite(got).all()
    assert not got[0].any()
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def _stream(kind, R, N, rng):
    if kind == "contiguous":
        return np.arange(5, 5 + N, dtype=np.int32)
    if kind == "random":
        return rng.integers(0, R, N, dtype=np.int32)
    # mixed: runs of consecutive rows with jumps between them
    parts, left = [], N
    while left:
        n = min(left, int(rng.integers(1, 12)))
        start = int(rng.integers(0, R - n))
        parts.append(np.arange(start, start + n, dtype=np.int32))
        left -= n
    return np.concatenate(parts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["contiguous", "random", "mixed"])
def test_burst_gather_is_exact(dtype, kind):
    rng = np.random.default_rng(7)
    R, D, N = 64, 40, 21                   # N not a multiple of IB = 8
    jt, tt = _pair(rng, (R, D), dtype)
    idx = _stream(kind, R, N, rng)
    got = ops.burst_gather(tt, torch.from_numpy(idx))
    want = jax_gather(jt, jnp.asarray(idx), interpret=True)
    assert got.dtype == TDT[dtype] and got.shape == (N, D)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("bad", [64, 100, -1])
def test_burst_gather_ref_raises_out_of_range(bad):
    table = torch.zeros((64, 8))
    idx = torch.tensor([0, 1, bad], dtype=torch.int32)
    with pytest.raises((IndexError, RuntimeError)):
        ref.burst_gather_ref(table, idx)


def test_wrappers_do_not_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel path, which rejects what it cannot launch on."""
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        fa.decode_attention(q[:, :1], q, q)
    with pytest.raises(ValueError):
        bg.burst_gather(torch.empty((8, 4), device="meta"),
                        torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        m2.mamba2_scan(q, torch.empty((1, 4, 2), device="meta"),
                       torch.empty((2,), device="meta"),
                       torch.empty((1, 4, 8), device="meta"),
                       torch.empty((1, 4, 8), device="meta"))
    with pytest.raises(ValueError):
        r6.rwkv6_scan(q, q, q, q, torch.empty((2, 16), device="meta"))
    with pytest.raises(ValueError):
        gmm.moe_gmm(torch.empty((4, 16), device="meta"),
                    torch.empty((2, 16, 8), device="meta"),
                    torch.zeros(4, dtype=torch.int32, device="meta"))
    assert fa.flash_attention.launches == 0
    assert fa.decode_attention.launches == 0
    assert bg.burst_gather.launches == 0
    assert m2.mamba2_scan.launches == 0
    assert r6.rwkv6_scan.launches == 0
    assert gmm.moe_gmm.launches == 0
