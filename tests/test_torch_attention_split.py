"""The split-KV decode's plan and merge rule, on the CPU.

``decode_attention`` on the card cuts the cache into the chunks that
``flash_attention.decode_splits`` plans, computes one unnormalised partial
(acc, m, l) per chunk and merges them in split order (the two kernels of
``csrc/flash_attention.cu``).  No CUDA kernel runs here, so this file
checks the plan itself and holds a plain-torch model of the partial and
combine rule, on the wrapper's plan, against the JAX package's
``attention_ref`` and its Pallas ``decode_attention`` in interpret mode,
from numpy-seeded inputs, in f32 at 2e-5 (tests/test_kernels.py).  The
model fills the partials of empty chunks with NaN, as the kernel leaves
them unwritten, so the merge must skip them.
"""
import functools
import math
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
TILE = fa.DECODE_TILE
_jref = jax.jit(jref.attention_ref, static_argnames=(
    "causal", "window", "softcap", "scale", "q_offset"))

PLANS = [
    # (B, Hkv, Skv, n_sm): the served decode shapes on an H100 (132 SMs)
    (4, 8, 544, 132),      # granite-8b, granite-moe-3b-a800m
    (4, 32, 544, 132),     # zamba2-7b's H layers
    (1, 1, 1, 132),        # a cache of one key
    (4, 8, 1, 132),
    (4, 8, 0, 132),        # an empty cache
    (2, 2, 200, 132),      # the mqa-d64 case of chip_smoke.py
    (1, 1, 32768, 132),    # a long cache, one head
    (64, 8, 544, 132),     # B * Hkv already twice the SMs
    (4, 8, 4096, 132),
    (3, 5, 1000, 7),
    (2, 2, 200, 8),
    (4, 8, 544, 1),
]


@pytest.mark.parametrize("B,Hkv,Skv,n_sm", PLANS)
def test_decode_splits_cover_the_cache(B, Hkv, Skv, n_sm):
    n_split, chunk = fa.decode_splits(B, Hkv, Skv, n_sm)
    tiles = max(1, math.ceil(Skv / TILE))
    assert 1 <= n_split <= tiles
    assert chunk > 0 and chunk % TILE == 0
    bounds = [(s * chunk, min((s + 1) * chunk, Skv)) for s in range(n_split)]
    # contiguous, in order, from 0 to Skv; every chunk but the last is full
    assert bounds[0][0] == 0 and bounds[-1][1] == Skv
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(hi - lo == chunk for lo, hi in bounds[:-1])
    assert Skv == 0 or 0 < bounds[-1][1] - bounds[-1][0] <= chunk
    # as many blocks as SMs wherever the cache has tiles enough
    if B * Hkv * tiles >= n_sm:
        assert B * Hkv * n_split >= n_sm


def test_decode_tile_is_the_kernels():
    src = (Path(fa.__file__).parent / "csrc" / "flash_attention.cu") \
        .read_text()
    assert re.search(r"constexpr int DK = (\d+);", src).group(1) == str(TILE)


def _per_batch(value, B):
    if value is None:
        return None
    return np.broadcast_to(np.asarray(value, np.int64), (B,))


def split_decode(q, k, v, *, causal=False, window=None, softcap=None,
                 scale=None, q_offset=0, kv_len=None, n_sm=132):
    """The kernels' rule in plain torch: per (batch, KV head, chunk) of the
    wrapper's plan, the f32 partial over the chunk's valid keys, then the
    merge in split order.  q (B, 1, Hq, D); k, v (B, Skv, Hkv, D)."""
    B, _, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    n_split, chunk = fa.decode_splits(B, Hkv, Skv, n_sm)
    scale = D ** -0.5 if scale is None else scale
    qp = _per_batch(q_offset, B)
    kl = _per_batch(Skv if kv_len is None else kv_len, B)
    qf = q[:, 0].float().view(B, Hkv, g, D) * scale
    kf, vf = k.float(), v.float()
    acc = torch.full((B, Hkv, n_split, g, D), float("nan"))
    m = torch.full((B, Hkv, n_split, g), -math.inf)
    l = torch.zeros((B, Hkv, n_split, g))
    for b in range(B):
        hi_b = min(int(kl[b]), Skv)
        if causal:
            hi_b = min(hi_b, int(qp[b]) + 1)
        lo_b = max(0, int(qp[b]) - window + 1) if window is not None else 0
        for s in range(n_split):
            lo, hi = max(lo_b, s * chunk), min(hi_b, s * chunk + chunk)
            if lo >= hi:
                continue        # m = -inf, l = 0, acc never written
            x = torch.einsum("hgd,nhd->hgn", qf[b], kf[b, lo:hi])
            if softcap is not None:
                x = torch.tanh(x / softcap) * softcap
            mx = x.amax(-1)
            p = torch.exp(x - mx[..., None])
            m[b, :, s], l[b, :, s] = mx, p.sum(-1)
            acc[b, :, s] = torch.einsum("hgn,nhd->hgd", p, vf[b, lo:hi])
    M = m.amax(2)
    L = torch.zeros_like(M)
    a = torch.zeros((B, Hkv, g, D))
    for s in range(n_split):
        live = m[:, :, s] != -math.inf
        w = torch.where(live, torch.exp(m[:, :, s] - M), 0.0)
        L = L + l[:, :, s] * w
        a = a + torch.where(live[..., None], acc[:, :, s] * w[..., None], 0.0)
    out = torch.where(L[..., None] > 0, a / L[..., None], 0.0)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


#: name -> ((B, Skv, Hq, Hkv, D), kwargs from the plan's chunk); q_offset
#: stays an int, as the JAX ref takes it
CASES = {
    "g1-kv0": ((3, 200, 4, 4, 16), lambda c: dict(kv_len=[200, c, 0])),
    "g3-boundary": ((3, 200, 6, 2, 24), lambda c: dict(
        kv_len=[c, c + 1, 1])),
    "g4-softcap": ((3, 200, 8, 2, 32), lambda c: dict(
        softcap=5.0, kv_len=[200, 2 * c - 1, 2 * c])),
    "g16": ((2, 200, 16, 1, 16), lambda c: dict(kv_len=[0, 77])),
    "g4-window": ((3, 200, 8, 2, 32), lambda c: dict(
        causal=True, window=50, q_offset=150, kv_len=[200, 151, 40])),
    "g3-window-softcap": ((2, 130, 6, 2, 24), lambda c: dict(
        causal=True, window=c + 3, softcap=8.0, q_offset=129,
        kv_len=[130, 2 * c + 1])),
}


@functools.lru_cache(maxsize=None)
def _case(name, n_sm):
    (B, Skv, Hq, Hkv, D), make = CASES[name]
    rng = np.random.default_rng(sum((B, Skv, Hq, Hkv, D)))
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B, 1, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = make(fa.decode_splits(B, Hkv, Skv, n_sm)[1])
    kw["kv_len"] = np.asarray(kw["kv_len"], np.int32)
    got = split_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                       **{**kw, "kv_len": torch.from_numpy(kw["kv_len"])},
                       n_sm=n_sm)
    return (q, k, v), kw, got


@pytest.mark.parametrize("n_sm", [8, 132])
@pytest.mark.parametrize("name", list(CASES))
def test_split_rule_matches_jax_ref(name, n_sm):
    (q, k, v), kw, got = _case(name, n_sm)
    want = _jref(*(jnp.asarray(a) for a in (q, k, v)),
                 **{"causal": False, **kw, "kv_len": jnp.asarray(kw["kv_len"])})
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for b, n in enumerate(kw["kv_len"]):
        if n == 0:
            assert not got[b].any()


@pytest.mark.parametrize("name", [n for n in CASES if "window" not in n])
def test_split_rule_matches_pallas_decode(name):
    """The Pallas decode (interpret mode) drops ``window`` and is never
    causal, so only the cases without them."""
    (q, k, v), kw, got = _case(name, 132)
    want = jax_decode(*(jnp.asarray(a) for a in (q, k, v)),
                      **{**kw, "kv_len": jnp.asarray(kw["kv_len"])},
                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_split_rule_matches_the_plain_version(name):
    """The wrapper on CPU tensors (``ref.attention_ref``) and the split
    rule agree, so the card's kernels are held to one contract."""
    (q, k, v), kw, got = _case(name, 132)
    plain = fa.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        **{**kw, "kv_len": torch.from_numpy(kw["kv_len"])})
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
