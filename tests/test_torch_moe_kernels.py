"""The port's grouped matmul ``moe_gmm`` vs the JAX package, on the CPU.

The same numpy inputs go to ``repro.kernels.ref.moe_gmm_ref``, to the
Pallas kernel in interpret mode (``tb=16``, as ``tests/test_kernels.py``
runs it) and to the port's wrapper, which for CPU tensors runs the plain
PyTorch version.  Tolerances are those of ``tests/test_kernels.py``: 2e-5
in f32, 2e-2 in bf16 (one bf16 rounding of outputs of magnitude ~1; w is
scaled by 0.1 as there).

The Pallas kernel reads only the first and last id of each token tile, so
it is right only for sorted ids: the port is held to it on sorted ids and
to the JAX ref on any ids, unsorted and out of range included.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as jax_gmm  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: (T, K, N, E): test_kernels.py's sweep, and a ragged case with K and N
#: not multiples of 8
SHAPES = [(50, 24, 36, 5), (16, 8, 8, 2), (33, 40, 24, 4)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(shape, dtype, ids):
    """x, w as (jax, torch) pairs of ``dtype`` and the ids as int32
    (jax, torch); ``ids`` is "sorted", "unsorted" or "out-of-range"
    (unsorted, with ids below 0 and at or above E)."""
    T, K, N, E = shape
    rng = np.random.default_rng(T * 1000 + K)
    x = rng.standard_normal((T, K), dtype=np.float32)
    w = 0.1 * rng.standard_normal((E, K, N), dtype=np.float32)
    lo, hi = (-2, E + 3) if ids == "out-of-range" else (0, E)
    g = rng.integers(lo, hi, T).astype(np.int32)
    if ids == "sorted":
        g = np.sort(g)
    return ((jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])), (jnp.asarray(w).astype(JDT[dtype]),
                       torch.from_numpy(w).to(TDT[dtype])),
            (jnp.asarray(g), torch.from_numpy(g)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_moe_gmm_matches_jax_ref_and_pallas_on_sorted_ids(dtype, shape):
    (jx, tx), (jw, tw), (jg, tg) = _inputs(shape, dtype, "sorted")
    got = ops.moe_gmm(tx, tw, tg)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (shape[0],
                                                           shape[2])
    np.testing.assert_allclose(_np(got), _np(jref.moe_gmm_ref(jx, jw, jg)),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(jax_gmm(jx, jw, jg, tb=16,
                                                     interpret=True)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ids", ["unsorted", "out-of-range"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_moe_gmm_matches_jax_ref_on_any_ids(dtype, ids, shape):
    (jx, tx), (jw, tw), (jg, tg) = _inputs(shape, dtype, ids)
    got = ops.moe_gmm(tx, tw, tg)
    want = _np(jref.moe_gmm_ref(jx, jw, jg))
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    outside = (_np(tg) < 0) | (_np(tg) >= shape[3])
    assert (ids == "out-of-range") == bool(outside.any())
    assert not _np(got)[outside].any()          # zero rows, as one_hot


def test_moe_gmm_takes_empty_and_one_expert_inputs():
    x, w = torch.randn(0, 8), torch.randn(3, 8, 5)
    assert tuple(ops.moe_gmm(x, w, torch.zeros(0, dtype=torch.int32))
                 .shape) == (0, 5)
    x, w = torch.randn(6, 8), torch.randn(1, 8, 5)
    got = ops.moe_gmm(x, w, torch.zeros(6, dtype=torch.int64))
    torch.testing.assert_close(got, x @ w[0], rtol=2e-5, atol=2e-5)


def test_pallas_moe_gmm_drops_rows_of_unsorted_ids():
    """The fault of the JAX Pallas kernel recorded in ROADMAP.md: it skips
    every expert outside [first id, last id] of a tile, so with unsorted
    ids it leaves rows at zero (a whole tile when its first id exceeds its
    last).  The ref and the port compute them."""
    shape = (40, 24, 16, 4)
    (jx, tx), (jw, tw), (jg, tg) = _inputs(shape, "float32", "unsorted")
    want = _np(jref.moe_gmm_ref(jx, jw, jg))
    pallas = _np(jax_gmm(jx, jw, jg, tb=16, interpret=True))
    dropped = ~pallas.any(1) & want.any(1)
    assert dropped.sum() >= 10, dropped.sum()
    np.testing.assert_allclose(_np(ops.moe_gmm(tx, tw, tg)), want,
                               **TOL["float32"])


def test_moe_gmm_wrapper_raises_on_bad_inputs(monkeypatch):
    """Off the CPU (here on the meta device) the wrapper checks what the
    kernel takes before it would launch, and never falls back: inputs that
    pass take the shape-only path (``kernels.shape_only``), one launch
    counted."""
    monkeypatch.setattr(gmm.moe_gmm, "launches", 0)
    monkeypatch.setattr(gmm.plan, "launches", 0)
    meta = dict(device="meta")
    x, w = torch.empty((8, 16), **meta), torch.empty((4, 16, 32), **meta)
    ids = torch.empty(8, dtype=torch.int32, **meta)
    bad = [
        (ValueError, (torch.empty((8, 12), **meta), w, ids)),     # K
        (ValueError, (x, w, torch.empty(7, dtype=torch.int32, **meta))),
        (ValueError, (x, torch.empty((4, 16), **meta), ids)),     # w 2-D
        (ValueError, (x, torch.empty((1025, 16, 2), **meta), ids)),
        (ValueError, (x, w, torch.zeros(8, dtype=torch.int32))),  # CPU ids
        (TypeError, (x.to(**meta, dtype=torch.bfloat16), w, ids)),
        (TypeError, (x, w, torch.empty(8, **meta))),               # float ids
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            gmm.moe_gmm(*args)
    assert gmm.moe_gmm.launches == 0
    out = gmm.moe_gmm(x, w, ids)
    assert out.device.type == "meta" and tuple(out.shape) == (8, 32)
    assert (gmm.moe_gmm.launches, gmm.plan.launches) == (1, 1)


def test_moe_gmm_ref_loops_over_present_experts_only():
    """The plain version is the semantics contract: x[i] @ w[ids[i]] in
    f32, zero rows out of range, whatever the order."""
    x = torch.arange(12, dtype=torch.float32).view(4, 3)
    w = torch.stack([torch.eye(3), 2 * torch.eye(3)])
    ids = torch.tensor([1, -1, 0, 2])
    want = torch.stack([2 * x[0], torch.zeros(3), x[2], torch.zeros(3)])
    assert torch.equal(ref.moe_gmm_ref(x, w, ids), want)
