"""The grouped matmul's schedule, plan and per-block sums, on the CPU.

``moe_gmm`` on the card first builds a stable plan of the ids
(``moe_gmm.plan``), then launches the grid that ``moe_gmm.schedule``
picks from host-known sizes: a block per (column tile, row tile), which
sums the whole of K; the generic kernels cut a tile into sub-tiles of 64
rows (``csrc/moe_gmm.cu``).  No CUDA kernel runs here, so this file
checks the plan and the schedule themselves, and holds a plain-torch
model of the kernels' per-block sums, on the plain plan and the
schedule, against the JAX package's ``moe_gmm_ref`` and its Pallas
``moe_gmm`` in interpret mode (sorted ids, as that kernel needs), from
numpy-seeded inputs, in f32 at 2e-5 (tests/test_kernels.py).  Last, the
MoE layer asks for one plan per step and hands it to its three products.
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
from repro.kernels.moe_gmm import moe_gmm as jax_gmm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import burst_gather as bg  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.model import lm  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
CSRC = Path(gmm.__file__).parent / "csrc"


def _ids(kind, T, E, seed=0):
    """(T,) int32 ids: "routed" (top-8 of random scores, sorted, as the
    model dispatches; T a multiple of 8), "sorted", "random" (any order),
    "out-of-range" (none in [0, E)) or "mixed" (some outside)."""
    rng = np.random.default_rng(seed)
    if kind == "routed":
        scores = rng.standard_normal((T // 8, E))
        return np.sort(np.argsort(-scores, 1)[:, :8].reshape(-1)).astype(
            np.int32)
    if kind == "out-of-range":
        return rng.integers(E, E + 5, T).astype(np.int32)
    if kind == "mixed":
        return rng.integers(-2, E + 3, T).astype(np.int32)
    g = rng.integers(0, E, T).astype(np.int32)
    return np.sort(g) if kind == "sorted" else g


#: (name, T, K, N, E, ids): the served shapes, arctic's, ragged sizes
#: (K or N not a multiple of 8 take the generic kernels, cut into 64-row
#: sub-tiles where the tiles have 128 rows), one expert, no rows, and ids
#: all out of range
SHAPES = [
    ("prefill-gate-up", 16384, 1536, 512, 40, "routed"),
    ("prefill-down", 16384, 512, 1536, 40, "routed"),
    ("decode-gate-up", 32, 1536, 512, 40, "routed"),
    ("decode-down", 32, 512, 1536, 40, "routed"),
    ("arctic-480b", 4096, 7168, 4864, 128, "sorted"),
    ("ragged-k1000-n200", 1024, 1000, 200, 8, "random"),
    ("ragged-t33-k40-n24", 33, 40, 24, 5, "mixed"),
    ("t24-many-experts", 24, 1536, 512, 40, "random"),
    ("wmma-k37-n23-random", 192, 37, 23, 6, "random"),
    ("wmma-k37-n23-sub-tiles", 1200, 37, 23, 4, "mixed"),
    ("e1-every-row", 300, 256, 264, 1, "sorted"),
    ("t0", 0, 64, 64, 4, "sorted"),
    ("all-out-of-range", 100, 128, 64, 4, "out-of-range"),
]


def kernel_blocks(plan, s, N, E):
    """What each block of the schedule's grid does, as the kernels assign
    it: (bucket, rows, columns) for every block with a tile, in the order
    it takes them; the generic kernels take a tile's rows in sub-tiles of
    ``SUB``.  A tile of bucket E (ids out of range) is zero-filled."""
    perm, off, toff = (t.tolist() for t in plan[:3])
    cols_n, tiles = s.grid
    sub = gmm.SUB if s.path == "generic" else s.bm
    for y in range(tiles):
        if y >= toff[E + 1]:
            continue                       # past the last tile: exits
        e = next(b for b in range(E + 1) if toff[b] <= y < toff[b + 1])
        r0 = off[e] + (y - toff[e]) * s.bm
        rows = perm[r0:min(r0 + s.bm, off[e + 1])]
        for x in range(cols_n):
            cols = range(x * s.bn, min((x + 1) * s.bn, N))
            for i in range(0, len(rows), sub):
                yield e, rows[i:i + sub], cols


def _dtype(K, N):
    """bf16 where the wgmma kernel takes the shape, else f32 (the generic
    kernels, which bf16 with K or N not a multiple of 8 also takes)."""
    return torch.bfloat16 if K % 8 == 0 and N % 8 == 0 else torch.float32


@pytest.mark.parametrize("name,T,K,N,E,kind", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_schedule_covers_every_output_once(name, T, K, N, E, kind):
    ids = _ids(kind, T, E)
    plan = gmm.plan(torch.from_numpy(ids), E)
    for dtype in {_dtype(K, N), torch.float32}:
        s = gmm.schedule(T, K, N, E, dtype)
        assert s.path == ("wgmma" if dtype == torch.bfloat16 else "generic")
        assert s.bm == plan.bm == gmm.row_tile(T, E)
        # the grid's row bound holds these ids' tiles
        assert s.tiles >= int(plan.toff[-1]) and s.grid[1] == s.tiles
        hits = np.zeros((T, N), np.int16)
        for e, rows, cols in kernel_blocks(plan, s, N, E):
            assert len(rows) <= min(s.bm, gmm.SUB if s.path == "generic"
                                    else s.bm) and len(cols) <= s.bn
            assert all(ids[r] == e if e < E else not 0 <= ids[r] < E
                       for r in rows)
            hits[np.ix_(rows, list(cols))] += 1
        # each output once: a product of its expert, or a zero
        assert (hits == 1).all()


def test_bf16_with_k_or_n_not_a_multiple_of_8_is_generic():
    for K, N in ((37, 24), (40, 23), (37, 23)):
        assert gmm.schedule(1200, K, N, 4, torch.bfloat16).path == "generic"
    s = gmm.schedule(1200, 40, 24, 4, torch.bfloat16)
    assert (s.path, s.bm, s.bn) == ("wgmma", 128, gmm.WGMMA_TILES[128])


@pytest.mark.parametrize("seed", range(6))
def test_grid_bound_is_never_below_the_tile_count(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        E = int(rng.integers(1, 200))
        T = int(rng.integers(0, 3000))
        skew = rng.random()
        # few experts take most rows, and one row each for the rest
        ids = np.where(rng.random(T) < skew, rng.integers(0, 3, T),
                       rng.integers(-1, E + 1, T)).astype(np.int32)
        if T >= E:
            ids[:E] = np.arange(E)
        plan = gmm.plan(torch.from_numpy(ids), E)
        for dtype in (torch.bfloat16, torch.float32):
            s = gmm.schedule(T, 64, 64, E, dtype)
            assert int(plan.toff[-1]) <= s.tiles, (T, E)


def test_constants_are_the_kernels():
    src = (CSRC / "moe_gmm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("SUB") == gmm.SUB
    assert const("MAXE") == gmm.MAX_EXPERTS
    tiles = {int(m): int(n) for m, n in re.findall(
        r"if \(bm == (\d+) && bn == (\d+)\)\n\s+return launch_wgmma<", src)}
    assert tiles == gmm.WGMMA_TILES
    gather = (CSRC / "burst_gather.cu").read_text()
    assert re.search(r"constexpr int IB = (\d+);", gather).group(1) == str(
        bg.TILE)


#: (kind, T, E): routing gives 8 ids a token, to 8 of E >= 8 experts
PLAN_CASES = [(kind, T, E) for T, E in ((16384, 40), (32, 40), (1000, 7),
                                        (0, 3), (500, 1))
              for kind in ("routed", "sorted", "random", "mixed",
                           "out-of-range")
              if kind != "routed" or E >= 8]


@pytest.mark.parametrize("kind,T,E", PLAN_CASES, ids=str)
def test_plain_plan_is_a_stable_counting_sort(kind, T, E):
    ids = _ids(kind, T, E, seed=T + E)
    plan = gmm.plan(torch.from_numpy(ids), E)
    bucket = np.where((ids >= 0) & (ids < E), ids, E)
    want = np.argsort(bucket, kind="stable")
    np.testing.assert_array_equal(plan.perm.numpy(), want)
    counts = np.bincount(bucket, minlength=E + 1)
    np.testing.assert_array_equal(plan.off.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))
    tiles = -(-counts // plan.bm)
    np.testing.assert_array_equal(plan.toff.numpy(),
                                  np.concatenate([[0], np.cumsum(tiles)]))
    assert plan.perm.dtype == plan.off.dtype == torch.int32
    # stable: within a bucket, rows in increasing order
    for b in range(E + 1):
        seg = plan.perm[plan.off[b]:plan.off[b + 1]].numpy()
        assert (np.diff(seg) > 0).all()
    if kind in ("routed", "sorted"):
        np.testing.assert_array_equal(plan.perm.numpy(), np.arange(T))
    # each tile's (bucket, first slot, rows, first x row of a run or -1),
    # then (-1, 0, 0, -1) up to the bound
    tiles = plan.tiles.numpy()
    assert tiles.shape == (gmm.tile_bound(T, E), 4)
    n_tiles = int(plan.toff[-1])
    perm = plan.perm.numpy()
    for t, (b, r0, n, run) in enumerate(tiles[:n_tiles]):
        assert plan.toff[b] <= t < plan.toff[b + 1]
        assert r0 == plan.off[b] + (t - plan.toff[b]) * plan.bm
        assert n == min(plan.bm, plan.off[b + 1] - r0) > 0
        rows = perm[r0:r0 + n]
        one_run = b < E and (np.diff(rows) == 1).all()
        assert run == (rows[0] if one_run else -1)
    assert (tiles[n_tiles:] == [-1, 0, 0, -1]).all()


def kernel_sum(x, w, ids, dtype):
    """The kernels' arithmetic in plain torch: per block of the schedule
    for ``dtype``, its rows and columns summed over the whole of K in f32;
    rows of ids outside [0, E) zero."""
    T, K = x.shape
    E, _, N = w.shape
    plan = gmm.plan(ids, E)
    s = gmm.schedule(T, K, N, E, dtype)
    out = torch.full((T, N), float("nan"))
    for e, rows, cols in kernel_blocks(plan, s, N, E):
        r, c = torch.tensor(rows, dtype=torch.long), list(cols)
        out[r[:, None], torch.tensor(c)] = 0.0 if e == E else \
            x[r].float() @ w[e][:, c[0]:c[-1] + 1].float()
    return out, s


#: (T, K, N, E): 64-row tiles, 128-row tiles (T >= 128 E; the generic
#: kernels' two sub-tiles), K and N not multiples of the tiles
SUM_SHAPES = [(24, 320, 48, 6), (40, 200, 24, 3), (300, 136, 40, 2),
              (16, 64, 8, 2)]


@pytest.mark.parametrize("shape", SUM_SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["sorted", "mixed"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["wgmma", "generic"])
def test_kernel_sum_matches_jax(shape, kind, dtype):
    T, K, N, E = shape
    rng = np.random.default_rng(T * 7 + K)
    x = rng.standard_normal((T, K), dtype=np.float32)
    w = 0.1 * rng.standard_normal((E, K, N), dtype=np.float32)
    ids = _ids(kind, T, E, seed=K)
    got, s = kernel_sum(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(ids), dtype)
    assert s.bm == (128 if T >= 128 * E else 64)
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.moe_gmm_ref(jx, jw, jg)), **TOL)
    if kind == "sorted":
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jax_gmm(jx, jw, jg, tb=16, interpret=True)), **TOL)


def test_moe_layer_builds_one_plan_per_step(monkeypatch):
    """Every MoE layer asks ``ops.moe_plan`` for one plan per step and
    hands that plan to each of its three grouped matmuls.  For CPU ids no
    plan is built (the plain ``moe_gmm`` takes none): the wrapper here
    stands a token in for the plan the card would build."""
    made, used = [], []
    moe_plan, moe_gmm = ops.moe_plan, ops.moe_gmm

    def counting_plan(ids, E):
        assert moe_plan(ids, E) is None
        made.append(object())
        return made[-1]

    def recording_gmm(x, w, ids, p=None):
        used.append(p)
        return moe_gmm(x, w, ids)

    def no_plan(*args):
        raise AssertionError("a plan was built for CPU ids")

    monkeypatch.setattr(ops, "moe_plan", counting_plan)
    monkeypatch.setattr(ops, "moe_gmm", recording_gmm)
    monkeypatch.setattr(gmm, "plan", no_plan)
    cfg = configs.get_reduced("granite-moe-3b-a800m")
    params = lm.init_params(cfg, seed=0, device="cpu")
    cache = lm.init_cache(params, cfg, 2, 12, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    n_moe = sum(hasattr(layer, "moe") for layer in params.layers)
    assert n_moe > 0
    for step, feed in enumerate([tokens, tokens[:, -1:]], 1):
        _, cache = lm.step(params, cfg, cache, feed)
        assert len(made) == n_moe * step
        assert len(used) == 3 * n_moe * step
        assert all(u is made[i // 3] for i, u in enumerate(used))
