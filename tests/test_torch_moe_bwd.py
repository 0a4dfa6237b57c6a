"""The grouped matmul's gradient (``moe_gmm_bwd``) and the MoE layer's, on
the CPU, against the JAX package.

``moe_gmm_bwd`` on the CPU is autograd through the plain version: it is
held to ``jax.vjp`` of ``repro.kernels.ref.moe_gmm_ref`` on numpy-seeded
inputs, with sorted, unsorted and out-of-range ids and an expert that no
row takes.  On the card its kernels run on ``moe_gmm.bwd_schedule``: dX
over (row tile, column tile) items with K and N swapped (w read
transposed), dW over (expert, K tile, N tile) items that walk the
expert's rows of the plan in order; in bf16 both are persistent
(``_dx_work``, ``_dw_work``) and dW's stages come by TMA where they are one
run of x (``_dw_stages``).  No CUDA kernel runs here, so this file checks
those schedules (every dX output once, every dW element once, the work
lists, the stages, the constants read from ``csrc/moe_gmm.cu``), holds a
plain-torch model of the dW kernels' walk (f32 sums a stage of rows at a
time, a TMA stage's rows read from its first x row with its tail set to
zero, zeros for an expert with no row) to the plain gradient and JAX's,
follows the CUDA branch of the wrappers through a faked library on meta
tensors, and holds the MoE layer's gradients, and arctic-480b-reduced's
whole loss and gradients, to JAX's.  ``chip_smoke.py`` holds the kernels
to the plain version on the card.

Tolerances: 2e-5 in f32 and 2e-2 in bf16, ``tests/test_kernels.py``'s
(the same sums in another order; in bf16 one rounding of outputs of
magnitude ~1, w scaled by 0.1 as there); the layer's and the model's f32
gradients within 1e-4 of each leaf's largest entry, as
``tests/test_torch_train.py`` holds them (f32 sums over d, f and the
tokens in another order).
"""
import contextlib
import re
import types
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import SyntheticTokens  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.model import lm as jlm  # noqa: E402
from repro.model import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import shape_only  # noqa: E402
from repro_torch.model import convert, lm, moe  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: f32 gradients of the layer and the model, relative to each leaf's
#: largest entry
GRAD_REL = 1e-4
CSRC = Path(gmm.__file__).parent / "csrc"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


#: rows of each expert of the "stage-edge" ids: 63, 64 and 65 past a
#: stage edge, the next expert's rows in the same stage
EDGE_ROWS = (63, 64, 65, 127, 128, 129, 1)


def _ids(kind, T, E, rng):
    """(T,) int32 ids: "sorted", "unsorted", "out-of-range" (unsorted,
    some below 0 and some at or above E), "sorted-out-of-range" (as
    "out-of-range", sorted: each expert's rows one run of x that does not
    start at its first slot), "empty-expert" (unsorted, no row of expert
    E // 2), "stage-edge" (sorted, ``EDGE_ROWS`` rows an expert, in
    turn, up to T) or "mixed" (token order: experts 0 and 1 a run of T // 6
    consecutive rows each, expert 2 the plan's row tile plus one rows at
    random places, so a gathered tile and then a one-row run, and the rest
    uniform over the other experts)."""
    if kind == "mixed":
        run = T // 6
        g = rng.integers(3, E, T).astype(np.int32)
        g[:2 * run] = np.repeat(np.arange(2, dtype=np.int32), run)
        rest = 2 * run + rng.permutation(T - 2 * run)
        g[rest[:gmm.row_tile(T, E) + 1]] = 2
        return g
    if kind == "stage-edge":
        counts = [EDGE_ROWS[e % len(EDGE_ROWS)] for e in range(E)]
        g = np.repeat(np.arange(E, dtype=np.int32), counts)[:T]
        return np.concatenate([g, np.full(T - len(g), E - 1, np.int32)])
    lo, hi = (-2, E + 3) if "out-of-range" in kind else (0, E)
    g = rng.integers(lo, hi, T).astype(np.int32)
    if kind == "empty-expert":
        g[g == E // 2] = (E // 2 + 1) % E
    return np.sort(g) if kind.startswith("sorted") else g


def _inputs(shape, kind, seed=0):
    """x (T, K), w (E, K, N) (0.1 standard normal, as test_kernels.py),
    ids and dy (T, N), numpy f32 / int32."""
    T, K, N, E = shape
    rng = np.random.default_rng(seed * 1000 + T + K)
    x = rng.standard_normal((T, K), dtype=np.float32)
    w = 0.1 * rng.standard_normal((E, K, N), dtype=np.float32)
    g = _ids(kind, T, E, rng)
    dy = rng.standard_normal((T, N), dtype=np.float32)
    return x, w, g, dy


def _jax_grads(x, w, g, dy, dtype):
    _, vjp = jax.vjp(lambda a, b: jref.moe_gmm_ref(a, b, jnp.asarray(g)),
                     jnp.asarray(x, JDT[dtype]), jnp.asarray(w, JDT[dtype]))
    return vjp(jnp.asarray(dy, JDT[dtype]))


#: (T, K, N, E), K != N so that a transposed operand shows: the sweep of
#: test_kernels.py and a ragged case with K and N not multiples of 8
SHAPES = [(50, 24, 36, 5), (33, 40, 24, 4)]
KINDS = ["sorted", "unsorted", "out-of-range", "empty-expert"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp(dtype, shape, kind):
    """``moe_gmm_bwd`` on the CPU against ``jax.vjp`` of the JAX ref; the
    rows of ids outside [0, E) get zero dx, an expert no row takes zero
    dw; autograd through the ``moe_gmm`` wrapper gives the same bits, and
    ``need`` leaves out the gradient not asked for."""
    x, w, g, dy = _inputs(shape, kind)
    E = shape[3]
    jdx, jdw = _jax_grads(x, w, g, dy, dtype)
    tx, tw, tdy = (torch.from_numpy(a).to(TDT[dtype]) for a in (x, w, dy))
    tg = torch.from_numpy(g)
    dx, dw = gmm.moe_gmm_bwd(tdy, tx, tw, tg)
    for name, got, want in (("dx", dx, jdx), ("dw", dw, jdw)):
        assert got.dtype == TDT[dtype] and got.shape == want.shape, name
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype],
                                   err_msg=name)
    outside = (g < 0) | (g >= E)
    assert not _np(dx)[outside].any()
    for e in range(E):
        if not (g == e).any():
            assert not _np(dw[e]).any()
    leaves = [t.clone().requires_grad_(True) for t in (tx, tw)]
    via = torch.autograd.grad(gmm.moe_gmm(*leaves, tg), leaves, tdy)
    assert torch.equal(via[0], dx) and torch.equal(via[1], dw)
    only_x = gmm.moe_gmm_bwd(tdy, tx, tw, tg, need=(True, False))
    assert only_x[1] is None and torch.equal(only_x[0], dx)


# ---------------------------------------------------------------------------
# the schedule of the card's backward kernels, and a model of dW's walk
# ---------------------------------------------------------------------------

def _const(name):
    src = (CSRC / "moe_gmm.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


#: rows of an expert a stage of the bf16 dW kernel
_DW_STEP = _const("GBK")


def _dw_step(path, dtype):
    """Rows of an expert a dW block takes a step: ``GBK`` of the wgmma
    kernel, ``WBK`` (bf16) or ``FBK`` (f32) of the generic ones."""
    if path == "wgmma":
        return _const("GBK")
    return _const("WBK" if dtype == torch.bfloat16 else "FBK")


def test_bwd_constants_are_the_kernels():
    """The dW tile is the kernel's, and its cluster of ``DW_CK`` blocks
    along K (a portable cluster size) splits dY's 64-column boxes evenly
    among its blocks; dX launches the
    forward's tiles, transposed; the ring of ``BWD_ST`` stages, two
    epilogue buffers a consumer warpgroup and the barriers (and dW's
    expert order, 2 bytes an expert) fit a block's shared memory with no
    room lost to alignment."""
    assert gmm.DW_TILE == (_const("DW_BK"), _const("DW_BN"))
    ck = _const("DW_CK")
    assert 1 <= ck <= 8 and gmm.DW_TILE[1] // 64 % ck == 0
    src = (CSRC / "moe_gmm.cu").read_text()
    back = src[re.search(r"^// -+ backward", src, re.M).start():]
    tiles = {int(m): int(n) for m, n in re.findall(
        r"if \(bm == (\d+) && bn == (\d+)\)\n\s+return launch_dx_wgmma<\1, "
        r"\2>", back)}
    assert tiles == gmm.WGMMA_TILES
    stages, step, buf = _const("BWD_ST"), _const("GBK"), _const("EPI_BUF")

    def smem(rows, cols, extra=0):
        return stages * step * (rows + cols) * 2 + rows // 64 * 2 * buf + \
            2 * stages * 8 + extra
    assert buf == 64 * 128
    assert smem(*gmm.DW_TILE, 2 * _const("MAXE")) <= _const("kMaxSmem")
    for bm, bn in gmm.WGMMA_TILES.items():
        assert smem(bm, bn) <= _const("kMaxSmem")


#: (T, K, N, E, ids): granite-moe's training products (gate/up and down,
#: 32,800 routed rows), arctic-reduced's N 96, 64-row tiles (T < 128 E),
#: unsorted and out-of-range ids, one expert, an expert with no row, K or
#: N not a multiple of 8 (the generic kernels), and no rows
BWD_SHAPES = [
    (32800, 1536, 512, 40, "sorted"),
    (32800, 512, 1536, 40, "sorted"),
    (516, 64, 96, 8, "sorted"),
    (600, 136, 40, 8, "unsorted"),
    (300, 72, 200, 6, "out-of-range"),
    (200, 64, 64, 1, "sorted"),
    (333, 40, 48, 5, "empty-expert"),
    (250, 37, 23, 4, "unsorted"),
    (0, 64, 64, 3, "sorted"),
]


def _dx_blocks(plan, s, K, E):
    """What each block of dX's grid does (the forward's kernels on the sum
    over N and K output columns): (bucket, rows, columns) a block and
    sub-tile, as ``test_torch_moe_schedule.kernel_blocks`` walks them."""
    perm, off, toff = (t.tolist() for t in plan[:3])
    cols_n, tiles = s.grid
    sub = gmm.SUB if s.path == "generic" else s.bm
    for y in range(tiles):
        if y >= toff[E + 1]:
            continue
        e = next(b for b in range(E + 1) if toff[b] <= y < toff[b + 1])
        r0 = off[e] + (y - toff[e]) * s.bm
        rows = perm[r0:min(r0 + s.bm, off[e + 1])]
        for x in range(cols_n):
            cols = range(x * s.bn, min((x + 1) * s.bn, K))
            for i in range(0, len(rows), sub):
                yield e, rows[i:i + sub], cols


def _dw_blocks(plan, s, K, N, E, dtype):
    """Each dW block of the grid: (expert, K rows, N columns, the expert's
    rows a step at a time, in slot order)."""
    perm, off = plan.perm.tolist(), plan.off.tolist()
    bk, bn = s.dw_tile
    step = _dw_step(s.path, dtype)
    nx, ny, nz = s.dw_grid
    for e in range(nz):
        steps = [perm[t:min(t + step, off[e + 1])]
                 for t in range(off[e], off[e + 1], step)]
        for yk in range(ny):
            for xn in range(nx):
                yield (e, range(yk * bk, min((yk + 1) * bk, K)),
                       range(xn * bn, min((xn + 1) * bn, N)), steps)


def _partition(ranges, n):
    """Do ``ranges`` (distinct ``range``s) cover [0, n) once each?"""
    got = sorted((r.start, r.stop) for r in ranges)
    return [a for a, _ in got] == [0] + [b for _, b in got[:-1]] and \
        (got[-1][1] if got else 0) == n


@pytest.mark.parametrize("T,K,N,E,kind", BWD_SHAPES, ids=str)
def test_bwd_schedule_covers_every_gradient_once(T, K, N, E, kind):
    """dX: its blocks' column ranges cut [0, K) once, and at each the
    blocks take every row once, by its own expert or as a zero row; dW: at
    each expert its blocks' (K rows, N columns) ranges cut the (K, N)
    table once, and the expert's steps take its rows once, in increasing
    slot order; the grids fit the kernels' limits."""
    g = _ids(kind, T, E, np.random.default_rng(T + K))
    plan = gmm.plan(torch.from_numpy(g), E)
    mine = {e: [i for i in range(T) if g[i] == e] for e in range(E)}
    for dtype in (torch.bfloat16, torch.float32):
        s = gmm.bwd_schedule(T, K, N, E, dtype)
        wgmma = dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
        assert s.path == ("wgmma" if wgmma else "generic")
        assert s.dx == gmm.schedule(T, N, K, E, dtype)
        assert s.dx.tiles >= int(plan.toff[-1]) and s.dx.tiles <= 65535
        by_cols = {}
        for e, rows, cols in _dx_blocks(plan, s.dx, K, E):
            assert all(g[r] == e if e < E else not 0 <= g[r] < E
                       for r in rows)
            by_cols.setdefault(cols, []).extend(rows)
        assert T == 0 or _partition(by_cols, K)
        assert all(sorted(rows) == list(range(T))
                   for rows in by_cols.values())
        assert s.dw_grid[2] == E and s.dw_grid[1] <= 65535
        tiles, walks = {}, {}
        for e, ks, ns, steps in _dw_blocks(plan, s, K, N, E, dtype):
            tiles.setdefault(e, []).append((ks, ns))
            walks[e] = [r for st in steps for r in st]
        for e in range(E):
            assert walks[e] == sorted(walks[e]) == mine[e]
            ks = {k for k, _ in tiles[e]}
            ns = {n for _, n in tiles[e]}
            assert len(set(tiles[e])) == len(tiles[e]) == len(ks) * len(ns)
            assert _partition(ks, K) and _partition(ns, N)


def _stage_rows(plan, T, slot, rows, xrow):
    """The ``DW_STEP`` x rows a dW stage holds, row T standing for the
    zeros TMA reads past the table: from its first x row by TMA, else its
    rows through perm."""
    step = _DW_STEP
    if xrow >= 0:
        return [min(r, T) for r in range(xrow, xrow + step)]
    return plan.perm[slot:slot + rows].tolist() + [T] * (step - rows)


def _dw_model(x, dy, ids, E, dtype, clusters=3):
    """The dW kernels' arithmetic in plain torch, on the plain plan.  On
    the wgmma path each block of ``_dw_work`` (``clusters`` clusters) walks
    its items' ``_dw_stages``: the stage's ``DW_STEP`` rows of x and dY,
    read from its first x row where it comes by TMA (the next expert's
    rows, or zeros past T, included) and its rows past ``rows`` set to
    zero, or gathered through perm; on the generic path each block of the
    grid its expert's rows a step at a time.  x^T dY of each stage is
    added to an f32 accumulator, rounded once, and a tile past the table
    is not stored; an expert with no row gets the zeros its block writes.
    The table starts as NaN, and each element may be written once, so an
    element no block wrote, or two wrote, shows."""
    T, K = x.shape
    N = dy.shape[1]
    plan = gmm.plan(ids, E)
    s = gmm.bwd_schedule(T, K, N, E, dtype)
    bk, bn = s.dw_tile
    xz = torch.cat([x, x.new_zeros((1, K))])
    dyz = torch.cat([dy, dy.new_zeros((1, N))])
    dw = torch.full((E, K, N), float("nan"))
    if s.path == "generic":
        items = [(e, ks, ns, [(rows, len(rows)) for rows in steps])
                 for e, ks, ns, steps in _dw_blocks(plan, s, K, N, E, dtype)]
    else:
        items = [(e, range(kt * bk, min(kt * bk + bk, K)),
                  range(nt * bn, min(nt * bn + bn, N)),
                  [(_stage_rows(plan, T, *st), st[1])
                   for st in _dw_stages(plan, e)])
                 for walk in _dw_work(s, plan.off, clusters)
                 for e, kt, nt in walk]
    for e, ks, ns, stages in items:
        if not ks or not ns:        # past the table: summed, not stored
            continue
        acc = torch.zeros((len(ks), len(ns)))
        for rows, n in stages:
            r = torch.tensor(rows, dtype=torch.long)
            a = xz[r][:, ks.start:ks.stop].float()
            b = dyz[r][:, ns.start:ns.stop].float()
            a[n:], b[n:] = 0, 0
            acc += a.T @ b
        assert torch.isnan(dw[e, ks.start:ks.stop, ns.start:ns.stop]).all()
        dw[e, ks.start:ks.stop, ns.start:ns.stop] = acc
    return dw.to(x.dtype)


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "empty-expert",
                                  "sorted-out-of-range", "stage-edge",
                                  "mixed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_model_is_the_plain_gradient(dtype, kind):
    """The model of the dW kernels' walk equals the plain gradient and
    JAX's within the dtype's tolerance, on the wgmma tiles (bf16: K and N
    multiples of 8 and K != N, more rows an expert than one stage, three K
    tiles in clusters of ``DW_CK``, a partial last N tile) and the generic
    ones (f32), with exact zeros for the expert no row takes: stages by
    TMA from runs of x that start at their slot (sorted) or elsewhere
    (sorted with ids out of range), partial last stages of 63, 64 and 65
    rows with the next expert's rows behind them (stage edge), gathered
    stages (unsorted), and experts of runs beside gathered ones (mixed)."""
    shape = (700, 264, 200, 5) if kind != "stage-edge" else (660, 264, 200, 7)
    x, w, g, dy = _inputs(shape, kind, seed=3)
    tx, tw, tdy = (torch.from_numpy(a).to(TDT[dtype]) for a in (x, w, dy))
    got = _dw_model(tx, tdy, torch.from_numpy(g), shape[3], TDT[dtype])
    assert not torch.isnan(got).any()
    _, want = gmm.moe_gmm_bwd(tdy, tx, tw, torch.from_numpy(g),
                              need=(False, True))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    _, jdw = _jax_grads(x, w, g, dy, dtype)
    np.testing.assert_allclose(_np(got), _np(jdw), **TOL[dtype])
    for e in range(shape[3]):
        if not (g == e).any():
            assert not _np(got[e]).any()


# ---------------------------------------------------------------------------
# the persistent work lists and dW's stages
# ---------------------------------------------------------------------------
def _dx_work(s, n_tiles, blocks):
    """A model of the bf16 dX kernel's items, block by block, as it walks
    them: block b takes items b, b + blocks, .. of (row tile y, column
    tile x), x fastest, while y is below ``n_tiles`` (the plan's tiles,
    ``toff[E + 1]``).  ``s`` is ``bwd_schedule(..).dx``."""
    cols = s.grid[0]
    return [[(i // cols, i % cols)
             for i in range(b, n_tiles * cols, blocks)]
            for b in range(blocks)]


def _dw_order(off):
    """The experts of a dW launch in the order its work list takes them:
    by rows (``off[e + 1] - off[e]``), most first, ties by expert."""
    off = [int(o) for o in off]
    E = len(off) - 2
    return sorted(range(E), key=lambda e: (off[e] - off[e + 1], e))


def _dw_work(s, off, clusters):
    """A model of the bf16 dW kernel's items, block by block in the order
    of the launch's blocks (``clusters`` clusters of ck = ``DW_CK`` blocks
    along K, rank kr), as each walks them: (expert, K tile, N tile).

    An expert's items are ceil(K tiles / ck) x (N tiles) groups, the K
    group fastest, and the experts come in ``_dw_order``.  Round w gives
    cluster c the group w nc + c, in odd rounds w nc + nc - 1 - c (nc =
    ``clusters``), so the largest groups spread over the clusters; block
    kr of the cluster takes K tile kg ck + kr and N tile ng of group (kg,
    ng).  A K tile past the table (an odd count of K tiles) is loaded and
    summed as zeros and not stored."""
    ck = _const("DW_CK")
    nn, nk, E = s.dw_grid
    nkg = -(-nk // ck)
    per = nkg * nn
    order = _dw_order(off)
    work = []
    for c in range(clusters):
        rounds = []
        for w in range(-(-E * per // clusters) + 1):
            i = w * clusters + (clusters - 1 - c if w & 1 else c)
            if i >= E * per:
                break
            rounds.append((order[i // per], i % per % nkg, i % per // nkg))
        work += [[(e, kg * ck + kr, ng) for e, kg, ng in rounds]
                 for kr in range(ck)]
    return work


def _dw_stages(p, e):
    """A model of expert e's stages in the bf16 dW kernel's walk: (first
    slot, rows, first x row or -1), ``_DW_STEP`` slots a stage from
    ``off[e]``.

    A stage lies in one row tile of the plan (tiles of ``p.bm``, a
    multiple of ``_DW_STEP``, from ``off[e]``), so its rows are one run of
    x exactly when that tile's run (its 4th entry) is not -1, and then
    they start at the tile's first x row plus the stage's offset in the
    tile: the stage comes by TMA boxes of ``_DW_STEP`` rows from there,
    and its rows past ``rows`` (the next expert's, or past T) are set to
    zero once it lands.  Else (-1) its rows are gathered through perm,
    zeros past ``rows``."""
    off, toff = p.off.tolist(), p.toff.tolist()
    stages = []
    for rel in range(0, off[e + 1] - off[e], _DW_STEP):
        run = int(p.tiles[toff[e] + rel // p.bm, 3])
        stages.append((off[e] + rel,
                       min(_DW_STEP, off[e + 1] - off[e] - rel),
                       run + rel % p.bm if run >= 0 else -1))
    return stages



#: (T, K, N, E, ids): granite-moe's training products, fewer items than
#: clusters (one expert), an empty expert, three K tiles and a partial N
#: tile, arctic-reduced's single tile, and runs beside gathered experts
WORK_CASES = [
    (32800, 1536, 512, 40, "sorted"),
    (32800, 512, 1536, 40, "sorted"),
    (100, 256, 512, 1, "sorted"),
    (333, 264, 200, 5, "empty-expert"),
    (516, 64, 96, 8, "sorted"),
    (32800, 1536, 512, 40, "mixed"),
]


@pytest.mark.parametrize("clusters", [1, 4, 66])
@pytest.mark.parametrize("T,K,N,E,kind", WORK_CASES, ids=str)
def test_dw_work_takes_every_tile_once(T, K, N, E, kind, clusters):
    """dW's work list on one cluster, a few, and the 66 of an H100 (132
    SMs in pairs): every (expert, K tile, N tile) of the table once over
    all blocks, a K tile past it only as a cluster's spare block; the
    items in the order of the experts' rows, most first; within a
    cluster, at every round, one expert (so the same stages of the same
    rows) and one N tile (dY's boxes, which its blocks share), each block
    on its own K tile, and every block the same number of items."""
    g = _ids(kind, T, E, np.random.default_rng(T + K))
    plan = gmm.plan(torch.from_numpy(g), E)
    off = plan.off.tolist()
    s = gmm.bwd_schedule(T, K, N, E)
    ck = _const("DW_CK")
    nn, nk, _ = s.dw_grid
    work = _dw_work(s, plan.off, clusters)
    assert len(work) == clusters * ck
    seen = [item for walk in work for item in walk]
    inside = [(e, kt, nt) for e, kt, nt in seen if kt < nk]
    assert all(nt < nn for _, _, nt in seen)
    assert sorted(inside) == [(e, kt, nt) for e in range(E)
                              for kt in range(nk) for nt in range(nn)]
    assert len(seen) - len(inside) == E * nn * (-(-nk // ck) * ck - nk)
    rows = [off[e + 1] - off[e] for e in range(E)]
    assert _dw_order(plan.off) == sorted(range(E),
                                            key=lambda e: (-rows[e], e))
    firsts = [walk[0][0] for walk in work[::ck] if walk]
    assert rows[firsts[0]] == max(rows)
    # round w of every cluster takes items of experts of no more rows than
    # round w - 1 of any
    by_round = {}
    for walk in work:
        for w, (e, _, _) in enumerate(walk):
            by_round.setdefault(w, []).append(rows[e])
    for w in range(1, len(by_round)):
        assert max(by_round[w]) <= min(by_round[w - 1])
    for c in range(clusters):
        blocks = work[c * ck:(c + 1) * ck]
        assert len({len(b) for b in blocks}) == 1
        for items in zip(*blocks):
            assert len({e for e, _, _ in items}) == 1
            assert len({nt for _, _, nt in items}) == 1    # dY's boxes
            assert [kt % ck for _, kt, _ in items] == list(range(ck))


@pytest.mark.parametrize("blocks", [1, 7, 132, 264])
@pytest.mark.parametrize("T,K,N,E,kind", [
    (32800, 1536, 512, 40, "sorted"), (600, 136, 40, 8, "unsorted"),
    (300, 72, 200, 6, "out-of-range"), (100, 256, 512, 1, "sorted")],
    ids=str)
def test_dx_work_takes_every_tile_once(T, K, N, E, kind, blocks):
    """dX's work list: every (row tile, column tile) of the plan's tiles
    once over the blocks, each block's in increasing order, the column
    tile fastest."""
    g = _ids(kind, T, E, np.random.default_rng(T + K))
    plan = gmm.plan(torch.from_numpy(g), E)
    s = gmm.bwd_schedule(T, K, N, E).dx
    n_tiles = int(plan.toff[-1])
    work = _dx_work(s, n_tiles, blocks)
    seen = [item for walk in work for item in walk]
    assert sorted(seen) == [(y, x) for y in range(n_tiles)
                            for x in range(s.grid[0])]
    assert all(walk == sorted(walk) for walk in work)
    assert s.grid[0] == -(-K // s.bn)


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "out-of-range",
                                  "sorted-out-of-range", "empty-expert",
                                  "stage-edge", "mixed"])
def test_dw_stages_load_runs_by_tma_and_zero_the_tail(kind):
    """Each expert's stages cut its slots into ``DW_STEP``-slot stages in
    order; a stage goes by TMA (a first x row) exactly when the rows of its
    row tile of the plan are one run of x, from the x row of its first
    slot, else it is gathered;
    only the last stage is partial, its rows past the expert (the next
    expert's, or past T, in a TMA box) zeroed.  With sorted ids every
    stage goes by TMA from its own slot; at the stage edge an expert of
    63, 64 and 65 rows takes one partial, one full, and a full and a
    one-row stage; mixed, the experts of a run go by TMA from their own
    slots, and the scattered expert of a row tile plus one is gathered but
    for its last stage, a one-row run."""
    T, E = (660, 7) if kind == "stage-edge" else (700, 6)
    g = _ids(kind, T, E, np.random.default_rng(17))
    plan = gmm.plan(torch.from_numpy(g), E)
    perm, off = plan.perm.tolist(), plan.off.tolist()
    step = _DW_STEP
    for e in range(E):
        stages = _dw_stages(plan, e)
        n = off[e + 1] - off[e]
        assert [st[0] for st in stages] == list(range(off[e], off[e + 1],
                                                      step))
        assert [st[1] for st in stages] == [min(step, n - i)
                                            for i in range(0, n, step)]
        for slot, rows, xrow in stages:
            # the stage's row tile of the plan, and whether it is one run
            t0 = off[e] + (slot - off[e]) // plan.bm * plan.bm
            t_rows = perm[t0:min(t0 + plan.bm, off[e + 1])]
            run = t_rows == list(range(t_rows[0], t_rows[0] + len(t_rows)))
            assert (xrow >= 0) == run
            if xrow >= 0:
                assert perm[slot:slot + rows] == list(range(xrow,
                                                            xrow + rows))
            if kind.startswith("sorted") or kind == "stage-edge":
                assert xrow == perm[slot]
            if kind == "sorted" or kind == "stage-edge":
                assert xrow == slot
        if kind == "empty-expert" and e == E // 2:
            assert stages == []
    if kind == "stage-edge":
        got = {off[e + 1] - off[e]: [st[1] for st in _dw_stages(plan, e)]
               for e in range(3)}
        assert got == {63: [63], 64: [64], 65: [64, 1]}
    if kind == "unsorted":
        assert any(xrow < 0 for e in range(E)
                   for _, _, xrow in _dw_stages(plan, e))
    if kind == "mixed":
        for e in (0, 1):
            assert all(xrow == slot for slot, _, xrow in _dw_stages(plan, e))
        assert off[3] - off[2] == plan.bm + 1
        tail = _dw_stages(plan, 2)
        assert [xrow >= 0 for _, _, xrow in tail] == \
            [False] * (len(tail) - 1) + [True]
        assert tail[-1][1] == 1


# ---------------------------------------------------------------------------
# the CUDA branch of the wrappers, through a faked library on meta tensors
# ---------------------------------------------------------------------------

def _meta_plan(T, E):
    """A plan of the right shapes on the meta device."""
    meta = dict(dtype=torch.int32, device="meta")
    return gmm.Plan(torch.empty(T, **meta), torch.empty(E + 2, **meta),
                    torch.empty(E + 2, **meta),
                    torch.empty((gmm.tile_bound(T, E), 4), **meta),
                    gmm.row_tile(T, E))


@pytest.fixture
def faked_card(monkeypatch):
    """The CUDA branches of ``moe_gmm`` and ``moe_gmm_bwd`` up to their
    launches, on meta tensors: the library records each call.  The
    wrappers' launch counts are restored afterwards, so no other test in
    the process sees the faked launches.  The shape-only path, which a
    meta tensor takes otherwise (``kernels.shape_only``), is turned off
    so that the CUDA branch runs."""
    calls = []
    monkeypatch.setattr(shape_only, "active", lambda *tensors: False)
    for fn in (gmm.moe_gmm, gmm.moe_gmm_bwd, gmm.plan):
        monkeypatch.setattr(fn, "launches", fn.launches)

    class Lib:
        def moe_gmm_fwd(self, *args):
            calls.append(("fwd", args))
            return 0

        def moe_gmm_bwd(self, *args):
            calls.append(("bwd", args))
            return 0
    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(gmm, "_check", lambda *a: None)
    monkeypatch.setattr(gmm, "_check_plan", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("dtype,K,N,path", [
    (torch.bfloat16, 1536, 512, "wgmma"), (torch.bfloat16, 512, 1536,
                                           "wgmma"),
    (torch.bfloat16, 40, 23, "generic"), (torch.float32, 64, 96, "generic")])
def test_cuda_grad_goes_through_the_backward_kernels(faked_card, dtype, K, N,
                                                     path):
    """On CUDA an input that requires grad (in grad mode) takes ``_Gmm``,
    whose backward launches ``moe_gmm_bwd`` once on the forward's plan
    with ``bwd_schedule``'s path and dX tiles, both gradients asked for,
    and counts it; under no_grad the product launches alone."""
    T, E = 4100 * 8, 40
    meta = dict(device="meta")
    x = torch.empty((T, K), dtype=dtype, **meta).requires_grad_(True)
    w = torch.empty((E, K, N), dtype=dtype, **meta).requires_grad_(True)
    ids = torch.empty(T, dtype=torch.int32, **meta)
    plan = _meta_plan(T, E)
    with torch.no_grad():
        gmm.moe_gmm(x, w, ids, plan)
    assert [c[0] for c in faked_card] == ["fwd"]
    fwd, bwd = gmm.moe_gmm.launches, gmm.moe_gmm_bwd.launches
    with torch.enable_grad():
        out = gmm.moe_gmm(x, w, ids, plan)
    assert out.requires_grad and out.grad_fn.name().startswith("_Gmm")
    dx, dw = torch.autograd.grad(out, (x, w), torch.empty_like(out))
    assert dx.shape == x.shape and dw.shape == w.shape
    assert [c[0] for c in faked_card] == ["fwd", "fwd", "bwd"]
    s = gmm.bwd_schedule(T, K, N, E, dtype)
    args = faked_card[-1][1]
    # dx and dw both written; then T, K, N, E, dtype, path, dX's bm, bn,
    # tiles and the stream
    assert args[3] is not None and args[4] is not None
    assert args[9:] == (T, K, N, E, gmm._DTYPES[dtype],
                        0 if path == "wgmma" else 1, s.dx.bm, s.dx.bn,
                        s.dx.tiles, 0)
    assert s.path == path
    assert (gmm.moe_gmm.launches, gmm.moe_gmm_bwd.launches) == (fwd + 1,
                                                                bwd + 1)


def test_cuda_backward_skips_the_gradient_not_wanted(faked_card):
    """Frozen weights: only dX is written (dw's pointer is null)."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    T, K, N, E = 256, 64, 128, 4
    x = torch.empty((T, K), **meta).requires_grad_(True)
    w = torch.empty((E, K, N), **meta)
    ids = torch.empty(T, dtype=torch.int32, device="meta")
    with torch.enable_grad():
        out = gmm.moe_gmm(x, w, ids, _meta_plan(T, E))
    (dx,) = torch.autograd.grad(out, (x,), torch.empty_like(out))
    args = faked_card[-1][1]
    assert faked_card[-1][0] == "bwd" and args[3] is not None \
        and args[4] is None


# ---------------------------------------------------------------------------
# the MoE layer's gradient, and arctic-reduced's whole loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b"])
def test_moe_layer_gradients_match_jax_vjp(arch):
    """In f32, the layer's input gradient and each parameter's against
    ``jax.vjp`` of ``moe_apply`` for the same cotangents of y and of the
    aux loss.  On identical inputs no token may route otherwise
    (``tests/test_torch_moe_model.py``'s layer margin); the gradient of
    x sums the gate and up products' dX (and the dispatch gather's
    scatter), as JAX sums the cotangents of its two uses."""
    jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jmoe.moe_init(jcfg, jax.random.PRNGKey(3)))
    layer = moe.MoE(tcfg, "cpu").to(torch.float32)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.from_numpy(np.array(_np(jp[name]))))
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 16, tcfg.d_model), dtype=np.float32)
    cot = rng.standard_normal(x.shape, dtype=np.float32)
    (jy, jaux), vjp = jax.vjp(lambda p, a: jmoe.moe_apply(p, jcfg, a), jp,
                              jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(cot), jnp.float32(0.7)))
    tx = torch.from_numpy(x).requires_grad_(True)
    layer.requires_grad_(True)
    y, aux = layer(tx, tcfg)
    with torch.no_grad():
        _, _, top_i = moe.route(layer.router, tcfg,
                                 tx.reshape(-1, tcfg.d_model))
    jtop = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x).reshape(-1, tcfg.d_model) @ jp["router"], -1),
        tcfg.top_k)[1])
    assert all(set(a) == set(b) for a, b in zip(top_i.numpy(), jtop))
    leaves = [tx, *layer.parameters()]
    grads = torch.autograd.grad((y, aux), leaves,
                                (torch.from_numpy(cot), torch.tensor(0.7)))
    names = ["x"] + [n for n, _ in layer.named_parameters()]
    want = {"x": jgx, **jgp}
    for name, got in zip(names, grads):
        w = _np(want[name])
        np.testing.assert_allclose(_np(got), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)


def test_arctic_reduced_loss_and_grads_match_jax():
    """arctic-480b-reduced (the MoE beside a dense residual MLP, top-2 of
    8) in f32: the loss and every parameter's gradient against the JAX
    package's jitted ``value_and_grad(loss_fn)`` on the same weights and
    batch, the port through its plain versions."""
    arch = "arctic-480b"
    jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, jparams)
    params = convert.from_jax_params(tree, tcfg, device="cpu",
                                     dtype=torch.float32)
    params.requires_grad_(True)
    toks = SyntheticTokens(jcfg.vocab, seed=5).batch(0, 0, 2, 32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b)))(jparams,
                                               {"tokens": jnp.asarray(toks)})
    loss = lm.loss_fn(params, tcfg, {"tokens": torch.from_numpy(toks)})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    want = dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jgrads), tcfg, device="cpu",
        dtype=torch.float32).named_parameters())
    n = 0
    for name, p in params.named_parameters():
        w = _np(want[name])
        if p.grad is None:
            assert not w.any(), name
            continue
        np.testing.assert_allclose(_np(p.grad), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max() + 1e-30,
                                   err_msg=name)
        n += 1
    assert n > 0 and any("moe" in name for name, _ in
                         params.named_parameters())
