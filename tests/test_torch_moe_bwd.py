"""The grouped matmul's gradient (``moe_gmm_bwd``) and the MoE layer's, on
the CPU, against the JAX package.

``moe_gmm_bwd`` on the CPU is autograd through the plain version: it is
held to ``jax.vjp`` of ``repro.kernels.ref.moe_gmm_ref`` on numpy-seeded
inputs, with sorted, unsorted and out-of-range ids and an expert that no
row takes.  On the card its kernels run on ``moe_gmm.bwd_schedule``: dX
on the forward's kernels with K and N swapped (w read transposed), dW a
block a (K tile, N tile, expert) that walks the expert's rows of the plan
in order.  No CUDA kernel runs here, so this file checks that schedule
(every dX output once, every dW element once, the tiles read from
``csrc/moe_gmm.cu``), holds a plain-torch model of the dW kernels' walk
(f32 sums a step of rows at a time, zeros for an expert with no row)
to the plain gradient and JAX's, follows the CUDA branch of the wrappers
through a faked library on meta tensors, and holds the MoE layer's
gradients, and arctic-480b-reduced's whole loss and gradients, to JAX's.
``chip_smoke.py`` holds the kernels to the plain version on the card.

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


def _ids(kind, T, E, rng):
    """(T,) int32 ids: "sorted", "unsorted", "out-of-range" (unsorted,
    some below 0 and some at or above E) or "empty-expert" (unsorted, no
    row of expert E // 2)."""
    lo, hi = (-2, E + 3) if kind == "out-of-range" else (0, E)
    g = rng.integers(lo, hi, T).astype(np.int32)
    if kind == "empty-expert":
        g[g == E // 2] = (E // 2 + 1) % E
    return np.sort(g) if kind == "sorted" else g


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


def _dw_step(path, dtype):
    """Rows of an expert a dW block takes a step: ``GBK`` of the wgmma
    kernel, ``WBK`` (bf16) or ``FBK`` (f32) of the generic ones."""
    if path == "wgmma":
        return _const("GBK")
    return _const("WBK" if dtype == torch.bfloat16 else "FBK")


def test_bwd_constants_are_the_kernels():
    """The dW tile is the kernel's; dX launches the forward's wgmma tiles,
    transposed."""
    assert gmm.DW_TILE == (_const("DW_BK"), _const("DW_BN"))
    src = (CSRC / "moe_gmm.cu").read_text()
    back = src[re.search(r"^// -+ backward", src, re.M).start():]
    tiles = {int(m): int(n) for m, n in re.findall(
        r"if \(bm == (\d+) && bn == (\d+)\)\n\s+return launch_wgmma<\1, \2, "
        r"4, 1>", back)}
    assert tiles == gmm.WGMMA_TILES


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


def _dw_model(x, dy, ids, E, dtype):
    """The dW kernels' arithmetic in plain torch, on the plain plan and
    ``bwd_schedule``'s tiles: each block sums its expert's rows a step at
    a time in slot order, x^T dY of the step added to an f32 accumulator,
    rounded once; an expert with no row gets the zeros its block writes.
    The table starts as NaN, so an element no block wrote shows."""
    T, K = x.shape
    N = dy.shape[1]
    plan = gmm.plan(ids, E)
    s = gmm.bwd_schedule(T, K, N, E, dtype)
    dw = torch.full((E, K, N), float("nan"))
    for e, ks, ns, steps in _dw_blocks(plan, s, K, N, E, dtype):
        acc = torch.zeros((len(ks), len(ns)))
        for rows in steps:
            r = torch.tensor(rows, dtype=torch.long)
            acc += x[r][:, ks.start:ks.stop].float().T @ \
                dy[r][:, ns.start:ns.stop].float()
        dw[e, ks.start:ks.stop, ns.start:ns.stop] = acc
    return dw.to(x.dtype)


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "empty-expert"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_model_is_the_plain_gradient(dtype, kind):
    """The model of the dW kernels' walk equals the plain gradient and
    JAX's within the dtype's tolerance, on the wgmma tiles (bf16: K and N
    multiples of 8, more rows an expert than one step) and the generic
    ones (f32), with exact zeros for the expert no row takes."""
    shape = (700, 136, 264, 5)
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
    launches, on meta tensors: the library records each call."""
    calls = []

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
    assert args[8:] == (T, K, N, E, gmm._DTYPES[dtype],
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
