"""The backward of the port's two training kernels in their plain
versions (the CPU path of ``flash_attention_bwd`` and ``burst_gather_bwd``,
autograd through ``ref.py``) against JAX's gradients of the JAX package's
refs, on the CPU; plain-torch models of the CUDA kernels' schedules (the
attention backward's tile loops, with the tile rows read from the CUDA
source; the gather backward's sort, one block's or past ``SORT_MAX`` ids
the multi-block one, and its segmented sum); the rule of the wrapper
that has no backward kernel; which backward path ``mamba2_scan_bwd`` and
``burst_gather_bwd`` launch (through a faked library on meta tensors);
and, from the CUDA sources, that the scans' and the grouped matmul's
backward call no atomic and rwkv6's no logarithm.  The CUDA kernels
themselves are held to these plain versions on the card by
``chip_smoke.py``.

Tolerances: 2e-2 in bf16 and 2e-5 in f32, ``tests/test_kernels.py``'s
(the same math; sums in other orders, and in bf16 the roundings of two
frameworks); the gather's f32 scatter-add within 1e-6; the f32 attention
model within 1e-4 (its f32 sums taken tile by tile over up to 200 keys);
the bf16 attention model (the tensor-core passes: bf16 operands, P and dS
rounded to bf16) within the bf16 2e-2; the gather model exactly.
"""
import math
import os
import re

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import burst_gather as bg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import shape_only  # noqa: E402
from repro_torch.kernels._grad import refuse_grad  # noqa: E402


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


#: (B, Sq, Skv, Hq, Hkv, D), kwargs of each attention backward case
ATTN_CASES = {
    "causal-gqa": ((2, 19, 19, 4, 2, 16), dict(causal=True)),
    "window": ((1, 33, 33, 4, 1, 24), dict(causal=True, window=8)),
    "softcap-scale": ((2, 17, 17, 8, 4, 16),
                      dict(causal=True, softcap=50.0, scale=1 / 12)),
    "cross": ((2, 9, 21, 4, 4, 32), dict(causal=False)),
    "group-16": ((1, 12, 12, 16, 1, 8), dict(causal=True)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_plain_backward_matches_jax_grad(case, dtype):
    """``flash_attention_bwd`` on the CPU (autograd through the plain
    version), and autograd through the ``flash_attention`` wrapper, against
    ``jax.vjp`` of ``repro.kernels.ref.attention_ref``."""
    shape, kw = ATTN_CASES[case]
    b, sq, skv, hq, hkv, d = shape
    rng = np.random.default_rng(list(ATTN_CASES).index(case))
    q, do = (rng.standard_normal((b, sq, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda q, k, v: jref.attention_ref(q, k, v, **kw), q, k, v)[1](do))(
        *(jnp.asarray(a, jd) for a in (q, k, v, do)))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    got = fa.flash_attention_bwd(tq, tk, tv, None, None, tdo, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    via = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves,
                              tdo)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for g, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == td and a.shape == w.shape, g
        np.testing.assert_allclose(_np(a), _np(w), rtol=tol, atol=tol,
                                   err_msg=g)
    for a, w in zip(via, got):
        assert torch.equal(a, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_plain_backward_matches_jax_grad(dtype):
    """``burst_gather_bwd`` on the CPU against ``jax.vjp`` of
    ``jnp.take``, with ids repeated (one of them by half the rows) and rows
    no id takes; it adds in the table's dtype, as the reference's VJP."""
    rng = np.random.default_rng(11)
    R, N, D = 50, 64, 24
    idx = rng.integers(0, R // 2, N).astype(np.int32)
    idx[::2] = 3
    dout = rng.standard_normal((N, D)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda t: jref.burst_gather_ref(t, jnp.asarray(idx)),
                     jnp.zeros((R, D), jd))
    (want,) = vjp(jnp.asarray(dout, jd))
    got = bg.burst_gather_bwd(torch.from_numpy(dout).to(td),
                              torch.from_numpy(idx), R)
    assert got.dtype == td and got.shape == (R, D)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    assert not _np(got)[R // 2:].any()


def test_refuse_grad_only_when_a_gradient_is_wanted():
    """The rule of the CUDA wrappers with no backward kernel: it raises
    for an input that requires grad in grad mode, and not under no_grad or
    for inputs that do not."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        refuse_grad("mamba2_scan", x, None)
    with torch.no_grad():
        refuse_grad("mamba2_scan", x)
    refuse_grad("mamba2_scan", x.detach(), None)


def _calls(module, name):
    """Whether ``module``'s source calls ``name`` (a plain call)."""
    import ast
    tree = ast.parse(open(module.__file__).read())
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               and n.func.id == name for n in ast.walk(tree))


@pytest.mark.parametrize("module,refuses", [
    ("mamba2_scan", False), ("rwkv6_scan", False), ("moe_gmm", False),
    ("flash_attention", True)])
def test_which_wrappers_refuse_a_gradient(module, refuses):
    """The scans and the grouped matmul have backward kernels
    (``_Mamba2``, ``_Rwkv6``, ``_Gmm``) and no longer call
    ``refuse_grad``; the decode attention in ``flash_attention`` still
    does; every wrapper with a backward kernel has its ``*_bwd`` and a
    ``torch.autograd.Function``."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert _calls(mod, "refuse_grad") == refuses
    if not refuses:
        assert callable(getattr(mod, f"{module}_bwd"))
        assert any(isinstance(v, type)
                   and issubclass(v, torch.autograd.Function)
                   for v in vars(mod).values())


# ---------------------------------------------------------------------------
# models of the CUDA backward kernels' schedules, in plain torch
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "csrc")


def _bwd_rows(dp):
    """``BwdCfg<DP>::R`` of csrc/flash_attention.cu: the rows of a query
    tile and of a key tile of the backward kernels."""
    src = open(os.path.join(_CSRC, "flash_attention.cu")).read()
    m = re.search(r"static constexpr int R = DP > (\d+) \? (\d+) : (\d+);",
                  src)
    limit, small, large = (int(g) for g in m.groups())
    return small if dp > limit else large


def _scores(q, k, qs, ks, causal, window, softcap, scale):
    """x (capped, scaled scores), dx/ds and the mask of the pairs (qs, ks)
    of one (batch, head): q (Sq', D), k (Sk', D) in f32."""
    s = q @ k.T
    x, dx = s * scale, torch.full_like(s, scale)
    if softcap is not None:
        t = torch.tanh(x / softcap)
        x, dx = t * softcap, scale * (1 - t * t)
    ok = torch.ones_like(s, dtype=torch.bool)
    if causal:
        ok &= ks[None, :] <= qs[:, None]
    if window is not None:
        ok &= ks[None, :] > qs[:, None] - window
    return x, dx, ok


def _flash_bwd_model(q, k, v, do, *, causal, window, softcap, scale, R):
    """The kernels' two passes, tile by tile: delta = rowsum(dO o O), then
    for each (KV tile, KV head) the group's heads and the query tiles its
    keys can see (dK, dV), and for each (query tile, head) the KV tiles
    its rows can see (dQ), with the same tile bounds as the kernels.
    Returns (dq, dk, dv) and the number of (query, key) pairs each pass
    let through, which must be every valid pair once."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    # the forward's o and log-sum-exp
    lse = torch.empty((B, Hq, Sq))
    o = torch.empty_like(qf)
    qs_all, ks_all = torch.arange(Sq), torch.arange(Skv)
    for b in range(B):
        for h in range(Hq):
            x, _, ok = _scores(qf[b, :, h], kf[b, :, h // g], qs_all, ks_all,
                               causal, window, softcap, scale)
            x = x.masked_fill(~ok, -torch.inf)
            lse[b, h] = torch.logsumexp(x, -1)
            o[b, :, h] = torch.softmax(x, -1).nan_to_num(0.0) @ vf[b, :, h // g]
    delta = (dof * o).sum(-1).permute(0, 2, 1)           # (B, Hq, Sq)
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    seen_kv = seen_q = 0
    for b in range(B):
        for hk in range(Hkv):
            for k0 in range(0, Skv, R):
                ks = torch.arange(k0, min(k0 + R, Skv))
                qbeg = k0 // R * R if causal else 0
                qend = Sq if window is None else min(Sq, k0 + R - 1 + window)
                for h in range(hk * g, hk * g + g):
                    for qt0 in range(qbeg, qend, R):
                        qs = torch.arange(qt0, min(qt0 + R, Sq))
                        x, dx, ok = _scores(qf[b, qs, h], kf[b, ks, hk], qs,
                                            ks, causal, window, softcap,
                                            scale)
                        p = torch.where(ok, torch.exp(x - lse[b, h, qs, None]),
                                        0.0)
                        dp = dof[b, qs, h] @ vf[b, ks, hk].T
                        ds = p * (dp - delta[b, h, qs, None]) * dx
                        dv[b, ks, hk] += p.T @ dof[b, qs, h]
                        dk[b, ks, hk] += ds.T @ qf[b, qs, h]
                        seen_kv += int(ok.sum())
        for h in range(Hq):
            for q0 in range(0, Sq, R):
                qs = torch.arange(q0, min(q0 + R, Sq))
                kend = min(Skv, min(q0 + R, Sq)) if causal else Skv
                kbeg = max(0, q0 - window + 1) // R * R if window else 0
                for kt0 in range(kbeg, kend, R):
                    ks = torch.arange(kt0, min(kt0 + R, kend))
                    x, dx, ok = _scores(qf[b, qs, h], kf[b, ks, h // g], qs,
                                        ks, causal, window, softcap, scale)
                    p = torch.where(ok, torch.exp(x - lse[b, h, qs, None]),
                                    0.0)
                    dp = dof[b, qs, h] @ vf[b, ks, h // g].T
                    dq[b, qs, h] += (p * (dp - delta[b, h, qs, None])
                                     * dx) @ kf[b, ks, h // g]
                    seen_q += int(ok.sum())
    return (dq, dk, dv), seen_kv, seen_q


#: (B, Sq, Skv, Hq, Hkv, D), kwargs: tiles of 64 (32 at D = 256) cut by
#: the causal diagonal, by windows narrower and wider than a tile, ragged
#: ends, Sq != Skv and a group of 4
MODEL_CASES = {
    "causal-ragged": ((1, 150, 150, 4, 2, 16), dict(causal=True)),
    "window-8": ((1, 150, 150, 2, 1, 16), dict(causal=True, window=8)),
    "window-100-softcap": ((1, 200, 200, 2, 2, 16),
                           dict(causal=True, window=100, softcap=50.0,
                                scale=1 / 12)),
    "cross-70x130": ((2, 70, 130, 4, 1, 16), dict(causal=False)),
    "d256-causal": ((1, 100, 100, 2, 1, 256), dict(causal=True)),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_flash_bwd_schedule_model_matches_the_plain_backward(case):
    """A plain-torch model of ``flash_bwd_dkdv`` / ``flash_bwd_dq``'s tile
    loops (tile rows read from the CUDA source) gives the plain
    version's gradients, and each pass visits every valid (query, key)
    pair exactly once."""
    (b, sq, skv, hq, hkv, d), kw = MODEL_CASES[case]
    rng = np.random.default_rng(list(MODEL_CASES).index(case) + 40)
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, hq, d)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, hkv, d)).astype(
        np.float32)) for _ in range(2))
    full = dict(causal=kw["causal"], window=kw.get("window"),
                softcap=kw.get("softcap"), scale=kw.get("scale", d ** -0.5))
    got, seen_kv, seen_q = _flash_bwd_model(q, k, v, do, R=_bwd_rows(d),
                                            **full)
    want = fa.flash_attention_bwd(q, k, v, None, None, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    _, _, ok = _scores(q[0, :, 0], k[0, :, 0], torch.arange(sq),
                       torch.arange(skv), full["causal"], full["window"],
                       None, 1.0)
    assert seen_kv == seen_q == int(ok.sum()) * b * hq


def _gather_src_int(name):
    """An ``int`` constant of csrc/burst_gather.cu."""
    src = open(os.path.join(_CSRC, "burst_gather.cu")).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _gather_bwd_model(dout, idx, R, seed=0, sort=None):
    """``burst_gather_bwd``'s two kernels.  bwd_sort: a stable sort of
    the ids' rows (an id outside [0, R) as row R) with their positions, so
    each row's positions come out in increasing order; the taken rows'
    segments (row, first, count) in classes of floor(log2(count)), largest
    first, in an order within a class that varies from run to run (drawn
    from ``seed`` here); the bitmap of taken rows.  bwd_write: the summing
    items, one a (segment, column slice of 32 lanes x 16 bytes) for a row
    taken 2^HEAVY times or more, one a segment (all its slices in turn) for
    a lighter row, one a (segment, 32 columns) where rows are not 16-byte
    aligned, each slice the sum of its rows in f32 from 0 in position order
    rounded once; then runs of ZERO_BYTES of rows, zeroed but for the taken
    ones.  The table starts as NaN, so a row no item wrote shows.
    ``sort`` (idx, R) -> (sorted positions, segments) stands in for the
    sort kernels: ``bwd_sort``'s by default, past ``SORT_MAX`` ids the
    multi-block path's (``_multi_block_sort``)."""
    N, D = dout.shape
    perm, segs = (sort or _one_block_sort)(idx, R)
    perm, segs = perm.tolist(), [list(sg) for sg in segs]
    rng = np.random.default_rng(seed)
    rng.shuffle(segs)
    segs.sort(key=lambda sg: -int(np.log2(sg[2])))   # stable: by class
    taken = torch.zeros(R, dtype=torch.bool)
    for r, _, _ in segs:
        taken[r] = True
    size = dout.element_size()
    vec = D * size % 16 == 0
    width = 32 * 16 // size if vec else 32
    slices = [range(c0, min(D, c0 + width)) for c0 in range(0, D, width)]
    heavy = 2 ** _gather_src_int("HEAVY")
    items = [(sg, [sl]) for sg in segs if sg[2] >= heavy or not vec
             for sl in slices]
    items += [(sg, slices) for sg in segs if sg[2] < heavy and vec]
    out = torch.full((R, D), float("nan"), dtype=dout.dtype)
    for (r, first, cnt), item_slices in items:
        for cols in item_slices:
            cols = list(cols)
            acc = torch.zeros(len(cols), dtype=torch.float32)
            for p in perm[first:first + cnt]:
                acc = acc + dout[p, cols].float()
            out[r, cols] = acc.to(dout.dtype)
    zr = max(1, _gather_src_int("ZERO_BYTES") // (D * size))
    for r0 in range(0, R, zr):
        for r in range(r0, min(R, r0 + zr)):
            if not taken[r]:
                out[r] = 0
    return out


@pytest.mark.parametrize("dtype,D", [("float32", 12), ("bfloat16", 12),
                                     ("bfloat16", 64)])
def test_gather_bwd_model_is_the_sequential_f32_sum(dtype, D):
    """The model of the kernels equals a sequential f32 ``index_add_``
    rounded once, bit for bit (what ``chip_smoke.py`` holds the kernels
    to), with repeated ids, one id taken by a third of the rows, ids
    outside [0, R), which add to no row, rows 16-byte aligned or not, and
    for any order of the summing items within a class."""
    rng = np.random.default_rng(17)
    R, N = 40, 90
    idx = torch.from_numpy(rng.integers(-3, R + 3, N).astype(np.int32))
    idx[::3] = 5
    dout = torch.from_numpy(rng.standard_normal((N, D)).astype(
        np.float32)).to(getattr(torch, dtype))
    keep = (idx >= 0) & (idx < R)
    want = torch.zeros((R, D)).index_add_(
        0, idx[keep].long(), dout[keep].float()).to(dout.dtype)
    for seed in range(3):
        assert torch.equal(_gather_bwd_model(dout, idx, R, seed), want)


@pytest.mark.parametrize("N,path", [
    (0, "one_block"), (4100, "one_block"), (16384, "one_block"),
    (16385, "multi_block"), (16400, "multi_block"), (32800, "multi_block")])
def test_gather_bwd_id_limit_is_the_sorts(monkeypatch, N, path):
    """The one-block sort's limit is what its block holds (``SORT_MAX`` of
    csrc/burst_gather.cu: 1024 threads x 16 ids); the wrapper sends more
    ids to the multi-block path (the library's ``multi`` argument), sizes
    the scratch by ``bwd_scratch_ints`` (the library's layout, its state
    ``STATE`` ints), passes that size for the library to check, and
    counts the launch on its path."""
    import contextlib
    import types

    from repro_torch.kernels import _build
    assert bg.SORT_MAX == _gather_src_int("SORT_MAX") == \
        _gather_src_int("SORT_T") * 16
    assert bg.bwd_path(N) == path
    assert bg.WRITER_STATE == _gather_src_int("STATE")
    calls = []

    class Lib:
        def burst_gather_bwd(self, *args):
            calls.append(args)
            return 0
    # the CUDA branch, not the shape-only path a meta tensor takes
    monkeypatch.setattr(shape_only, "active", lambda *tensors: False)
    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(bg, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    meta = dict(device="meta")
    dout = torch.empty((N, 64), dtype=torch.bfloat16, **meta)
    idx = torch.empty(N, dtype=torch.int32, **meta)
    counts = (bg.burst_gather_bwd.launches,
              bg.burst_gather_bwd.one_block_launches,
              bg.burst_gather_bwd.multi_block_launches)
    dtable = bg.burst_gather_bwd(dout, idx, 4100)
    multi = path == "multi_block"
    assert dtable.shape == (4100, 64) and len(calls) == 1
    # rows, N, D, dtype, the path, the scratch and its size, SMs, stream
    args = calls[0]
    assert args[3:8] == (4100, N, 64, 0, int(multi))
    size = 4 * min(N, 4100) + N + 129 + 5
    if multi:
        size += -(-N // 16384) * 4101 + 3 * N
    assert args[9:] == (size, 132, 0) == (bg.bwd_scratch_ints(4100, N, multi),
                                          132, 0)
    assert (bg.burst_gather_bwd.launches,
            bg.burst_gather_bwd.one_block_launches,
            bg.burst_gather_bwd.multi_block_launches) == (
        counts[0] + 1, counts[1] + (not multi), counts[2] + multi)


def test_gather_bwd_raises_where_the_library_refuses_the_ids(monkeypatch):
    """Ids whose counts or offsets would not fit an int32 raise before any
    launch, by the scratch rule the library checks (``bwd_scratch_ints``),
    on the card's path and on the shape-only path alike: 20,000 ids take
    two chunks of the multi-block sort, whose counts over 2^30 rows pass
    2^31 ints, where 10 rows fit."""
    from repro_torch.kernels import _build

    class Lib:
        def burst_gather_bwd(self, *args):
            raise AssertionError("launched")
    monkeypatch.setattr(_build, "load", lambda name: Lib())
    dout = torch.empty((20000, 8), dtype=torch.float32, device="meta")
    idx = torch.empty(20000, dtype=torch.int32, device="meta")
    assert bg.bwd_scratch_ints(10, 20000, True) == \
        4 * 10 + 20000 + 1 + 5 + 2 * 11 + 3 * 20000
    with pytest.raises(ValueError, match="multi_block sort's int32"):
        bg.bwd_scratch_ints(2 ** 30, 20000, True)
    for card in (False, True):
        monkeypatch.setattr(shape_only, "active",
                            lambda *tensors, card=card: not card)
        with pytest.raises(ValueError, match="multi_block sort's int32"):
            bg.burst_gather_bwd(dout, idx, 2 ** 30)


def _one_block_sort(idx, R):
    """``bwd_sort``'s order: a stable sort of the ids' rows (an id outside
    [0, R) as row R) with their positions; the taken rows' segments (row,
    first slot, count) in row order."""
    rows = torch.where((idx >= 0) & (idx < R), idx.long(), R)
    order = torch.sort(rows, stable=True)
    counts = torch.bincount(rows, minlength=R + 1)[:R]
    first = torch.cumsum(counts, 0) - counts
    return order.indices, [(r, int(first[r]), int(counts[r]))
                           for r in torch.nonzero(counts)[:, 0].tolist()]


def _multi_block_sort(idx, R, chunk):
    """``bwd_chunk_sort`` then ``bwd_merge``: each chunk of ``chunk`` ids
    sorted stably on its own, with each sorted id's rank among the
    chunk's ids of its row, and the chunk's count of each row in [0, R];
    an exclusive scan of the counts over the rows and, within a row, over
    the chunks in order gives each (chunk, row) its first slot; each id
    goes to its slot plus its rank.  Returns the sorted positions and the
    taken rows' segments (row, first slot, count) in row order."""
    N = idx.numel()
    rows = torch.where((idx >= 0) & (idx < R), idx.long(), R)
    nc = -(-N // chunk)
    hist = torch.zeros((nc, R + 1), dtype=torch.long)
    ckey, cpos, crank = (torch.empty(N, dtype=torch.long) for _ in range(3))
    for c in range(nc):
        sl = slice(c * chunk, min(N, (c + 1) * chunk))
        order = torch.sort(rows[sl], stable=True)
        key = order.values
        ckey[sl], cpos[sl] = key, order.indices + c * chunk
        crank[sl] = torch.arange(key.numel()) - torch.searchsorted(key, key)
        hist[c] = torch.bincount(key, minlength=R + 1)
    flat = hist.t().reshape(-1)                  # (row, chunk) order
    slot = (torch.cumsum(flat, 0) - flat).view(R + 1, nc).t()
    perm = torch.full((N,), -1, dtype=torch.long)
    perm[slot[torch.arange(N) // chunk, ckey] + crank] = cpos
    counts = hist.sum(0)[:R]
    return perm, [(r, int(slot[0, r]), int(counts[r]))
                  for r in torch.nonzero(counts)[:, 0].tolist()]


#: (N, rows, ids): at the one-block limit and either side of it, the MoE
#: dispatch's 32,800 ids (each of 4,100 rows 8 times) and one row taken by
#: every id, with ids outside [0, R) mixed in
SORT_CASES = [(16383, 3000, "spread"), (16384, 2048, "each-8"),
              (16385, 3000, "spread"), (32800, 4100, "each-8"),
              (32800, 4100, "one-row"), (20000, 500, "out-of-range")]


def _sort_ids(N, R, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "each-8":
        idx = np.repeat(np.arange(N // 8), 8)
        return torch.from_numpy(idx.astype(np.int32) % R)
    if kind == "one-row":
        return torch.full((N,), 7, dtype=torch.int32)
    lo, hi = (-3, R + 3) if kind == "out-of-range" else (0, R)
    return torch.from_numpy(rng.integers(lo, hi, N).astype(np.int32))


@pytest.mark.parametrize("N,R,kind", SORT_CASES, ids=str)
def test_gather_bwd_multi_block_sort_is_the_one_block_sort(N, R, kind):
    """The multi-block sort, on chunks of ``SORT_MAX`` ids (read from the
    source), gives a stable argsort of the rows (each row's positions in
    increasing order) and the same segments as the one-block sort."""
    idx = _sort_ids(N, R, kind, seed=N + R)
    perm, segs = _multi_block_sort(idx, R, _gather_src_int("SORT_MAX"))
    want_perm, want_segs = _one_block_sort(idx, R)
    assert torch.equal(perm, want_perm)
    assert segs == want_segs


@pytest.mark.parametrize("N,R,kind", [(16385, 3000, "spread"),
                                      (32800, 4100, "each-8"),
                                      (32800, 4100, "one-row")], ids=str)
def test_gather_bwd_multi_block_sum_is_the_sequential_f32_sum(N, R, kind):
    """``_gather_bwd_model`` on the multi-block sort's order and segments
    equals a sequential f32 ``index_add_`` rounded once, bit for bit, in
    bf16 (16-byte rows) and f32."""
    idx = _sort_ids(N, R, kind, seed=N)
    rng = np.random.default_rng(N + 1)
    for dtype, D in ((torch.bfloat16, 8), (torch.float32, 4)):
        dout = torch.from_numpy(rng.standard_normal((N, D)).astype(
            np.float32)).to(dtype)
        keep = (idx >= 0) & (idx < R)
        want = torch.zeros((R, D)).index_add_(
            0, idx[keep].long(), dout[keep].float()).to(dtype)
        got = _gather_bwd_model(dout, idx, R, sort=lambda i, r: (
            _multi_block_sort(i, r, _gather_src_int("SORT_MAX"))))
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the bf16 passes on the tensor cores (flash_bwd_kv_wg, flash_bwd_dq_wg)
# ---------------------------------------------------------------------------

def _c_value(expr, **names):
    """A constant expression of the CUDA source (integers, names, + - * /
    and one ``a ? b : c``) evaluated in Python with ``names``."""
    m = re.fullmatch(r"(.+?)\?(.+):(.+)", expr)
    if m:
        cond, yes, no = m.groups()
        return _c_value(yes if _c_value(cond, **names) else no, **names)
    return eval(expr.replace("/", "//"), {"__builtins__": {}}, names)


def _wg_cfg(dp):
    """``BwdWgCfg<DP>``'s constants from csrc/flash_attention.cu at
    ``dp``: BM (a warpgroup's own rows), BN (rows of a streamed tile), ST
    (stages), BLOCKS (blocks an SM), the passes' shared memory (smem_dv,
    smem_dk, smem_dq, bytes), and the file's ``kLsePad`` and
    ``kMaxSmem``."""
    src = _code(open(os.path.join(_CSRC, "flash_attention.cu")).read())
    body = src[src.index("struct BwdWgCfg {"):]
    body = body[:body.index("};")]
    out = {"DP": dp, "GNT": 128}
    for name, expr in re.findall(
            r"static constexpr (?:int|size_t) (\w+) =\s*([^;]+);", body):
        out[name] = _c_value(" ".join(expr.split()), **out)
    for name in ("kLsePad", "kMaxSmem"):
        out[name] = int(re.search(rf"constexpr int {name} = (\d+);",
                                  src).group(1))
    return out


def _wg_tiles(dp=128):
    """``BwdWgCfg<DP>``'s BM and BN, and ``kLsePad``."""
    cfg = _wg_cfg(dp)
    return cfg["BM"], cfg["BN"], cfg["kLsePad"]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(x):
    """A bf16 pair hi + lo for x, as the dK / dV passes' fragments."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _flash_bwd_wg_model(q, k, v, do, *, causal, window, softcap, scale, BM,
                        BN):
    """The three tensor-core passes, tile by tile, on bf16 inputs: the
    forward's o (rounded to bf16) and lse, delta = rowsum(dO o O); the dV
    pass (P^T as bf16 hi + lo into dV += P^T dO), the dK pass (dS^T as hi +
    lo into dK += dS^T Q) and the dQ pass (dS as bf16 into dQ += dS K),
    products summed in f32, each result rounded to bf16 once; with the
    kernels' tile bounds and skipped tiles.  Returns (dq, dk, dv) and the
    (query, key) pairs each pass let through."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    lse = torch.empty((B, Hq, Sq))
    o = torch.empty_like(qf)
    for b in range(B):
        for h in range(Hq):
            x, _, ok = _scores(qf[b, :, h], kf[b, :, h // g], torch.arange(Sq),
                               torch.arange(Skv), causal, window, softcap,
                               scale)
            x = x.masked_fill(~ok, -torch.inf)
            lse[b, h] = torch.logsumexp(x, -1)
            o[b, :, h] = torch.softmax(x, -1).nan_to_num(0.0) @ vf[b, :, h // g]
    delta = (dof * _bf16(o)).sum(-1).permute(0, 2, 1)     # (B, Hq, Sq)
    lse2 = lse * math.log2(math.e)

    def tile(b, h, qs, ks):
        """p and ds of the pairs (qs, ks) of (batch b, head h), masked."""
        x, dx, ok = _scores(qf[b, qs, h], kf[b, ks, h // g], qs, ks, causal,
                            window, softcap, scale)
        p = torch.where(ok, torch.exp2(x * math.log2(math.e)
                                       - lse2[b, h, qs, None]), 0.0)
        dp = dof[b, qs, h] @ vf[b, ks, h // g].T
        return p, p * (dp - delta[b, h, qs, None]) * dx, int(ok.sum())

    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    seen = dict.fromkeys(("dv", "dk", "dq"), 0)
    for b in range(B):
        for hk in range(Hkv):
            for k0 in range(0, Skv, BM):
                ks = torch.arange(k0, min(k0 + BM, Skv))
                qbeg = k0 // BN * BN if causal else 0
                qend = Sq if window is None else min(Sq, k0 + BM - 1 + window)
                for h in range(hk * g, hk * g + g):
                    for qt0 in range(qbeg, qend, BN):
                        if (causal and k0 > qt0 + BN - 1) or (
                                window is not None
                                and k0 + BM - 1 <= qt0 - window):
                            continue
                        qs = torch.arange(qt0, min(qt0 + BN, Sq))
                        p, ds, n = tile(b, h, qs, ks)
                        for name, frag, out, other in (
                                ("dv", p, dv, dof), ("dk", ds, dk, qf)):
                            hi, lo = _hi_lo(frag)
                            out[b, ks, hk] += hi.T @ other[b, qs, h] + \
                                lo.T @ other[b, qs, h]
                            seen[name] += n
        for h in range(Hq):
            for q0 in range(0, Sq, BM):
                qs = torch.arange(q0, min(q0 + BM, Sq))
                kend = min(Skv, q0 + BM, Sq) if causal else Skv
                kbeg = max(0, q0 - window + 1) // BN * BN if window else 0
                for kt0 in range(kbeg, kend, BN):
                    ks = torch.arange(kt0, min(kt0 + BN, Skv))
                    _, ds, n = tile(b, h, qs, ks)
                    dq[b, qs, h] += _bf16(ds) @ kf[b, ks, h // g]
                    seen["dq"] += n
    return tuple(_bf16(t) for t in (dq, dk, dv)), seen


#: (B, Sq, Skv, Hq, Hkv, D), kwargs: 64-row tiles cut by the causal
#: diagonal, windows narrower and wider than a tile, gemma2's softcap with
#: its scale, Sq != Skv both ways, a ragged head size and a group of 16;
#: the same modes at D 256 (gemma's head size, the passes at DP 256) and
#: at a ragged D between 128 and 256 (zero-padded to DP 256)
WG_CASES = {
    "causal-ragged-d24": ((1, 150, 150, 4, 2, 24), dict(causal=True)),
    "window-40": ((1, 200, 200, 2, 1, 32), dict(causal=True, window=40)),
    "softcap-window-100": ((1, 200, 200, 4, 2, 16),
                           dict(causal=True, window=100, softcap=50.0,
                                scale=1 / 12)),
    "cross-70x130": ((2, 70, 130, 4, 1, 16), dict(causal=False)),
    "causal-130x70": ((1, 130, 70, 2, 2, 16), dict(causal=True)),
    "group-16": ((1, 130, 130, 16, 1, 8), dict(causal=True)),
    "d256-window-40": ((1, 150, 150, 2, 1, 256),
                       dict(causal=True, window=40)),
    "d256-softcap": ((1, 130, 130, 4, 2, 256),
                     dict(causal=True, softcap=50.0, scale=1 / 12)),
    "d256-cross-70x130": ((1, 70, 130, 2, 1, 256), dict(causal=False)),
    "d256-group-16": ((1, 130, 130, 16, 1, 256), dict(causal=True)),
    "ragged-d200-window-100": ((1, 150, 150, 4, 2, 200),
                               dict(causal=True, window=100)),
}


@pytest.mark.parametrize("case", list(WG_CASES))
def test_flash_bwd_wgmma_model_matches_the_plain_backward(case):
    """A plain-torch model of the bf16 tensor-core passes (tile sizes read
    from the CUDA source; bf16 operands; P and dS rounded to bf16 where the
    kernels round them, dK's and dV's as a hi + lo pair) lands within the
    bf16 tolerance of the plain backward, and each pass visits every valid
    (query, key) pair exactly once."""
    (b, sq, skv, hq, hkv, d), kw = WG_CASES[case]
    rng = np.random.default_rng(list(WG_CASES).index(case) + 60)
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, hq, d)).astype(
        np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, hkv, d)).astype(
        np.float32)).bfloat16() for _ in range(2))
    full = dict(causal=kw["causal"], window=kw.get("window"),
                softcap=kw.get("softcap"), scale=kw.get("scale", d ** -0.5))
    bm, bn, _ = _wg_tiles(-(-d // 64) * 64 if d > 128 else 128)
    got, seen = _flash_bwd_wg_model(q, k, v, do, BM=bm, BN=bn, **full)
    want = fa.flash_attention_bwd(q, k, v, None, None, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w.float().numpy(), rtol=2e-2,
                                   atol=2e-2, err_msg=name)
    _, _, ok = _scores(q[0, :, 0].float(), k[0, :, 0].float(),
                       torch.arange(sq), torch.arange(skv), full["causal"],
                       full["window"], None, 1.0)
    assert seen == dict.fromkeys(("dv", "dk", "dq"), int(ok.sum()) * b * hq)


def test_flash_bwd_row_pad_is_the_kernels():
    """The wrapper pads the lse / delta scratch to the kernels' kLsePad,
    a whole number of the passes' 64-row blocks."""
    for dp in (64, 128, 256):
        bm, bn, pad = _wg_tiles(dp)
        assert fa.BWD_ROW_PAD == pad and pad % bm == 0 and pad % bn == 0


#: shared memory of an SM (228 KB) and what the card reserves a block
SM_SMEM, BLOCK_RESERVED = 233472, 1024


@pytest.mark.parametrize("dp", [64, 128, 256])
def test_flash_bwd_wgmma_blocks_fit_an_sm(dp):
    """Each bf16 pass's shared memory (from ``BwdWgCfg``'s own formulas)
    fits a block, and ``BLOCKS`` of them an SM; at DP 256 the dK and dQ
    passes (a resident 64 x 256 pair, a two-stage ring of two) leave room
    for one block only, at DP <= 128 for two."""
    cfg = _wg_cfg(dp)
    smem = [cfg[k] for k in ("smem_dv", "smem_dk", "smem_dq")]
    assert all(b <= cfg["kMaxSmem"] for b in smem)
    assert cfg["BLOCKS"] * (max(smem) + BLOCK_RESERVED) <= SM_SMEM
    assert cfg["BLOCKS"] == (1 if dp > 128 else 2)
    if dp > 128:
        assert 2 * (max(smem) + BLOCK_RESERVED) > SM_SMEM


def _dispatch():
    """The branches of ``flash_attention_bwd``'s C entry point: for each
    dtype code, [(largest D or None, launcher, DP)] in order, and the
    path index its launches count on, as a function of D."""
    text = _code(open(os.path.join(_CSRC, "flash_attention.cu")).read())
    body = text[text.index('extern "C" int flash_attention_bwd('):]
    body = body[:body.index("#undef BWD_ARGS")]
    out = {}
    for code, branch in re.findall(r"if \(dtype == (\d)\) \{(.*?)\n  \}",
                                   body, re.S):
        launches = [(None if lim is None or lim == "" else int(lim), fn,
                     int(dp)) for lim, fn, dp in re.findall(
            r"(?:if \(D <= (\d+)\) )?return (launch_\w+)<(?:float, )?(\d+)>",
            branch)]
        counter = re.search(r"\+\+g_bwd_launches\[([^\]]+)\];",
                            branch).group(1)
        out[int(code)] = launches, counter
    return text, out


def _c_path(counter, D):
    return fa.BWD_PATHS[_c_value(counter, D=D)]


def test_flash_bwd_dispatch_is_the_sources():
    """From csrc/flash_attention.cu: bf16 (dtype 0) at every D up to 256
    launches the wgmma passes (``launch_bwd_wg``: ``flash_bwd_kv_wg`` and
    ``flash_bwd_dq_wg`` only), 128 < D <= 256 at DP 256 and counted on
    "wgmma_d256"; f32 (dtype 1) the FMA kernels (``launch_bwd``:
    ``flash_bwd_dkdv`` and ``flash_bwd_dq`` only); the wrapper's
    ``bwd_path`` names the same path, and the ctypes code of each dtype is
    the one the source branches on."""
    text, branches = _dispatch()
    assert fa._DTYPES == {torch.bfloat16: 0, torch.float32: 1}
    for code, dtype in ((0, torch.bfloat16), (1, torch.float32)):
        launches, counter = branches[code]
        for D in range(8, 257, 8):
            lim, fn, dp = next(x for x in launches
                               if x[0] is None or D <= x[0])
            assert fn == ("launch_bwd_wg" if code == 0 else "launch_bwd")
            assert dp == (64 if D <= 64 else 128 if D <= 128 else 256)
            assert _c_path(counter, D) == fa.bwd_path(dtype, D)
    assert fa.bwd_path(torch.bfloat16, 200) == "wgmma_d256"
    assert fa.bwd_path(torch.bfloat16, 128) == "wgmma"
    assert fa.bwd_path(torch.float32, 256) == "fma"
    for launcher, kernels, never in (
            ("launch_bwd_wg", {"flash_bwd_kv_wg", "flash_bwd_dq_wg",
                               "flash_bwd_delta"},
             {"flash_bwd_dkdv", "flash_bwd_dq"}),
            ("launch_bwd", {"flash_bwd_dkdv", "flash_bwd_dq",
                            "flash_bwd_delta"},
             {"flash_bwd_kv_wg", "flash_bwd_dq_wg"})):
        start = re.search(rf"^int {launcher}\(", text, re.M).start()
        body = text[start:text.index("\n}\n", start)]
        launched = set(re.findall(r"(flash_bwd_\w+)(?:<[^<>]*>)?\s*<<<",
                                  body))
        assert launched == kernels and not launched & never, launcher


@pytest.mark.parametrize("dtype,D,path", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 112, "wgmma"),
    (torch.bfloat16, 200, "wgmma_d256"), (torch.bfloat16, 256, "wgmma_d256"),
    (torch.float32, 64, "fma"), (torch.float32, 256, "fma")])
def test_flash_bwd_cuda_branch_passes_dtype_and_head_size(monkeypatch,
                                                          dtype, D, path):
    """The CUDA branch of ``flash_attention_bwd`` (through a faked library
    on meta tensors) passes the dtype's code and D, on which the library
    picks ``path`` (``test_flash_bwd_dispatch_is_the_sources``), and
    counts one launch; ``bwd_paths`` reads the library's counts by
    ``BWD_PATHS`` index."""
    import contextlib
    import types

    from repro_torch.kernels import _build
    calls = []

    class Lib:
        def flash_attention_bwd(self, *args):
            calls.append(args)
            return 0

        def flash_attention_bwd_launches(self, path):
            return 10 + path
    monkeypatch.setattr(shape_only, "active", lambda *tensors: False)
    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    meta = dict(device="meta", dtype=dtype)
    q, o, do = (torch.empty((2, 70, 4, D), **meta) for _ in range(3))
    k, v = (torch.empty((2, 90, 2, D), **meta) for _ in range(2))
    lse = torch.empty((2, 4, 70), device="meta", dtype=torch.float32)
    n = fa.flash_attention_bwd.launches
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    # B, Sq, Skv, Hq, Hkv, D, dtype
    assert len(calls) == 1 and calls[0][10:17] == (2, 70, 90, 4, 2, D,
                                                    fa._DTYPES[dtype])
    assert fa.flash_attention_bwd.launches == n + 1
    assert fa.bwd_path(dtype, D) == path
    assert fa.bwd_paths() == {"fma": 10, "wgmma": 11, "wgmma_d256": 12}


# ---- the scans' backward: which path, and what the sources call ----------

def _scan_bwd_inputs(dtype, S, P=64, N=64, H=2):
    """Meta tensors of ``mamba2_scan_bwd``'s inputs: shapes and dtypes, no
    data, so the CUDA branch runs up to its (faked) launch on the CPU."""
    meta = dict(device="meta")
    x = torch.empty((1, S, H, P), dtype=dtype, **meta)
    dt = torch.empty((1, S, H), dtype=torch.float32, **meta)
    A = torch.empty((H,), dtype=torch.float32, **meta)
    B_ = torch.empty((1, S, N), dtype=dtype, **meta)
    C = torch.empty((1, S, N), dtype=dtype, **meta)
    dy = torch.empty((1, S, H, P), dtype=dtype, **meta)
    return x, dt, A, B_, C, dy


@pytest.mark.parametrize("dtype,S,path", [
    ("bfloat16", 64, "chunked"), ("bfloat16", 65, "chunked"),
    ("bfloat16", 1024, "chunked"), ("bfloat16", 63, "sequential"),
    ("bfloat16", 1, "sequential"), ("float32", 64, "sequential"),
    ("float32", 1024, "sequential")])
def test_mamba2_bwd_routes_by_bwd_schedule(monkeypatch, dtype, S, path):
    """``bwd_schedule`` picks the chunked backward exactly for bf16 with S
    >= ``CHUNK``; ``_Mamba2``'s backward (the CUDA branch) reaches
    ``mamba2_scan_bwd``, which launches that path (the library's
    ``chunked`` argument), sizes its scratch for it and counts the launch
    on it."""
    import contextlib
    import types

    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_scan as m2
    td = getattr(torch, dtype)
    assert m2.bwd_schedule(td, S) == path
    calls = []

    class Lib:
        def mamba2_scan_bwd(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(shape_only, "active", lambda *tensors: False)
    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(m2, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    scratch = []
    empty = torch.empty

    def record_empty(*a, **k):
        t = empty(*a, **k)
        scratch.append(t.numel())
        return t
    monkeypatch.setattr(torch, "empty", record_empty)
    x, dt, A, B_, C, dy = _scan_bwd_inputs(td, S)
    counts = (m2.mamba2_scan_bwd.launches,
              m2.mamba2_scan_bwd.chunked_launches,
              m2.mamba2_scan_bwd.sequential_launches)
    ctx = types.SimpleNamespace(saved_tensors=(x, dt, A, B_, C, None))
    grads = m2._Mamba2.backward(ctx, dy, None)
    assert len(calls) == 1 and len(grads) == 6 and grads[5] is None
    chunked = path == "chunked"
    # the path, then the cluster the scratch was sized for (H 2, P 64: one
    # slice a head, so 2 blocks a b), then the stream
    assert calls[0][-3:-1] == (int(chunked), m2.bwd_cluster(2) if chunked
                               else 1)
    assert m2.bwd_scratch_floats(1, S, 2, 64, 64, path) == scratch[-1]
    assert (m2.mamba2_scan_bwd.launches,
            m2.mamba2_scan_bwd.chunked_launches,
            m2.mamba2_scan_bwd.sequential_launches) == (
        counts[0] + 1, counts[1] + chunked, counts[2] + (not chunked))


def _code(text):
    """CUDA source text without its // comments."""
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def _backward_section(source):
    """The code of the backward part of a CUDA source: from its
    first "backward" section rule (``// ---... backward``) to the end."""
    from repro_torch.kernels import mamba2_scan as m2
    text = open(os.path.dirname(m2.__file__) + "/csrc/" + source).read()
    start = re.search(r"^// -+ backward", text, re.M)
    assert start, source
    return _code(text[start.start():])


@pytest.mark.parametrize("source", ["mamba2_scan.cu", "rwkv6_scan.cu",
                                    "moe_gmm.cu"])
def test_scan_backward_sources_take_no_float_atomics(source):
    """Two runs of the scans' and the grouped matmul's backward give the
    same bits: their sums run in a fixed order, and no backward kernel
    calls an atomic (``atomicAdd`` on floats, or any other), nor does
    ``scan_bwd.cuh``."""
    from repro_torch.kernels import mamba2_scan as m2
    header = _code(open(os.path.dirname(m2.__file__)
                        + "/csrc/scan_bwd.cuh").read())
    for code in (_backward_section(source), header):
        assert not re.search(r"\batomic\w*\s*\(", code)
        assert not re.search(r"\bred\.(?:global|shared)", code)


_C_TYPES = {"ptr": "c_void_p", "long long": "c_longlong", "int": "c_int",
            "float": "c_float"}


@pytest.mark.parametrize("source", ["flash_attention", "burst_gather",
                                    "mamba2_scan", "rwkv6_scan", "moe_gmm",
                                    "sim_sweep"])
def test_build_signatures_are_the_sources(source):
    """``_build``'s ctypes signature of each exported function is its C
    declaration's, argument by argument (a pointer or stream, ``long
    long``, ``int`` or ``float``), and every ``extern "C"`` function of
    the source has one: a wrong count would shift every argument after
    it."""
    import ctypes

    from repro_torch.kernels import _build
    text = _code((_build._CSRC / f"{source}.cu").read_text())
    found = {}
    for name, params in re.findall(
            r'extern "C" int (\w+)\(([^)]*)\)', text):
        kinds = []
        for param in params.split(","):
            param = " ".join(param.split())
            ptr = "*" in param or param.startswith("cudaStream_t ")
            kinds.append("ptr" if ptr else next(
                k for k in ("long long", "int", "float")
                if param.startswith(k + " ")))
        found[name] = [getattr(ctypes, _C_TYPES[k]) for k in kinds]
    assert found == _build._SIGNATURES[source]


def test_scan_bwd_load_counts_read_the_library(monkeypatch):
    """The scans' backward counts by load, from the library's counters:
    ``vec`` 1 is the TMA or 16-byte way, 0 the element-by-element one."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6

    class Lib:
        def mamba2_bwd_chunked_launches(self, vec):
            return 10 + vec

        def rwkv6_bwd_scan_launches(self, vec):
            return 20 + vec
    monkeypatch.setattr(_build, "load", lambda name: Lib())
    assert m2.bwd_chunked_loads() == {"tma": 11, "element": 10}
    assert r6.bwd_loads() == {"vec": 21, "element": 20}


def test_rwkv6_backward_source_takes_no_logarithm():
    """``rwkv6_bwd_scan`` walks the recurrence step by step: no logarithm
    of w (whose exact zeros and 1e-30-scale products the card's cases
    hold), in any of its CUDA spellings, and no division."""
    code = _backward_section("rwkv6_scan.cu")
    assert not re.search(r"\b(?:__)?log(?:2|10|1p|b)?f?\s*\(", code)
    assert not re.search(r"__fdividef|__frcp|\brcp", code)
