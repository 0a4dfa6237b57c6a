"""The backward of the port's two training kernels in their plain
versions (the CPU path of ``flash_attention_bwd`` and ``burst_gather_bwd``,
autograd through ``ref.py``) against JAX's gradients of the JAX package's
refs, on the CPU; plain-torch models of the CUDA kernels' schedules (the
attention backward's tile loops, with the tile rows read from the CUDA
source; the gather backward's counting sort and segmented sum); and the
rule of the wrappers that have no backward kernel.  The CUDA kernels
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


def _gather_bwd_model(dout, idx, R, seed=0):
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
    ones.  The table starts as NaN, so a row no item wrote shows."""
    N, D = dout.shape
    rows = torch.where((idx >= 0) & (idx < R), idx.long(), R)
    order = torch.sort(rows, stable=True)
    perm, srows = order.indices.tolist(), order.values.tolist()
    segs = []
    for j, r in enumerate(srows):
        if r < R and (j == 0 or srows[j - 1] != r):
            segs.append([r, j, 0])
        if r < R:
            segs[-1][2] += 1
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


def test_gather_bwd_id_limit_is_the_sorts():
    """The wrapper's id limit is what the one sorting block holds
    (``SORT_MAX`` of csrc/burst_gather.cu: 1024 threads x 16 ids)."""
    assert bg.BWD_MAX_IDS == _gather_src_int("SORT_MAX") == \
        _gather_src_int("SORT_T") * 16


# ---------------------------------------------------------------------------
# the bf16 passes on the tensor cores (flash_bwd_kv_wg, flash_bwd_dq_wg)
# ---------------------------------------------------------------------------

def _wg_tiles():
    """``BwdWgCfg``'s BM (a warpgroup's own rows) and BN (rows of a
    streamed tile), and ``kLsePad``, from csrc/flash_attention.cu."""
    src = open(os.path.join(_CSRC, "flash_attention.cu")).read()
    cfg = src[src.index("struct BwdWgCfg {"):]
    bm = int(re.search(r"static constexpr int BM = (\d+);", cfg).group(1))
    bn = int(re.search(r"static constexpr int BN = (\d+);", cfg).group(1))
    pad = int(re.search(r"constexpr int kLsePad = (\d+);", src).group(1))
    return bm, bn, pad


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
#: its scale, Sq != Skv both ways, a ragged head size and a group of 16
WG_CASES = {
    "causal-ragged-d24": ((1, 150, 150, 4, 2, 24), dict(causal=True)),
    "window-40": ((1, 200, 200, 2, 1, 32), dict(causal=True, window=40)),
    "softcap-window-100": ((1, 200, 200, 4, 2, 16),
                           dict(causal=True, window=100, softcap=50.0,
                                scale=1 / 12)),
    "cross-70x130": ((2, 70, 130, 4, 1, 16), dict(causal=False)),
    "causal-130x70": ((1, 130, 70, 2, 2, 16), dict(causal=True)),
    "group-16": ((1, 130, 130, 16, 1, 8), dict(causal=True)),
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
    bm, bn, _ = _wg_tiles()
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
    bm, bn, pad = _wg_tiles()
    assert fa.BWD_ROW_PAD == pad and pad % bm == 0 and pad % bn == 0
