"""The chunked backward of ``mamba2_scan`` on the CPU.

On the card, the gradient of a bf16 ``mamba2_scan`` with at least
``m2.CHUNK`` steps runs ``mamba2_bwd_chunked`` (``csrc/mamba2_scan.cu``,
``m2.bwd_schedule``): a states pass (``mamba2_chunked`` writing the state
entering each chunk as its bf16 hi + lo image), then a reverse pass, one
warpgroup per (b, h, slice of ``CK_PS`` rows of P), walking the chunks of
``CK_T`` steps from the last with the gradient of the state carried in f32,
summing dB and dC over a cluster of up to ``CK_CL`` head blocks in rank
order, then ``mamba2_bwd_sum``, the partials in order.  Per chunk, with s
the chunk-local cumsum of dt A, L[t, tau] = exp(s_t - s_tau) on tau <= t,
G = C B^T, D = dY (dt x)^T and Q = L o G o D:

  dX~ = (L o G)^T dY + diag(exp(s_T - s)) B dh^T ,  dx = dt dX~
  dC  = (L o D) B + diag(exp(s)) dY h_in
  dB  = (L o D)^T C + diag(exp(s_T - s)) (dt x) dh
  dh <- exp(s_T) dh + (diag(exp(s)) dY)^T C
  ds  = rowsum(Q) - colsum(Q) + exp(s) rowsum((dY h_in) o C) - R
        (+ sum(R) + exp(s_T) <h_in, dh> at the chunk's last step)

with R_tau = exp(s_T - s_tau) (dt x)_tau . (dh B_tau); da is the in-chunk
reverse cumsum of ds, ddt = sum_p x dX~ + A da, dA = sum dt da.

No CUDA kernel runs here, so this file holds a plain-torch model of that
walk (its constants read from the source) against autograd through
``ref.mamba2_scan_ref`` and ``jax.vjp`` of the JAX package's
``repro.kernels.ref.mamba2_scan_ref``: in f32 within 1e-5 of each
gradient's largest entry (the same math summed in another order); with
bf16 inputs and the kernel's operand rounding (each f32 operand of a
bf16 product as a hi + lo pair) at the scans' forward tolerances, 2e-2
for the bf16 gradients and 3e-2 for the f32 ones (dt, A, the state).
"""
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402

CSRC = Path(m2.__file__).parent / "csrc"
F32_REL = 1e-5
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
STATE_BF16_TOL = dict(rtol=3e-2, atol=3e-2)
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dstate0")


def _const(name):
    text = (CSRC / "mamba2_scan.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


T_, PS_ = _const("CK_T"), _const("CK_PS")


def _bf16(a):
    return a.to(torch.bfloat16).float()


def _split(a):
    """An f32 operand as the kernel feeds it to a bf16 product: hi =
    bf16(a) and lo = bf16(a - hi), summed back (``split2``)."""
    hi = _bf16(a)
    return hi + _bf16(a - hi)


def _pad_s(a, Sp):
    """Zeros past S on axis 1: the kernel's zero-filled last chunk (dt 0
    there, so the padded steps neither decay nor update the state)."""
    pad = [0, 0] * (a.dim() - 2) + [0, Sp - a.shape[1]]
    return torch.nn.functional.pad(a, pad)


#: the f32 operands of the kernel's bf16 products: the states pass's
#: update (x dt exp(s_T - s))^T, h_in's image, dh, (L o G)^T, L o D and
#: its transpose, and (exp(s) dY)^T
OPERANDS = ("update", "h_in", "dh", "LG", "LD", "edY")


def mamba2_chunk_bwd_model(x, dt, A, B_, C, state, dy, dstate, *, T=T_,
                           PS=PS_, rounding=None, once=()):
    """``mamba2_scan_bwd``'s chunked path in plain torch, every block at
    once: the states pass, the reverse pass over chunks of T steps per
    slice of PS rows of P with dh carried in f32, and the block sums in
    ``mamba2_bwd_sum``'s order.  ``rounding`` is how an f32 operand enters
    a bf16 product (``_split``, ``_bf16`` or None for exact f32; by
    default ``_split`` for bf16 x); the ``OPERANDS`` named in ``once``
    take one bf16 rounding instead.  Returns (dx, ddt, dA, dB, dC,
    dstate0) in the kernel's dtypes."""
    if rounding is None and x.dtype == torch.bfloat16:
        rounding = _split
    base = rounding or (lambda a: a)
    rnd = {op: _bf16 if op in once else base for op in OPERANDS}
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    nc = -(-S // T)
    nsl = -(-P // PS)
    Sp = nc * T
    xf, dyf = _pad_s(x.float(), Sp), _pad_s(dy.float(), Sp)
    Bf, Cf = _pad_s(B_.float(), Sp), _pad_s(C.float(), Sp)
    dtf, Af = _pad_s(dt.float(), Sp), A.float()
    h0 = torch.zeros((Bsz, H, P, N)) if state is None else state.float()
    dhT = torch.zeros((Bsz, H, P, N)) if dstate is None else dstate.float()
    dx = torch.zeros((Bsz, Sp, H, P))
    ddt_part = torch.zeros((Bsz, Sp, H, nsl))
    dB_part = torch.zeros((Bsz, Sp, H, nsl, N))
    dC_part = torch.zeros((Bsz, Sp, H, nsl, N))
    dA_part = torch.zeros((Bsz, H, nsl))
    ds0 = torch.zeros((Bsz, H, P, N))
    tri = torch.tril(torch.ones((T, T), dtype=torch.bool))   # [t, tau]
    for sl in range(nsl):
        ps = slice(sl * PS, min(P, (sl + 1) * PS))
        # the states pass: mamba2_chunked's state walk, writing each
        # chunk's h_in as its hi + lo image
        h, hin = h0[:, :, ps].clone(), []
        for c in range(nc):
            ts = slice(c * T, (c + 1) * T)
            hin.append(rnd["h_in"](h))
            s = torch.cumsum(dtf[:, ts] * Af, 1)                # (B, T, H)
            sT = s[:, -1]
            dd = rnd["update"]((dtf[:, ts] * torch.exp(sT[:, None] - s))[..., None]
                     * xf[:, ts, :, ps])
            h = h * torch.exp(sT)[..., None, None] + torch.einsum(
                "bthp,btn->bhpn", dd, Bf[:, ts])
        # the reverse pass
        dh = dhT[:, :, ps].clone()
        for c in reversed(range(nc)):
            ts = slice(c * T, (c + 1) * T)
            xc, dyc = xf[:, ts, :, ps], dyf[:, ts, :, ps]       # (B, T, H, p)
            Bc, Cc, dtc = Bf[:, ts], Cf[:, ts], dtf[:, ts]
            s = torch.cumsum(dtc * Af, 1)                       # (B, T, H)
            sT = s[:, -1]                                       # (B, H)
            sh = s.transpose(1, 2)                              # (B, H, T)
            dth = dtc.transpose(1, 2)
            e_end = torch.exp(sT[..., None] - sh)               # (B, H, T)
            # L[t, tau] = exp(s_t - s_tau) on tau <= t; the models below
            # hold the kernel's transposed products, [tau, t]
            diff = sh[..., :, None] - sh[..., None, :]          # [t, tau]
            L = torch.exp(torch.where(tri, diff, -torch.inf))
            Lt = L.transpose(-1, -2)                            # [tau, t]
            GT = torch.einsum("bun,btn->but", Bc, Cc)[:, None]  # [tau, t]
            DTp = torch.einsum("buhp,bthp->bhut", xc, dyc)      # x dY^T
            Gm = GT * Lt                                        # (L o G)^T
            Dm = DTp * Lt * dth[..., None]                      # (L o D)^T
            QT = Gm * DTp * dth[..., None]                      # Q^T
            # Q's part of da_tau, sum over u < tau <= t of Q[t, u], as the
            # kernel sums it: V = each row u of Q^T summed over t >= tau,
            # then V's column tau over the rows u < tau (no difference of
            # large sums, as rowsum(Q) - colsum(Q) would take)
            V = torch.flip(torch.cumsum(torch.flip(QT, [-1]), -1), [-1])
            da = (V * ~tri).sum(-2)                     # [u, tau]: u < tau
            dhr = rnd["dh"](dh)
            P1 = torch.einsum("bun,bhpn->bhup", Bc, dhr) * e_end[..., None]
            xh, dyh = xc.transpose(1, 2), dyc.transpose(1, 2)   # (B, H, T, p)
            R = dth * (xh * P1).sum(-1)
            dXt = P1 + torch.einsum("bhut,bhtp->bhup", rnd["LG"](Gm), dyh)
            dx[:, ts, :, ps] = (dth[..., None] * dXt).transpose(1, 2)
            ddt_dir = (xh * dXt).sum(-1)                        # (B, H, T)
            dBc = torch.einsum("bhup,bhpn->bhun", xh, dhr) * (
                e_end * dth)[..., None] + torch.einsum(
                "bhut,btn->bhun", rnd["LD"](Dm), Cc)
            hi = hin[c]
            Z = torch.einsum("bhtp,bhpn->bhtn", dyh, hi)        # dY h_in
            es = torch.exp(sh)
            zt = es * (Z * Cc[:, None]).sum(-1)
            dCc = Z * es[..., None] + torch.einsum(
                "bhtu,bun->bhtn", rnd["LD"](Dm.transpose(-1, -2)), Bc)
            # the in-chunk reverse cumsum of ds: the dY h_in term summed
            # over t >= tau, R's over t < tau (its -R_t at t and sum(R) at
            # the last step cancel on the rest), and exp(s_T) <h_in, dh>,
            # which sits at the last step, on every tau
            da = da + torch.flip(torch.cumsum(torch.flip(zt, [-1]), -1),
                                 [-1]) + (torch.cumsum(R, -1) - R) + (
                torch.exp(sT) * (hi * dh).sum((-1, -2)))[..., None]
            ddt_part[:, ts, :, sl] = (ddt_dir + Af[:, None] * da).transpose(
                1, 2)
            dA_part[:, :, sl] += (dth * da).sum(-1)
            dB_part[:, ts, :, sl] = dBc.transpose(1, 2)
            dC_part[:, ts, :, sl] = dCc.transpose(1, 2)
            E = rnd["edY"](es[..., None] * dyh)                # (B, H, T, p)
            dh = dh * torch.exp(sT)[..., None, None] + torch.einsum(
                "bhtp,btn->bhpn", E, Cc)
        ds0[:, :, ps] = dh
    # dB and dC: each cluster of cl consecutive blocks of one b sums its
    # blocks' partials in rank order, then mamba2_bwd_sum the clusters' in
    # order
    cl = m2.bwd_cluster(H * nsl)
    sums = []
    for part in (dB_part, dC_part):
        blocks = part.flatten(2, 3)                 # (B, Sp, H nsl, N)
        acc = torch.zeros((Bsz, Sp, N))
        for c0 in range(0, H * nsl, cl):
            cacc = torch.zeros((Bsz, Sp, N))
            for r in range(cl):
                cacc = cacc + blocks[:, :, c0 + r]
            acc = acc + cacc
        sums.append(acc[:, :S].to(x.dtype))
    ddt = torch.zeros((Bsz, Sp, H))
    for sl in range(nsl):
        ddt = ddt + ddt_part[..., sl]
    dA = torch.zeros(H)
    for b in range(Bsz):
        for sl in range(nsl):
            dA = dA + dA_part[b, :, sl]
    return (dx[:, :S].to(x.dtype), ddt[:, :S], dA, sums[0], sums[1], ds0)


def _inputs(seed, shape, dtype, state, dstate, strong=False):
    """numpy-seeded x, dt (softplus; ``strong``: dt A down to -100 a step),
    A < 0, B, C, state, dy and dstate, as jax arrays and torch tensors,
    x, B, C and dy in ``dtype``."""
    rng = np.random.default_rng(seed)
    Bsz, S, H, P, N = shape
    f32 = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    x, Bm, Cm = f32(Bsz, S, H, P), f32(Bsz, S, N), f32(Bsz, S, N)
    dt = np.log1p(np.exp(f32(Bsz, S, H))).astype(np.float32)
    A = -np.exp(f32(H)).astype(np.float32)
    if strong:
        # a_t = dt A in [-100, 0): L underflows to exact zeros
        dt = rng.uniform(0.0, 1.0, (Bsz, S, H)).astype(np.float32)
        A = -rng.uniform(1.0, 100.0, H).astype(np.float32)
    h0 = f32(Bsz, H, P, N) if state else np.zeros((Bsz, H, P, N), np.float32)
    dy = f32(Bsz, S, H, P)
    dh = f32(Bsz, H, P, N) if dstate else None
    arrays = (x, dt, A, Bm, Cm, h0, dy)
    typed = [dtype, "float32", "float32", dtype, dtype, "float32", dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    j = [jnp.asarray(a, jdt[d]) for a, d in zip(arrays, typed)]
    t = [torch.from_numpy(a).to(tdt[d]) for a, d in zip(arrays, typed)]
    return j, t, dh


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _outside(got, want, bf16):
    """Per gradient, the count of entries outside the tolerance: f32
    within ``F32_REL`` of the largest entry; from bf16 inputs the bf16
    gradients at ``BF16_TOL``, the f32 ones at ``STATE_BF16_TOL``."""
    bad = {}
    for name, g, w in zip(NAMES, got, want, strict=True):
        g_, w_ = _np(g), _np(w)
        assert g_.shape == w_.shape, (name, g_.shape, w_.shape)
        assert np.isfinite(g_).all(), name
        if not bf16:
            lim = F32_REL * max(float(np.abs(w_).max(initial=0.0)), 1e-30)
            bad[name] = int((np.abs(g_ - w_) > lim).sum())
        else:
            tol = BF16_TOL if g.dtype == torch.bfloat16 else STATE_BF16_TOL
            bad[name] = int((np.abs(g_ - w_) > tol["atol"] + tol["rtol"]
                             * np.abs(w_)).sum())
    return bad


def _plain(t, state, dh):
    return m2.mamba2_scan_bwd(*t[:5], t[5] if state else None, t[6],
                              None if dh is None else torch.from_numpy(dh))


LENGTHS = [1, T_ - 1, T_, T_ + 1, 2 * T_ + 2]
WIDTHS = [(16, 16), (40, 24), (64, 64), (64, 128)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("P,N", WIDTHS)
@pytest.mark.parametrize("S", LENGTHS)
def test_mamba2_chunk_bwd_model_f32_matches_autograd_and_jax(S, P, N,
                                                             with_state):
    """In f32 with no operand rounding the model is the gradient:
    autograd through the plain version and ``jax.vjp`` of the JAX ref."""
    shape = (1, S, 2, P, N)
    j, t, dh = _inputs(100 * S + P + N, shape, "float32", with_state,
                       with_state)
    st = t[5] if with_state else None
    got = mamba2_chunk_bwd_model(*t[:5], st, t[6],
                                 None if dh is None else torch.from_numpy(dh))
    assert not any(_outside(got, _plain(t, with_state, dh), False).values())
    dh_j = jnp.zeros(j[5].shape, jnp.float32) if dh is None else \
        jnp.asarray(dh)
    _, vjp = jax.vjp(jref.mamba2_scan_ref, *j[:6])
    want = vjp((j[6], dh_j))
    bad = _outside(got, want, False)
    if not with_state:
        bad.pop("dstate0")       # the JAX ref's zeros went in, not None
    assert not any(bad.values()), bad


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("P,N", WIDTHS)
@pytest.mark.parametrize("S", LENGTHS)
def test_mamba2_chunk_bwd_model_bf16_within_the_tolerances(S, P, N,
                                                           with_state):
    """With bf16 inputs and the kernel's hi + lo operands, against the
    plain backward on the same bf16 inputs."""
    shape = (1, S, 3, P, N)
    _, t, dh = _inputs(7 + 100 * S + P + N, shape, "bfloat16", with_state,
                       with_state)
    st = t[5] if with_state else None
    got = mamba2_chunk_bwd_model(*t[:5], st, t[6],
                                 None if dh is None else torch.from_numpy(dh))
    bad = _outside(got, _plain(t, with_state, dh), True)
    assert not any(bad.values()), bad


@pytest.mark.parametrize("P,N", [(64, 64), (40, 24)])
def test_mamba2_chunk_bwd_model_at_strong_decay(P, N):
    """dt A down to -100 a step, in bf16 (the only dtype the chunked path
    takes): L and exp(s) underflow to exact zeros, which give zeros and no
    NaN, and the gradients hold.  (In f32 the chunk-local cumsum reaches
    ~-3000, where f32's spacing is 2.4e-4, so exp(s_t - s_tau) carries that
    relative error: f32 takes the sequential path, which multiplies the
    steps' decays.)"""
    shape = (1, 2 * T_ + 5, 2, P, N)
    _, t, dh = _inputs(31, shape, "bfloat16", True, True, strong=True)
    Af, dtf = t[2], t[1]
    s = torch.cumsum(dtf[:, :T_] * Af, 1)
    assert bool((torch.exp(s) == 0).any())
    got = mamba2_chunk_bwd_model(*t[:6], t[6], torch.from_numpy(dh))
    bad = _outside(got, _plain(t, True, dh), True)
    assert not any(bad.values()), bad


def test_mamba2_chunk_bwd_one_bf16_rounding_is_not_enough():
    """Why the kernel splits every f32 operand of its bf16 products into
    hi + lo: on a training-like walk (S 256, P = N = 64, 8 heads, a state
    and a final-state gradient) the split holds every gradient, and one
    bf16 rounding of any one of ``OPERANDS``, the others split, puts some
    gradient outside the tolerances."""
    shape = (1, 256, 8, 64, 64)
    _, t, dh = _inputs(5, shape, "bfloat16", True, True)
    dhT = torch.from_numpy(dh)
    want = _plain(t, True, dh)
    split = _outside(mamba2_chunk_bwd_model(*t[:6], t[6], dhT), want, True)
    assert not any(split.values()), split
    for op in OPERANDS:
        once = _outside(mamba2_chunk_bwd_model(*t[:6], t[6], dhT,
                                               once=(op,)), want, True)
        assert sum(once.values()) > 0, (op, once)


def test_bwd_schedule_and_constants():
    """``bwd_schedule`` mirrors ``schedule``: the chunked backward for
    bf16 with at least ``CHUNK`` steps, the sequential one otherwise; the
    chunk and slice the model walks are the source's."""
    assert m2.CHUNK == T_ and PS_ == 64
    bf, f32 = torch.bfloat16, torch.float32
    for S in (T_, T_ + 1, 1024):
        assert m2.bwd_schedule(bf, S) == "chunked"
        assert m2.bwd_schedule(f32, S) == "sequential"
    for S in (0, 1, T_ - 1):
        assert m2.bwd_schedule(bf, S) == m2.bwd_schedule(f32, S) == \
            "sequential"


@pytest.mark.parametrize("shape", [(4, 1024, 112, 64, 64), (2, 127, 8, 64, 64),
                                   (1, 100, 4, 64, 128), (1, 70, 3, 40, 24),
                                   (1, 130, 2, 80, 16)])
def test_chunked_bwd_scratch_is_the_sources(shape):
    """The wrapper's scratch for the chunked path, as the source lays it
    out: a (CK_PS, 64 NPN) state's hi and lo image (2 NPN panels of TILE
    bytes) a block and chunk, then the partial dB and dC (B S N a cluster
    of cl blocks each: cl the largest of CK_CL, 4, 2, 1 dividing H nsl),
    ddt (B S H nsl) and dA (one a block)."""
    Bsz, S, H, P, N = shape
    text = (CSRC / "mamba2_scan.cu").read_text()
    tile = eval(re.search(r"constexpr int TILE = ([\d\s*]+);", text).group(1))
    npn = 1 if N <= 64 else 2
    nsl, nc = -(-P // PS_), -(-S // T_)
    grid = Bsz * H * nsl
    cl = next(c for c in (_const("CK_CL"), 4, 2, 1) if H * nsl % c == 0)
    assert m2.CLUSTER == _const("CK_CL") and m2.bwd_cluster(H * nsl) == cl
    image = grid * nc * 2 * npn * tile // 4
    part = Bsz * S * H * nsl
    assert m2.bwd_scratch_floats(Bsz, S, H, P, N, "chunked") == \
        image + 2 * part // cl * N + part + grid
    assert m2.CHUNK_ROWS == PS_
