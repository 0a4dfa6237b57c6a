"""``moe_gmm``: grouped (per-expert) matmul of the MoE FFN.

Counterpart of ``repro/kernels/moe_gmm.py``.  For tensors on the CPU the
wrapper runs the plain version, ``ref.moe_gmm_ref``.  For CUDA tensors it
launches the kernels of ``csrc/moe_gmm.cu`` or raises: there is no
fallback.  Each grouped-matmul call adds one to ``moe_gmm.launches``; each
plan built on the card adds one to ``plan.launches``.

Unlike the Pallas kernel, which reads only the first and last id of each
token tile and so needs sorted ids, the kernel takes ids in any order and
needs no padding of T, K or N.

A call on the card runs in two steps.  ``plan(group_ids, E)`` sorts the
rows by expert, stably (``Plan``); a caller with several products over
the same ids, as the MoE layer's three, builds it once and passes it.
``schedule(T, K, N, E, dtype)`` then picks the kernel, its tiles and the
grid from what the host knows, so nothing waits for the card.

Its gradient is ``moe_gmm_bwd``: on the CPU autograd through the plain
version; on CUDA (grad mode on and ``x`` or ``w`` requiring grad, through
``_Gmm``) the backward kernels of ``csrc/moe_gmm.cu`` on the forward's
plan.  In bf16 both are persistent, a block an SM walking a work list:
dX over (row tile, column tile) items, dW over (expert, K tile, N tile)
items, experts with the most rows first, in clusters of two blocks along
K that share dY's TMA loads, each walking its expert's rows.  Each
backward call adds one to ``moe_gmm_bwd.launches``.

Meta or fake tensors take the shape-only path (``shape_only.launch``):
the plan's buffer, the products' outputs, counted by their operations
(``costs``) and in the same counters.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import costs, ref, shape_only

#: largest number of experts the kernel takes
MAX_EXPERTS = 1024
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
#: rows and columns of a tile of the generic kernels (``SUB``)
SUB = 64
#: (rows, columns) of a tile of the wgmma kernel, by the plan's row tile:
#: the instantiations of ``launch_wgmma`` in csrc/moe_gmm.cu
WGMMA_TILES = {128: 256, 64: 128}
#: (K rows, N columns) of a dW tile of the bf16 backward kernel
#: (``DW_BK``, ``DW_BN`` of csrc/moe_gmm.cu); the generic kernels' are
#: ``SUB`` x ``SUB``
DW_TILE = (128, 256)


class Plan(NamedTuple):
    """The rows of a grouped matmul sorted by expert, stably.

    ``perm`` (T,) int32: the rows of expert e, in increasing order, at
    ``perm[off[e]:off[e + 1]]``; rows whose id lies outside [0, E) form
    bucket E.  ``off`` (E + 2,) int32: first slot of each bucket,
    ``off[E + 1] = T``.  ``toff`` (E + 2,) int32: first row tile of each
    bucket in tiles of ``bm`` rows, ``toff[E + 1]`` the tile count.
    ``tiles`` (``tile_bound(T, E)``, 4) int32: per tile, its bucket, first
    slot, rows, and first row of x when its rows are one run of x (else
    -1); bucket -1 past the last tile.  A block of the product reads its
    tile there in one load.
    """
    perm: torch.Tensor
    off: torch.Tensor
    toff: torch.Tensor
    tiles: torch.Tensor
    bm: int


class Schedule(NamedTuple):
    """What ``moe_gmm`` launches on the card.  ``path`` "wgmma" (bf16, K
    and N multiples of 8) or "generic" (f32, or odd K or N); tiles of
    ``bm`` x ``bn`` outputs, each summed over the whole of K; ``tiles``
    bounds the plan's row tiles for any ids; the grid is (column tiles,
    ``tiles``)."""
    path: str
    bm: int
    bn: int
    tiles: int
    grid: tuple[int, int]


class BwdSchedule(NamedTuple):
    """What ``moe_gmm_bwd`` launches on the card.  ``path`` as the
    forward's; ``dx`` the forward's schedule of the product with K and N
    swapped (the sum over N, K output columns, w read transposed): its
    tiles, and as ``grid`` its work items (column tiles, row tiles), each
    a block on the generic path, walked by persistent blocks on the wgmma
    path.  ``dw_tile`` the (K rows, N columns) of a dW item and
    ``dw_grid`` the items (N tiles, K tiles, E), each walking its expert's
    rows: a block each on the generic path, walked by persistent clusters
    of ``DW_CK`` blocks along K (csrc/moe_gmm.cu) on the wgmma path."""
    path: str
    dx: Schedule
    dw_tile: tuple[int, int]
    dw_grid: tuple[int, int, int]


def row_tile(T: int, E: int) -> int:
    """Rows of the plan's tiles: 128 where the experts average 128 rows or
    more (prefill), else 64.  Depends on T and E only, so one plan serves
    products of any K and N."""
    return 128 if T >= 128 * E else 64


def tile_bound(T: int, E: int) -> int:
    """The most row tiles any ids can give: ceil(T / bm) full tiles plus
    one partial tile per non-empty bucket, of which there are at most
    min(E + 1, T)."""
    return -(-T // row_tile(T, E)) + min(E + 1, T)


def schedule(T: int, K: int, N: int, E: int,
             dtype: torch.dtype = torch.bfloat16) -> Schedule:
    """The kernel, tiles and grid of one call, from host-known sizes.

    bf16 with K and N multiples of 8 (TMA's 16-byte strides) takes the
    wgmma kernel, anything else the generic ones.  The grid has a row of
    blocks for each of ``tile_bound(T, E)`` row tiles and a block for each
    column tile in it; a block sums the whole of K.  (Splitting K across
    blocks where the tiles leave SMs idle, decode at one to four tokens,
    measured no faster on an H100: PERF.md.)"""
    bm = row_tile(T, E)
    tiles = tile_bound(T, E)
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0:
        path, bn = "wgmma", WGMMA_TILES[bm]
    else:
        path, bn = "generic", SUB
    return Schedule(path, bm, bn, tiles, (-(-N // bn), tiles))


def bwd_schedule(T: int, K: int, N: int, E: int,
                 dtype: torch.dtype = torch.bfloat16) -> BwdSchedule:
    """The kernels, tiles and grids of one backward call of a product x
    (T, K) @ w (E, K, N), from host-known sizes: the forward's path rule
    (bf16 with K and N multiples of 8 on wgmma, else the generic kernels)
    for both dX and dW."""
    dx = schedule(T, N, K, E, dtype)
    bk, bn = DW_TILE if dx.path == "wgmma" else (SUB, SUB)
    return BwdSchedule(dx.path, dx, (bk, bn), (-(-N // bn), -(-K // bk), E))


def plan_ref(ids: torch.Tensor, E: int) -> Plan:
    """The plan in plain PyTorch, on any device: a stable sort by bucket."""
    T = ids.shape[0]
    bm = row_tile(T, E)
    bucket = torch.where((ids >= 0) & (ids < E), ids.long(), E)
    perm = torch.argsort(bucket, stable=True)
    counts = torch.zeros(E + 1, dtype=torch.int64, device=ids.device)
    counts.scatter_add_(0, bucket, torch.ones_like(bucket))
    zero = counts.new_zeros(1)
    off = torch.cat([zero, counts.cumsum(0)])
    toff = torch.cat([zero, ((counts + bm - 1) // bm).cumsum(0)])
    # tile t of bucket b starts at slot off[b] + (t - toff[b]) bm
    n_tiles = int(toff[-1])
    t = torch.arange(n_tiles, device=ids.device)
    b = torch.searchsorted(toff, t, right=True) - 1
    r0 = off[b] + (t - toff[b]) * bm
    n = torch.clamp(off[b + 1] - r0, max=bm)
    # one run of x rows: perm steps by one through the tile
    step = torch.cat([perm[1:] - perm[:-1] == 1, perm.new_ones(1, dtype=
                                                               torch.bool)])
    bad = torch.cumsum(torch.cat([step.new_zeros(1, dtype=torch.long),
                                  (~step).long()]), 0)
    last = r0 + n - 1
    run = (bad[last] - bad[r0] == 0) & (b < E)
    tiles = torch.full((tile_bound(T, E), 4), -1, dtype=torch.int64,
                       device=ids.device)
    tiles[:, 1:3] = 0
    tiles[:n_tiles] = torch.stack(
        [b, r0, n, torch.where(run, perm[r0.clamp(max=max(T - 1, 0))], -1)],
        1)
    i32 = torch.int32
    return Plan(perm.to(i32), off.to(i32), toff.to(i32), tiles.to(i32), bm)


def plan(group_ids: torch.Tensor, E: int) -> Plan:
    """The stable plan of ``group_ids`` (T,) over E experts (``Plan``),
    with row tiles of ``row_tile(T, E)`` rows.  On the card one block of
    ``csrc/moe_gmm.cu`` builds it without a host sync."""
    if group_ids.dim() != 1 or group_ids.dtype.is_floating_point \
            or group_ids.dtype.is_complex or group_ids.dtype == torch.bool:
        raise TypeError(f"moe_gmm.plan: want (T,) integer ids, got "
                        f"{tuple(group_ids.shape)} {group_ids.dtype}")
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"moe_gmm.plan: the kernel takes 1 to "
                         f"{MAX_EXPERTS} experts, got {E}")
    T = group_ids.shape[0]
    if group_ids.device.type == "cpu":
        return plan_ref(group_ids, E)
    if group_ids.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_gmm.plan: ids must lie on the CPU or a CUDA "
                         f"device, got {group_ids.device}")
    ids = group_ids.to(torch.int32).contiguous()
    bm, bound = row_tile(T, E), tile_bound(T, E)
    size = 4 * bound + T + 2 * (E + 2)
    if shape_only.active(ids):
        (buf,) = shape_only.launch("moe_plan", (ids,),
                                   [((size,), torch.int32)])
        plan.launches += 1
        tiles, perm, off, toff = torch.split(buf, [4 * bound, T, E + 2,
                                                   E + 2])
        return Plan(perm, off, toff, tiles.view(bound, 4), bm)
    from . import _build

    # the tiles first: 16-byte aligned for the kernels' one load a tile
    buf = torch.empty(size, dtype=torch.int32, device=ids.device)
    tiles, perm, off, toff = torch.split(buf, [4 * bound, T, E + 2, E + 2])
    lib = _build.load("moe_gmm")
    with torch.cuda.device(ids.device):
        err = lib.moe_gmm_plan(ids.data_ptr(), perm.data_ptr(),
                               off.data_ptr(), toff.data_ptr(),
                               tiles.data_ptr(), T, E, bm, bound,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(err, "moe_gmm.plan")
    plan.launches += 1
    return Plan(perm, off, toff, tiles.view(bound, 4), bm)


plan.launches = 0
_plan = plan            # ``moe_gmm``'s argument of that name hides it


def _check(x, w, group_ids):
    if x.dim() != 2 or w.dim() != 3 or group_ids.dim() != 1:
        raise ValueError(f"moe_gmm: want x (T, K), w (E, K, N) and "
                         f"group_ids (T,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(group_ids.shape)}")
    T, K = x.shape
    E, Kw, _ = w.shape
    if Kw != K or group_ids.shape[0] != T:
        raise ValueError(f"moe_gmm: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"and group_ids {tuple(group_ids.shape)} disagree")
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"moe_gmm: the kernel takes 1 to {MAX_EXPERTS} "
                         f"experts, got {E}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm: x and w must share one dtype of "
                        f"bfloat16/float32, got {x.dtype}, {w.dtype}")
    if group_ids.dtype.is_floating_point or group_ids.dtype.is_complex \
            or group_ids.dtype == torch.bool:
        raise TypeError(f"moe_gmm: group_ids must be integer, got "
                        f"{group_ids.dtype}")
    tensors = (x, w, group_ids)
    if any(t.device != x.device for t in tensors) or \
            x.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_gmm: all tensors must lie on the CPU or all "
                         f"on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def _check_plan(p: Plan, T: int, E: int, device) -> None:
    shapes = (p.perm.shape, p.off.shape, p.toff.shape, p.tiles.shape)
    if shapes != ((T,), (E + 2,), (E + 2,), (tile_bound(T, E), 4)) or \
            p.bm != row_tile(T, E) or \
            any(t.device != device or t.dtype != torch.int32
                for t in p[:4]):
        raise ValueError(f"moe_gmm: the plan does not belong to {T} ids "
                         f"over {E} experts on {device}")


def _forward(x, w, ids, plan, rows=None):
    """The card's product on contiguous x, w and int32 ids, with their
    plan: one launch.  ``rows``: the rows the shape-only path counts."""
    T, K = x.shape
    E, _, N = w.shape
    if shape_only.active(x, w, ids):
        moe_gmm.launches += 1
        return shape_only.launch("moe_gmm", (x, w, ids, *plan[:4]),
                                 [((T, N), x.dtype)],
                                 costs.gmm_flops(T if rows is None else rows,
                                                 K, N))[0]
    from . import _build

    s = schedule(T, K, N, E, x.dtype)
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    lib = _build.load("moe_gmm")
    with torch.cuda.device(x.device):
        err = lib.moe_gmm_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), plan.perm.data_ptr(),
            plan.tiles.data_ptr(), T, K, N, E, _DTYPES[x.dtype],
            0 if s.path == "wgmma" else 1, s.bm, s.bn, s.tiles,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "moe_gmm")
    moe_gmm.launches += 1
    return out


class _Gmm(torch.autograd.Function):
    """The card's grouped matmul with ``moe_gmm_bwd`` as its backward, on
    the forward's plan (built once a layer for its three products)."""

    @staticmethod
    def forward(ctx, x, w, ids, plan, rows):
        ctx.save_for_backward(x, w, ids)
        ctx.plan, ctx.rows = plan, rows
        return _forward(x, w, ids, plan, rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, ids = ctx.saved_tensors
        dx, dw = moe_gmm_bwd(dy, x, w, ids, ctx.plan,
                             need=ctx.needs_input_grad[:2], rows=ctx.rows)
        return dx, dw, None, None, None


def moe_gmm(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor,
            plan: Plan | None = None, *,
            rows: int | None = None) -> torch.Tensor:
    """x: (T, K); w: (E, K, N); group_ids: (T,) integer in any order ->
    (T, N) in x.dtype with row i = ``x[i] @ w[group_ids[i]]``, accumulated
    in f32; a row whose id lies outside [0, E) is zero.  As
    ``ref.moe_gmm_ref``.

    On CUDA: x and w in one of bf16/f32 (bf16 on the tensor cores, f32 in
    full f32 on the FMA pipes), E at most ``MAX_EXPERTS``; ``plan`` is the
    ``plan`` of these ids, built here when not given.  Non-contiguous
    inputs are copied.  With grad mode on and x or w requiring grad, the
    call goes through ``_Gmm``, whose backward is ``moe_gmm_bwd``.  On the
    CPU ``plan`` is not used.  ``rows``: the rows whose products the
    shape-only path counts in its FLOPs, where the caller knows that only
    about so many ids lie in [0, E) (an expert-parallel rank's share);
    all T by default.
    """
    if x.device.type == "cpu":
        return ref.moe_gmm_ref(x, w, group_ids)
    _check(x, w, group_ids)
    T = x.shape[0]
    E = w.shape[0]
    x, w = x.contiguous(), w.contiguous()
    ids = group_ids.to(torch.int32).contiguous()
    if plan is None:
        plan = _plan(ids, E)
    _check_plan(plan, T, E, x.device)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Gmm.apply(x, w, ids, plan, rows)
    return _forward(x, w, ids, plan, rows)


moe_gmm.launches = 0


def moe_gmm_bwd(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                group_ids: torch.Tensor, plan: Plan | None = None, *,
                need=(True, True), rows: int | None = None):
    """The gradients of ``moe_gmm(x, w, group_ids)`` for the output
    gradient dy (T, N): ``(dx, dw)``, dx (T, K) and dw (E, K, N) in x's
    dtype, or None where ``need`` (for x, for w) is false.

    dx[i] = dy[i] @ w[group_ids[i]]^T, zero for an id outside [0, E);
    dw[e] = the sum over the rows i of e of x[i]^T dy[i], zeros for an
    expert with no row.  Each is accumulated in f32 and rounded once.

    On the CPU: autograd through ``ref.moe_gmm_ref``.  On CUDA, on
    ``bwd_schedule``'s path and the forward's ``plan`` of these ids
    (built here when not given): dX over (row tile, column tile) items,
    dW over (expert, K tile, N tile) items, each walking the expert's
    rows in increasing order.
    No atomics, so two runs give the same bits.  Adds one to
    ``moe_gmm_bwd.launches``.
    """
    need_x, need_w = need
    if x.device.type == "cpu":
        leaves = [t.detach().requires_grad_(bool(n))
                  for t, n in ((x, need_x), (w, need_w))]
        want = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(
                ref.moe_gmm_ref(*leaves, group_ids), want, dy)
                if want else ())
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves)
    _check(x, w, group_ids)
    T, K = x.shape
    E, _, N = w.shape
    if tuple(dy.shape) != (T, N) or dy.dtype != x.dtype \
            or dy.device != x.device:
        raise ValueError(f"moe_gmm_bwd: want dy {(T, N)} {x.dtype} on "
                         f"{x.device}, got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")
    x, w, dy = x.contiguous(), w.contiguous(), dy.contiguous()
    ids = group_ids.to(torch.int32).contiguous()
    if plan is None:
        plan = _plan(ids, E)
    _check_plan(plan, T, E, x.device)
    if shape_only.active(x, w, dy, ids):
        moe_gmm_bwd.launches += 1
        outs = ([((T, K), x.dtype)] if need_x else []) + \
            ([((E, K, N), x.dtype)] if need_w else [])
        got = iter(shape_only.launch(
            "moe_gmm_bwd", (x, w, dy, ids, *plan[:4]), outs,
            costs.gmm_flops(T if rows is None else rows, K, N)
            * (int(need_x) + int(need_w))))
        return (next(got) if need_x else None,
                next(got) if need_w else None)
    from . import _build

    s = bwd_schedule(T, K, N, E, x.dtype)
    dx = torch.empty((T, K), dtype=x.dtype, device=x.device) \
        if need_x else None
    dw = torch.empty((E, K, N), dtype=x.dtype, device=x.device) \
        if need_w else None
    lib = _build.load("moe_gmm")
    with torch.cuda.device(x.device):
        err = lib.moe_gmm_bwd(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(),
            None if dx is None else dx.data_ptr(),
            None if dw is None else dw.data_ptr(), plan.perm.data_ptr(),
            plan.off.data_ptr(), plan.toff.data_ptr(), plan.tiles.data_ptr(),
            T, K, N, E, _DTYPES[x.dtype], 0 if s.path == "wgmma" else 1,
            s.dx.bm, s.dx.bn, s.dx.tiles,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "moe_gmm_bwd")
    moe_gmm_bwd.launches += 1
    return dx, dw


moe_gmm_bwd.launches = 0

