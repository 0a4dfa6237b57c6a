"""``burst_gather``: row gather with a burst detector, and its gradient.

Counterpart of ``repro/kernels/burst_gather.py``.  For a table on the CPU
the wrapper runs the plain version, ``ref.burst_gather_ref``, which
autograd differentiates.  For a CUDA table it launches the kernel of
``csrc/burst_gather.cu`` or raises: there is no fallback.  Each launch
adds one to ``burst_gather.launches``.  When a gradient is wanted (grad
mode on and a table that requires grad) the CUDA call goes through
``_Gather``, whose backward is the hand-written ``burst_gather_bwd``
(one more in ``burst_gather_bwd.launches`` a call, and in the count of
the path ``bwd_path`` picks).  Meta or fake tensors take the shape-only path
(``shape_only.launch``), counted alike.
"""
from __future__ import annotations

import torch

from . import costs, ref, shape_only
from .flash_attention import _sm_count


#: ids per tile of the burst detector (``IB`` in csrc/burst_gather.cu)
TILE = 8
#: table dtypes of the backward kernel, by its C code
_BWD_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
#: ids the backward's one-block sort takes: what one sorting block holds
#: in shared memory (``SORT_MAX`` in csrc/burst_gather.cu); more take the
#: multi-block path, chunks of this many ids
SORT_MAX = 16384
#: ints of the backward writer's state (``STATE`` in csrc/burst_gather.cu)
WRITER_STATE = 5


def bwd_path(N: int) -> str:
    """The sort ``burst_gather_bwd`` launches for N ids: "one_block"
    (``bwd_sort``) up to ``SORT_MAX``, else "multi_block"
    (``bwd_chunk_sort`` over chunks of ``SORT_MAX``, then ``bwd_merge``)."""
    return "one_block" if N <= SORT_MAX else "multi_block"


def bwd_scratch_ints(R: int, N: int, multi: bool) -> int:
    """Ints of ``burst_gather_bwd``'s scratch for N ids into R rows on the
    one-block or the multi-block (``multi``) path: the taken rows'
    segments (4 ints each, at most min(N, R)), the sorted positions (N),
    the bitmap of taken rows, the writer's state; on the multi-block path
    also the chunks' counts (a chunk of ``SORT_MAX`` ids x (R + 1) rows)
    and each sorted id's row, position and rank (3 N).  The one rule, for
    the card and the shape-only path; the library checks the size it is
    given against its own layout (``scratch_ints`` in
    csrc/burst_gather.cu).  Raises ``ValueError`` where an offset would
    not fit an int32, as the library would refuse the launch."""
    n = 4 * min(N, R) + N + (R + 31) // 32 + WRITER_STATE
    if multi:
        n += -(-N // SORT_MAX) * (R + 1) + 3 * N
    if n > 2 ** 31 - 1:
        path = "multi_block" if multi else "one_block"
        raise ValueError(f"burst_gather_bwd: {N} ids into {R} rows do not "
                         f"fit the {path} sort's int32 counts and offsets")
    return n


def _forward(table, idx, bursts):
    if table.device.type not in ("cuda", "meta") or \
            idx.device != table.device:
        raise ValueError(f"burst_gather: table and idx must lie on one "
                         f"CUDA device, got {table.device}, {idx.device}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"burst_gather: want table (R, D) and idx (N,), "
                         f"got {tuple(table.shape)}, {tuple(idx.shape)}")
    if idx.dtype.is_floating_point or idx.dtype.is_complex \
            or idx.dtype == torch.bool:
        raise TypeError(f"burst_gather: idx must be integer, got {idx.dtype}")
    if not table.is_contiguous():
        raise ValueError("burst_gather: table must be contiguous")
    if bursts is not None and (bursts.device != table.device or
                               bursts.dtype != torch.int32 or
                               bursts.numel() != 1):
        raise ValueError("burst_gather: bursts must be one int32 on the "
                         "table's device")
    R, D = table.shape
    idx32 = idx.to(torch.int32).contiguous()
    if shape_only.active(table, idx):
        burst_gather.launches += 1
        return shape_only.launch("burst_gather", (table, idx32),
                                 [((idx.shape[0], D), table.dtype)])[0]
    from . import _build

    out = torch.empty((idx.shape[0], D), dtype=table.dtype,
                      device=table.device)
    lib = _build.load("burst_gather")
    with torch.cuda.device(table.device):
        err = lib.burst_gather_fwd(
            table.data_ptr(), idx32.data_ptr(), out.data_ptr(), R,
            idx.shape[0], D * table.element_size(),
            None if bursts is None else bursts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "burst_gather")
    burst_gather.launches += 1
    return out


class _Gather(torch.autograd.Function):
    """The CUDA gather with ``burst_gather_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, table, idx, bursts):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return _forward(table, idx, bursts)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        return burst_gather_bwd(dout, idx, ctx.rows), None, None


def burst_gather(table: torch.Tensor, idx: torch.Tensor, *,
                 bursts: torch.Tensor | None = None) -> torch.Tensor:
    """table: (R, D); idx: (N,) integer -> (N, D) rows ``table[idx]``.

    Indices must lie in [0, R).  The plain version raises on any other; the
    kernel does not check (that would cost a copy to the host) and writes
    a zero row for it without reading outside the table.

    On CUDA: ``bursts``, a (1,) int32 tensor on the table's device, gains
    the number of tiles of ``TILE`` ids that were one run of rows.  On
    the CPU it is ignored.  A table that requires grad (in grad mode)
    differentiates through ``burst_gather_bwd``.
    """
    if table.device.type == "cpu":
        return ref.burst_gather_ref(table, idx)
    if torch.is_grad_enabled() and table.requires_grad:
        return _Gather.apply(table, idx, bursts)
    return _forward(table, idx, bursts)


burst_gather.launches = 0


def burst_gather_bwd(dout: torch.Tensor, idx: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """The table gradient of the gather: dout (N, D), idx (N,) ->
    (rows, D) in dout's dtype, zeros with each dout[i] added into row
    idx[i].

    Each row's contributions are summed in f32 in increasing i and rounded
    to the dtype once, with no float atomics, so two runs give the same
    bits, equal to a sequential f32 ``index_add_`` rounded once.  The
    plain version (CPU) is autograd's backward of ``ref.burst_gather_ref``,
    which adds in the table's dtype, as ``jnp.take``'s VJP in the JAX
    package does: in bf16 the two differ by the roundings of a row's
    repeated adds, so they are held to each other within a tolerance, not
    bit for bit.  On CUDA: bf16 or f32, ids in [0, rows) (others add to no
    row); a stable sort of the ids by row (one block up to ``SORT_MAX``
    ids, else chunks and a merge: ``bwd_path``), then a writer that sums
    the taken rows while it zeroes the rest.  The scratch is sized by
    ``bwd_scratch_ints``, which raises where the ids' counts would not
    fit an int.  Adds one to
    ``burst_gather_bwd.launches`` and to the path's
    ``.one_block_launches`` or ``.multi_block_launches``.
    """
    if dout.device.type == "cpu":
        with torch.enable_grad():
            table = torch.zeros((rows, dout.shape[1]), dtype=dout.dtype,
                                requires_grad=True)
            (grad,) = torch.autograd.grad(ref.burst_gather_ref(table, idx),
                                          table, dout)
        return grad
    if dout.dim() != 2 or idx.dim() != 1 or idx.shape[0] != dout.shape[0]:
        raise ValueError(f"burst_gather_bwd: want dout (N, D) and idx (N,), "
                         f"got {tuple(dout.shape)}, {tuple(idx.shape)}")
    if dout.dtype not in _BWD_DTYPES:
        raise TypeError(f"burst_gather_bwd: dout must be bfloat16 or "
                        f"float32, got {dout.dtype}")
    if idx.device != dout.device:
        raise ValueError(f"burst_gather_bwd: dout and idx lie on "
                         f"{dout.device} and {idx.device}")
    N, D = dout.shape
    multi = int(bwd_path(N) == "multi_block")
    size = bwd_scratch_ints(rows, N, multi)
    if shape_only.active(dout, idx):
        dtable, _ = shape_only.launch(
            "burst_gather_bwd", (dout, idx),
            [((rows, D), dout.dtype), ((size,), torch.int32)],
            costs.gather_bwd_flops(dout.numel()))
        _count_bwd(multi)
        return dtable
    from . import _build

    lib = _build.load("burst_gather")
    dout = dout.contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    dtable = torch.empty((rows, D), dtype=dout.dtype, device=dout.device)
    scratch = torch.empty(size, dtype=torch.int32, device=dout.device)
    with torch.cuda.device(dout.device):
        err = lib.burst_gather_bwd(
            dout.data_ptr(), idx32.data_ptr(), dtable.data_ptr(), rows, N, D,
            _BWD_DTYPES[dout.dtype], multi, scratch.data_ptr(), size,
            _sm_count(dout.device.index),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "burst_gather_bwd")
    _count_bwd(multi)
    return dtable


def _count_bwd(multi):
    burst_gather_bwd.launches += 1
    if multi:
        burst_gather_bwd.multi_block_launches += 1
    else:
        burst_gather_bwd.one_block_launches += 1


burst_gather_bwd.launches = 0
burst_gather_bwd.one_block_launches = 0
burst_gather_bwd.multi_block_launches = 0
