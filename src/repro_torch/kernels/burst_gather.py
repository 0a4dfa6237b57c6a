"""``burst_gather``: row gather with a burst detector.

Counterpart of ``repro/kernels/burst_gather.py``.  For a table on the CPU
the wrapper runs the plain version, ``ref.burst_gather_ref``.  For a CUDA
table it launches the kernel of ``csrc/burst_gather.cu`` or raises: there
is no fallback.  Each launch adds one to ``burst_gather.launches``.
"""
from __future__ import annotations

import torch

from . import ref


#: ids per tile of the burst detector (``IB`` in csrc/burst_gather.cu)
TILE = 8


def burst_gather(table: torch.Tensor, idx: torch.Tensor, *,
                 bursts: torch.Tensor | None = None) -> torch.Tensor:
    """table: (R, D); idx: (N,) integer -> (N, D) rows ``table[idx]``.

    Indices must lie in [0, R).  The plain version raises on any other; the
    kernel does not check (that would cost a copy to the host) and writes
    a zero row for it without reading outside the table.

    On CUDA: ``bursts``, a (1,) int32 tensor on the table's device, gains
    the number of tiles of ``TILE`` ids that were one run of rows.  On
    the CPU it is ignored.
    """
    if table.device.type == "cpu":
        return ref.burst_gather_ref(table, idx)
    from . import _build

    if table.device.type != "cuda" or idx.device != table.device:
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


burst_gather.launches = 0
