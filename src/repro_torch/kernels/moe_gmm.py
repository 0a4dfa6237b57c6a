"""``moe_gmm``: grouped (per-expert) matmul of the MoE FFN.

Counterpart of ``repro/kernels/moe_gmm.py``.  For tensors on the CPU the
wrapper runs the plain version, ``ref.moe_gmm_ref``.  For CUDA tensors it
launches the kernels of ``csrc/moe_gmm.cu`` or raises: there is no
fallback.  Each launch adds one to ``moe_gmm.launches``.

Unlike the Pallas kernel, which reads only the first and last id of each
token tile and so needs sorted ids, the kernel takes ids in any order and
needs no padding of T, K or N.
"""
from __future__ import annotations

import torch

from . import ref

#: largest number of experts the kernel takes
MAX_EXPERTS = 1024
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


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
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError(f"moe_gmm: all tensors must lie on the CPU or all "
                         f"on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_ids: torch.Tensor) -> torch.Tensor:
    """x: (T, K); w: (E, K, N); group_ids: (T,) integer in any order ->
    (T, N) in x.dtype with row i = ``x[i] @ w[group_ids[i]]``, accumulated
    in f32; a row whose id lies outside [0, E) is zero.  As
    ``ref.moe_gmm_ref``.

    On CUDA: x and w in one of bf16/f32 (bf16 on the tensor cores, f32 in
    full f32 on the FMA pipes), E at most ``MAX_EXPERTS``.  Non-contiguous
    inputs are copied.
    """
    if x.device.type == "cpu":
        return ref.moe_gmm_ref(x, w, group_ids)
    from . import _build

    _check(x, w, group_ids)
    T, K = x.shape
    E, _, N = w.shape
    x, w = x.contiguous(), w.contiguous()
    ids = group_ids.to(torch.int32).contiguous()
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    scratch = torch.empty(T + 2 * (E + 2), dtype=torch.int32,
                          device=x.device)
    perm, off, toff = torch.split(scratch, [T, E + 2, E + 2])
    lib = _build.load("moe_gmm")
    with torch.cuda.device(x.device):
        err = lib.moe_gmm_fwd(
            x.data_ptr(), w.data_ptr(), ids.data_ptr(), out.data_ptr(),
            perm.data_ptr(), off.data_ptr(), toff.data_ptr(), T, K, N, E,
            _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "moe_gmm")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
