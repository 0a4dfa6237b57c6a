"""``mamba2_scan``: the SSD (Mamba-2) recurrence.

Counterpart of ``repro/kernels/mamba2_scan.py``.  For tensors on the CPU
the wrapper runs the plain version, ``ref.mamba2_scan_ref``.  For CUDA
tensors it launches a kernel of ``csrc/mamba2_scan.cu`` or raises: there
is no fallback.  ``schedule`` picks the kernel by dtype and S: the chunked
dual form on the tensor cores for bf16 with at least ``CHUNK`` steps, the
sequential f32 kernel otherwise (every f32 call, and bf16 decode).  Each
call adds one to ``mamba2_scan.launches``.

On CUDA it has no backward kernel yet: it raises when a gradient is
wanted of an input (``_grad.refuse_grad``).  On the CPU the plain
version differentiates.
"""
from __future__ import annotations

import torch

from . import ref
from ._grad import refuse_grad

#: largest head size P and state size N the kernel takes
MAX_DIM = 128
#: steps per chunk of the chunked kernel (``CK_T`` in the source)
CHUNK = 64
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def schedule(dtype, S):
    """The kernel a call of ``S`` steps in ``dtype`` launches: "chunked"
    (``mamba2_chunked``, bf16 with S >= ``CHUNK``) or "sequential"
    (``mamba2_seq``: f32 at every S, bf16 below one chunk)."""
    return "chunked" if dtype == torch.bfloat16 and S >= CHUNK else \
        "sequential"


def _check(x, dt, A, B_, C, state):
    if x.dim() != 4 or B_.dim() != 3:
        raise ValueError(f"mamba2_scan: want x (B, S, H, P) and B, C "
                         f"(B, S, N), got {tuple(x.shape)}, "
                         f"{tuple(B_.shape)}")
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    want = {"dt": (dt, (Bsz, S, H)), "A": (A, (H,)), "B": (B_, (Bsz, S, N)),
            "C": (C, (Bsz, S, N))}
    if state is not None:
        want["state"] = (state, (Bsz, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba2_scan: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
    if P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"mamba2_scan: the kernel takes P and N up to "
                         f"{MAX_DIM}, got P={P}, N={N}")
    tensors = [x, dt, A, B_, C] + ([] if state is None else [state])
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError(f"mamba2_scan: all tensors must lie on the CPU or "
                         f"all on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or not (x.dtype == B_.dtype == C.dtype):
        raise TypeError(f"mamba2_scan: x, B, C must share one dtype of "
                        f"bfloat16/float32, got {x.dtype}, {B_.dtype}, "
                        f"{C.dtype}")


def _last_dense(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def mamba2_scan(x, dt, A, B_, C, state=None):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); B_, C: (B, S, N); state:
    (B, H, P, N) or None -> (y (B, S, H, P) in x.dtype, state (B, H, P, N)
    f32), as ``ref.mamba2_scan_ref``.

    On CUDA: x, B and C in one of bf16/f32, with any strides but a dense
    last axis (the model passes slices of one projection); dt, A and the
    state are read as f32; P and N at most ``MAX_DIM``; any S >= 0.  The
    kernel is ``schedule(x.dtype, S)``'s.
    """
    if x.device.type == "cpu":
        return ref.mamba2_scan_ref(x, dt, A, B_, C, state)
    from . import _build

    _check(x, dt, A, B_, C, state)
    refuse_grad("mamba2_scan", x, dt, A, B_, C, state)
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    x, B_, C = (_last_dense(t) for t in (x, B_, C))
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    h0 = None if state is None else state.float().contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    hout = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    lib = _build.load("mamba2_scan")
    with torch.cuda.device(x.device):
        err = lib.mamba2_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hout.data_ptr(), Bsz, S, H, P, N,
            x.stride(0), x.stride(1), x.stride(2), B_.stride(0),
            B_.stride(1), C.stride(0), C.stride(1), _DTYPES[x.dtype],
            int(schedule(x.dtype, S) == "chunked"),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mamba2_scan")
    mamba2_scan.launches += 1
    return y, hout


mamba2_scan.launches = 0
