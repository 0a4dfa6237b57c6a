"""``mamba2_scan``: the SSD (Mamba-2) recurrence.

Counterpart of ``repro/kernels/mamba2_scan.py``.  For tensors on the CPU
the wrapper runs the plain version, ``ref.mamba2_scan_ref``.  For CUDA
tensors it launches a kernel of ``csrc/mamba2_scan.cu`` or raises: there
is no fallback.  ``schedule`` picks the kernel by dtype and S: the chunked
dual form on the tensor cores for bf16 with at least ``CHUNK`` steps, the
sequential f32 kernel otherwise (every f32 call, and bf16 decode).  Each
call adds one to ``mamba2_scan.launches``.

Its gradient is ``mamba2_scan_bwd``: on the CPU autograd through the
plain version, on CUDA the sequential f32 kernels ``mamba2_bwd_scan`` and
``mamba2_bwd_sum`` of ``csrc/mamba2_scan.cu``.  A CUDA call whose inputs
want a gradient (in grad mode) goes through ``_Mamba2``, whose backward is
``mamba2_scan_bwd``.
"""
from __future__ import annotations

import torch

from . import _scan_bwd, ref

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


def _launch(x, dt, A, B_, C, state):
    """The forward kernel of ``schedule(x.dtype, S)``."""
    from . import _build

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
    return y, hout


class _Mamba2(torch.autograd.Function):
    """The CUDA scan with ``mamba2_scan_bwd`` as its backward; it keeps its
    inputs, from which the backward recomputes the states."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B_, C, state)
        return _launch(x, dt, A, B_, C, state)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B_, C, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        dx, ddt, dA, dB, dC, ds0 = mamba2_scan_bwd(x, dt, A, B_, C, state,
                                                   dy, dstate)
        return dx, ddt, dA, dB, dC, None if state is None else ds0


def mamba2_scan(x, dt, A, B_, C, state=None):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); B_, C: (B, S, N); state:
    (B, H, P, N) or None -> (y (B, S, H, P) in x.dtype, state (B, H, P, N)
    f32), as ``ref.mamba2_scan_ref``.

    On CUDA: x, B and C in one of bf16/f32, with any strides but a dense
    last axis (the model passes slices of one projection); dt, A and the
    state are read as f32; P and N at most ``MAX_DIM``; any S >= 0.  The
    kernel is ``schedule(x.dtype, S)``'s.  Differentiable on the card
    through ``mamba2_scan_bwd``.
    """
    if x.device.type == "cpu":
        return ref.mamba2_scan_ref(x, dt, A, B_, C, state)
    _check(x, dt, A, B_, C, state)
    inputs = (x, dt, A, B_, C, state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        y, hout = _Mamba2.apply(*inputs)
    else:
        y, hout = _launch(*inputs)
    mamba2_scan.launches += 1
    return y, hout


mamba2_scan.launches = 0


def bwd_scratch_floats(Bsz, S, H, P, N):
    """f32 of ``mamba2_scan_bwd``'s scratch (``csrc/mamba2_scan.cu``):
    the checkpoints, then the blocks' partial dB, dC, ddt and dA."""
    nsl = _scan_bwd.slices(P)
    part = Bsz * S * H * nsl
    return (_scan_bwd.checkpoint_floats(Bsz * H * nsl, S, N)
            + part * (2 * N + 1) + Bsz * H * nsl)


def mamba2_scan_bwd(x, dt, A, B_, C, state, dy, dstate=None):
    """The gradient of ``mamba2_scan(x, dt, A, B_, C, state)`` for the
    output gradient ``dy`` (B, S, H, P) and the final state's ``dstate``
    (B, H, P, N) or None (zeros): ``(dx, ddt, dA, dB, dC, dstate0)``, each
    in its input's dtype; ``dstate0`` is f32, the gradient of the state
    going in (of zeros where ``state`` is None).

    On the CPU: autograd through ``ref.mamba2_scan_ref``.  On CUDA:
    ``mamba2_bwd_scan``, the sequential recurrence in f32 backwards with
    the states recomputed from checkpoints (``csrc/scan_bwd.cuh``), then
    ``mamba2_bwd_sum``, the sums of dB, dC, ddt and dA across blocks; no
    atomics, so two runs give the same bits.  Adds one to
    ``mamba2_scan_bwd.launches``.
    """
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    if x.device.type == "cpu":
        h0 = torch.zeros((Bsz, H, P, N), dtype=torch.float32) \
            if state is None else state
        return _scan_bwd.plain_vjp(ref.mamba2_scan_ref,
                                   (x, dt, A, B_, C, h0), (dy, dstate))
    from . import _build

    _check(x, dt, A, B_, C, state)
    if tuple(dy.shape) != (Bsz, S, H, P) or dy.dtype != x.dtype \
            or dy.device != x.device:
        raise ValueError(f"mamba2_scan_bwd: want dy {(Bsz, S, H, P)} "
                         f"{x.dtype} on {x.device}, got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    if dstate is not None and (tuple(dstate.shape) != (Bsz, H, P, N)
                               or dstate.device != x.device):
        raise ValueError(f"mamba2_scan_bwd: want dstate {(Bsz, H, P, N)} "
                         f"on {x.device}, got {tuple(dstate.shape)}")
    xk, Bk, Ck = (_last_dense(t) for t in (x, B_, C))
    dtk = dt.float().contiguous()
    Ak = A.float().contiguous()
    h0 = None if state is None else state.float().contiguous()
    dhT = None if dstate is None else dstate.float().contiguous()
    dy = dy.contiguous()
    dev = x.device
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    dB, dC = (torch.empty((Bsz, S, N), dtype=x.dtype, device=dev)
              for _ in range(2))
    ddt = torch.empty((Bsz, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    ds0 = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    scratch = torch.empty(bwd_scratch_floats(Bsz, S, H, P, N),
                          dtype=torch.float32, device=dev)
    lib = _build.load("mamba2_scan")
    with torch.cuda.device(dev):
        err = lib.mamba2_scan_bwd(
            xk.data_ptr(), dtk.data_ptr(), Ak.data_ptr(), Bk.data_ptr(),
            Ck.data_ptr(), None if h0 is None else h0.data_ptr(),
            dy.data_ptr(), None if dhT is None else dhT.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ds0.data_ptr(), scratch.data_ptr(), Bsz, S, H, P,
            N, xk.stride(0), xk.stride(1), xk.stride(2), Bk.stride(0),
            Bk.stride(1), Ck.stride(0), Ck.stride(1), _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mamba2_scan_bwd")
    mamba2_scan_bwd.launches += 1
    return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC, ds0


mamba2_scan_bwd.launches = 0
