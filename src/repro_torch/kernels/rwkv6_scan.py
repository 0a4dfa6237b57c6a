"""``rwkv6_scan``: the RWKV-6 WKV recurrence with data-dependent decay.

Counterpart of ``repro/kernels/rwkv6_scan.py``.  For tensors on the CPU
the wrapper runs the plain version, ``ref.rwkv6_scan_ref``.  For CUDA
tensors it launches a kernel of ``csrc/rwkv6_scan.cu`` or raises: there
is no fallback.  ``schedule`` picks the kernel by S: the chunked WKV split
over the value axis for at least ``CHUNK`` steps, the sequential kernel
below (the decode step).  Each call adds one to ``rwkv6_scan.launches``.

Its gradient is ``rwkv6_scan_bwd``: on the CPU autograd through the
plain version, on CUDA the f32 per-step walk ``rwkv6_bwd_scan`` (inputs
staged by cp.async, checkpoints every 8 steps) and ``rwkv6_bwd_sum`` of
``csrc/rwkv6_scan.cu``, for both dtypes.  A CUDA call whose inputs
want a gradient (in grad mode) goes through ``_Rwkv6``, whose backward is
``rwkv6_scan_bwd``.  Meta or fake tensors take the shape-only path
(``shape_only.launch``): the outputs and scratch of the launch, counted
by its operations (``costs``), one more in ``launches``.
"""
from __future__ import annotations

import torch

from . import _scan_bwd, costs, ref, shape_only

#: largest head size D the kernel takes
MAX_DIM = 128
#: steps per chunk of the chunked kernel (``RT`` in the source)
CHUNK = 16
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def schedule(dtype, S):
    """The kernel a call of ``S`` steps launches, in either dtype:
    "chunked" (``rwkv6_chunked``, S >= ``CHUNK``) or "sequential"
    (``rwkv6_seq``, below one chunk)."""
    del dtype                   # both dtypes take the same f32 arithmetic
    return "chunked" if S >= CHUNK else "sequential"


def _check(r, k, v, w, u, state):
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan: want r (B, S, H, D), got "
                         f"{tuple(r.shape)}")
    B, S, H, D = r.shape
    want = {"k": (k, r.shape), "v": (v, r.shape), "w": (w, r.shape),
            "u": (u, (H, D))}
    if state is not None:
        want["state"] = (state, (B, H, D, D))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"rwkv6_scan: {name} has shape "
                             f"{tuple(t.shape)}, want {tuple(shape)}")
    if D > MAX_DIM:
        raise ValueError(f"rwkv6_scan: the kernel takes head sizes up to "
                         f"{MAX_DIM}, got D={D}")
    tensors = [r, k, v, w, u] + ([] if state is None else [state])
    if any(t.device != r.device for t in tensors) or \
            r.device.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6_scan: all tensors must lie on the CPU or "
                         f"all on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if r.dtype not in _DTYPES or not (r.dtype == k.dtype == v.dtype
                                      == w.dtype):
        raise TypeError(f"rwkv6_scan: r, k, v, w must share one dtype of "
                        f"bfloat16/float32, got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}, {w.dtype}")


def _launch(r, k, v, w, u, state):
    """The forward kernel of ``schedule(r.dtype, S)``."""
    B, S, H, D = r.shape
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = u.float().contiguous()
    s0 = None if state is None else state.float().contiguous()
    if shape_only.active(r, k, v, w):
        y, sout = shape_only.launch(
            "rwkv6_scan", (r, k, v, w, u, s0),
            [((B, S, H, D), r.dtype), ((B, H, D, D), torch.float32)],
            costs.rwkv6_flops(r.numel(), D))
        return y, sout
    from . import _build

    y = torch.empty((B, S, H, D), dtype=r.dtype, device=r.device)
    sout = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    lib = _build.load("rwkv6_scan")
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), sout.data_ptr(), B, S, H, D, _DTYPES[r.dtype],
            int(schedule(r.dtype, S) == "chunked"),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rwkv6_scan")
    return y, sout


class _Rwkv6(torch.autograd.Function):
    """The CUDA scan with ``rwkv6_scan_bwd`` as its backward; it keeps its
    inputs, from which the backward recomputes the states."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        return _launch(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=r.dtype, device=r.device)
        dr, dk, dv, dw, du, ds0 = rwkv6_scan_bwd(r, k, v, w, u, state, dy,
                                                 dstate)
        return dr, dk, dv, dw, du, None if state is None else ds0


def rwkv6_scan(r, k, v, w, u, state=None):
    """r, k, v, w: (B, S, H, D) (w the decay in (0, 1)); u: (H, D); state:
    (B, H, D, D) or None -> (y (B, S, H, D) in r.dtype, state (B, H, D, D)
    f32), as ``ref.rwkv6_scan_ref``.

    On CUDA: r, k, v and w in one of bf16/f32; u and the state are read
    as f32; D at most ``MAX_DIM``; any S >= 0.  The kernel is
    ``schedule(r.dtype, S)``'s.  Differentiable on the card through
    ``rwkv6_scan_bwd``.
    """
    if r.device.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, w, u, state)
    _check(r, k, v, w, u, state)
    inputs = (r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        y, sout = _Rwkv6.apply(*inputs)
    else:
        y, sout = _launch(*inputs)
    rwkv6_scan.launches += 1
    return y, sout


rwkv6_scan.launches = 0


def bwd_scratch_floats(B, S, H, D):
    """f32 of ``rwkv6_scan_bwd``'s scratch (``csrc/rwkv6_scan.cu``): the
    checkpoints, then the blocks' partial dv and du."""
    nsl = _scan_bwd.slices(D)
    return (_scan_bwd.r6_checkpoint_floats(B * H * nsl, S, D)
            + B * S * H * nsl * D + B * H * D)


def rwkv6_scan_bwd(r, k, v, w, u, state, dy, dstate=None):
    """The gradient of ``rwkv6_scan(r, k, v, w, u, state)`` for the output
    gradient ``dy`` (B, S, H, D) and the final state's ``dstate`` (B, H,
    D, D) or None (zeros): ``(dr, dk, dv, dw, du, dstate0)``, each in its
    input's dtype; ``dstate0`` is f32, the gradient of the state going in
    (of zeros where ``state`` is None).

    On the CPU: autograd through ``ref.rwkv6_scan_ref``.  On CUDA:
    ``rwkv6_bwd_scan``, the sequential recurrence in f32 backwards with the
    states recomputed from checkpoints every 8 steps
    (``csrc/scan_bwd.cuh``), then ``rwkv6_bwd_sum``, the sums of dv and du
    across blocks; no atomics, so two runs give the same bits.  Adds one
    to ``rwkv6_scan_bwd.launches``.
    """
    B, S, H, D = r.shape
    if r.device.type == "cpu":
        s0 = torch.zeros((B, H, D, D), dtype=torch.float32) \
            if state is None else state
        return _scan_bwd.plain_vjp(ref.rwkv6_scan_ref, (r, k, v, w, u, s0),
                                   (dy, dstate))
    _check(r, k, v, w, u, state)
    if tuple(dy.shape) != (B, S, H, D) or dy.dtype != r.dtype \
            or dy.device != r.device:
        raise ValueError(f"rwkv6_scan_bwd: want dy {(B, S, H, D)} "
                         f"{r.dtype} on {r.device}, got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    if dstate is not None and (tuple(dstate.shape) != (B, H, D, D)
                               or dstate.device != r.device):
        raise ValueError(f"rwkv6_scan_bwd: want dstate {(B, H, D, D)} on "
                         f"{r.device}, got {tuple(dstate.shape)}")
    rk, kk, vk, wk = (t.contiguous() for t in (r, k, v, w))
    uk = u.float().contiguous()
    s0 = None if state is None else state.float().contiguous()
    dsT = None if dstate is None else dstate.float().contiguous()
    dy = dy.contiguous()
    dev = r.device
    if shape_only.active(r, k, v, w, dy):
        dr, dk, dv, dw, du, ds0, _ = shape_only.launch(
            "rwkv6_scan_bwd", (rk, kk, vk, wk, uk, s0, dy, dsT),
            [((B, S, H, D), r.dtype)] * 4
            + [((H, D), torch.float32), ((B, H, D, D), torch.float32),
               ((bwd_scratch_floats(B, S, H, D),), torch.float32)],
            costs.rwkv6_flops(r.numel(), D, backward=True))
        rwkv6_scan_bwd.launches += 1
        return dr, dk, dv, dw, du.to(u.dtype), ds0
    from . import _build

    dr, dk, dv, dw = (torch.empty((B, S, H, D), dtype=r.dtype, device=dev)
                      for _ in range(4))
    du = torch.empty((H, D), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
    scratch = torch.empty(bwd_scratch_floats(B, S, H, D),
                          dtype=torch.float32, device=dev)
    lib = _build.load("rwkv6_scan")
    with torch.cuda.device(dev):
        err = lib.rwkv6_scan_bwd(
            rk.data_ptr(), kk.data_ptr(), vk.data_ptr(), wk.data_ptr(),
            uk.data_ptr(), None if s0 is None else s0.data_ptr(),
            dy.data_ptr(), None if dsT is None else dsT.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), ds0.data_ptr(), scratch.data_ptr(), B, S, H, D,
            _DTYPES[r.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rwkv6_scan_bwd")
    rwkv6_scan_bwd.launches += 1
    return dr, dk, dv, dw, du.to(u.dtype), ds0


rwkv6_scan_bwd.launches = 0


def bwd_loads():
    """``rwkv6_bwd_scan``'s launches so far in this process by how they
    staged their inputs, as the library counts them: ``{"vec": n,
    "element": n}`` (element by element where D times the element's bytes
    is not a multiple of 16, or a pointer is not 16-byte aligned).  Needs
    the built library: on the card only."""
    from . import _build

    lib = _build.load("rwkv6_scan")
    return {"vec": lib.rwkv6_bwd_scan_launches(1),
            "element": lib.rwkv6_bwd_scan_launches(0)}
