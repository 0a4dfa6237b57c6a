"""``mamba2_scan``: the SSD (Mamba-2) recurrence.

Counterpart of ``repro/kernels/mamba2_scan.py``.  For tensors on the CPU
the wrapper runs the plain version, ``ref.mamba2_scan_ref``.  For CUDA
tensors it launches a kernel of ``csrc/mamba2_scan.cu`` or raises: there
is no fallback.  ``schedule`` picks the kernel by dtype and S: the chunked
dual form on the tensor cores for bf16 with at least ``CHUNK`` steps, the
sequential f32 kernel otherwise (every f32 call, and bf16 decode).  Each
call adds one to ``mamba2_scan.launches``.

Its gradient is ``mamba2_scan_bwd``: on the CPU autograd through the
plain version; on CUDA, by ``bwd_schedule``, the chunked dual form on the
tensor cores for bf16 with at least ``CHUNK`` steps (a states pass of
``mamba2_chunked``, then ``mamba2_bwd_chunked`` and ``mamba2_bwd_sum``) or
the sequential f32 kernels ``mamba2_bwd_scan`` and ``mamba2_bwd_sum``
otherwise, all of ``csrc/mamba2_scan.cu``.  A CUDA call whose inputs want
a gradient (in grad mode) goes through ``_Mamba2``, whose backward is
``mamba2_scan_bwd``.  Meta or fake tensors take the shape-only path
(``shape_only.launch``): the outputs and scratch of the launch, counted
by its operations (``costs``), one more in ``launches``.
"""
from __future__ import annotations

import torch

from . import _scan_bwd, costs, ref, shape_only

#: largest head size P and state size N the kernel takes
MAX_DIM = 128
#: steps per chunk of the chunked kernels (``CK_T`` in the source), rows
#: of P a block of them takes (``CK_PS``), and the most blocks of a
#: cluster of the chunked backward (``CK_CL``)
CHUNK = 64
CHUNK_ROWS = 64
CLUSTER = 8
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def schedule(dtype, S):
    """The kernel a call of ``S`` steps in ``dtype`` launches: "chunked"
    (``mamba2_chunked``, bf16 with S >= ``CHUNK``) or "sequential"
    (``mamba2_seq``: f32 at every S, bf16 below one chunk)."""
    return "chunked" if dtype == torch.bfloat16 and S >= CHUNK else \
        "sequential"


#: The backward follows the forward's split: "chunked" (the states pass,
#: then ``mamba2_bwd_chunked`` on the tensor cores, bf16 with S >=
#: ``CHUNK``) or "sequential" (``mamba2_bwd_scan``: f32 at every S, whose
#: gradients are held to 1e-4, and bf16 below one chunk).
bwd_schedule = schedule


def bwd_cluster(blocks):
    """Blocks a cluster of the chunked backward takes when ``blocks``
    blocks share a b: the largest of ``CLUSTER``, 4, 2, 1 that divides
    them; the cluster sums its blocks' dB and dC.  The one place the rule
    lives: the wrapper passes it to the kernel and sizes the scratch by
    it."""
    cl = CLUSTER
    while blocks % cl:
        cl //= 2
    return cl


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
    if any(t.device != x.device for t in tensors) or \
            x.device.type not in ("cuda", "meta"):
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
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    x, B_, C = (_last_dense(t) for t in (x, B_, C))
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    h0 = None if state is None else state.float().contiguous()
    if shape_only.active(x, dt, B_, C):
        y, hout = shape_only.launch(
            "mamba2_scan", (x, dt, A, B_, C, h0),
            [((Bsz, S, H, P), x.dtype), ((Bsz, H, P, N), torch.float32)],
            costs.mamba2_flops(x.numel(), N))
        return y, hout
    from . import _build

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


def bwd_scratch_floats(Bsz, S, H, P, N, path="sequential"):
    """f32 of ``mamba2_scan_bwd``'s scratch (``csrc/mamba2_scan.cu``) on
    ``path`` (``bwd_schedule``'s): the sequential path's checkpoints or
    the chunked path's chunk states (the hi and lo image of a (64, 64 NPN)
    state a block and chunk: 4096 NPN floats), then the partial dB and dC
    (one a block, or on the chunked path one a cluster), ddt and dA (one a
    block)."""
    if path == "chunked":
        nsl = -(-P // CHUNK_ROWS)
        nc = -(-S // CHUNK)
        head = Bsz * H * nsl * nc * (1 if N <= 64 else 2) * 4096
        cl = bwd_cluster(H * nsl)
    else:
        nsl = _scan_bwd.slices(P)
        head = _scan_bwd.checkpoint_floats(Bsz * H * nsl, S, N)
        cl = 1
    part = Bsz * S * H * nsl
    return head + part // cl * 2 * N + part + Bsz * H * nsl


def mamba2_scan_bwd(x, dt, A, B_, C, state, dy, dstate=None):
    """The gradient of ``mamba2_scan(x, dt, A, B_, C, state)`` for the
    output gradient ``dy`` (B, S, H, P) and the final state's ``dstate``
    (B, H, P, N) or None (zeros): ``(dx, ddt, dA, dB, dC, dstate0)``, each
    in its input's dtype; ``dstate0`` is f32, the gradient of the state
    going in (of zeros where ``state`` is None).

    On the CPU: autograd through ``ref.mamba2_scan_ref``.  On CUDA, by
    ``bwd_schedule(x.dtype, S)``: "chunked", the states pass
    (``mamba2_chunked`` writing the state entering each chunk), then
    ``mamba2_bwd_chunked``, the chunked dual form backwards on the tensor
    cores; or "sequential", ``mamba2_bwd_scan``, the recurrence in f32
    backwards with the states recomputed from checkpoints
    (``csrc/scan_bwd.cuh``); then ``mamba2_bwd_sum``, the sums of dB, dC,
    ddt and dA across blocks.  No atomics, so two runs give the same bits.
    Adds one to ``mamba2_scan_bwd.launches`` and to the path's
    ``mamba2_scan_bwd.chunked_launches`` or ``.sequential_launches``.
    """
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    if x.device.type == "cpu":
        h0 = torch.zeros((Bsz, H, P, N), dtype=torch.float32) \
            if state is None else state
        return _scan_bwd.plain_vjp(ref.mamba2_scan_ref,
                                   (x, dt, A, B_, C, h0), (dy, dstate))
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
    path = bwd_schedule(x.dtype, S)
    if shape_only.active(x, dt, B_, C, dy):
        dx, dB, dC, ddt, dA, ds0, _ = shape_only.launch(
            "mamba2_scan_bwd", (xk, dtk, Ak, Bk, Ck, h0, dy, dhT),
            [((Bsz, S, H, P), x.dtype), ((Bsz, S, N), x.dtype),
             ((Bsz, S, N), x.dtype), ((Bsz, S, H), torch.float32),
             ((H,), torch.float32), ((Bsz, H, P, N), torch.float32),
             ((bwd_scratch_floats(Bsz, S, H, P, N, path),), torch.float32)],
            costs.mamba2_flops(x.numel(), N, backward=True))
        _count_bwd(path)
        return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC, ds0
    from . import _build

    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    dB, dC = (torch.empty((Bsz, S, N), dtype=x.dtype, device=dev)
              for _ in range(2))
    ddt = torch.empty((Bsz, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    ds0 = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    cl = bwd_cluster(H * -(-P // CHUNK_ROWS)) if path == "chunked" else 1
    scratch = torch.empty(bwd_scratch_floats(Bsz, S, H, P, N, path),
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
            int(path == "chunked"), cl,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mamba2_scan_bwd")
    _count_bwd(path)
    return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC, ds0


def _count_bwd(path):
    mamba2_scan_bwd.launches += 1
    if path == "chunked":
        mamba2_scan_bwd.chunked_launches += 1
    else:
        mamba2_scan_bwd.sequential_launches += 1


mamba2_scan_bwd.launches = 0
mamba2_scan_bwd.chunked_launches = 0
mamba2_scan_bwd.sequential_launches = 0


def bwd_chunked_loads():
    """The chunked backward's launches so far in this process by how they
    loaded B, C, x and dY, as the library counts them: ``{"tma": n,
    "element": n}`` (element by element where P or N is not a multiple of
    8, or a stride or pointer is one TMA cannot take).  Needs the built
    library: on the card only."""
    from . import _build

    lib = _build.load("mamba2_scan")
    return {"tma": lib.mamba2_bwd_chunked_launches(1),
            "element": lib.mamba2_bwd_chunked_launches(0)}
