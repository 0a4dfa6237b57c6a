"""``rwkv6_scan``: the RWKV-6 WKV recurrence with data-dependent decay.

Counterpart of ``repro/kernels/rwkv6_scan.py``.  For tensors on the CPU
the wrapper runs the plain version, ``ref.rwkv6_scan_ref``.  For CUDA
tensors it launches a kernel of ``csrc/rwkv6_scan.cu`` or raises: there
is no fallback.  ``schedule`` picks the kernel by S: the chunked WKV split
over the value axis for at least ``CHUNK`` steps, the sequential kernel
below (the decode step).  Each call adds one to ``rwkv6_scan.launches``.

On CUDA it has no backward kernel yet: it raises when a gradient is
wanted of an input (``_grad.refuse_grad``).  On the CPU the plain
version differentiates.
"""
from __future__ import annotations

import torch

from . import ref
from ._grad import refuse_grad

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
    if any(t.device != r.device for t in tensors) or r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: all tensors must lie on the CPU or "
                         f"all on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if r.dtype not in _DTYPES or not (r.dtype == k.dtype == v.dtype
                                      == w.dtype):
        raise TypeError(f"rwkv6_scan: r, k, v, w must share one dtype of "
                        f"bfloat16/float32, got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}, {w.dtype}")


def rwkv6_scan(r, k, v, w, u, state=None):
    """r, k, v, w: (B, S, H, D) (w the decay in (0, 1)); u: (H, D); state:
    (B, H, D, D) or None -> (y (B, S, H, D) in r.dtype, state (B, H, D, D)
    f32), as ``ref.rwkv6_scan_ref``.

    On CUDA: r, k, v and w in one of bf16/f32; u and the state are read
    as f32; D at most ``MAX_DIM``; any S >= 0.  The kernel is
    ``schedule(r.dtype, S)``'s.
    """
    if r.device.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, w, u, state)
    from . import _build

    _check(r, k, v, w, u, state)
    refuse_grad("rwkv6_scan", r, k, v, w, u, state)
    B, S, H, D = r.shape
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = u.float().contiguous()
    s0 = None if state is None else state.float().contiguous()
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
    rwkv6_scan.launches += 1
    return y, sout


rwkv6_scan.launches = 0
