"""Attention wrappers: ``flash_attention`` (prefill) and
``decode_attention`` (one query token against a KV cache), and the
gradient of the first, ``flash_attention_bwd``.

Counterpart of ``repro/kernels/flash_attention.py``.  For tensors on the
CPU each wrapper runs the plain version, ``ref.attention_ref``, which
autograd differentiates.  For CUDA tensors it launches the kernels of
``csrc/flash_attention.cu`` or raises: there is no fallback.  Each wrapper
call adds one to the wrapper's ``launches``.  A decode call launches two
kernels, a split-KV pass and the combine, on a plan from
``decode_splits``; a backward call three (delta, dK/dV, dQ).

A CUDA ``flash_attention`` whose q, k or v requires grad (in grad mode)
goes through ``_Flash``: its forward also writes each row's log-sum-exp,
and its backward is ``flash_attention_bwd``.  It raises for ``kv_len`` or
``q_offset``, which no training path passes.  ``decode_attention`` has no
backward kernel and raises when a gradient is wanted of a CUDA input.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from ._grad import refuse_grad

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
#: keys per tile of the split-KV decode (``DK`` in csrc/flash_attention.cu)
DECODE_TILE = 32
#: query heads per KV head the decode kernel takes: 4 warps of 4 heads
DECODE_MAX_GROUP = 16
#: rows a head of the backward's padded lse / delta scratch is rounded up
#: to (``kLsePad`` in csrc/flash_attention.cu: a wgmma block's rows)
BWD_ROW_PAD = 128


def decode_splits(B: int, Hkv: int, Skv: int, n_sm: int) -> tuple[int, int]:
    """Plan the split-KV decode over a cache of ``Skv`` keys:
    ``(n_split, chunk)``.

    Split s takes the keys [s * chunk, (s + 1) * chunk); ``chunk`` is a
    multiple of ``DECODE_TILE`` and the splits cover [0, Skv) with no empty
    one at the end.  The grid is n_split x Hkv x B blocks, aimed at about
    two per SM where the cache has that many tiles.  Only host-known sizes
    go in: the valid length ``kv_len`` stays on the card.
    """
    tiles = max(1, -(-Skv // DECODE_TILE))
    want = min(tiles, max(1, -(-2 * n_sm // max(1, B * Hkv))))
    chunk = -(-tiles // want) * DECODE_TILE
    return max(1, -(-Skv // chunk)), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v, name):
    if not (q.device.type == k.device.type == v.device.type == "cuda"):
        raise ValueError(f"{name}: q, k, v must all lie on the CPU or all "
                         f"on a CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v lie on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v must share one dtype of "
                        f"bfloat16/float32, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B, Sq, Hq, D) and k, v "
                         f"(B, Skv, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2] != 0:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if D % 8 != 0 or D > 256:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 8 "
                         f"and at most 256")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must start 16-byte aligned")


def _per_batch(value, B, device):
    """An int or a (B,) tensor -> (int32 device tensor or None, scalar)."""
    if isinstance(value, torch.Tensor):
        t = value.to(device=device, dtype=torch.int32).reshape(-1)
        if t.numel() not in (1, B):
            raise ValueError(f"want a (B,) = ({B},) tensor, got "
                             f"{tuple(value.shape)}")
        return t.expand(B).contiguous(), 0
    return None, int(value)


def _launch(fn_name, q, k, v, *, causal, window, softcap, scale, q_offset,
            kv_len, lse=None):
    """Launch a forward kernel; ``lse``, a (B, Hq, Sq) f32 tensor or None,
    takes the prefill's log-sum-exp of each row."""
    from . import _build

    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = (D ** -0.5) if scale is None else scale
    kl, kl_all = _per_batch(Skv if kv_len is None else kv_len, B, q.device)
    qo, qo_all = _per_batch(q_offset, B, q.device)
    o = torch.empty_like(q)
    lib = _build.load("flash_attention")
    if fn_name == "flash_attention_fwd":
        shape = (B, Sq, Skv, Hq, Hkv, D)
        plan = (None if lse is None else lse.data_ptr(),)
    else:
        shape = (B, Skv, Hq, Hkv, D)
        n_split, chunk = decode_splits(B, Hkv, Skv, _sm_count(q.device.index))
        # per (batch, query head, split): an f32 partial acc (D), m and l
        scratch = torch.empty(B * Hq * n_split * (D + 2),
                              dtype=torch.float32, device=q.device)
        plan = (scratch.data_ptr(), n_split, chunk)
    with torch.cuda.device(q.device):
        err = getattr(lib, fn_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if kl is None else kl.data_ptr(), kl_all,
            None if qo is None else qo.data_ptr(), qo_all,
            *shape, _DTYPES[q.dtype], int(causal),
            int(window is not None), 0 if window is None else int(window),
            int(softcap is not None),
            0.0 if softcap is None else float(softcap), float(scale),
            *plan, torch.cuda.current_stream().cuda_stream)
    _build.check(err, fn_name)
    return o


class _Flash(torch.autograd.Function):
    """The CUDA prefill with ``flash_attention_bwd`` as its backward; the
    forward keeps o and the rows' log-sum-exp for it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        B, Sq, Hq, _ = q.shape
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        o = _launch("flash_attention_fwd", q, k, v, causal=causal,
                    window=window, softcap=softcap, scale=scale, q_offset=0,
                    kv_len=None, lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mode = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do, **ctx.mode),
                None, None, None, None)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, q_offset=0, kv_len=None):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    Same arguments and result as ``ref.attention_ref``; ``q_offset`` and
    ``kv_len`` are ints or (B,) tensors.  On CUDA: bf16 or f32, contiguous,
    head_dim a multiple of 8 up to 256.  Differentiable on the card through
    ``flash_attention_bwd``, without ``kv_len`` and ``q_offset``.
    """
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale,
                                 q_offset=q_offset, kv_len=kv_len)
    _check(q, k, v, "flash_attention")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if kv_len is not None or isinstance(q_offset, torch.Tensor) \
                or q_offset != 0:
            raise NotImplementedError(
                "flash_attention: the backward kernel takes no kv_len or "
                "q_offset; no training path passes them")
        o = _Flash.apply(q, k, v, causal, window, softcap, scale)
    else:
        o = _launch("flash_attention_fwd", q, k, v, causal=causal,
                    window=window, softcap=softcap, scale=scale,
                    q_offset=q_offset, kv_len=kv_len)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                        softcap=None, scale=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v, ...)`` (no kv_len, no
    q_offset) for the output gradient ``do``, given its output ``o`` and
    the rows' log-sum-exp ``lse`` (B, Hq, Sq) f32 from the forward.

    The gradients of ``ref.attention_ref``: q scaled in f32, the softcap
    through tanh, the causal and window masks, the softmax, and GQA, whose
    ``repeat_interleave`` transposes to a sum over the group's query heads:
    dk and dv sum them in f32 and round once.  On the CPU the plain version
    is autograd through ``ref.attention_ref`` (o and lse are not read).
    On CUDA: the kernels of ``csrc/flash_attention.cu``, two passes (dK
    and dV, then dQ) with no atomics, so the same bits on every run.  bf16
    at head_dim <= 128 runs on the tensor cores (``flash_bwd_dkdv_wg``,
    ``flash_bwd_dq_wg``: TMA tiles, ``wgmma``, f32 sums, P and dS rounded
    to bf16 as the second products' operands); f32, and bf16 at head_dim
    256, on the FMA pipes in f32.  Adds one to
    ``flash_attention_bwd.launches``.
    """
    if q.device.type == "cpu":
        with torch.enable_grad():
            args = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = ref.attention_ref(*args, causal=causal, window=window,
                                    softcap=softcap, scale=scale)
            return torch.autograd.grad(out, args, do)
    from . import _build

    _check(q, k, v, "flash_attention_bwd")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    do = do.contiguous()
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype \
            or o.dtype != q.dtype or not o.is_contiguous():
        raise ValueError("flash_attention_bwd: o and do must be contiguous "
                         "tensors of q's shape and dtype")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: want lse (B, Hq, Sq) = "
                         f"{(B, Hq, Sq)} contiguous f32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    scale = (D ** -0.5) if scale is None else scale
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # delta and the padded copy of lse, B * Hq rows of Sq rounded up each
    sqp = -(-Sq // BWD_ROW_PAD) * BWD_ROW_PAD
    scratch = torch.empty(2 * B * Hq * sqp, dtype=torch.float32,
                          device=q.device)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), B, Sq, Skv, Hq, Hkv, D,
            _DTYPES[q.dtype], int(causal), int(window is not None),
            0 if window is None else int(window), int(softcap is not None),
            0.0 if softcap is None else float(softcap), float(scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def decode_attention(q, k, v, *, causal=False, window=None, softcap=None,
                     scale=None, q_offset=0, kv_len=None):
    """Single-token decode: q (B, 1, Hq, D) against a (possibly ring-
    buffered) KV cache k, v (B, max_seq, Hkv, D) -> (B, 1, Hq, D).

    Held to ``ref.attention_ref`` with the same arguments, ``window``
    included.  Causality at decode comes through ``kv_len`` (every cached
    key up to it is valid), hence ``causal=False`` by default.
    """
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention: want one query token, got "
                         f"q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale,
                                 q_offset=q_offset, kv_len=kv_len)
    _check(q, k, v, "decode_attention")
    refuse_grad("decode_attention", q, k, v)
    if q.shape[2] // k.shape[2] > DECODE_MAX_GROUP:
        raise ValueError(f"decode_attention: at most {DECODE_MAX_GROUP} "
                         f"query heads per KV head on CUDA, got "
                         f"{q.shape[2]} / {k.shape[2]}")
    o = _launch("decode_attention_fwd", q, k, v, causal=causal,
                window=window, softcap=softcap, scale=scale,
                q_offset=q_offset, kv_len=kv_len)
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
