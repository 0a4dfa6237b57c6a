"""What the two scans' backward wrappers share: the schedule constants of
``csrc/scan_bwd.cuh`` (the wrappers size the kernels' scratch with them,
and the CPU tests model the kernels with them), and the plain backward,
autograd through a plain version."""
from __future__ import annotations

import torch

#: ``mamba2_bwd_scan`` (the sequential path): threads a block
#: (``BW_NT``), lanes a state row (``BW_G``), state rows a block
#: (``BW_ROWS``)
THREADS = 512
LANES = 16
ROWS = THREADS // LANES
#: steps between the checkpoints in device memory (``BW_K1``) and between
#: those in shared memory (``BW_K2``)
CHECKPOINT = 64
SUB = 8

#: ``rwkv6_bwd_scan``: threads a block (``RB_NT``), lanes a state row
#: (``RB_G``), steps between the checkpoints in device memory (``RB_K``),
#: steps of the inputs loaded and converted at once (``RB_CH``); state
#: rows a block are ``ROWS`` too
R6_THREADS = 256
R6_LANES = 8
R6_CHECKPOINT = 8
R6_CHUNK = 64


def slices(rows: int) -> int:
    """Blocks a head's ``rows`` state rows take."""
    return -(-rows // ROWS)


def checkpoint_floats(grid: int, S: int, cols: int) -> int:
    """f32 of ``mamba2_bwd_scan``'s device checkpoints of ``grid`` blocks
    over ``S`` steps for rows of ``cols`` columns (4 registers a lane up to
    64, else 8)."""
    nv = 1 if cols <= 64 else 2
    return grid * (-(-S // CHECKPOINT)) * nv * THREADS * 4


def r6_checkpoint_floats(grid: int, S: int, cols: int) -> int:
    """f32 of ``rwkv6_bwd_scan``'s device checkpoints, one every
    ``R6_CHECKPOINT`` steps (8 registers a lane up to 64 columns, else
    16)."""
    nv = 2 if cols <= 64 else 4
    return grid * (-(-S // R6_CHECKPOINT)) * nv * R6_THREADS * 4


def plain_vjp(fn, inputs, cotangents):
    """The gradient of every tensor of ``inputs`` through ``fn(*inputs)``
    (a tuple of outputs) for ``cotangents``, by autograd; a None
    cotangent leaves its output out (a zero gradient, as the final state's
    is in training), and an input no used output depends on gets zeros."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(True) for t in inputs]
        pairs = [(out, cot) for out, cot in zip(fn(*args), cotangents,
                                                strict=True)
                 if cot is not None and out.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], args, [c for _, c in pairs],
            allow_unused=True) if pairs else [None] * len(args)
    return tuple(torch.zeros_like(a) if g is None else g
                 for a, g in zip(args, grads))
