"""The kernels' shape-only path: what a CUDA wrapper does with meta or
fake tensors, which have shapes and no memory.

A trace of a step on such stand-ins (``repro_torch.launch.dryrun``) goes
through every wrapper's checks and counters as the card's run does, but
no wrapper may read a pointer or run its plain version there.  So each
one calls ``launch``: one op, ``repro_torch::kernel``, that returns
tensors of the kernel's output shapes and dtypes on the inputs' device
(the scratch it would allocate among them, so that a tracker of live
bytes sees it) and that ``torch.utils.flop_counter.FlopCounterMode``
counts by the kernel's operations (``costs``).  The card's path does not
go through this op: a real CUDA tensor is launched directly, with no
dispatcher hop.
"""
from __future__ import annotations

import torch
from torch import Tensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

#: the dtypes an output may take, by their index in the op's arguments
DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int64,
          torch.float16, torch.int8, torch.bool)


def active(*tensors) -> bool:
    """Whether a wrapper given ``tensors`` takes the shape-only path: one
    of them is a meta tensor or a fake one (a CPU tensor, fake or not, has
    taken the plain version before this is asked)."""
    return any(isinstance(t, torch.Tensor)
               and (t.is_meta or isinstance(t, FakeTensor))
               for t in tensors)


@torch.library.custom_op("repro_torch::kernel", mutates_args=())
def _kernel(name: str, inputs: list[Tensor], ranks: list[int],
            dims: list[int], dtypes: list[int], flops: int) -> list[Tensor]:
    raise RuntimeError(f"{name}: the shape-only op runs on meta or fake "
                       f"tensors only; the card launches the kernel")


@_kernel.register_fake
def _(name, inputs, ranks, dims, dtypes, flops):
    device = inputs[0].device
    out, i = [], 0
    for r, d in zip(ranks, dtypes):
        out.append(torch.empty(dims[i:i + r], dtype=DTYPES[d],
                               device=device))
        i += r
    return out


@register_flop_formula(torch.ops.repro_torch.kernel)
def _flops(*args, **kwargs) -> int:
    return args[5]


#: the shape-only launches, and their operations, by the name of the
#: wrapper's launch counter (``flash_attention``, ``moe_plan``, ...) since
#: the last ``reset`` (the dry run reports them by kernel)
calls: dict[str, int] = {}
flops: dict[str, int] = {}


def reset() -> None:
    calls.clear()
    flops.clear()


def launch(name: str, inputs, outputs, ops: int = 0) -> list[Tensor]:
    """Tensors of ``outputs`` ((shape, dtype) each) on the device of
    ``inputs`` (the kernel's operands, None entries left out), through
    ``repro_torch::kernel``, counted as ``ops`` operations."""
    inputs = [t for t in inputs if isinstance(t, torch.Tensor)]
    shapes = [tuple(int(n) for n in s) for s, _ in outputs]
    calls[name] = calls.get(name, 0) + 1
    flops[name] = flops.get(name, 0) + int(ops)
    return torch.ops.repro_torch.kernel(
        name, inputs, [len(s) for s in shapes], [n for s in shapes for n in s],
        [DTYPES.index(d) for _, d in outputs], int(ops))
