"""The runtime's collectives: mesh axes as process groups, all-reduce and
all-gather that autograd can see, the pipeline's stage exchange, and int8
error-feedback gradient compression.

Counterpart of ``repro/distributed/collectives.py`` (the compression) and
of what XLA's collectives do for the JAX package.  Every helper runs on
NCCL with tensors on the card and on gloo with tensors on the CPU.  A gloo
group given tensors on the card (two ranks sharing one card, which NCCL
refuses) moves each tensor through host memory and back; ``_staged``
decides that by the group's backend, once, and nothing is retried another
way when a collective fails.

Compression: before the data-parallel gradient reduction, quantize each
leaf to int8 with a per-leaf scale; the quantization residual is carried
in an error-feedback buffer and added back next step (Karimireddy et al.).
On the wire it cuts the all-reduce's bytes 4x against f32.  As in the JAX
package, no step builder calls it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

#: most elements in one flat buffer of ``all_reduce_``
BUCKET = 1 << 26

# ---------------------------------------------------------------------------
# mesh axes as process groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis (or several, flattened) of a mesh as seen by one rank: its
    process group (None for a single rank), its size and this rank's index
    along it."""
    group: object
    size: int
    rank: int

    @property
    def ranks(self) -> list[int]:
        """The group's global ranks, in axis order."""
        if self.group is None:
            return [dist.get_rank() if dist.is_initialized() else 0]
        return dist.get_process_group_ranks(self.group)


#: (id of a mesh, axis names) -> (the mesh, its Axis), so each flattened
#: group is made once (the mesh is kept so that its id is not reused)
_AXES: dict = {}


def axis(mesh, names) -> Axis:
    """The sub-group of ``mesh`` (a ``DeviceMesh``) along ``names`` (one
    axis name or several) that holds this rank.  Several axes flatten in
    mesh order; every rank must ask for them in the same order, since each
    flattened group is made on every rank (``dist.new_group``).  A missing
    or empty list of names is the single rank."""
    names = (names,) if isinstance(names, str) else tuple(names)
    key = (id(mesh), names)
    if key in _AXES:
        return _AXES[key][1]
    ranks = mesh.mesh.cpu().numpy()
    dims = [mesh.mesh_dim_names.index(n) for n in names]
    me = dist.get_rank()
    size = int(np.prod([ranks.shape[d] for d in dims])) if dims else 1
    if size == 1:
        out = Axis(None, 1, 0)
    elif len(dims) == 1:
        group = mesh.get_group(names[0])
        members = dist.get_process_group_ranks(group)
        out = Axis(group, size, members.index(me))
    else:
        rest = [d for d in range(ranks.ndim) if d not in dims]
        rows = np.transpose(ranks, rest + dims).reshape(-1, size)
        out = None
        for row in rows:
            group = dist.new_group([int(r) for r in row])
            if me in row:
                out = Axis(group, size, int(list(row).index(me)))
    _AXES[key] = (mesh, out)
    return out


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a collective over ``group`` takes ``t`` through host
    memory: a gloo group given a tensor on the card."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, ax: Axis, op=dist.ReduceOp.SUM):
    """A new tensor: ``t`` reduced over ``ax`` (``t`` itself on one
    rank)."""
    if ax.size == 1:
        return t
    if _staged(ax.group, t):
        host = t.detach().cpu()
        dist.all_reduce(host, op=op, group=ax.group)
        return host.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, op=op, group=ax.group)
    return out


def all_reduce_(tensors, ax: Axis, op=dist.ReduceOp.SUM):
    """Reduce a list of tensors of one dtype over ``ax`` in place, packed
    into flat buckets of at most ``BUCKET`` elements."""
    if ax.size == 1 or not tensors:
        return tensors
    i = 0
    while i < len(tensors):
        j, n = i, 0
        while j < len(tensors) and (j == i or n + tensors[j].numel()
                                    <= BUCKET):
            n += tensors[j].numel()
            j += 1
        flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors[i:j]]),
                          ax, op)
        off = 0
        for t in tensors[i:j]:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        i = j
    return tensors


def all_gather(t: torch.Tensor, ax: Axis, dim: int):
    """The pieces of ``t`` on every rank of ``ax``, concatenated along
    ``dim`` in axis order."""
    if ax.size == 1:
        return t
    staged = _staged(ax.group, t)
    src = t.detach().cpu() if staged else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if staged else out


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward; the gradient passed through as it is (every
    rank holds the same downstream gradient).  Unlike
    ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces again and so scales a gradient that is the same on every
    rank by the group's size."""

    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x, ax: Axis):
    """Megatron's f: the input of a column-parallel product."""
    return x if ax.size == 1 else _CopyToGroup.apply(x, ax)


def reduce_from(x, ax: Axis):
    """Megatron's g: the sum of the row-parallel products' partials."""
    return x if ax.size == 1 else _ReduceFromGroup.apply(x, ax)


# ---------------------------------------------------------------------------
# the pipeline's stage exchange
# ---------------------------------------------------------------------------

def _send_recv(send, recv_like, ax: Axis, forward: bool):
    """Send ``send`` one stage on (``forward``) or back, and receive a
    tensor like ``recv_like`` from the other side; zeros where there is no
    such stage.  One batched pair of point-to-point operations."""
    ranks = ax.ranks
    s = ax.rank
    dst = s + 1 if forward else s - 1
    src = s - 1 if forward else s + 1
    staged = _staged(ax.group, recv_like)
    recv = torch.zeros_like(recv_like, device="cpu" if staged else None)
    ops = []
    if 0 <= dst < ax.size:
        out = send.detach().cpu() if staged else send.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, out, ranks[dst], ax.group))
    if 0 <= src < ax.size:
        ops.append(dist.P2POp(dist.irecv, recv, ranks[src], ax.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(recv_like.device) if staged else recv


class _Exchange(torch.autograd.Function):
    """Forward: send ``payload`` to the next stage and receive the previous
    stage's.  Backward: send the received tensor's gradient back and
    receive the next stage's gradient of ``payload``.  ``order`` is a 0-d
    tensor passed through: chained from one exchange to the next and into
    the loss, it makes every exchange's backward run, in reverse tick
    order, on every rank, whether or not its received tensor was used;
    point-to-point messages then pair up (NCCL's ignore tags)."""

    @staticmethod
    def forward(ctx, payload, order, ax):
        ctx.ax = ax
        ctx.shape = (payload.shape, payload.dtype, payload.device)
        return _send_recv(payload, payload, ax, forward=True), order.clone()

    @staticmethod
    def backward(ctx, g_recv, g_order):
        shape, dtype, device = ctx.shape
        like = torch.empty(shape, dtype=dtype, device=device)
        g_payload = _send_recv(g_recv.to(dtype), like, ctx.ax, forward=False)
        return g_payload, g_order, None


def exchange(payload, order, ax: Axis):
    """(received payload, next ``order``): one tick's stage exchange."""
    return _Exchange.apply(payload, order, ax)


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor):
    """(int8 values, f32 scale): x / scale rounded half to even and clipped
    to +-127, scale = max(max |x|, 1e-12) / 127, in f32."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor):
    return q.float() * scale


def compress_grads(grads: dict, error_buf: dict):
    """Quantize each gradient plus its carried residual to int8; returns
    ({name: int8}, {name: scale}, {name: new residual})."""
    q_tree, s_tree, e_tree = {}, {}, {}
    for name, g in grads.items():
        gf = g.float() + error_buf[name]
        q, s = quantize_int8(gf)
        q_tree[name], s_tree[name] = q, s
        e_tree[name] = gf - dequantize_int8(q, s)
    return q_tree, s_tree, e_tree


def decompress_grads(q_tree: dict, s_tree: dict) -> dict:
    return {name: dequantize_int8(q, s_tree[name])
            for name, q in q_tree.items()}


def init_error_buf(grads_like: dict) -> dict:
    return {name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for name, g in grads_like.items()}
