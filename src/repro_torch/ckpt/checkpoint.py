"""Checkpoints with a manifest, saved in the background, restored by
template.

Counterpart of ``repro/ckpt/checkpoint.py``, with its on-disk layout:
``<dir>/step_<N:08d>/shard_<k>.npz`` plus ``manifest.json``.  A tree is
nested dicts and lists of tensors (the trainer saves
``{"params": {name: tensor}, "opt": optimizer state}``, the params by
their ``named_parameters`` names); each leaf is stored under its path,
"/"-joined, with "|" in place of "/" in the npz key.  npz holds no bf16,
so bf16 leaves are stored as f32 (exact) and cast back on restore to the
template leaf's dtype.  Arrays are read with NumPy's default
``allow_pickle=False``: nothing is ever unpickled.

Restoring onto a new mesh's shardings is the distributed runtime's, which
the port does not have yet; ``restore_checkpoint`` puts each leaf on the
template leaf's device.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(v) -> np.ndarray:
    """A host copy of a leaf, bf16 widened to f32.  The copy is taken now,
    so a leaf updated in place after ``save_checkpoint`` returns does not
    reach the file."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy().copy()
    return np.array(v)


def save_checkpoint(directory: str, step: int, tree, *, asynchronous=False,
                    _host_id: int = 0):
    """Write ``tree`` as step ``step``.  The leaves are copied to the host
    before this returns; with ``asynchronous`` the files are written by a
    thread, which is returned (join it before relying on the files)."""
    flat = _flatten(tree)
    arrays = {k: _to_numpy(v) for k, v in flat.items() if v is not None}

    def _write():
        d = os.path.join(directory, f"step_{step:08d}")
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(
            d, f".shard_{_host_id}.{threading.get_ident()}.tmp.npz")
        np.savez(tmp, **{k.replace("/", "|"): v for k, v in arrays.items()})
        os.replace(tmp, os.path.join(d, f"shard_{_host_id}.npz"))
        manifest = {"step": step, "keys": sorted(arrays),
                    "hosts": [_host_id]}
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    if asynchronous:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(directory: str) -> int | None:
    """The highest step in ``directory`` whose manifest is written."""
    if not os.path.isdir(directory):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(directory)
             if n.startswith("step_") and
             os.path.exists(os.path.join(directory, n, "manifest.json"))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, tree_like):
    """The tree of step ``step``, shaped as ``tree_like``: each tensor leaf
    comes back as a fresh tensor of the template's dtype on its device
    (bf16 through the stored f32, exactly)."""
    d = os.path.join(directory, f"step_{step:08d}")
    data = {}
    for fn in os.listdir(d):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(d, fn)) as z:
                for k in z.files:
                    data[k.replace("|", "/")] = z[k]

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            t = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            return type(tree)(t) if isinstance(tree, tuple) else t
        if tree is None:
            return None
        arr = data[prefix[:-1]]
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(arr).to(device=tree.device,
                                            dtype=tree.dtype)
        return arr

    return rebuild(tree_like)
