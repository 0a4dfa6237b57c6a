"""Config registry: ``get(name)`` / ``get_reduced(name)`` for the
architectures the port serves today.

The names list mirrors ``repro.configs.ARCHS``.  An architecture the port
does not serve yet raises ``NotImplementedError`` naming the item of the
port queue in ``ROADMAP.md`` that brings it.
"""
from __future__ import annotations

import importlib

from .base import ArchConfig

ARCHS = ["granite-8b", "zamba2-7b", "rwkv6-1.6b"]

_MODULES = {"granite-8b": "granite_8b", "zamba2-7b": "zamba2_7b",
            "rwkv6-1.6b": "rwkv6_1p6b"}

#: architecture -> the ROADMAP port-queue item that brings it
_PENDING = {
    "granite-moe-3b-a800m": "port queue item 4 (moe_gmm and the MoE blocks)",
    "arctic-480b": "port queue item 4 (moe_gmm and the MoE blocks)",
    "gemma2-27b": "port queue item 6 (the other attention families)",
    "gemma3-12b": "port queue item 6 (the other attention families)",
    "chatglm3-6b": "port queue item 6 (the other attention families)",
    "llama-3.2-vision-11b": "port queue item 6 (the other attention families)",
    "whisper-tiny": "port queue item 6 (the other attention families)",
}


def _module(name: str):
    if name in _PENDING:
        raise NotImplementedError(
            f"{name} is not ported yet: see ROADMAP.md, {_PENDING[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()
