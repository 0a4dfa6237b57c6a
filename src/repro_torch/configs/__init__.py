"""Config registry: ``get(name)`` / ``get_reduced(name)`` for every
architecture of ``repro.configs.ARCHS``, in its order.

An unknown name raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from .base import ArchConfig

_MODULES = {
    "arctic-480b": "arctic_480b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "granite-8b": "granite_8b",
    "gemma2-27b": "gemma2_27b",
    "chatglm3-6b": "chatglm3_6b",
    "gemma3-12b": "gemma3_12b",
    "zamba2-7b": "zamba2_7b",
    "whisper-tiny": "whisper_tiny",
    "rwkv6-1.6b": "rwkv6_1p6b",
}

ARCHS = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()
