"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``.cu`` file has a plain C interface and includes no PyTorch header,
so it builds in seconds.  Libraries go to ``build/repro_torch/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  Nothing is built when the module is imported: the
first call of ``load`` (or ``build_all``) builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "burst_gather", "mamba2_scan", "rwkv6_scan",
           "moe_gmm")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ATTN = [_P, _P, _P, _P, _P, _I, _P, _I]
#: C signature of every exported function, by source
_SIGNATURES = {
    "flash_attention": {
        "flash_attention_fwd": _ATTN + [_I] * 11 + [_F, _F, _P],
        "decode_attention_fwd": _ATTN + [_I] * 10 + [_F, _F, _P],
    },
    "burst_gather": {
        "burst_gather_fwd": [_P, _P, _P, _LL, _LL, _LL, _P],
    },
    "mamba2_scan": {
        "mamba2_scan_fwd": [_P] * 8 + [_I] * 5 + [_LL] * 7 + [_I, _P],
    },
    "rwkv6_scan": {
        "rwkv6_scan_fwd": [_P] * 8 + [_I] * 5 + [_P],
    },
    "moe_gmm": {
        "moe_gmm_fwd": [_P] * 7 + [_I] * 5 + [_P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Build every source that is not built yet, one ``nvcc`` per source,
    all started together.  Returns the seconds taken."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, target))
    failed = []
    for name, proc, tmp, target in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_all()
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
