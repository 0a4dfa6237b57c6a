"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``.cu`` file has a plain C interface and includes no PyTorch header,
so it builds in seconds.  Libraries go to ``build/repro_torch/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one
is loaded as it is.  Nothing is built when the module is imported: the
first call of ``load`` (or ``build_all``) builds.  ``ptxas -v``'s report
(registers, spills) is kept beside each library; ``kernel_report`` reads it
with the count of tensor-core instructions in the library's SASS.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "burst_gather", "mamba2_scan", "rwkv6_scan",
           "moe_gmm", "sim_sweep")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ATTN = [_P, _P, _P, _P, _P, _I, _P, _I]
#: C signature of every exported function, by source
_SIGNATURES = {
    "flash_attention": {
        "flash_attention_fwd": _ATTN + [_I] * 11 + [_F, _F, _P, _P],
        "decode_attention_fwd": _ATTN + [_I] * 10 + [_F, _F, _P, _I, _I, _P],
        "flash_attention_bwd": [_P] * 10 + [_I] * 11 + [_F, _F, _P],
    },
    "burst_gather": {
        "burst_gather_fwd": [_P, _P, _P, _LL, _LL, _LL, _P, _P],
        "burst_gather_bwd": [_P, _P, _P, _I, _I, _I, _I, _P, _I, _P],
    },
    "mamba2_scan": {
        "mamba2_scan_fwd": [_P] * 8 + [_I] * 5 + [_LL] * 7 + [_I, _I, _P],
    },
    "rwkv6_scan": {
        "rwkv6_scan_fwd": [_P] * 8 + [_I] * 6 + [_P],
    },
    "moe_gmm": {
        "moe_gmm_plan": [_P] * 5 + [_I] * 4 + [_P],
        "moe_gmm_fwd": [_P] * 5 + [_I] * 9 + [_P],
    },
    "sim_sweep": {
        "sim_sweep_fwd": [_P] * 8 + [_I] * 5 + [_P] * 5 + [_I, _P],
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
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
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
            target.with_suffix(".log").write_text(log)
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


#: template arguments that are types, as mangled, by the name printed
_TYPES = {"__nv_bfloat16": "bf16", "f": "f32", "h": "u8", "t": "u16",
          "j": "u32"}


def _kernel_name(mangled: str) -> str:
    """``_ZN<len><namespace><len>flash_fwd_bf16ILi128EEEv...`` ->
    ``flash_fwd_bf16<128>``: the innermost name, with its template
    arguments (integers, and types such as bf16, f32 or uint4)."""
    pos, name = (3, mangled) if mangled.startswith("_ZN") else (2, mangled)
    while m := re.match(r"\d+", mangled[pos:]):
        start = pos + m.end()
        name, pos = mangled[start:start + int(m.group())], start + int(
            m.group())
    if not mangled.startswith("I", pos):
        return name
    args, pos = [], pos + 1
    while pos < len(mangled) and mangled[pos] != "E":
        if mangled.startswith("L", pos):       # a literal: L, type, value
            end = mangled.index("E", pos)
            args.append(mangled[pos + 2:end])
            pos = end + 1
        elif m := re.match(r"\d+", mangled[pos:]):
            start = pos + m.end()
            arg = mangled[start:start + int(m.group())]
            args.append(_TYPES.get(arg, arg))
            pos = start + int(m.group())
        else:
            args.append(_TYPES.get(mangled[pos], mangled[pos]))
            pos += 1
    return name + "<" + ", ".join(args) + ">"


def kernel_report(name: str) -> dict[str, dict[str, int]]:
    """Per kernel of the built ``csrc/<name>.cu``: ``registers``,
    ``spill_stores`` and ``spill_loads`` (bytes) from ``ptxas -v``, and
    ``tensor_core``, the count of tensor-core instructions (``HMMA``,
    from ``mma.sync``, and ``HGMMA``, from ``wgmma``) in
    ``cuobjdump -sass`` of the library, and ``hgmma``, the HGMMA alone."""
    target = _target(name)
    if not target.exists():
        build_all()
    report: dict[str, dict[str, int]] = {}
    current = None
    for line in target.with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            current = report.setdefault(_kernel_name(m.group(1)), {})
        elif current is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            current.update(spill_stores=int(st), spill_loads=int(ld))
        elif current is not None and "Used" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
    sass = subprocess.run(
        [str(Path(_nvcc()).parent / "cuobjdump"), "-sass", str(target)],
        capture_output=True, text=True, check=True).stdout
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        kernel = _kernel_name(chunk.split()[0])
        report.setdefault(kernel, {}).update(
            tensor_core=len(re.findall(r"\b(?:HMMA|HGMMA)\b", chunk)),
            hgmma=len(re.findall(r"\bHGMMA\b", chunk)))
    return report
