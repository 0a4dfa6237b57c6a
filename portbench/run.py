"""Run one cell of the benchmark of ``repro_torch`` once, and print its
result as one JSON line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for (``BENCHMARK.json``).  ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` its per-layer metrics (each read by
``metrics/<name>.py``), the device's busy and window seconds and a
``breakdown`` of the traced steps.  Every run checks what its timed path
produced against the plain reference and prints each compared number with
its limit, last on standard error and last in the result line
(``checks``).  With no CUDA device, too few of them, no ``src/`` beside
it, or the JAX package loaded, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the program's caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "CUDA_CACHE_PATH": "build/cuda_cache"}
#: top-level module names that may not be loaded in the process that
#: prints the result: JAX, and the JAX package the program was ported from
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _setup_paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def metrics_for(bench: dict, cell: str, section: str,
                reported: set[str] | None = None) -> list[dict]:
    """The entries of ``bench[section]`` this cell reports: those whose
    ``workloads`` name it, or, without the key, every cell (end-to-end) or
    every cell that reports the metric it moves (per-layer)."""
    out = []
    for e in bench[section]:
        if "workloads" in e:
            if cell in e["workloads"]:
                out.append(e)
        elif section == "end_to_end" or e["moves"] in (reported or set()):
            out.append(e)
    return out


def run(argv=None, *, require_chip: bool = True, device: str = "cuda",
        cell=None, bench: dict | None = None) -> dict:
    """One run; returns the result dict (``main`` prints it).  The keyword
    arguments are for tests on the CPU: they skip the look for a chip and
    may hand in a cell of their own."""
    _setup_paths()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import compare, harness
    bench = bench or harness.load_json(ROOT / "BENCHMARK.json")
    cell = cell or harness.find_cell(args.workload, bench)
    if require_chip:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{cell.name} needs {cell.chips} CUDA "
                             f"device(s); found "
                             f"{torch.cuda.device_count()}")
    dev = torch.device(device)
    seed = args.seed % (1 << 62)
    torch.manual_seed(seed)
    driver = __import__(f"portbench.drivers.{cell.traffic['driver']}",
                        fromlist=["run"])
    import repro_torch.launch.serve  # noqa: F401
    import repro_torch.launch.train  # noqa: F401
    parts = {"imports_s": time.perf_counter() - T0}
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        parts["kernel_build_s"] = _build.build_all()
    out = driver.run(cell, seed=seed, seconds=args.seconds,
                     trace=bool(args.trace), device=dev, t0=T0)

    e2e = metrics_for(bench, cell.name, "end_to_end")
    reported = {e["name"] for e in e2e}
    metrics = {}
    if not args.trace:
        for e in e2e:
            metrics[e["name"]] = {"value": out.end_to_end[e["name"]],
                                  "unit": e["unit"]}
    else:
        for e in metrics_for(bench, cell.name, "per_layer", reported):
            value = harness.metric_reader(e["name"])(out.reading)
            if value is not None:
                metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    correct, checks = compare.judge(out.numbers, cell.limits)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct and out.failed == 0),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    tr = out.reading.trace
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.span_s)
        host = out.reading.host_trace
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": host.idle_gaps()}
        result["traced"] = {"units": tr.units,
                            "untraced_s_per_unit":
                            out.reading.window_s / out.reading.units,
                            "traced_s_per_unit": tr.span_s / tr.units,
                            "host_traced_s_per_unit": host.span_s,
                            "host_traced_idle_pct":
                            100 * (1 - host.busy_s / host.span_s)}
    result["notes"] = {"setup_parts": {**parts, **out.setup_parts},
                       **out.notes}
    result["notes"]["numbers"] = out.numbers
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    result = run(argv)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
