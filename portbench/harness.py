"""What the drivers share: a cell's files found by name, the program's
configuration built from a configuration file, the benchmark's weights
put into the program's parameters, and what a run hands to the per-layer
metrics.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``);
its limits are ``limits/<cell>.json`` and each per-layer metric is
``metrics/<metric>.py``.  Adding a cell, a configuration, a mix or a
metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: keys of a configuration's ``model`` that the program fixes rather than
#: takes (``lm.loss_fn`` adds the MoE's load-balance loss at 0.01)
FIXED = {"aux_loss_coef": 0.01}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # limits/<cell>.json
    chips: int

    @property
    def model(self) -> dict:
        return self.config["model"]


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        if w["name"] == name:
            return Cell(name,
                        load_json(HERE / "configs" / f"{w['config']}.json"),
                        load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                        load_json(HERE / "limits" / f"{name}.json"),
                        w["chips"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Reading:
    """What a run hands its per-layer metrics."""
    kind: str                  # "train" or "serve"
    model: dict
    traffic: dict
    window_s: float            # the untraced window, host clock
    units: int                 # steps or calls completed in it
    trace: object = None       # devtrace.Trace of the traced steps or calls
    host_trace: object = None  # one more, with the host's ops recorded
    program: dict = dataclasses.field(default_factory=dict)  # its own clocks


@dataclasses.dataclass
class Outcome:
    end_to_end: dict           # name -> value
    numbers: dict              # the numbers compared, by name
    attempted: int
    failed: int
    memory_peak_bytes: int
    reading: Reading
    notes: dict = dataclasses.field(default_factory=dict)
    setup_parts: dict = dataclasses.field(default_factory=dict)  # seconds


def program_config(config: dict):
    """The program's ArchConfig for a configuration file: its architecture
    (``arch``) with every key of the file's ``model``.  A key the program
    neither takes nor fixes at the file's value is refused: the program
    would run another model than the file states."""
    from repro_torch import configs
    arch = configs.get(config["arch"])
    fields = {f.name for f in dataclasses.fields(arch)}
    m = config["model"]
    kw = {k: v for k, v in m.items() if k in fields}
    cannot = sorted(k for k, v in m.items()
                    if k not in fields and FIXED.get(k, object()) != v)
    if cannot:
        raise ValueError(f"{config['name']}: the program cannot run "
                         f"{cannot} as the file states them")
    return dataclasses.replace(arch, name=config["name"], **kw)


def program_params(pc, m: dict, seed: int, device):
    """The program's ``lm.LM`` for ``pc`` holding ``weights.draw``'s
    leaves; the leaves must be the program's, name for name, shape for
    shape and dtype for dtype."""
    import torch
    from repro_torch.model import lm
    from portbench import weights
    params = lm.LM(pc, device)
    named = dict(params.named_parameters())
    drawn = weights.draw(m, seed, device)
    if set(named) != set(drawn):
        raise ValueError("leaves differ: "
                         f"{sorted(set(named) ^ set(drawn))[:8]}")
    with torch.no_grad():
        for k, p in named.items():
            if p.shape != drawn[k].shape or p.dtype != drawn[k].dtype:
                raise ValueError(f"{k}: {tuple(p.shape)} {p.dtype} in the "
                                 f"program, {tuple(drawn[k].shape)} "
                                 f"{drawn[k].dtype} drawn")
            p.copy_(drawn[k])
    del drawn
    return params


def free_device() -> None:
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
