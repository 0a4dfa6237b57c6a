"""The benchmark's files: every cell's configuration, traffic, limits and
metrics load by name; a new traffic mix and metric are found as new files;
nothing the harness or the reference loads is JAX or the JAX package."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness, run as runner

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = harness.find_cell(cell, BENCH)
    assert c.traffic["driver"] in ("train", "serve")
    assert c.limits and all(v > 0 for v in c.limits.values())
    # the configuration file holds the program's sizes as run
    pc = harness.program_config(c.config)
    assert pc.n_layers == c.model["n_layers"]
    entry = next(e for e in BENCH["configs"] if e["name"] == c.config["name"])
    assert entry["reduced"] == c.config["reduced"]
    assert entry["file"] == f"portbench/configs/{c.config['name']}.json"
    e2e = runner.metrics_for(BENCH, cell, "end_to_end")
    names = {e["name"] for e in e2e}
    assert "setup_s" in names and len(names) >= 2
    layers = runner.metrics_for(BENCH, cell, "per_layer", names)
    assert layers
    for e in layers:
        assert callable(harness.metric_reader(e["name"]))


def test_every_metric_of_the_benchmark_has_its_file():
    """Every per-layer metric has its reader; the one more file is
    ``moe_roofline.train``, for granite-moe's configuration, which no
    cell runs yet."""
    files = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert files - {e["name"] for e in BENCH["per_layer"]} == {
        "moe_roofline.train"}
    assert {e["name"] for e in BENCH["per_layer"]} <= files


def test_a_configuration_the_program_cannot_run_is_refused():
    """granite-moe's published scalars have no counterpart in the program:
    the harness refuses the file rather than run another model."""
    config = harness.load_json(harness.HERE / "configs"
                               / "granite-moe-3b-a800m.json")
    with pytest.raises(ValueError, match="attention_multiplier"):
        harness.program_config(config)
    for k in ("attention_multiplier", "embedding_multiplier",
              "residual_multiplier", "logits_scaling"):
        config["model"].pop(k)
    assert harness.program_config(config).n_experts == 40
    config["model"]["aux_loss_coef"] = 0.02
    with pytest.raises(ValueError, match="aux_loss_coef"):
        harness.program_config(config)


def test_a_new_traffic_and_metric_are_found_as_new_files(tmp_path,
                                                         monkeypatch):
    """A copy of the benchmark with a new traffic file, a new metric file
    and new entries in BENCHMARK.json, and no other file changed: the
    harness finds and drives the new cell and reads the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (root / "portbench/traffic/train1k-b1.json").write_text(json.dumps(
        dict(harness.load_json(harness.HERE / "traffic/train4k-b1.json"),
             seq=1024)))
    (root / "portbench/metrics/positions_per_step.train.py").write_text(
        "def read(r):\n"
        "    return r.traffic['batch'] * (r.traffic['seq'] + 1)\n")
    (root / "portbench/limits/train1k.granite-8b.json").write_text(
        json.dumps(harness.load_json(
            harness.HERE / "limits/train4k.granite-8b.json")))
    bench["workloads"].append(
        {"name": "train1k.granite-8b",
         "config": "granite-8b-stage9of36", "traffic": "train1k-b1",
         "chips": 1, "why": "a test cell"})
    bench["per_layer"].append(
        {"name": "positions_per_step.train", "unit": "count",
         "better": "higher", "source": "program_counter", "layer": "device",
         "moves": "train_tokens_per_s",
         "workloads": ["train1k.granite-8b"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", root / "portbench")
    monkeypatch.setattr(harness, "ROOT", root)

    c = harness.find_cell("train1k.granite-8b")
    assert c.traffic["seq"] == 1024
    from portbench.tests import _tiny
    monkeypatch.setitem(_tiny.TRAFFIC, "train1k-b1", dict(batch=1, seq=16))
    small = _tiny.cell("train1k.granite-8b")
    out = runner.run(["--workload", small.name, "--seed", "5",
                      "--seconds", "0.1", "--trace", "1"],
                     require_chip=False, device="cpu", cell=small,
                     bench=bench)
    assert out["metrics"]["positions_per_step.train"]["value"] == 17


def _imports_in_subprocess(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         f"sys.path[0:0] = [{str(harness.ROOT / 'src')!r}, "
         f"{str(harness.ROOT)!r}]\n" + code +
         "\nprint(' '.join(sorted({n.split('.')[0] for n in sys.modules})))"],
        capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole small run of each kind in a fresh process: no module whose
    top-level name, compared whole, is jax, jaxlib, flax or repro
    (``repro_torch`` is the program and stays)."""
    names = _imports_in_subprocess(
        "from portbench.tests import _tiny\n"
        "import portbench.control, portbench.run as R\n"
        "_tiny.run(_tiny.cell('train4k.granite-8b'), trace=1)\n"
        "_tiny.run(_tiny.cell('serve-longprompt.granite-8b'), trace=1)\n"
        "assert not R.forbidden_modules(), R.forbidden_modules()\n")
    assert "repro_torch" in names
    assert not names & runner.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    names = _imports_in_subprocess(
        "import portbench.reference.granite, portbench.reference.train\n"
        "import portbench.reference.precision, portbench.costs\n"
        "import portbench.traffic, portbench.weights, portbench.compare\n")
    assert not names & ({"repro_torch"} | runner.FORBIDDEN), names


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "reproduce_me", sys)
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert "reproduce_me" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert runner.forbidden_modules() == ["repro.core"]
