"""Small cells for CPU tests: a real cell of ``BENCHMARK.json`` with its
configuration cut to a CPU's size and its traffic shortened; its limits
are the cell's own.  The serving cell keeps a wider model and 256 served
tokens compared, since its limit is a gap in logits, whose scale grows
with width and depth.  ``moe`` is granite-moe's configuration file, which
no cell runs yet, cut alike and without the four scalars the program
does not apply, on the B 1 training traffic."""
from __future__ import annotations

import copy

from portbench import harness

DENSE = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
             d_ff=512, vocab=512)
MOE = dict(DENSE, d_ff=128, moe_d_ff=128, n_experts=16, top_k=4)
SERVE = dict(DENSE, d_model=2048, n_heads=16, head_dim=128, d_ff=4096)
TRAFFIC = {"train4k-b2": dict(batch=2, seq=64),
           "train4k-b1": dict(batch=1, seq=64),
           "serve-longprompt": dict(batch=8, prompt_len=32, gen=16,
                                    sample_requests=16)}


def cell(name: str, **model) -> harness.Cell:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    c = harness.find_cell(name, bench)
    c.config = copy.deepcopy(c.config)
    m = c.config["model"]
    traffic = next(w["traffic"] for w in bench["workloads"]
                   if w["name"] == name)
    m.update(MOE if m.get("n_experts") else
             SERVE if c.traffic["driver"] == "serve" else DENSE)
    m.update(model)
    c.traffic = dict(c.traffic, **TRAFFIC[traffic])
    return c


def moe() -> harness.Cell:
    config = harness.load_json(harness.HERE / "configs"
                               / "granite-moe-3b-a800m.json")
    for k in ("attention_multiplier", "embedding_multiplier",
              "residual_multiplier", "logits_scaling"):
        config["model"].pop(k)
    config["model"].update(MOE)
    traffic = harness.load_json(harness.HERE / "traffic" / "train4k-b1.json")
    return harness.Cell("train.granite-moe-small", config,
                        dict(traffic, **TRAFFIC["train4k-b1"]), {}, 1)


def run(c: harness.Cell, seed: int = 3000000001, seconds: float = 0.3,
        trace: int = 0) -> dict:
    from portbench import run as runner
    return runner.run(["--workload", c.name, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      require_chip=False, device="cpu", cell=c)
