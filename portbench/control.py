"""Readings that set a cell's limits (``limits/<cell>.json``): the
program's numbers on many seeds, the control's, and a training cell's
faults.  The benchmark's own runs do not run this.

  python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
      [--control-seeds 1,2,3] [--calls 3] [--out FILE]

For each seed it prints one JSON line (and appends it to ``--out``):

- training: the program's first steps (set-up's, on the cell's own
  object and feed) against the f32 reference (``program``); on a control
  seed also the reference computed in fp8 (``reference/precision.FP8``,
  the precision below the configurations' bf16) in the program's place
  (``control``), and the reference with half of each batch's targets left
  out of the loss (``fault_half_batch``), both against the f32 reference.
  A step that leaves its state unchanged reads 1 on ``grad_gap`` and
  ``change_gap`` by their definition, with no run.
- serving: ``--calls`` calls of the cell's own shape (batch, prompt,
  answer), a sample of their requests as a run draws it, and the widest
  gap of the served tokens (``program``); on a control seed the gap of
  the tokens the fp8 reference puts first at the same positions of the
  same sequences (``control``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _path() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def readings(workload: str, seeds, controls=(), calls: int = 3,
             out: str | None = None) -> list[dict]:
    """One line of readings a seed (see the module's docstring)."""
    _path()
    import torch
    from portbench import compare, harness
    from portbench.drivers import serve, train
    from portbench.reference.precision import FP8

    cell = harness.find_cell(workload)
    device = torch.device("cuda")
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        line = {"cell": cell.name, "seed": seed}
        if cell.traffic["driver"] == "train":
            step, params, opt, loader = train.build(cell, seed, device)
            prog = train.first_steps(cell, seed, device, step, params, opt)
            loader.close()
            del step, params, opt
            harness.free_device()
            ref = train.reference(cell, seed, device)
            line["program"] = compare.train_numbers(prog, ref)
            line["losses"] = {"program": prog["losses"],
                              "reference": ref["losses"]}
            if seed in controls:
                low = train.reference(cell, seed, device, FP8)
                half = train.reference(cell, seed, device,
                                       fault="half_batch")
                line["control"] = compare.train_numbers(low, ref)
                line["fault_half_batch"] = compare.train_numbers(half, ref)
                line["losses"].update(control=low["losses"],
                                      fault_half_batch=half["losses"])
        else:
            call = serve.build(cell, seed, device)
            served = torch.stack([call(i).tokens.cpu()
                                  for i in range(calls)])
            del call
            harness.free_device()
            numbers, _ = serve.check(cell, seed, served, device,
                                     control=seed in controls)
            line["program"] = {"logit_gap": numbers["logit_gap"]}
            if seed in controls:
                line["control"] = {
                    "logit_gap": numbers["control_logit_gap"]}
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(text + "\n")
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    readings(args.workload, [int(s) for s in args.seeds.split(",") if s],
             {int(s) for s in args.control_seeds.split(",") if s},
             args.calls, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
