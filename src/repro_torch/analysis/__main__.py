"""``python -m repro_torch.analysis`` — lint benchmark designs from the CLI.

Runs ``analyze()`` over the named designs of ``repro_torch.fpga.benchmarks``
(``autobridge_suite`` + ``hbm_suite``) against their board's slot grid.
Exits non-zero when any design carries an error-severity diagnostic, which
is what the CI ``lint-designs`` step gates on.

    python -m repro_torch.analysis --all                # every design
    python -m repro_torch.analysis page_rank bucket_sort
    python -m repro_torch.analysis --all --json         # machine-readable
    python -m repro_torch.analysis --list               # show the registry
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.fpga import benchmarks, grid_for

from . import analyze


def _registry() -> dict[str, tuple[str, object]]:
    """``name@board -> (board, graph)`` over both benchmark suites; bare
    design names also resolve when unambiguous."""
    entries: dict[str, tuple[str, object]] = {}
    for name, board, graph in (benchmarks.autobridge_suite()
                               + benchmarks.hbm_suite()):
        entries[f"{name}@{board}"] = (board, graph)
    return entries


def _resolve(entries: dict, names: list[str]) -> list[str]:
    keys = []
    for want in names:
        if want in entries:
            keys.append(want)
            continue
        matches = [k for k in entries if k.split("@", 1)[0] == want]
        if not matches:
            raise SystemExit(f"unknown design {want!r} "
                             "(try --list for the registry)")
        keys.extend(matches)
    return keys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static dataflow lint over the benchmark designs")
    ap.add_argument("designs", nargs="*",
                    help="design names (bare or name@board)")
    ap.add_argument("--all", action="store_true",
                    help="lint every design of both suites")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON report list instead of text")
    ap.add_argument("--firings", type=int, default=200,
                    help="wave size for the deadlock verdict (default 200)")
    ap.add_argument("--list", action="store_true", dest="list_only",
                    help="list the design registry and exit")
    args = ap.parse_args(argv)

    entries = _registry()
    if args.list_only:
        for k in entries:
            print(k)
        return 0
    if args.all:
        keys = list(entries)
    elif args.designs:
        keys = _resolve(entries, args.designs)
    else:
        ap.error("name at least one design (or pass --all)")

    reports = []
    failed = 0
    for k in keys:
        board, graph = entries[k]
        rep = analyze(graph, grid=grid_for(board), firings=args.firings)
        reports.append((k, rep))
        if not rep.ok:
            failed += 1

    if args.as_json:
        print(json.dumps([dict(design=k, **rep.as_dict())
                          for k, rep in reports], indent=2))
    else:
        for k, rep in reports:
            print(f"{k}: {rep.summary().split(': ', 1)[1]}")
            for d in rep.diagnostics:
                if d.severity != "info":
                    print(f"  {d}")
        print(f"{len(reports)} design(s) linted, {failed} with errors")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
