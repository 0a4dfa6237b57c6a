"""CLI for trace files: ``python -m repro_torch.obs {summarize,validate} trace.json``."""

from __future__ import annotations

import argparse
import json
import sys

from .trace import summarize, validate_chrome


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summarize",
                           help="top-N wall-time table for a trace")
    p_sum.add_argument("trace", help="Chrome trace_event JSON file")
    p_sum.add_argument("-n", "--top", type=int, default=15,
                       help="rows to show (default 15)")
    p_val = sub.add_parser("validate",
                           help="schema-check a trace; exit 1 on errors")
    p_val.add_argument("trace", help="Chrome trace_event JSON file")
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        doc = json.load(f)

    if args.cmd == "summarize":
        print(summarize(doc, top=args.top))
        return 0
    errors = validate_chrome(doc)
    for err in errors:
        print(f"trace: {err}", file=sys.stderr)
    if errors:
        return 1
    n = sum(1 for e in doc.get("traceEvents", ()) if e.get("ph") == "E")
    print(f"ok: {n} spans")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
