"""CLI for the chaos plane (the drilled subprocesses need torch).

::

    python -m tpudist_torch.chaos drill  --run-dir DIR [--family F ...]
                                         [--bench-out BENCH_CHAOS.json]
    python -m tpudist_torch.chaos verify --run-dir DIR

``drill`` runs the seeded fault matrix (baseline + the five families the
port carries) through the port's train CLI, then replays the artifacts
through the invariant checker and exits nonzero if any family broke its
contract; a family that needs the live bus (``hang``,
``telemetry_garbage``) exits 2 naming ROADMAP Queue A item 11b.
``verify`` re-checks an existing drill directory. ``chaos_report.json``
lands in the run dir either way, with the families not drilled under
``not_drilled``. The exit codes and summary lines are the JAX CLI's
(``tpudist/chaos/__main__.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from tpudist_torch.chaos import drill as drill_mod
from tpudist_torch.chaos import verify as verify_mod


def _summarise(report) -> None:
    for name, fam in sorted(report.get("families", {}).items()):
        status = "green" if fam.get("ok") else "RED"
        print(f"tpudist: chaos {name}: {status}"
              + ("" if fam.get("ok")
                 else " — " + "; ".join(fam.get("problems", []))))
    print(f"tpudist: chaos matrix "
          f"{'green' if report.get('ok') else 'RED'} "
          f"({len(report.get('families', {}))} families)")


def _not_drilled(report) -> None:
    """Name the families the drill left out in the report (and its
    ``chaos_report.json``), from ``chaos_results.json``."""
    run_dir = report.get("run_dir")
    results = verify_mod._load_json(os.path.join(
        run_dir, drill_mod.RESULTS_NAME)) if run_dir else None
    report["not_drilled"] = (results or {}).get("not_drilled", {})
    path = os.path.join(run_dir, verify_mod.REPORT_NAME)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, path)
    for name, why in sorted(report["not_drilled"].items()):
        print(f"tpudist: chaos {name}: not drilled — {why}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.chaos",
        description="deterministic fault-injection drills + the "
                    "invariant checker (jax-free driver)")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("drill", help="run the fault matrix then verify")
    d.add_argument("--run-dir", type=str, required=True)
    d.add_argument("--family", action="append", default=None,
                   choices=sorted(drill_mod.FAMILIES),
                   help="drill only these families (repeatable; "
                        "default: the five the port carries; hang and "
                        "telemetry_garbage are refused, naming ROADMAP "
                        "Queue A item 11b)")
    d.add_argument("--bench-out", type=str, default=None,
                   help="also write BENCH_CHAOS.json (BENCH_* harness "
                        "shape, headline = green family count)")
    v = sub.add_parser("verify", help="re-check an existing drill dir")
    v.add_argument("--run-dir", type=str, required=True)
    args = p.parse_args(argv)

    if args.cmd == "drill":
        try:
            report = verify_mod.run_and_verify(args.run_dir,
                                               families=args.family)
        except ValueError as e:
            print(f"tpudist_torch.chaos: {e}", file=sys.stderr)
            return 2
        if args.bench_out:
            tmp = f"{args.bench_out}.tmp"
            os.makedirs(os.path.dirname(args.bench_out) or ".",
                        exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(verify_mod.bench_artifact(report), f, indent=1)
            os.replace(tmp, args.bench_out)
    else:
        try:
            report = verify_mod.verify_matrix(args.run_dir)
        except FileNotFoundError as e:
            print(f"tpudist_torch.chaos: {e}", file=sys.stderr)
            return 2
        report["run_dir"] = args.run_dir
    _not_drilled(report)
    _summarise(report)
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
