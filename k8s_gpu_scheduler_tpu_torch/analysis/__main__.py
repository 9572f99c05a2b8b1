"""graftcheck for the port — ``python -m k8s_gpu_scheduler_tpu_torch.analysis
[paths...]``.

Default: every pass (the fast AST, lock-order, determinism and
shared-memory passes; the dynamic shared-page, steady-state and
wire-format passes) over the port's package, or over ``paths`` when
given (the registries' scenarios run only when the package is among
them). Exit code 0 iff no error-severity finding; findings print as
``file:line: [rule] message``, and each pass's seconds are printed.

``--fast`` runs only the fast passes (AST only, no card). ``--device cuda|cpu``
is where the dynamic passes run: ``cuda`` (the default) raises without a
card, ``cpu`` runs the kernels' plain versions. ``--json`` emits one
machine-readable line (findings, per-pass seconds, notes, the
multi-rank entries' stats by rank). ``--suppressions``
prints the suppression catalogue (the README block regenerates from it).
``--update-schemas`` refuses (exit 2): the goldens under
tests/data/graftcheck/schemas/ are the JAX package's, which the port only
reads.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m k8s_gpu_scheduler_tpu_torch.analysis",
        description="graftcheck for the PyTorch/CUDA port")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to analyze (default: the port's "
                             "package)")
    parser.add_argument("--fast", action="store_true",
                        help="AST, lock-order, determinism and "
                             "shared-memory passes only (AST only)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the dynamic passes run (default cuda, "
                             "which raises without a card)")
    parser.add_argument("--json", action="store_true",
                        help="emit a JSON summary line (findings list + "
                             "per-pass seconds)")
    parser.add_argument("--suppressions", action="store_true",
                        help="print the suppression catalogue (markdown "
                             "rows) and exit")
    parser.add_argument("--update-schemas", action="store_true",
                        help="refused: the port only reads the JAX "
                             "package's wire goldens")
    parser.add_argument("--warnings-as-errors", action="store_true")
    args = parser.parse_args(argv)

    from . import package_root, run_dynamic_passes, run_fast_passes
    from .findings import suppression_catalogue

    paths = list(args.paths) or [package_root()]
    if args.suppressions:
        for row in suppression_catalogue(paths):
            print(row)
        return 0
    if args.update_schemas:
        print("graftcheck: refusing --update-schemas: the wire goldens "
              "under tests/data/graftcheck/schemas/ are the JAX package's "
              "and the port only reads them; regenerate them with "
              "`python -m k8s_gpu_scheduler_tpu.analysis --update-schemas`",
              file=sys.stderr)
        return 2

    report = run_fast_passes(paths)
    if not args.fast:
        dyn = run_dynamic_passes(paths, device=args.device)
        report.findings.extend(dyn.findings)
        report.pass_seconds.update(dyn.pass_seconds)
        report.notes.extend(dyn.notes)
        report.stats.update(dyn.stats)
    failing = report.findings if args.warnings_as_errors else report.errors
    if args.json:
        print(json.dumps({
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "severity": f.severity, "message": f.message}
                for f in sorted(report.findings,
                                key=lambda f: (f.path, f.line, f.rule))],
            "n_findings": len(report.findings),
            "errors": len(report.errors),
            "pass_seconds": {k: round(v, 3)
                             for k, v in report.pass_seconds.items()},
            "rules": sorted({f.rule for f in report.findings}),
            "notes": report.notes,
            "stats": report.stats,
        }, default=str))
    timing = ", ".join(f"{k} {v:.3f} s"
                       for k, v in report.pass_seconds.items())
    if report.findings:
        print(report.render(header="graftcheck findings:"), file=sys.stderr)
    for note in report.notes:
        print(f"graftcheck: {note}", file=sys.stderr)
    print(f"graftcheck: {'clean' if not failing else 'FAILED'} "
          f"({timing})", file=sys.stderr)
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
