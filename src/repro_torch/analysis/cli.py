"""``python -m repro_torch.analysis`` — run the three analysis layers,
gate against a baseline, exit non-zero on any new finding.

Usage::

    python -m repro_torch.analysis                    # all layers, the card
    python -m repro_torch.analysis --device cpu       # all layers, the CPU
    python -m repro_torch.analysis --format=json --out findings.json
    python -m repro_torch.analysis --only lint,contracts
    python -m repro_torch.analysis --skip audit

The contracts and audit layers build models on ``--device`` (the card
unless it says ``cpu``); the lint needs none.  The port's tree is kept
clean, so the default baseline file is absent and every finding is new;
``--baseline`` names one, written by ``--write-baseline --reason``.

Exit codes: 0 = clean (no finding outside the baseline), 1 = new
findings, 2 = usage error."""

from __future__ import annotations

import argparse
import os
import sys

from .findings import Baseline, render_human, render_json, sort_findings

LAYERS = ("lint", "contracts", "audit")
BASELINE_NAME = "analysis_baseline_torch.json"


def default_root() -> str:
    """The repo root: cwd when it holds ``src/repro_torch``, else derived
    from this file's location (three levels up from
    ``src/repro_torch/analysis``)."""
    if os.path.isdir(os.path.join(os.getcwd(), "src", "repro_torch")):
        return os.getcwd()
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


def collect(layers, root: str, archs=None, device=None) -> list:
    findings = []
    if "lint" in layers:
        from .lint import run_lint
        findings += run_lint(root)
    if "contracts" in layers:
        from .contracts import run_contracts
        findings += run_contracts(device)
    if "audit" in layers:
        from .audit import run_audit
        findings += run_audit(archs, device)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis and model audit of the port")
    ap.add_argument("--format", choices=("human", "json"), default="human")
    ap.add_argument("--root", default=None,
                    help="repo root to lint (default: auto-detected)")
    ap.add_argument("--baseline", default=None,
                    help=f"suppression file (default <root>/{BASELINE_NAME})")
    ap.add_argument("--only", default="",
                    help=f"comma list of layers to run ({','.join(LAYERS)})")
    ap.add_argument("--skip", default="",
                    help="comma list of layers to skip")
    ap.add_argument("--arch", action="append", default=None,
                    help="restrict the audit to these arch ids "
                         "(repeatable; default: all five families)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu, for the contracts "
                         "and audit layers")
    ap.add_argument("--out", default="",
                    help="also write the JSON report to this path")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from current findings")
    ap.add_argument("--reason", default="",
                    help="justification recorded with --write-baseline")
    args = ap.parse_args(argv)

    layers = list(LAYERS)
    if args.only:
        layers = [l for l in args.only.split(",") if l]
    if args.skip:
        skip = set(args.skip.split(","))
        layers = [l for l in layers if l not in skip]
    unknown = [l for l in layers if l not in LAYERS]
    if unknown:
        print(f"unknown layer(s) {unknown}; known: {LAYERS}",
              file=sys.stderr)
        return 2

    root = os.path.abspath(args.root) if args.root else default_root()
    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)

    findings = collect(layers, root, args.arch, args.device)

    if args.write_baseline:
        if not args.reason:
            print("--write-baseline requires --reason (the baseline is "
                  "an audit trail)", file=sys.stderr)
            return 2
        Baseline.from_findings(findings, args.reason).dump(baseline_path)
        print(f"baselined {len(findings)} finding(s) -> {baseline_path}")
        return 0

    new, suppressed = Baseline.load(baseline_path).apply(findings)
    new = sort_findings(new)
    if args.format == "json":
        print(render_json(new, suppressed))
    else:
        print(render_human(new, suppressed))
    if args.out:
        with open(args.out, "w") as f:
            f.write(render_json(new, suppressed) + "\n")
    return 1 if new else 0
