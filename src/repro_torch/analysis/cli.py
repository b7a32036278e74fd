"""torchlint CLI: ``python -m repro_torch.analysis [options] [paths...]``
(the port's copy of ``repro.analysis.cli``).

Exit-code contract (stable — CI and tests depend on it):

* ``0`` — analyzed cleanly: zero unsuppressed findings (justified
  suppressions are fine and inventoried in the report);
* ``1`` — at least one unsuppressed finding (including PARSE errors in
  analyzed files and SUP001/SUP002 suppression-hygiene findings);
* ``2`` — usage error: unknown flag, nonexistent path.

``--output FILE`` always writes the full JSON report (findings AND the
suppression inventory) regardless of ``--format``, so CI can gate on
the exit code while archiving machine-readable findings as an
artifact; ``--sarif FILE`` does the same for the SARIF 2.1.0 report
GitHub code scanning ingests.

Default paths are the port's roots -- ``src/repro_torch`` and
``chip_smoke.py`` -- filtered to the ones that exist (explicitly-given
paths must exist or the run is a usage error). ``--changed-only``
narrows a directory scan to files git reports as modified/untracked,
falling back to the full scan outside a git checkout — cheap enough
for a pre-commit hook, never silently weaker than CI's full scan.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from repro_torch.analysis import core

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")


def _list_rules() -> str:
    lines = ["torchlint rules (details: the repro_torch.analysis "
             "docstring):", ""]
    for rule in core.all_rules():
        lines.append(f"  {rule.id:8s} {rule.title}")
        lines.append(f"  {'':8s}   guards: {rule.tax}")
    lines.append("")
    for rid, desc in sorted(core.META_RULES.items()):
        lines.append(f"  {rid:8s} {desc} (meta; not suppressible)")
    return "\n".join(lines)


def _git_changed_files() -> set[Path] | None:
    """Absolute paths of files git reports as changed (vs HEAD) or
    untracked. None when git is unavailable or this is not a checkout —
    callers then fall back to the full scan."""
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=30)
        if top.returncode != 0:
            return None
        root = Path(top.stdout.strip())
        changed = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            capture_output=True, text=True, timeout=30)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            capture_output=True, text=True, timeout=30)
        if changed.returncode != 0 or untracked.returncode != 0:
            return None
        names = changed.stdout.splitlines() + untracked.stdout.splitlines()
        return {(root / n).resolve() for n in names if n.strip()}
    except (OSError, subprocess.SubprocessError):
        return None


def _select_changed(paths: list[str]) -> list[Path] | None:
    """Narrow the scan to changed files under ``paths``. None means
    'no narrowing possible' (not a git checkout); an empty list means
    'git says nothing under these paths changed'."""
    changed = _git_changed_files()
    if changed is None:
        return None
    files = []
    for f in core.iter_python_files(paths):
        if Path(f).resolve() in changed:
            files.append(f)
    return files


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torchlint: the Three-Taxes static analyzer for the "
                    "PyTorch port (host syncs, graph-key hazards, "
                    "dispatch budgets, ring schedules, kernel hygiene). "
                    "Stdlib-only; imports neither torch nor jax.")
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to analyze (default: the existing "
             "subset of: " + " ".join(DEFAULT_PATHS) + ")")
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
        help="stdout report format (default: text)")
    parser.add_argument(
        "--output", metavar="FILE",
        help="also write the JSON report to FILE (written on both "
             "clean and failing runs, for CI artifacts)")
    parser.add_argument(
        "--sarif", metavar="FILE",
        help="also write the SARIF 2.1.0 report to FILE (for GitHub "
             "code-scanning upload; written on both clean and failing "
             "runs)")
    parser.add_argument(
        "--changed-only", action="store_true",
        help="analyze only files git reports as changed or untracked "
             "(full scan outside a git checkout) — for pre-commit")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit 0")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    paths = args.paths
    if not paths:
        paths = [p for p in DEFAULT_PATHS if Path(p).exists()]
        if not paths:
            print("torchlint: error: none of the default paths "
                  f"({' '.join(DEFAULT_PATHS)}) exist here — pass "
                  "paths explicitly", file=sys.stderr)
            return 2

    try:
        if args.changed_only:
            selected = _select_changed(paths)
            if selected is None:
                findings, suppressed, nfiles = core.analyze_paths(paths)
            else:
                findings, suppressed, nfiles = core.analyze_paths(selected)
        else:
            findings, suppressed, nfiles = core.analyze_paths(paths)
    except core.UsageError as e:
        print(f"torchlint: error: {e}", file=sys.stderr)
        return 2

    report = core.to_report(findings, suppressed, nfiles, paths)
    if args.output:
        Path(args.output).write_text(json.dumps(report, indent=2) + "\n")
    if args.sarif:
        Path(args.sarif).write_text(
            json.dumps(core.to_sarif(findings, suppressed), indent=2)
            + "\n")

    if args.format == "json":
        print(json.dumps(report, indent=2))
    elif args.format == "sarif":
        print(json.dumps(core.to_sarif(findings, suppressed), indent=2))
    else:
        for f in findings:
            print(f.render())
        status = "clean" if not findings else "FAILED"
        print(f"torchlint: {status} — {len(findings)} finding(s), "
              f"{len(suppressed)} suppressed (justified), "
              f"{nfiles} file(s)")
    return 1 if findings else 0
