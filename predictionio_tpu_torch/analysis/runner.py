"""Lint orchestration: parse -> rules -> baseline -> report.

The port's copy of `predictionio_tpu/analysis/runner.py`. ``run_lint()``
is the one entry point the CLI, the tier-1 gate test and the fixture
suite all share; rule selection and root/baseline paths are parameters
so fixtures lint a directory of snippets with no baseline while the
gate lints ``predictionio_tpu_torch/`` under the port's own baseline,
``predictionio_tpu_torch/analysis/lint_baseline.json``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from predictionio_tpu_torch.analysis import (rules_cost, rules_locks,
                                            rules_torch)
from predictionio_tpu_torch.analysis.baseline import (BaselineEntry,
                                                apply_baseline,
                                                load_baseline)
from predictionio_tpu_torch.analysis.core import (Finding, RepoModel,
                                            number_occurrences)

#: every rule's checker, in reporting order
CHECKERS: Sequence[Callable[[RepoModel], List[Finding]]] = (
    rules_locks.check_lock001,
    rules_locks.check_lock002,
    rules_locks.check_lock003,
    rules_torch.check_torch001,
    rules_torch.check_torch002,
    rules_torch.check_torch003,
    rules_torch.check_torch004,
    rules_torch.check_torch005,
    rules_torch.check_torch006,
    rules_cost.check_cost001,
    rules_cost.check_cost002,
    rules_cost.check_cost003,
)


def default_root() -> str:
    """The package directory itself — the analyzer's repo-run target."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_baseline_path() -> str:
    """The port's baseline, shipped beside this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint_baseline.json")


@dataclass
class LintReport:
    findings: List[Finding]           # all, pre-baseline
    new: List[Finding]
    suppressed: List[Finding]
    stale: List[str]
    files: int
    elapsed_s: float
    parse_errors: List = field(default_factory=list)
    baseline_path: Optional[str] = None

    @property
    def ok(self) -> bool:
        # stale entries fail too: the tier-1 gate rejects them, so a
        # local `lint` must agree — a fixed
        # finding's baseline entry has to be deleted, not left to rot
        return not self.new and not self.parse_errors \
            and not self.stale

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "files": self.files,
            "elapsedS": round(self.elapsed_s, 3),
            "findings": [f.to_dict() for f in self.new],
            "suppressed": len(self.suppressed),
            "staleBaselineEntries": sorted(self.stale),
            "parseErrors": [{"path": p, "error": e}
                            for p, e in self.parse_errors],
            "baseline": self.baseline_path,
        }

    def render(self) -> str:
        lines = []
        for f in sorted(self.new, key=lambda f: (f.path, f.line)):
            lines.append(f"{f.path}:{f.line}: {f.rule_id} "
                         f"[{f.symbol or '<module>'}] {f.message}")
        for p, e in self.parse_errors:
            lines.append(f"{p}: PARSE ERROR {e}")
        stale_part = ""
        if self.stale:
            plural = "y" if len(self.stale) == 1 else "ies"
            stale_part = f", {len(self.stale)} STALE baseline entr{plural}"
        lines.append(
            f"pio lint: {len(self.new)} new finding(s), "
            f"{len(self.suppressed)} suppressed by baseline{stale_part} "
            f"({self.files} files, {self.elapsed_s:.1f}s)")
        if self.stale:
            for fp in sorted(self.stale):
                lines.append(f"  stale (no longer fires — remove from "
                             f"baseline): {fp}")
        return "\n".join(lines)


def run_lint(root: Optional[str] = None,
             baseline_path: Optional[str] = None,
             base: Optional[str] = None,
             use_baseline: bool = True) -> LintReport:
    t0 = time.perf_counter()
    root = root or default_root()
    repo = RepoModel(root, base=base)
    findings: List[Finding] = []
    for check in CHECKERS:
        findings.extend(check(repo))
    number_occurrences(findings)
    entries: List[BaselineEntry] = []
    bpath = None
    if use_baseline:
        bpath = baseline_path or default_baseline_path()
        entries = load_baseline(bpath)
    new, suppressed, stale = apply_baseline(findings, entries)
    return LintReport(findings=findings, new=new, suppressed=suppressed,
                      stale=stale, files=len(repo.modules),
                      elapsed_s=time.perf_counter() - t0,
                      parse_errors=repo.parse_errors,
                      baseline_path=bpath)


def main(argv: Optional[List[str]] = None) -> int:
    """``lint`` entry point (tools/cli.py delegates here)."""
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch lint",
        description="Static concurrency + torch hot-path analyzer. "
                    "Exit 0 = zero findings outside the baseline.")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report on stdout (CI mode)")
    p.add_argument("--root", default=None,
                   help="directory to analyze (default: the "
                        "predictionio_tpu_torch package)")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: predictionio_tpu_torch/"
                        "analysis/lint_baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, suppressing nothing")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to the current finding "
                        "set (new entries get a TODO justification "
                        "you must edit before committing)")
    args = p.parse_args(argv)

    report = run_lint(root=args.root, baseline_path=args.baseline,
                      use_baseline=not args.no_baseline)
    if args.update_baseline:
        from predictionio_tpu_torch.analysis.baseline import write_baseline
        bpath = args.baseline or default_baseline_path()
        existing = load_baseline(bpath)
        todo = write_baseline(bpath, report.findings, existing)
        print(f"wrote {bpath}: {len(report.findings)} entr"
              f"{'y' if len(report.findings) == 1 else 'ies'}"
              + (f", {todo} needing a justification (search for "
                 f"'TODO')" if todo else ""))
        return 1 if todo else 0
    if args.json:
        print(json.dumps(report.to_dict(), indent=1))
    else:
        print(report.render())
    return 0 if report.ok else 1
