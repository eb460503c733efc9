"""Accepted-finding baseline: ``analysis/lint_baseline.json``.

The port's copy of `predictionio_tpu/analysis/baseline.py`, with the
same file format and the same hygiene; the port keeps its own file,
shipped beside this module.

Every entry suppresses exactly ONE finding by its line-independent
fingerprint and must carry a one-line justification — there are no
wildcard/blanket suppressions by construction (a fingerprint names a
rule, file, symbol and evidence). The gate is therefore "zero NEW
findings": the analyzer stays honest about the debt it has accepted,
and a suppressed finding that stops firing surfaces as a *stale* entry
so the baseline shrinks as defects are paid down.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from predictionio_tpu_torch.analysis.core import Finding

MIN_JUSTIFICATION_CHARS = 10

#: fingerprint shape: RULE:path:symbol:evidence[#n] — validated so a
#: hand-edited entry can't silently match nothing (or everything)
_FPRINT_RE = re.compile(
    r"^(LOCK|TORCH|COST)[0-9]{3}:[^:]+:[^:]*:.+$")


class BaselineError(ValueError):
    pass


@dataclass(frozen=True)
class BaselineEntry:
    fingerprint: str
    justification: str


def load_baseline(path: str) -> List[BaselineEntry]:
    """Parse + validate. Raises BaselineError on blanket suppressions
    (wildcards), missing/short justifications, or duplicates."""
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("entries", [])
    out: List[BaselineEntry] = []
    seen = set()
    for i, e in enumerate(entries):
        fp = e.get("fingerprint", "")
        just = (e.get("justification") or "").strip()
        if "*" in fp or not _FPRINT_RE.match(fp):
            raise BaselineError(
                f"{path} entry {i}: fingerprint {fp!r} is not a full "
                f"single-finding fingerprint (no wildcards/blanket "
                f"suppressions)")
        if len(just) < MIN_JUSTIFICATION_CHARS:
            raise BaselineError(
                f"{path} entry {i} ({fp}): justification is required "
                f"(>= {MIN_JUSTIFICATION_CHARS} chars explaining why "
                f"this finding is accepted)")
        if fp in seen:
            raise BaselineError(f"{path}: duplicate fingerprint {fp}")
        seen.add(fp)
        out.append(BaselineEntry(fp, just))
    return out


def apply_baseline(findings: Sequence[Finding],
                   entries: Sequence[BaselineEntry]
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """-> (new, suppressed, stale_fingerprints)."""
    by_fp: Dict[str, BaselineEntry] = {e.fingerprint: e for e in entries}
    new: List[Finding] = []
    suppressed: List[Finding] = []
    hit = set()
    for f in findings:
        if f.fingerprint in by_fp:
            suppressed.append(f)
            hit.add(f.fingerprint)
        else:
            new.append(f)
    stale = [fp for fp in by_fp if fp not in hit]
    return new, suppressed, stale


def write_baseline(path: str, findings: Sequence[Finding],
                   existing: Sequence[BaselineEntry],
                   placeholder: str = "TODO: justify this accepted "
                                      "finding") -> int:
    """``pio lint --update-baseline``: rewrite with the CURRENT finding
    set, keeping justifications for fingerprints that survive and
    stamping new entries with a placeholder the operator must edit
    (load_baseline accepts it, review should not). Returns the number
    of placeholder entries written."""
    keep = {e.fingerprint: e.justification for e in existing}
    out = []
    todo = 0
    for f in sorted(findings, key=lambda f: f.fingerprint):
        just = keep.get(f.fingerprint)
        if just is None:
            just = placeholder
            todo += 1
        out.append({"fingerprint": f.fingerprint,
                    "rule": f.rule_id, "path": f.path,
                    "justification": just})
    doc = {"version": 1,
           "comment": "Accepted `pio lint` findings. Every entry "
                      "suppresses exactly one fingerprint and needs a "
                      "one-line justification; the CI gate is zero "
                      "findings outside this file (`python -m "
                      "predictionio_tpu_torch lint`).",
           "entries": out}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return todo
