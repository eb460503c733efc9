"""`lint`: whole-package static analysis of the port for the defect
classes the rebuild keeps paying for by hand.

The port's counterpart of `predictionio_tpu/analysis/`, pure ``ast``
like it. Three rule families over ``predictionio_tpu_torch/``:

- ``LOCK*``: lock discipline: the package-wide lock graph (order cycles
  = deadlock potential), locks held across blocking calls (FFI
  ``el_*``, fsync/file IO, HTTP, queue waits, a host sync with the card),
  attributes mutated from background threads without a lock.
- ``TORCH*``: hot-path hygiene: implicit host syncs in serving/fold
  code, CUDA graphs captured around closures or per call, a graph's
  static output read after its next replay, serve-zone programs called
  around the compile plane, syncs in the pipelined serve zone.
- ``COST*``: hot-path cost: fsync, eager log-string formatting, or
  metric *registration* (vs. increment) on the ingest-ack/query paths.

Accepted findings live in ``analysis/lint_baseline.json`` with one-line
justifications; the gate (``tests/test_torch_analysis.py`` and
``python -m predictionio_tpu_torch lint --json``) is **zero NEW
findings** and no stale entries.
"""

from predictionio_tpu_torch.analysis.core import (Finding, RepoModel, Rule,
                                            RULES)
from predictionio_tpu_torch.analysis.runner import (LintReport,
                                              default_baseline_path,
                                              default_root, run_lint)

__all__ = ["Finding", "RepoModel", "Rule", "RULES", "LintReport",
           "run_lint", "default_root", "default_baseline_path"]
