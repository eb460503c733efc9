"""Port parity: the static analyzer (`predictionio_tpu_torch/analysis/`,
`python -m predictionio_tpu_torch lint`) vs the JAX reference's
(`predictionio_tpu/analysis/`), on the CPU.

- Both analyzers run on both packages' sources with no baseline; each
  run gives the two the same LOCK*/COST* findings (rule, path, line,
  symbol, evidence, fingerprint), except the port-only host-sync lock
  label's, listed here by fingerprint with the reason.
- One true positive and one true negative per registered rule: the
  LOCK and COST rows on the reference's fixture files (read only, both
  analyzers agreeing on them), the TORCH rows on source strings written
  into a temporary tree; every true negative is clean of every rule.
- Rule ids keep their pattern and numbering; both packages'
  `load_baseline` reject the same bad files and both runners surface a
  stale entry; the port lints clean against its own baseline (no new
  finding, no stale entry) in under 30 s, through `run_lint` and through
  the port's `lint --json`; entries the reference baselines carry its
  justification.
- The triage: `costmon._dev_lock` is never taken by the thread that
  holds it (the LOCK001 the baseline accepts), and the zones keep the
  sanctioned sync sites out.
"""

import json
import os
import pathlib
import re
import threading
import time

import pytest

from predictionio_tpu.analysis import run_lint as j_run_lint
from predictionio_tpu.analysis.baseline import BaselineError as JBaselineError
from predictionio_tpu.analysis.baseline import load_baseline as j_load
from predictionio_tpu_torch.analysis import RULES, run_lint
from predictionio_tpu_torch.analysis.baseline import (BaselineError,
                                                      load_baseline)
from predictionio_tpu_torch.analysis.core import RULE_ID_PATTERN, RepoModel
from predictionio_tpu_torch.analysis.runner import default_baseline_path

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = str(REPO / "tests" / "fixtures" / "lint")
PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")

#: LOCK*/COST* findings only the port's analyzer reports, by fingerprint,
#: with the reason: its host-sync lock label (the counterpart of the
#: reference's jit-dispatch label) is the only blocking label it adds
PORT_ONLY = {
    "LOCK002:predictionio_tpu_torch/obs/costmon.py:device_timed:"
    "call:_event_pair_poll":
        "the poll closure that _event_pair_poll builds under _dev_lock "
        "synchronizes its end event (a host sync); the closure runs later, "
        "outside the lock",
}

#: the TORCH rows' fixtures: relative path -> source. Paths carry the
#: rule id; serving/ puts a file in the hot, serve and pipelined zones
TORCH_SOURCES = {
    "serving/torch001_tp.py": '''
import torch


def score(table, q):
    scores = torch.matmul(q, table.T)
    best = scores.max()
    return best.item()
''',
    "serving/torch001_tn.py": '''
import torch


def score(table, q):
    scores = torch.matmul(q, table.T)
    return torch.topk(scores, 4)
''',
    "torch002_tp.py": '''
import torch


def serve_step(table, x):
    def step():
        return x @ table.T
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = step()
    g.replay()
    return out.clone()
''',
    "torch002_tn.py": '''
import torch

_GRAPHS = {}


def serve_step(table, x):
    def step():
        return x @ table.T
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = step()
    _GRAPHS[id(table)] = (g, out)
    return out
''',
    "torch003_tp.py": '''
import torch


def replay_once(fn, x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = fn(x)
    g.replay()
    return y.clone()
''',
    "torch003_tn.py": '''
import functools

import torch


@functools.lru_cache(maxsize=8)
def graph_for(fn, shape):
    x = torch.zeros(shape, device="cuda")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = fn(x)
    return g, x, y
''',
    "torch004_tp.py": '''
import torch

_HELD = {}


def two_replays(fn, x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn(x)
    _HELD["g"] = g
    g.replay()
    first = out
    g.replay()
    return first + out
''',
    "torch004_tn.py": '''
import torch

_HELD = {}


def two_replays(fn, x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn(x)
    _HELD["g"] = g
    g.replay()
    first = out.clone()
    g.replay()
    return first + out
''',
    "serving/torch005_tp.py": '''
import functools

import torch


def _topk_b(table, q, k):
    return torch.topk(q @ table.T, k)


def _builder(bound, k=0):
    (table,) = bound
    return functools.partial(_topk_b, table, k=k), (torch.zeros(1, 4),)


def register_specs(aot):
    aot.register("topk", _builder)


def serve(table, q, k):
    return _topk_b(table, q, k)
''',
    "serving/torch005_tn.py": '''
import functools

import torch


def _topk_b(table, q, k):
    return torch.topk(q @ table.T, k)


def serve(table, q, k):
    from predictionio_tpu_torch.compile.aot import get_aot
    return get_aot().dispatch("topk", {"k": k},
                              functools.partial(_topk_b, table, k=k), q,
                              bound=(table,))
''',
    "serving/torch006_tp.py": '''
import torch


def finish_window(scores):
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return scores
''',
    "serving/torch006_tn.py": '''
import torch


def form_window(queries):
    batch = torch.stack(queries)
    return batch
''',
    # the host-sync lock label (LOCK002's counterpart of jit-dispatch)
    "lock002_hostsync_tp.py": '''
import threading

import torch


class Stager:
    def __init__(self):
        self._lock = threading.Lock()
        self.done = torch.cuda.Event()

    def wait(self):
        with self._lock:
            self.done.synchronize()

    def rows(self, x):
        y = torch.relu(x)
        with self._lock:
            return y.tolist()
''',
    "lock002_hostsync_tn.py": '''
import threading

import torch


class Stager:
    def __init__(self):
        self._lock = threading.Lock()
        self.done = torch.cuda.Event()
        self.waited = 0

    def wait(self):
        self.done.synchronize()
        with self._lock:
            self.waited += 1
''',
    # a device-wide synchronize in the serve zone outside the pipelined
    # zone (an ops serve kernel)
    "ops/als.py": '''
import torch


def users_topk(U, V, ixs, k):
    s, i = torch.topk(U[ixs] @ V.T, k)
    torch.cuda.synchronize()
    return s, i
''',
}

#: rule id -> (true-positive, true-negative) fixture; the LOCK and COST
#: rows name the reference's files under tests/fixtures/lint/, the TORCH
#: rows TORCH_SOURCES. Every registered rule has a row (asserted below).
RULE_FIXTURES = {
    "LOCK001": ("lock001_tp.py", "lock001_tn.py"),
    "LOCK002": ("lock002_tp.py", "lock002_tn.py"),
    "LOCK003": ("lock003_tp.py", "lock003_tn.py"),
    "TORCH001": ("serving/torch001_tp.py", "serving/torch001_tn.py"),
    "TORCH002": ("torch002_tp.py", "torch002_tn.py"),
    "TORCH003": ("torch003_tp.py", "torch003_tn.py"),
    "TORCH004": ("torch004_tp.py", "torch004_tn.py"),
    "TORCH005": ("serving/torch005_tp.py", "serving/torch005_tn.py"),
    "TORCH006": ("serving/torch006_tp.py", "serving/torch006_tn.py"),
    "COST001": ("cost001_tp/event_server.py",
                "cost001_tn/event_server.py"),
    "COST002": ("cost002_tp/server.py", "cost002_tn/server.py"),
    "COST003": ("cost003_tp/batcher.py", "cost003_tn/batcher.py"),
}


def _key(f):
    return (f.rule_id, f.path, f.line, f.symbol, f.evidence, f.fingerprint)


def _lock_cost(report):
    return {_key(f) for f in report.findings
            if f.rule_id.startswith(("LOCK", "COST"))}


@pytest.fixture(scope="module")
def package_runs():
    """{(analyzer, package): report} for both analyzers on both packages'
    sources, no baseline. Module-scoped: each pass parses a package."""
    out = {}
    for pkg in PACKAGES:
        for name, run in (("jax", j_run_lint), ("port", run_lint)):
            out[(name, pkg)] = run(root=str(REPO / pkg), base=str(REPO),
                                   use_baseline=False)
    return out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_both_analyzers_find_the_same_lock_and_cost_findings(package_runs,
                                                             pkg):
    j, t = package_runs[("jax", pkg)], package_runs[("port", pkg)]
    assert not j.parse_errors and not t.parse_errors
    assert j.files == t.files
    jf, tf = _lock_cost(j), _lock_cost(t)
    assert jf - tf == set()
    assert {k[-1] for k in tf - jf} == (
        set(PORT_ONLY) if pkg == "predictionio_tpu_torch" else set())
    assert len(tf) > 40


def test_the_port_analyzer_finds_no_torch_rule_on_the_reference(
        package_runs):
    """The TORCH rules key on torch calls, graph captures and the
    executable registry, none of which the JAX package has."""
    t = package_runs[("port", "predictionio_tpu")]
    assert [f.fingerprint for f in t.findings
            if f.rule_id.startswith("TORCH")] == []


def test_the_canary_verdict_is_off_the_request_graph_as_in_the_reference(
        package_runs):
    """The standalone deploy's durable canary verdict calls the registry
    as `ModelVersionRegistry().pin_last_good(...)`, as the reference's
    does, so neither analyzer's request graph reaches its fsync
    (tests/test_torch_canary.py holds that the pin is still made)."""
    for name, pkg in (("jax", "predictionio_tpu"),
                      ("port", "predictionio_tpu_torch")):
        report = package_runs[(name, pkg)]
        assert not [f for f in report.findings if f.rule_id == "COST001"]


@pytest.fixture(scope="module")
def torch_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("lint_fixtures")
    for rel, src in TORCH_SOURCES.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src.lstrip())
    return str(root)


def _by_path(report):
    by_path = {}
    for f in report.findings:
        by_path.setdefault(f.path, set()).add(f.rule_id)
    return by_path


@pytest.fixture(scope="module")
def fixture_findings(torch_tree):
    """The port analyzer's rule ids per fixture path: the reference's
    fixture tree and the TORCH tree, one pass each."""
    ref = run_lint(root=FIXTURES, base=FIXTURES, use_baseline=False)
    own = run_lint(root=torch_tree, base=torch_tree, use_baseline=False)
    assert not ref.parse_errors and not own.parse_errors
    return {**_by_path(ref), **_by_path(own)}, own


def test_both_analyzers_agree_on_the_reference_fixtures():
    j = j_run_lint(root=FIXTURES, base=FIXTURES, use_baseline=False)
    t = run_lint(root=FIXTURES, base=FIXTURES, use_baseline=False)
    assert _lock_cost(t) == _lock_cost(j)
    assert _lock_cost(t)


@pytest.mark.parametrize("rule_id", sorted(RULE_FIXTURES))
def test_true_positive_caught(fixture_findings, rule_id):
    tp, _ = RULE_FIXTURES[rule_id]
    fired = fixture_findings[0].get(tp, set())
    assert rule_id in fired, (rule_id, tp, sorted(fired))


@pytest.mark.parametrize("rule_id", sorted(RULE_FIXTURES))
def test_true_negative_clean(fixture_findings, rule_id):
    _, tn = RULE_FIXTURES[rule_id]
    assert rule_id not in fixture_findings[0].get(tn, set())


def test_true_negatives_fully_clean(fixture_findings):
    offenders = {tn: sorted(fixture_findings[0].get(tn, set()))
                 for _, tn in RULE_FIXTURES.values()
                 if fixture_findings[0].get(tn)}
    assert not offenders, offenders


def test_every_rule_has_a_fixture_row():
    assert set(RULE_FIXTURES) == set(RULES)
    assert len(RULES) == 12


def test_the_host_sync_lock_label(fixture_findings):
    """A lock held across an Event's synchronize or a device tensor's
    tolist is a LOCK002 (`host-sync:...`); the same sync outside the
    lock is not."""
    own = fixture_findings[1]
    got = sorted(f.evidence for f in own.findings
                 if f.path == "lock002_hostsync_tp.py"
                 and f.rule_id == "LOCK002")
    assert got == ["host-sync:self.done.synchronize", "host-sync:y.tolist"]
    assert "lock002_hostsync_tn.py" not in fixture_findings[0]


def test_a_device_wide_synchronize_in_a_serve_kernel(fixture_findings):
    """TORCH006 covers the whole serve zone for `torch.cuda.synchronize()`
    (it would invalidate a capture in flight), not only the pipelined
    modules."""
    own = fixture_findings[1]
    got = [(f.rule_id, f.evidence) for f in own.findings
           if f.path == "ops/als.py"]
    assert got == [("TORCH006", "device_synchronize")]


def test_fixture_names_embed_rule_ids():
    for rid, (tp, tn) in RULE_FIXTURES.items():
        assert rid.lower() in tp and rid.lower() in tn, rid


class TestRuleIds:
    def test_ids_match_pattern(self):
        assert RULE_ID_PATTERN == r"^(LOCK|TORCH|COST)[0-9]{3}$"
        assert [r for r in RULES if not re.match(RULE_ID_PATTERN, r)] == []

    def test_ids_match_their_registration_key(self):
        assert all(rule.id == key for key, rule in RULES.items())

    def test_families_are_contiguous_from_001(self):
        by_family = {}
        for rid in RULES:
            by_family.setdefault(rid[:-3], []).append(int(rid[-3:]))
        assert {f: sorted(n) for f, n in by_family.items()} == {
            "LOCK": [1, 2, 3], "TORCH": [1, 2, 3, 4, 5, 6],
            "COST": [1, 2, 3]}

    def test_titles_and_descriptions(self):
        for rule in RULES.values():
            assert rule.title and len(rule.title) <= 60, rule.id
            assert len(rule.description) >= 40, rule.id

    def test_lock_and_cost_rules_are_the_reference_rules(self):
        from predictionio_tpu.analysis import RULES as JRULES
        for rid, rule in RULES.items():
            if rid.startswith("COST") or rid in ("LOCK001", "LOCK003"):
                assert (rule.title, rule.description) == (
                    JRULES[rid].title, JRULES[rid].description), rid
        assert RULES["LOCK002"].title == JRULES["LOCK002"].title


def _write(tmp_path, entries):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"version": 1, "entries": entries}))
    return str(p)


@pytest.mark.parametrize("entries,match", [
    ([{"fingerprint": "LOCK002:*",
       "justification": "suppress everything in one line"}],
     "wildcard|blanket"),
    ([{"fingerprint": "LOCK002:a.py:F.m:os.fsync"}], "justification"),
    ([{"fingerprint": "LOCK002:a.py:F.m:os.fsync",
       "justification": "short"}], "justification"),
    ([{"fingerprint": "LOCK002:a.py:F.m:os.fsync",
       "justification": "because of reasons, ten+ chars"}] * 2,
     "duplicate"),
], ids=["wildcard", "missing", "short", "duplicate"])
def test_both_packages_reject_the_same_bad_baselines(tmp_path, entries,
                                                     match):
    p = _write(tmp_path, entries)
    with pytest.raises(BaselineError, match=match):
        load_baseline(p)
    with pytest.raises(JBaselineError, match=match):
        j_load(p)


def test_both_runners_surface_a_stale_entry(tmp_path):
    fp = "LOCK002:no/such/file.py:F.m:os.fsync"
    p = _write(tmp_path, [{"fingerprint": fp,
                           "justification": "this finding no longer exists"}])
    for run in (run_lint, j_run_lint):
        report = run(root=FIXTURES, base=FIXTURES, baseline_path=p)
        assert report.stale == [fp] and not report.ok


def test_a_torch_fingerprint_is_a_port_baseline_entry(tmp_path):
    fp = "TORCH001:predictionio_tpu_torch/ops/x.py:f:cpu:s"
    p = _write(tmp_path, [{"fingerprint": fp,
                           "justification": "a readback that is the result"}])
    assert [e.fingerprint for e in load_baseline(p)] == [fp]


class TestPortGate:
    """The port lints clean against its own baseline."""

    def test_whole_port_zero_new_and_zero_stale(self):
        t0 = time.monotonic()
        report = run_lint()
        elapsed = time.monotonic() - t0
        assert elapsed < 30.0, f"lint took {elapsed:.1f}s"
        assert report.baseline_path == default_baseline_path()
        assert default_baseline_path().endswith(
            os.path.join("predictionio_tpu_torch", "analysis",
                         "lint_baseline.json"))
        assert not report.parse_errors, report.parse_errors
        assert not report.new, "new lint findings:\n" + report.render()
        assert not report.stale, sorted(report.stale)
        assert report.files > 100

    def test_the_cli_json_contract(self, capsys):
        from predictionio_tpu_torch.tools.cli import main
        rc = main(["lint", "--json"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert out["ok"] is True
        assert out["findings"] == []
        assert out["staleBaselineEntries"] == []
        assert out["parseErrors"] == []
        assert out["suppressed"] > 0
        assert out["files"] > 100
        assert set(out) == {"ok", "files", "elapsedS", "findings",
                            "suppressed", "staleBaselineEntries",
                            "parseErrors", "baseline"}

    def test_the_baseline_carries_the_reference_justifications(self):
        ref = {e.fingerprint: e.justification for e in j_load(
            str(REPO / "conf" / "lint_baseline.json"))}
        entries = load_baseline(default_baseline_path())
        carried = 0
        for e in entries:
            assert e.fingerprint.split(":", 1)[0] in RULES, e.fingerprint
            theirs = ref.get(e.fingerprint.replace(
                "predictionio_tpu_torch/", "predictionio_tpu/"))
            if theirs is not None:
                assert e.justification == theirs, e.fingerprint
                carried += 1
        assert carried >= 44


class TestTriage:
    def test_the_cost_monitor_never_retakes_its_device_lock(
            self, monkeypatch):
        """LOCK001 on `costmon.device_timed` is accepted, not fixed: the
        lock-order edge comes from building the poll closure under
        `_dev_lock`, but the closure runs (`_book` ->
        `_note_device_time`, both taking the lock) only after `_harvest`
        has released it, and a graph's `sample=` callback runs outside
        it. A lock that fails on re-entry by its holder sees none over
        sampled event-pair dispatches, a stamping graph's replays and the
        flushes that book them."""
        import torch

        from predictionio_tpu_torch.analysis.rules_locks import \
            check_lock001
        from predictionio_tpu_torch.obs import costmon as TC

        class OwnedLock:
            def __init__(self):
                self._lk = threading.Lock()
                self.owner = None
                self.taken = 0

            def __enter__(self):
                if self.owner == threading.get_ident():
                    raise AssertionError("_dev_lock re-entered")
                self._lk.acquire()
                self.owner = threading.get_ident()
                self.taken += 1
                return self

            def __exit__(self, *exc):
                self.owner = None
                self._lk.release()

        class FakeEvent:
            def __init__(self, enable_timing=False):
                pass

            def record(self):
                pass

            def query(self):
                return True

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return 2.0

        class StampingGraph:
            records_events = True

            def __init__(self):
                self.pending = None

            def __call__(self, x, sample=None):
                self.poll(wait=True)
                self.pending = sample
                return x

            def poll(self, wait=False):
                if self.pending is not None:
                    book, self.pending = self.pending, None
                    book(0.001)
                return True

        TC.install()
        lock = OwnedLock()
        monkeypatch.setenv("PIO_DEVICE_SYNC_EVERY", "1")
        monkeypatch.setattr(TC, "_dev_lock", lock)
        monkeypatch.setattr(TC, "_dev_state", {})
        monkeypatch.setattr(TC, "_pending", [])
        monkeypatch.setattr(TC, "_on_card", lambda args: True)
        monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
        for _ in range(4):
            TC.device_timed("lock_probe_pair", lambda x: x, 1)
        graph = StampingGraph()
        for _ in range(4):
            TC.device_timed("lock_probe_graph", graph, 1)
        TC.flush()
        booked = TC.device_samples_by_executable()
        assert booked["lock_probe_pair"] == 4
        assert booked["lock_probe_graph"] == 4
        assert lock.taken > 0 and TC._pending == []
        report_fp = ("LOCK001:predictionio_tpu_torch/obs/costmon.py:"
                     "device_timed:self:costmon:_dev_lock")
        repo = RepoModel(str(REPO / "predictionio_tpu_torch"),
                         base=str(REPO))
        assert report_fp in {f.fingerprint for f in check_lock001(repo)}

    def test_the_zones_keep_the_sanctioned_sync_sites_out(self):
        from predictionio_tpu_torch.analysis.rules_torch import (
            in_hot_zone, in_pipelined_zone, in_serve_zone)
        p = "predictionio_tpu_torch/"
        for mod in ("serving/server.py", "serving/batcher.py",
                    "tenancy/host.py", "dataplane/pipeline.py"):
            assert in_pipelined_zone(p + mod) and in_serve_zone(p + mod)
        for mod in ("ops/readback.py", "ops/staging.py",
                    "obs/costmon.py", "compile/aot.py"):
            assert not in_pipelined_zone(p + mod), mod
        assert in_serve_zone(p + "ops/als.py")
        assert in_serve_zone(p + "online/fold_in.py")
        assert not in_serve_zone(p + "ops/markov.py")
        assert in_hot_zone(p + "ops/markov.py")
        assert not in_hot_zone(p + "obs/costmon.py")

    def test_the_programs_and_the_captures_are_recognised(self):
        repo = RepoModel(str(REPO / "predictionio_tpu_torch"),
                         base=str(REPO))
        mods = repo.modules
        assert mods["predictionio_tpu_torch/ops/als.py"].programs == {
            "_users_topk_b"}
        assert mods["predictionio_tpu_torch/ops/similarity.py"].programs \
            == {"_masked_topk_b"}
        from predictionio_tpu_torch.analysis.rules_torch import (
            _capture_sites, _graph_cached, _references_plane)
        fused = repo.functions[
            "predictionio_tpu_torch/ops/als.py::_FusedIteration.__init__"]
        sites = _capture_sites(fused)
        assert len(sites) == 2
        assert _graph_cached(fused, {"graph"})
        serve = repo.functions[
            "predictionio_tpu_torch/ops/als.py::users_topk_serve_begin"]
        assert _references_plane(serve)
