"""Port parity: the metrics registry (`obs/metrics.py`), its exposition
(`utils/prometheus.py`), the tenant context (`obs/tenantctx.py`) and
`GET /metrics` on both servers vs the JAX reference's, on the CPU.

- The same seeded sequence of registrations, `inc`/`set`/`observe` and
  func collectors on a port and a reference registry (each a child of a
  parent of its own) renders byte-equal exposition text, both formats,
  and equal JSON snapshots, histogram p50/p95/p99 included (exact: the
  same float operations in the same order).
- `render_metrics` on the same families, exemplar-bearing samples
  included, is byte-equal; `wants_exemplars` agrees on every spelling.
- `tenant_scope`/`metric_tenant_label` agree on the same registrations.
- The families (name, type, label names) the port's engine server and
  event server register, after the same traffic as the reference's on
  the same small model, equal the reference's apart from the families
  of planes not ported yet, each of which ROADMAP.md names. Measured in
  a fresh interpreter, so families other tests registered in the same
  worker cannot blur the sets.
- `/metrics` answers the text format on both servers; the event
  server's is 404 without `--stats`, with the reference's body.
"""

import json
import pathlib
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.obs import metrics as JM
from predictionio_tpu.obs import tenantctx as JT
from predictionio_tpu.utils import prometheus as JP
from predictionio_tpu_torch.obs import metrics as TM
from predictionio_tpu_torch.obs import tenantctx as TT
from predictionio_tpu_torch.utils import prometheus as TP

REPO = pathlib.Path(__file__).resolve().parent.parent

# the families of planes the port has not ported yet, which the
# reference's servers register and the port's do not (ROADMAP.md lists
# each by name): none left
UNPORTED_ENGINE = set()
# the diagnostics plane's families, registered by both packages' servers
DIAGNOSTICS = (
    "pio_flight_records_total", "pio_flight_dropped_total",
    "pio_flight_coalesced_total", "pio_flight_write_errors_total",
    "pio_incidents_captured_total", "pio_incidents_suppressed_total",
    "pio_lock_wait_seconds",
    "pio_profiler_running", "pio_profiler_samples_total",
    "pio_profiler_spent_seconds_total",
    "pio_slow_queries_total",
)
UNPORTED_EVENT = UNPORTED_ENGINE
# the resilience plane's families on the event server (the spill WAL and
# the event-store breaker), registered by both packages
RESILIENCE_EVENT = (
    "pio_ingest_spilled_total", "pio_ingest_spill_pending_bytes",
    "pio_breaker_state", "pio_breaker_transitions_total",
    "pio_breaker_fast_failures_total",
)


def ops(seed: int):
    """A seeded program of registry operations: (method, args)."""
    rng = np.random.default_rng(seed)
    prog = [("counter", ("c_plain_total", "plain counter")),
            ("counter", ("c_lab_total", 'a "quoted" help\nline',
                         ("reason", "kind"))),
            ("gauge", ("g_plain", "plain gauge")),
            ("gauge", ("g_lab", "labeled gauge", ("t",))),
            ("histogram", ("h_plain", "plain histogram", None)),
            ("histogram", ("h_lab", "labeled histogram",
                           (0.1, 1.0, 10.0), ("stage",)))]
    for _ in range(200):
        k = int(rng.integers(0, 6))
        v = float(np.round(rng.exponential(2.0), 6))
        lab = str(rng.choice(["a", "b", 'q"x\\y', "new\nline"]))
        prog.append([("inc", "c_plain_total", None, v),
                     ("inc", "c_lab_total", {"reason": lab, "kind": "k"}, v),
                     ("set", "g_plain", None, v - 2.0),
                     ("set", "g_lab", {"t": lab}, v),
                     ("observe", "h_plain", None, v),
                     ("observe", "h_lab", {"stage": lab}, v)][k])
    return prog


def run(M, seed: int):
    parent = M.MetricsRegistry()
    reg = M.MetricsRegistry(parent=parent)
    parent.counter("parent_total", "from the parent").inc(3)
    parent.gauge("c_plain_total", "shadowed by the child")
    state = {"n": 0}
    reg.gauge_func("f_gauge", "func gauge", lambda: state["n"] * 0.5)
    reg.counter_func("f_counter_total", "func counter",
                     lambda: [({"kind": "x"}, state["n"]),
                              ({"kind": "y"}, float("nan"))])
    reg.summary_func("f_summary", "func summary",
                     lambda: [({"quantile": "0.5"}, state["n"] / 3.0)])
    reg.gauge_func("f_raises", "raises", lambda: 1 / 0)
    fams = {}
    for step in ops(seed):
        if step[0] in ("counter", "gauge", "histogram"):
            kind, args = step
            if kind == "histogram":
                name, help_, buckets = args[:3]
                labels = args[3] if len(args) > 3 else ()
                fams[name] = reg.histogram(name, help_, buckets=buckets,
                                           labelnames=labels)
            else:
                fams[args[0]] = getattr(reg, kind)(*args)
            continue
        op, name, labels, v = step
        m = fams[name]
        if labels:
            m = m.labels(**labels)
        getattr(m, op)(v)
        state["n"] += 1
    return reg, fams


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_operations_render_byte_equal_text(seed):
    j, jf = run(JM, seed)
    t, tf = run(TM, seed)
    assert t.render() == j.render()
    assert t.render(exemplars=True) == j.render(exemplars=True)
    assert t.render(include_parent=False) == j.render(include_parent=False)
    assert t.snapshot() == j.snapshot()
    for name in ("h_plain", "h_lab"):
        hj, ht = jf[name], tf[name]
        kids = ([()] if name == "h_plain" else
                sorted(hj._children))
        for key in kids:
            a = hj if key == () else hj._children[key]
            b = ht if key == () else ht._children[key]
            for q in (50, 95, 99, 0, 100):
                assert b.percentile(q) == a.percentile(q)
            assert b.snapshot() == a.snapshot()
            assert b.bucket_counts() == a.bucket_counts()
    assert t.get("parent_total").value == j.get("parent_total").value == 3
    assert t.get("c_plain_total").mtype == "counter"


def test_registration_rules_match():
    for M in (JM, TM):
        reg = M.MetricsRegistry()
        c = reg.counter("x_total", "x")
        assert reg.counter("x_total", "again") is c
        with pytest.raises(ValueError):
            reg.gauge("x_total", "a gauge now")
        with pytest.raises(ValueError):
            c.inc(-1)
        lab = reg.counter("y_total", "y", labelnames=("a",))
        with pytest.raises(ValueError):
            lab.inc()
        with pytest.raises(ValueError):
            lab.labels(b="1")
        reg.unregister("x_total")
        assert reg.get("x_total") is None
    assert TM.json_label({"b": 2, "a": 1}) == JM.json_label({"b": 2, "a": 1})
    assert TM.DEFAULT_BUCKETS == JM.DEFAULT_BUCKETS
    assert TP.CONTENT_TYPE == JP.CONTENT_TYPE
    assert TP.OPENMETRICS_CONTENT_TYPE == JP.OPENMETRICS_CONTENT_TYPE


@pytest.mark.parametrize("exemplars", [False, True])
def test_render_metrics_is_the_reference(exemplars):
    fams = [
        ("a_total", "counter", 'help \\ with\nnewline', [
            ({"k": 'v"1'}, 1.5), (None, 2)]),
        ("h", "histogram", "h", [
            ("_bucket", {"le": "0.5"}, 3,
             {"labels": {"trace_id": "t1"}, "value": 0.25, "ts": 12.3456}),
            ("_bucket", {"le": "+Inf"}, 4),
            ("_sum", None, 1.0), ("_count", None, 4),
            ("_sum", None, 2.0, {"labels": {}, "value": 1.0})]),
        ("empty", "gauge", "no samples", []),
    ]
    assert TP.render_metrics(fams, exemplars=exemplars) == \
        JP.render_metrics(fams, exemplars=exemplars)


def test_wants_exemplars_agrees():
    class Req:
        def __init__(self, params):
            self.params = params
    for v in ("1", "true", "YES", "0", "", "no", None):
        req = Req({} if v is None else {"exemplars": v})
        assert TP.wants_exemplars(req) == JP.wants_exemplars(req)
    assert TP.wants_exemplars(object()) == JP.wants_exemplars(object())


def test_tenant_labels_are_bounded_alike(monkeypatch):
    for mod in (JT, TT):
        # the registration below is undone after the test
        monkeypatch.setattr(mod, "_registered", mod._registered)
        assert mod.current_tenant() is None
        assert mod.metric_tenant_label() == ""
        with mod.tenant_scope("t-unregistered"):
            assert mod.current_tenant() == "t-unregistered"
            assert mod.metric_tenant_label() == ""
        with mod.tenant_scope(None):
            assert mod.current_tenant() is None
        mod.register_tenant("t-parity")
        with mod.tenant_scope("t-parity"):
            assert mod.metric_tenant_label() == "t-parity"
        assert mod.metric_tenant_label("t-parity") == "t-parity"
        assert "t-parity" in mod.registered_tenants()
    assert TT.TENANT_LABEL == JT.TENANT_LABEL


FAMILIES_SCRIPT = r'''
import json, os, sys, tempfile, urllib.request
import numpy as np
root = tempfile.mkdtemp()
os.environ.update({
    "PIO_FS_BASEDIR": root,
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio_meta",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQLITE",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio_event",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQLITE",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOCALFS",
    "PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_SQLITE_URL": root + "/pio.db",
    "PIO_STORAGE_SOURCES_LOCALFS_TYPE": "localfs",
    "PIO_STORAGE_SOURCES_LOCALFS_HOSTS": root + "/models"})
import jax
jax.config.update("jax_platforms", "cpu")
from predictionio_tpu.core import FirstServing
from predictionio_tpu.data.api import event_server as JES
from predictionio_tpu.data.bimap import EntityIdIxMap
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu.ops import als as JALS
from predictionio_tpu.serving import server as JSrv
from predictionio_tpu_torch.core import TrainResult
from predictionio_tpu_torch.data.api import event_server as TES
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.weights import from_jax_model

def families(reg):
    out = {}
    while reg is not None:
        for m in list(reg._metrics.values()):
            out.setdefault(m.name, [m.mtype, list(m.labelnames)])
        reg = reg.parent
    return out

def traffic(port):
    base = "http://127.0.0.1:%d" % port
    for k in range(6):
        body = {"user": "u%d" % k, "num": 3}
        if k % 2:
            body["categories"] = ["c1"]
        req = urllib.request.Request(base + "/queries.json",
                                     data=json.dumps(body).encode(),
                                     method="POST")
        urllib.request.urlopen(req, timeout=60).read()
    urllib.request.urlopen(base + "/stats.json", timeout=60).read()
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        return r.headers["Content-Type"], r.read().decode()

rng = np.random.default_rng(0)
U = rng.standard_normal((40, 6)).astype(np.float32)
V = rng.standard_normal((30, 6)).astype(np.float32)
props = [{"categories": ["c%d" % (i % 3)]} for i in range(30)]
ui = EntityIdIxMap.build(["u%d" % k for k in range(40)])
ii = EntityIdIxMap.build(["i%d" % k for k in range(30)])
c, y = JR.RecommendationModel.derive_filters(props)
mj = JR.RecommendationModel(JALS.ALSModel(U, V, 6), ui, ii,
                            item_properties=props, item_categories=c,
                            item_years=y)
mt = from_jax_model(U, V, list(ui._ids), list(ii._ids), 6, device="cpu",
                    item_properties=props)
j = JSrv.EngineServer(JSrv.ServerConfig(ip="127.0.0.1", port=0),
                      engine=JR.RecommendationEngineFactory.apply())
j.algorithms = [JR.ALSAlgorithm(JR.ALSAlgorithmParams(rank=6))]
j.models, j.serving, j.model_version = [mj], FirstServing(), "v0"
t = EngineServer(ServerConfig(port=0), TR.RecommendationEngineFactory.apply(),
                 TR.RecommendationEngineFactory.engine_params(
                     TR.RatingsData([], [], [])),
                 TrainResult(models=[mt], algorithms=[TR.ALSAlgorithm(
                     TR.ALSAlgorithmParams(rank=6, device="cpu"))]))
j.start(background=True)
t.start()
out = {"engine": {}, "event": {}, "text": {}}
for name, srv in (("jax", j), ("port", t)):
    ctype, text = traffic(srv.config.port)
    out["engine"][name] = families(srv.metrics)
    out["text"][name] = [ctype, text]
t.stop()
j.stop()
es_j = JES.EventServer(JES.EventServerConfig(ip="127.0.0.1", port=0,
                                             stats=True))
es_t = TES.EventServer(TES.EventServerConfig(ip="127.0.0.1", port=0,
                                             stats=True))
out["event"] = {"jax": families(es_j.metrics), "port": families(es_t.metrics)}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def server_families():
    """Both packages' engine servers after the same six queries (half of
    them filtered), a /stats.json and a /metrics, and both event servers,
    in a fresh interpreter."""
    out = subprocess.run([sys.executable, "-c", FAMILIES_SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=240,
                         env={**__import__("os").environ,
                              "JAX_PLATFORMS": "cpu",
                              "PIO_AOT_WARM": "off", "PIO_PROFILER": "off",
                              "PIO_XLA_CACHE": "off"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("server,unported", [("engine", UNPORTED_ENGINE),
                                             ("event", UNPORTED_EVENT)])
def test_server_families_differ_only_by_the_unported_planes(
        server_families, server, unported):
    j, t = server_families[server]["jax"], server_families[server]["port"]
    assert set(t) <= set(j), sorted(set(t) - set(j))
    assert set(j) - set(t) == unported & set(j), sorted(set(j) - set(t))
    for name in t:
        assert t[name] == j[name], (name, t[name], j[name])
    if server == "event":
        assert set(RESILIENCE_EVENT) <= set(t) & set(j)
    roadmap = (REPO / "ROADMAP.md").read_text()
    assert [n for n in sorted(set(j) - set(t)) if n not in roadmap] == []


@pytest.mark.parametrize("family", DIAGNOSTICS)
@pytest.mark.parametrize("server", ["engine", "event"])
def test_diagnostics_families_are_registered(server_families, server,
                                             family):
    j, t = server_families[server]["jax"], server_families[server]["port"]
    assert family in j
    assert t.get(family) == j[family]


def test_engine_metrics_answer_the_text_format(server_families):
    ctype_j, text_j = server_families["text"]["jax"]
    ctype_t, text_t = server_families["text"]["port"]
    assert ctype_t == ctype_j == TP.CONTENT_TYPE
    typed = [line.split()[2] for line in text_t.splitlines()
             if line.startswith("# TYPE ")]
    assert len(typed) == len(set(typed)) == len(
        server_families["engine"]["port"])
    for line in text_t.splitlines():
        if line and not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.mark.parametrize("stats", [False, True])
def test_event_server_metrics_is_gated_like_the_reference(tmp_env, stats):
    from predictionio_tpu.data.api import event_server as JES
    from predictionio_tpu_torch.data.api import event_server as TES
    got = {}
    for name, mod in (("jax", JES), ("port", TES)):
        srv = mod.EventServer(mod.EventServerConfig(ip="127.0.0.1", port=0,
                                                    stats=stats))
        srv.start()
        try:
            got[name] = get(f"http://127.0.0.1:{srv.config.port}/metrics")
        finally:
            srv.stop()
    (sj, cj, bj), (st, ct, bt) = got["jax"], got["port"]
    assert st == sj == (200 if stats else 404)
    if stats:
        assert ct == cj == TP.CONTENT_TYPE
        assert b"# TYPE pio_event_window_events gauge" in bt
    else:
        assert json.loads(bt) == json.loads(bj)
