"""Port parity: the serving result cache (`serving/result_cache.py` and
the server's use of it) vs the JAX reference, on the CPU.

- `ResultCache`: the same seeded sequence of `put` (fresh, stale and
  absent generations, raw aliases), `get`, `get_raw`,
  `invalidate_entities` (default and strict), `invalidate_prefix`,
  `invalidate_all`, under entry and byte budgets, gives the same return
  value at every step, the same LRU order and the same `stats()` in both
  modules; the reference's unit cases (tests/test_result_cache.py) run
  over both.
- The server, each package's on the same f32 tables at its defaults but
  `micro_batch` 4: a hit returns the miss's f16-packed bytes without a
  window; a fold's swap naming a user drops exactly that user's entry
  (untouched entries byte-equal hits, the touched user recomputed); a
  swap without lineage clears everything; strict mode drops the entries
  ranking a touched item; `PIO_SERVE_CACHE=off` and
  `ServerConfig(result_cache=False)` turn the cache off; a window held
  open across a swap (the reference's generation fence) stores nothing.
Every assertion is the same for both packages.
"""

import json
import threading

import numpy as np
import pytest

from predictionio_tpu.core import FirstServing as JFirstServing
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.bimap import EntityIdIxMap as JMap
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu.ops import als as JALS
from predictionio_tpu.serving import result_cache as JRC
from predictionio_tpu.serving import server as JSrv
from predictionio_tpu.serving.plugins import EngineServerPluginContext
from predictionio_tpu.utils.http import Headers, Request
from predictionio_tpu_torch.core import TrainResult
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.serving import result_cache as TRC
from predictionio_tpu_torch.serving import server as TSrv
from predictionio_tpu_torch.weights import from_jax_model

MODULES = {"jax": JRC, "torch": TRC}
PKGS = ("jax", "torch")
RANK, N_USERS, N_ITEMS = 4, 12, 20


# ---------------------------------------------------------------------------
# ResultCache: one seeded sequence through both modules
# ---------------------------------------------------------------------------

def op_sequence(seed: int, n: int = 400):
    """Seeded operations over 24 users and 30 items: queries by user or
    by items, with a raw body whose key order varies; bodies of 10-60
    random bytes; result items a random subset; generations absent,
    current or stale."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(["put", "put", "put", "get", "get", "get_raw",
                           "invalidate", "invalidate_all", "prefix"],
                          p=[.2, .15, .15, .15, .1, .12, .08, .02, .03])
        if rng.random() < 0.8:
            q = {"user": f"u{rng.integers(24)}", "num": int(
                rng.integers(1, 4))}
        else:
            q = {"items": [f"i{x}" for x in rng.choice(30, 2,
                                                       replace=False)],
                 "num": 3}
        order = list(q) if rng.random() < 0.5 else list(q)[::-1]
        raw = json.dumps({k: q[k] for k in order}).encode()
        if kind == "put":
            body = rng.bytes(int(rng.integers(10, 61)))
            items = tuple(f"i{x}" for x in rng.choice(
                30, int(rng.integers(0, 4)), replace=False))
            ops.append(("put", q, raw, body, items,
                        rng.choice(["none", "current", "stale"],
                                   p=[.5, .4, .1])))
        elif kind in ("get", "get_raw"):
            ops.append((kind, q, raw))
        elif kind == "invalidate":
            tags = {"user": [f"u{x}" for x in rng.choice(24, 2)],
                    "item": [f"i{x}" for x in rng.choice(30, 2)]}
            ops.append(("invalidate", tags))
        elif kind == "prefix":
            ops.append(("prefix", '{"items"'))
        else:
            ops.append(("invalidate_all",))
    return ops


def replay(RC, ops, max_entries, max_bytes) -> tuple:
    c = RC.ResultCache(max_entries=max_entries, max_bytes=max_bytes)
    log = []
    for op in ops:
        if op[0] == "put":
            _, q, raw, body, items, gen = op
            g = {"none": None, "current": c.generation,
                 "stale": c.generation - 1}[gen]
            log.append(c.put(RC.query_key(q), body, RC.query_entities(q),
                             result_items=items, generation=g, raw=raw))
        elif op[0] == "get":
            log.append(c.get(RC.query_key(op[1])))
        elif op[0] == "get_raw":
            log.append(c.get_raw(op[2]))
        elif op[0] == "invalidate":
            log.append(c.invalidate_entities(RC.entity_tags(op[1])))
        elif op[0] == "prefix":
            log.append(c.invalidate_prefix(op[1]))
        else:
            log.append(c.invalidate_all("reload"))
    order = [(k, e.body, e.entities, e.result_items, e.raw)
             for k, e in c._entries.items()]
    return log, order, c.stats(), c.generation, c._bytes


@pytest.mark.parametrize("seed,strict,max_entries,max_bytes", [
    (0, False, 8192, 64 << 20), (1, False, 16, 64 << 20),
    (2, False, 8192, 700), (3, True, 8192, 64 << 20), (4, True, 16, 900),
    (5, False, 4, 240)])
def test_a_seeded_sequence_gives_the_same_cache(seed, strict, max_entries,
                                                max_bytes, monkeypatch):
    if strict:
        monkeypatch.setenv("PIO_SERVE_CACHE_STRICT", "1")
    else:
        monkeypatch.delenv("PIO_SERVE_CACHE_STRICT", raising=False)
    ops = op_sequence(seed)
    j = replay(JRC, ops, max_entries, max_bytes)
    t = replay(TRC, ops, max_entries, max_bytes)
    assert t == j
    stats = t[2]
    # the sequence reached every path it is meant to
    assert stats["hits"] and stats["misses"]
    assert stats["invalidations"].get("fold_swap")
    if max_entries < 100 or max_bytes < 1000:
        assert stats["evictions"]


@pytest.mark.parametrize("seed", [0, 1])
def test_keys_and_tags_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        q = {"user": f"u{rng.integers(9)}", "num": int(rng.integers(9)),
             "items": [f"i{x}" for x in rng.integers(0, 9, 2)],
             "categories": ["c1"], "item": "i3"}
        q = {k: q[k] for k in rng.permutation(list(q))}
        assert TRC.query_key(q) == JRC.query_key(q)
        assert TRC.query_entities(q) == JRC.query_entities(q)
    touched = {"user": ["a", "b"], "item": ["c"]}
    assert TRC.entity_tags(touched) == JRC.entity_tags(touched)
    assert TRC.query_key({"x": object()}) is None
    assert TRC.NS_SEP == JRC.NS_SEP


@pytest.mark.parametrize("value,on", [("", True), ("off", False),
                                      ("0", False), ("no", False),
                                      ("ON", True)])
def test_the_switches_read_the_environment_alike(value, on, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_CACHE", value)
    monkeypatch.setenv("PIO_SERVE_CACHE_STRICT", value)
    for RC in MODULES.values():
        assert RC.cache_enabled() is on
        assert RC.strict_items() is (value in ("1", "on", "ON", "true"))


# the reference's unit cases (tests/test_result_cache.py), over both
@pytest.mark.parametrize("pkg", PKGS)
class TestUnitCasesOverBoth:
    def test_roundtrip_and_hit_miss_counters(self, pkg):
        RC = MODULES[pkg]
        c = RC.ResultCache()
        k = RC.query_key({"user": "u1", "num": 3})
        assert c.get(k) is None
        assert c.put(k, b'{"a":1}', RC.query_entities({"user": "u1"}))
        assert c.get(k) == b'{"a":1}'
        assert c.hits == 1 and c.misses == 1

    def test_invalidate_exactly_touched_user(self, pkg):
        RC = MODULES[pkg]
        c = RC.ResultCache()
        for u in ("u1", "u2", "u3"):
            c.put(RC.query_key({"user": u}), f"body-{u}".encode(),
                  RC.query_entities({"user": u}))
        assert c.invalidate_entities(["user:u2"]) == 1
        assert c.get(RC.query_key({"user": "u1"})) == b"body-u1"
        assert c.get(RC.query_key({"user": "u2"})) is None
        assert c.invalidations.get("fold_swap") == 1

    def test_entry_budget_evicts_the_oldest(self, pkg):
        RC = MODULES[pkg]
        c = RC.ResultCache(max_entries=3)
        for i in range(5):
            c.put(RC.query_key({"user": f"u{i}"}), b"x",
                  RC.query_entities({"user": f"u{i}"}))
        assert len(c._entries) == 3 and c.evictions == 2
        assert c.get(RC.query_key({"user": "u0"})) is None
        assert c.get(RC.query_key({"user": "u4"})) == b"x"

    def test_byte_budget_and_oversized_body(self, pkg):
        RC = MODULES[pkg]
        c = RC.ResultCache(max_entries=100, max_bytes=100)
        for i in range(10):
            c.put(RC.query_key({"user": f"u{i}"}), b"x" * 20,
                  RC.query_entities({"user": f"u{i}"}))
        assert c._bytes <= 100
        assert not c.put(RC.query_key({"user": "u"}), b"x" * 50,
                         ("user:u",))

    def test_generation_fence_refuses_stale_store(self, pkg):
        RC = MODULES[pkg]
        c = RC.ResultCache()
        g = c.generation
        c.invalidate_all("swap")    # a swap landed while computing
        assert not c.put(RC.query_key({"user": "u"}), b"x", ("user:u",),
                         generation=g)
        assert c.put(RC.query_key({"user": "u"}), b"x", ("user:u",),
                     generation=c.generation)

    def test_raw_alias_hits_without_a_parse(self, pkg):
        RC = MODULES[pkg]
        c = RC.ResultCache()
        raw = b'{"num": 3, "user": "u1"}'
        k = RC.query_key(json.loads(raw))
        assert c.get_raw(raw) is None and c.misses == 0
        c.put(k, b"body", ("user:u1",), raw=raw)
        assert c.get_raw(raw) == b"body" and c.hits == 1
        c.invalidate_entities(["user:u1"])
        assert c.get_raw(raw) is None

    def test_strict_mode_drops_entries_ranking_a_touched_item(
            self, pkg, monkeypatch):
        RC = MODULES[pkg]
        c = RC.ResultCache()
        c.put(RC.query_key({"user": "u1"}), b"a", ("user:u1",),
              result_items=("i5", "i6"))
        c.put(RC.query_key({"user": "u2"}), b"b", ("user:u2",),
              result_items=("i7",))
        assert c.invalidate_entities(["item:i5"]) == 0   # default: kept
        monkeypatch.setenv("PIO_SERVE_CACHE_STRICT", "1")
        assert c.invalidate_entities(["item:i5"]) == 1
        assert c.get(RC.query_key({"user": "u1"})) is None
        assert c.get(RC.query_key({"user": "u2"})) == b"b"


# ---------------------------------------------------------------------------
# the server's cache: both packages on the same tables
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((N_USERS, RANK)).astype(np.float32),
            rng.standard_normal((N_ITEMS, RANK)).astype(np.float32))


def model(pkg, U, V):
    users = [f"u{k}" for k in range(N_USERS)]
    items = [f"i{k}" for k in range(N_ITEMS)]
    if pkg == "jax":
        return JR.RecommendationModel(
            JALS.ALSModel(U, V, RANK),
            JMap(JBiMap({u: k for k, u in enumerate(users)})),
            JMap(JBiMap({i: k for k, i in enumerate(items)})))
    return from_jax_model(U, V, users, items, RANK, device="cpu")


def server(pkg, U, V, **cfg):
    cfg = dict(dict(micro_batch=4, micro_batch_wait_ms=1.0), **cfg)
    if pkg == "jax":
        s = JSrv.EngineServer(
            JSrv.ServerConfig(ip="127.0.0.1", port=0, **cfg),
            engine=JR.RecommendationEngineFactory.apply())
        s.algorithms = [JR.ALSAlgorithm(JR.ALSAlgorithmParams(rank=RANK))]
        s.models = [model(pkg, U, V)]
        s.serving = JFirstServing()
        return s
    return TSrv.EngineServer(
        TSrv.ServerConfig(port=0, **cfg),
        TR.RecommendationEngineFactory.apply(),
        TR.RecommendationEngineFactory.engine_params(
            TR.RatingsData([], [], [])),
        TrainResult(models=[model(pkg, U, V)], algorithms=[
            TR.ALSAlgorithm(TR.ALSAlgorithmParams(rank=RANK,
                                                  device="cpu"))]))


def ask(pkg, s, body) -> bytes:
    """One `POST /queries.json` through the server's query route."""
    raw = json.dumps(body).encode()
    if pkg == "jax":
        resp = s._queries(Request("POST", "/queries.json", {}, Headers(),
                                  raw))
        assert resp.status == 200
        return resp.payload()
    out, extra = s.queries(raw)
    assert extra is None
    return out


@pytest.fixture(params=PKGS)
def cached(request, tables, tmp_env, monkeypatch):
    for k in ("PIO_SERVE_CACHE", "PIO_SERVE_CACHE_STRICT",
              "PIO_SERVE_PACK"):
        monkeypatch.delenv(k, raising=False)
    s = server(request.param, *tables)
    try:
        yield request.param, s
    finally:
        s.batcher.stop()


def top_ids(U, V, u: int, num: int) -> list:
    s64 = V.astype(np.float64) @ U[u].astype(np.float64)
    return [f"i{k}" for k in np.argsort(-s64, kind="stable")[:num]]


def test_a_hit_returns_the_miss_bytes_without_a_window(cached, tables):
    pkg, s = cached
    first = ask(pkg, s, {"user": "u1", "num": 3})
    windows = s.batcher.n_batches
    again = ask(pkg, s, {"user": "u1", "num": 3})
    assert again == first
    assert s.batcher.n_batches == windows
    assert s.result_cache.hits == 1 and s.result_cache.misses == 1
    body = json.loads(first)
    scores = np.array([x["score"] for x in body["itemScores"]])
    # the default f16-packed readback, serialized once
    assert (scores.astype(np.float16).astype(np.float64) == scores).all()
    assert [x["item"] for x in body["itemScores"]] == top_ids(*tables, 1, 3)
    # the same query, another key order: one parse, the same entry
    assert ask(pkg, s, {"num": 3, "user": "u1"}) == first
    assert s.result_cache.hits == 2


def test_a_fold_swap_drops_exactly_the_touched_user(cached, tables):
    pkg, s = cached
    U, V = tables
    bodies = {u: ask(pkg, s, {"user": u, "num": 4})
              for u in ("u1", "u2", "u3")}
    assert s.result_cache.stats()["entries"] == 3
    U2 = U.copy()
    U2[2] = -U[2]
    s.swap_models([model(pkg, U2, V)], version="fold-1",
                  touched_entities={"user": ["u2"], "item": []})
    stats = s.result_cache.stats()
    assert stats["entries"] == 2
    assert stats["invalidations"] == {"fold_swap": 1}
    hits = s.result_cache.hits
    assert ask(pkg, s, {"user": "u1", "num": 4}) == bodies["u1"]
    assert ask(pkg, s, {"user": "u3", "num": 4}) == bodies["u3"]
    assert s.result_cache.hits == hits + 2
    fresh = json.loads(ask(pkg, s, {"user": "u2", "num": 4}))
    assert [x["item"] for x in fresh["itemScores"]] == top_ids(U2, V, 2, 4)
    assert s.result_cache.misses == 4


def test_a_swap_without_lineage_clears_everything(cached, tables):
    pkg, s = cached
    for u in ("u1", "u2"):
        ask(pkg, s, {"user": u, "num": 2})
    s.swap_models([model(pkg, *tables)], version="op-swap")
    stats = s.result_cache.stats()
    assert stats["entries"] == 0 and stats["invalidations"] == {"swap": 2}


@pytest.mark.parametrize("strict", [False, True])
def test_strict_mode_drops_rankings_of_a_touched_item(cached, tables,
                                                      strict, monkeypatch):
    pkg, s = cached
    U, V = tables
    ranked = {u: {x["item"] for x in json.loads(ask(
        pkg, s, {"user": u, "num": 3}))["itemScores"]}
        for u in ("u0", "u1", "u2", "u3")}
    item = sorted(ranked["u0"])[0]
    if strict:
        monkeypatch.setenv("PIO_SERVE_CACHE_STRICT", "1")
    s.swap_models([model(pkg, U, V)], version="fold-2",
                  touched_entities={"user": [], "item": [item]})
    want = sum(item in r for r in ranked.values()) if strict else 0
    assert s.result_cache.stats()["entries"] == 4 - want
    assert s.result_cache.invalidations.get("fold_swap", 0) == want


@pytest.mark.parametrize("how", ["env", "config"])
@pytest.mark.parametrize("pkg", PKGS)
def test_the_cache_turns_off(pkg, how, tables, tmp_env, monkeypatch):
    monkeypatch.delenv("PIO_SERVE_CACHE", raising=False)
    if how == "env":
        monkeypatch.setenv("PIO_SERVE_CACHE", "off")
        s = server(pkg, *tables)
    else:
        s = server(pkg, *tables, result_cache=False)
    try:
        assert s.result_cache is None
        first = ask(pkg, s, {"user": "u1", "num": 3})
        windows = s.batcher.n_batches
        assert ask(pkg, s, {"user": "u1", "num": 3}) == first
        assert s.batcher.n_batches == windows + 1
    finally:
        s.batcher.stop()


class _FakeServing:
    def supplement(self, q):
        return q

    def serve(self, q, predictions):
        return predictions[0]


class _FakeInstance:
    id = "fake-instance"
    engine_factory = "fake"


class _HeldAlgo:
    """Answers each query with the model's value as its one score; the
    first window's results wait until `release` is set."""
    query_class = None

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()

    def predict(self, model, q):
        return {"itemScores": [{"item": "i1", "score": float(model)}]}

    def batch_predict_begin(self, model, indexed):
        self.started.set()

        def finish():
            assert self.release.wait(10)
            return [(i, self.predict(model, q)) for i, q in indexed]
        return finish

    def batch_predict(self, model, indexed):
        return self.batch_predict_begin(model, indexed)()


def fake_server(pkg, algo, **cfg):
    cfg = dict(dict(ip="127.0.0.1", port=0, micro_batch=4,
                    micro_batch_wait_ms=1.0), **cfg)
    if pkg == "jax":
        s = JSrv.EngineServer(JSrv.ServerConfig(**cfg),
                              plugin_context=EngineServerPluginContext())
    else:
        s = TSrv.EngineServer(TSrv.ServerConfig(**cfg))
    s.algorithms = [algo]
    s.models = [1.0]
    s.serving = _FakeServing()
    s.engine_instance = _FakeInstance()
    return s


@pytest.mark.parametrize("touched", [{"user": ["u9"], "item": []}, None])
@pytest.mark.parametrize("pkg", PKGS)
def test_a_window_open_across_a_swap_stores_nothing(pkg, touched, tmp_env,
                                                    monkeypatch):
    """The generation fence: a query whose window computes while a swap
    lands answers from its snapshot (the old model) and does not store
    it, whether the swap touched its entity or not."""
    monkeypatch.delenv("PIO_SERVE_CACHE", raising=False)
    algo = _HeldAlgo()
    s = fake_server(pkg, algo)
    try:
        out = []
        t = threading.Thread(target=lambda: out.append(
            ask(pkg, s, {"user": "u1"})))
        t.start()
        assert algo.started.wait(10)
        s.swap_models([2.0], version="v2", touched_entities=touched)
        algo.release.set()
        t.join(10)
        assert not t.is_alive()
        assert json.loads(out[0])["itemScores"][0]["score"] == 1.0
        assert s.result_cache.stats()["entries"] == 0
        again = json.loads(ask(pkg, s, {"user": "u1"}))
        assert again["itemScores"][0]["score"] == 2.0
        assert s.result_cache.stats()["entries"] == 1
        assert s.result_cache.misses == 2
    finally:
        s.batcher.stop()
