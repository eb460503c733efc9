"""Port parity: the bulk data plane (L0 storage's chunked cursor, the
dataplane's reader, stager and executor, the recommendation data source's
streamed read) vs the JAX reference, on the CPU.

Mirrors tests/test_dataplane.py (`TestChunkedParity`, `TestChunkReader`,
`TestBulkLoadExecutor`, `TestStreamedTrainingParity`) on the port's
SQLite backend with `device="cpu"`. Every comparison is exact: the
chunks, the streamed read and the trained factor tables are held bit for
bit (NaN where a rating is missing compares equal), since the stream
changes when rows are read and not what is computed from them.
"""

import datetime as dt
import json
import threading
import time

import numpy as np
import pytest
import torch

from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.data.storage.sqlite import StorageClient as JSQL
from predictionio_tpu.dataplane import StreamInterner as JStreamInterner
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu.ops import staging as JStaging
from predictionio_tpu_torch import dataplane as D
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base as TB
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.sqlite import StorageClient as TSQL
from predictionio_tpu_torch.dataplane import pipeline
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import staging
from predictionio_tpu_torch.utils.buckets import bucket_rows
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main)

UTC = dt.timezone.utc
CPU = torch.device("cpu")


def t_ms(ms):
    """Event time at millisecond `ms` past a fixed epoch."""
    return dt.datetime(2015, 1, 1, tzinfo=UTC) + dt.timedelta(
        milliseconds=ms)


def mk(E, DM, i, ms, event="rate", rating=None):
    props = DM({"rating": rating} if rating is not None else {})
    return E(event=event, entity_type="user", entity_id=f"u{i % 13}",
             target_entity_type="item", target_entity_id=f"i{i % 7}",
             event_time=t_ms(ms), properties=props)


def seed(ev, E=Event, DM=DataMap, app_id=1, n=240):
    """n events, three to a millisecond (so chunk boundaries meet the
    complete-millisecond rule), a quarter of them buys."""
    events = []
    for i in range(n):
        ms = (i // 3) * 10
        if i % 4 == 3:
            events.append(mk(E, DM, i, ms, event="buy"))
        else:
            events.append(mk(E, DM, i, ms, rating=float(1 + i % 5)))
    ev.insert_batch(events, app_id)


def concat(chunks, keys):
    return {k: np.concatenate([c[k] for c in chunks]) for k in keys}


def assert_columns_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        nan_ok = np.issubdtype(ref[k].dtype, np.floating)
        assert np.array_equal(got[k], ref[k], equal_nan=nan_ok), k


@pytest.fixture()
def db(tmp_path):
    """One SQLite file, opened by the port's client and the JAX
    package's; yields (port events, JAX events)."""
    url = str(tmp_path / "t.db")
    tc = TSQL(TReg.StorageClientConfig("TEST", "sqlite", {"URL": url}))
    jc = JSQL(JReg.StorageClientConfig("TEST", "sqlite", {"URL": url}))
    tev, jev = (c.get_data_object("events", "test") for c in (tc, jc))
    tev.init(1)
    yield tev, jev
    tc.close()
    jc.close()


# -- the chunked cursor (L0) -------------------------------------------------

class TestChunkedParity:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    @pytest.mark.parametrize("chunk_rows", [1, 7, 50, 10_000])
    def test_chunks_equal_the_reference_and_the_one_shot_read(
            self, db, chunk_rows, writer):
        tev, jev = db
        if writer == "port":
            seed(tev)
        else:
            seed(jev, JEvent, JDataMap)
        ref = tev.find_columnar(1, property_field="rating")
        got = list(tev.find_columnar_chunked(
            1, property_field="rating", chunk_rows=chunk_rows))
        want = list(jev.find_columnar_chunked(
            1, property_field="rating", chunk_rows=chunk_rows))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_columns_equal(g, w)
        assert_columns_equal(concat(got, ref.keys()), ref)
        if chunk_rows < len(ref["t"]):
            assert len(got) > 1
        # a chunk ends only at a complete millisecond
        for a, b in zip(got, got[1:]):
            assert a["t"][-1] < b["t"][0]

    def test_filtered_and_windowed(self, db):
        tev, jev = db
        seed(tev)
        kw = dict(property_field="rating", event_names=["rate"],
                  entity_type="user", target_entity_type="item",
                  start_time=t_ms(100), until_time=t_ms(600))
        ref = tev.find_columnar(1, **kw)
        assert len(ref["t"])
        got = list(tev.find_columnar_chunked(1, chunk_rows=16, **kw))
        want = list(jev.find_columnar_chunked(1, chunk_rows=16, **kw))
        assert [len(c["t"]) for c in got] == [len(c["t"]) for c in want]
        assert_columns_equal(concat(got, ref.keys()), ref)

    def test_single_ms_burst_comes_back_whole(self, db):
        tev, _ = db
        tev.insert_batch([mk(Event, DataMap, i, 5, rating=float(i % 5 + 1))
                          for i in range(40)], 1)
        ref = tev.find_columnar(1, property_field="rating")
        chunks = list(tev.find_columnar_chunked(
            1, property_field="rating", chunk_rows=4))
        assert len(chunks) == 1
        assert_columns_equal(chunks[0], ref)

    def test_equal_times_keep_insertion_order_across_windows(self, db):
        """Rows of one millisecond come back in rowid order through the
        windowed query, as through the one-shot read."""
        tev, _ = db
        tev.insert_batch([mk(Event, DataMap, i, (i // 5) * 3,
                             rating=float(i))
                          for i in range(60)], 1)
        got = concat(list(tev.find_columnar_chunked(
            1, property_field="rating", chunk_rows=6)), ("prop",))
        assert got["prop"].tolist() == [float(i) for i in range(60)]

    def test_empty_store_yields_nothing(self, db):
        assert list(db[0].find_columnar_chunked(
            1, property_field="rating", chunk_rows=8)) == []

    def test_midstream_inserts_after_cursor_are_seen(self, db):
        tev, _ = db
        seed(tev, n=120)
        gen = tev.find_columnar_chunked(1, property_field="rating",
                                        chunk_rows=9)
        first = next(gen)
        tev.insert_batch([mk(Event, DataMap, 1000 + i, 5000 + i * 10,
                             rating=5.0) for i in range(12)], 1)
        ref = tev.find_columnar(1, property_field="rating")
        assert len(ref["t"]) == 132
        assert_columns_equal(concat([first] + list(gen), ref.keys()), ref)

    @pytest.mark.parametrize("kw, match", [
        (dict(reversed_order=True), "ascending"),
        (dict(limit=5), "unbounded"),
        (dict(chunk_rows=-3), "positive")])
    def test_refusals_match_the_reference(self, db, kw, match):
        tev, jev = db
        for ev in (tev, jev):
            with pytest.raises(ValueError, match=match):
                next(ev.find_columnar_chunked(1, **kw))

    def test_default_chunk_rows_is_the_reference_s(self):
        from predictionio_tpu.data.storage import base as JB
        assert TB.DEFAULT_CHUNK_ROWS == JB.DEFAULT_CHUNK_ROWS


# -- the reader ---------------------------------------------------------------

class _FakeStore:
    """An app-name-keyed store double: canned wire chunks, optionally
    failing mid-stream or producing forever."""

    def __init__(self, chunks, fail_after=None, block=False):
        self.chunks = chunks
        self.fail_after = fail_after
        self.block = block
        self.kw = None

    def find_columnar_chunked(self, app_name, channel_name=None,
                              property_field=None, chunk_rows=None,
                              **filters):
        self.kw = dict(app_name=app_name, channel_name=channel_name,
                       property_field=property_field,
                       chunk_rows=chunk_rows, **filters)
        for i, c in enumerate(self.chunks):
            if self.fail_after is not None and i == self.fail_after:
                raise RuntimeError("shard scan failed")
            yield c
        while self.block:
            yield _wire_chunk(0, 1)
            time.sleep(0.01)


def _wire_chunk(base_ms, n):
    return {
        "entity_id": np.array([f"u{i}" for i in range(n)]),
        "target_entity_id": np.array([f"i{i}" for i in range(n)]),
        "event": np.array(["rate"] * n),
        "t": np.arange(base_ms, base_ms + n, dtype=np.int64),
        "prop": np.full(n, 3.0, dtype=np.float64),
    }


class TestChunkReader:
    def test_streams_in_order_with_stats(self):
        chunks = [_wire_chunk(i * 100, 5) for i in range(4)]
        store = _FakeStore(chunks)
        with D.ChunkReader(store, "app", property_field="rating",
                           chunk_rows=5, event_names=["rate"]) as r:
            got = list(r)
        assert [c["t"][0] for c in got] == [0, 100, 200, 300]
        assert r.rows == 20 and r.chunks == 4
        assert r.bytes == sum(v.nbytes for c in chunks for v in c.values())
        assert r.read_s >= 0
        assert store.kw["event_names"] == ["rate"]
        assert store.kw["property_field"] == "rating"

    def test_producer_error_raises_at_consumer(self):
        store = _FakeStore([_wire_chunk(0, 3)] * 3, fail_after=2)
        with D.ChunkReader(store, "app") as r:
            with pytest.raises(RuntimeError, match="shard scan failed"):
                list(r)

    def test_close_reclaims_thread_midstream(self):
        store = _FakeStore([_wire_chunk(0, 2)], block=True)
        r = D.ChunkReader(store, "app", queue_depth=1)
        it = iter(r)
        next(it)
        r.close()
        assert r._thread is not None
        r._thread.join(timeout=5)
        assert not r._thread.is_alive()
        before = threading.active_count()
        r.close()
        assert threading.active_count() == before


    def test_many_readers_under_fast_thread_switching(self):
        """More readers than cores, each thread switch forced early: every
        reader still delivers its chunks whole, in order, with its own
        counts."""
        import os
        import sys
        n_readers = 2 * (os.cpu_count() or 1) + 2
        results, errors = {}, []

        def consume(k):
            try:
                chunks = [_wire_chunk(k * 10_000 + i * 10, 3)
                          for i in range(60)]
                with D.ChunkReader(_FakeStore(chunks), "app",
                                   queue_depth=1) as r:
                    got = [int(c["t"][0]) for c in r]
                results[k] = (got, r.rows, r.chunks)
            except Exception as e:     # reported by the assertion below
                errors.append(e)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=consume, args=(k,))
                       for k in range(n_readers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        for k in range(n_readers):
            assert results[k] == ([k * 10_000 + i * 10 for i in range(60)],
                                  180, 60)


# -- staging and the stager ---------------------------------------------------

@pytest.mark.parametrize("n, rows", [(5, 64), (64, 64), (65, 128), (0, 64)])
def test_pad_to_bucket_matches_the_reference(n, rows):
    arr = np.arange(1, n + 1, dtype=np.int64)
    got = staging.pad_to_bucket(arr, rows)
    assert np.array_equal(got, JStaging.pad_to_bucket(arr, rows))
    out = np.full(rows, 7, dtype=np.int64)
    assert staging.pad_to_bucket(arr, rows, out=out) is out
    assert np.array_equal(out, got)


def test_device_stage_on_the_cpu_copies_plainly():
    cols = {"t": np.arange(70, dtype=np.int64),
            "v": np.linspace(0, 1, 70).astype(np.float32)}
    staging.COUNTS.reset()
    out, rows, padded, submit_s, event, hosts = staging.device_stage(
        cols, CPU)
    assert (staging.COUNTS.plain, staging.COUNTS.pinned) == (2, 0)
    assert (rows, padded, event) == (70, 128, None)
    assert submit_s >= 0 and len(hosts) == 2
    for k, a in cols.items():
        assert out[k].device.type == "cpu" and out[k].shape == (128,)
        assert not out[k].is_pinned()
        assert np.array_equal(out[k].numpy()[:70], a)
        assert not out[k].numpy()[70:].any()
        assert not np.shares_memory(out[k].numpy(), a)
    assert staging.wait_ready(event) == 0.0


def test_staging_refuses_what_it_cannot_copy():
    with pytest.raises(TypeError):
        staging.device_stage({"ids": np.array(["u1", "u2"])}, CPU)
    with pytest.raises(ValueError, match="copy stream"):
        staging.device_stage({"t": np.arange(3)}, torch.device("cuda"))


def test_stager_without_a_card_raises_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default stages there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.DeviceStager()
    assert D.DeviceStager(device="cpu").device == CPU


def test_stager_window_and_stats():
    st = D.DeviceStager(slots=2, device="cpu")
    for n in (3, 70, 130):
        st.stage({"t": np.arange(n, dtype=np.int64)})
    assert len(st._inflight) == 2       # the window bounds what is pending
    segs = st.finish()
    assert not st._inflight
    assert [(s.rows, s.padded_rows) for s in segs] == [
        (3, 64), (70, 128), (130, 256)]
    assert st.stats.buckets == [64, 128, 256]
    assert st.stats.h2d_bytes == (64 + 128 + 256) * 8
    assert st.stats.segments == 3 and st.stats.rows == 203
    assert st.stats.wait_s == 0.0 and st.stats.overlap_frac == 1.0
    st.stage({})
    assert st.stats.segments == 3


@pytest.mark.parametrize("submit, wait, frac", [
    (0.0, 0.0, 1.0), (3.0, 1.0, 0.75), (0.0, 2.0, 0.0)])
def test_overlap_frac_matches_the_reference(submit, wait, frac):
    from predictionio_tpu.dataplane.upload import StageStats as JStats
    assert D.StageStats(submit_s=submit, wait_s=wait).overlap_frac == \
        JStats(submit_s=submit, wait_s=wait).overlap_frac == frac


def test_stream_interner_matches_the_reference():
    rng = np.random.default_rng(3)
    chunks = [np.array([f"u{x}" for x in rng.integers(0, 40, 25)])
              for _ in range(4)]
    port, ref = D.StreamInterner(), JStreamInterner()
    for c in chunks:
        assert np.array_equal(port.encode(c), ref.encode(c))
    assert len(port) == len(ref)
    assert np.array_equal(port.vocabulary(), ref.vocabulary())
    perm = port.remap_to_sorted()
    assert np.array_equal(perm, ref.remap_to_sorted())
    ids = np.concatenate(chunks)
    vocab = np.unique(ids)
    streamed = perm[np.concatenate([port.encode(c) for c in chunks])]
    assert np.array_equal(vocab[streamed], ids)


# -- the executor -------------------------------------------------------------

class TestBulkLoadExecutor:
    def _run(self, chunks, **kw):
        ex = D.BulkLoadExecutor(store=_FakeStore(chunks), chunk_rows=8,
                                device="cpu")
        return ex.run("app", property_field="rating", **kw)

    def test_decode_accumulates_exact_parity(self):
        chunks = [_wire_chunk(i * 10, 4) for i in range(5)]
        result = self._run(chunks, decode=lambda c: c["t"] * 2,
                           encode=lambda d: {"t2": d})
        ref = np.concatenate([c["t"] * 2 for c in chunks])
        assert np.array_equal(np.concatenate(result.decoded), ref)
        assert len(result.segments) == 5
        dev = np.concatenate([s.arrays["t2"].numpy()[:s.rows]
                              for s in result.segments])
        assert np.array_equal(dev, ref)
        for s in result.segments:
            assert s.padded_rows == bucket_rows(s.rows)
        st = result.stats
        assert st.rows == 20 and st.chunks == 5
        assert st.h2d_bytes == 5 * 64 * 8 and st.wall_s > 0
        assert st.read_bytes == sum(v.nbytes for c in chunks
                                    for v in c.values())
        assert st.steady_compiles == 0 and st.steady_compile_s == 0.0

    def test_default_encode_stages_numeric_wire_columns(self):
        result = self._run([_wire_chunk(0, 6)])
        (seg,) = result.segments
        assert set(seg.arrays) == {"t", "prop"}
        assert seg.rows == 6 and seg.arrays["prop"].dtype == torch.float64

    def test_decode_none_skips_chunk(self):
        chunks = [_wire_chunk(0, 4), _wire_chunk(100, 4)]
        result = self._run(
            chunks, decode=lambda c: None if c["t"][0] == 0 else c["t"])
        assert len(result.decoded) == 1
        (seg,) = result.segments
        assert int(seg.arrays["t"][0]) == 100
        assert result.stats.rows == 8

    def test_stage_off_keeps_host_only(self):
        result = self._run([_wire_chunk(0, 4)], stage=False)
        assert result.segments == []
        assert result.stats.h2d_bytes == 0

    def test_last_stats_module_hook(self):
        pipeline.last_stats = None
        result = self._run([_wire_chunk(0, 4)])
        assert pipeline.last_stats is result.stats

    def test_steady_compiles_count_builds_run_mid_stream(self, monkeypatch):
        """The count is the kernel builds that ran during the stream, not
        a constant: a decode that runs one is counted."""
        monkeypatch.setattr(_build, "BUILDS", _build.BuildCounts())

        def decode(chunk):
            if chunk["t"][0] == 10:
                _build.BUILDS.builds += 1
                _build.BUILDS.seconds += 0.25
            return chunk
        result = self._run([_wire_chunk(i * 10, 4) for i in range(3)],
                           decode=decode)
        assert result.stats.steady_compiles == 1
        assert result.stats.steady_compile_s == 0.25

    def test_stats_fields_are_the_reference_s(self):
        from predictionio_tpu.dataplane.pipeline import \
            BulkLoadStats as JStats
        assert list(D.BulkLoadStats.__dataclass_fields__) == \
            list(JStats.__dataclass_fields__)


# -- the streamed training read (L3) ------------------------------------------

APP = "dpapp"


@pytest.fixture()
def dp_store(tmp_env):
    """A SQLite app with seeded rate and buy events, several rows a
    millisecond, that both packages' registries read."""
    TReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(TB.App(0, APP))
    rng = np.random.default_rng(11)
    n = 400
    u, i = rng.integers(0, 23, n), rng.integers(0, 17, n)
    names = np.where(rng.random(n) < 0.2, "buy", "rate")
    TReg.Storage.get_events().insert_columnar(ColumnarBatch(
        n, names.tolist(), "user", [f"u{x}" for x in u], "item",
        [f"i{x}" for x in i],
        [{"rating": float(1 + (a * b) % 5)} if nm == "rate" else {}
         for a, b, nm in zip(u, i, names)],
        ["2015-01-01T00:00:%02d.%03dZ" % divmod(j // 3 * 7, 1000)
         for j in range(n)]), app_id)
    yield app_id
    TReg.clear_cache()


def port_read(**kw):
    return TR.RecommendationDataSource(TR.DataSourceParams(
        app_name=APP, device="cpu", **kw))._read_ratings()


def assert_ratings_equal(a, b):
    for name in ("users", "items", "vals", "ts"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name


class TestStreamedTrainingParity:
    @pytest.mark.parametrize("chunk_rows", [16, 100, None])
    def test_streamed_read_equals_both_batch_reads(self, dp_store,
                                                   monkeypatch, chunk_rows):
        if chunk_rows is not None:
            monkeypatch.setattr(TB, "DEFAULT_CHUNK_ROWS", chunk_rows)
        pipeline.last_stats = None
        streamed = port_read(stream=True)
        st = pipeline.last_stats
        assert st.rows == len(streamed) == 400
        assert (st.chunks == 1) == (chunk_rows is None)
        assert st.h2d_bytes > 0 and st.steady_compiles == 0
        assert_ratings_equal(streamed, port_read(stream=False))
        ref = JR.RecommendationDataSource(JR.DataSourceParams(
            app_name=APP, stream=False))._read_ratings()
        assert_ratings_equal(streamed, ref)

    def test_env_var_activates_stream(self, dp_store, monkeypatch):
        monkeypatch.setenv("PIO_DATAPLANE_STREAM", "1")
        pipeline.last_stats = None
        port_read()
        assert pipeline.last_stats is not None
        assert pipeline.last_stats.rows == 400
        pipeline.last_stats = None
        port_read(stream=False)             # the field overrides the env
        assert pipeline.last_stats is None
        monkeypatch.setenv("PIO_DATAPLANE_STREAM", "off")
        port_read()
        assert pipeline.last_stats is None

    def test_streamed_eval_folds_equal_the_batch_folds(self, dp_store):
        folds = {s: TR.RecommendationDataSource(TR.DataSourceParams(
            app_name=APP, device="cpu", eval_k=3, stream=s)).read_eval()
            for s in (True, False)}
        for (td_s, _, qa_s), (td_b, _, qa_b) in zip(folds[True],
                                                    folds[False]):
            assert_ratings_equal(td_s.ratings, td_b.ratings)
            assert qa_s == qa_b

    def test_stream_stages_on_the_card_by_default(self, dp_store):
        if torch.cuda.is_available():
            pytest.skip("this machine has a card: the default stages there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TR.RecommendationDataSource(TR.DataSourceParams(
                app_name=APP, stream=True))._read_ratings()

    def test_stream_engine_json_trains_the_batch_factors(self, dp_store,
                                                         tmp_path):
        models = {}
        for stream in (False, True):
            path = tmp_path / f"engine_{stream}.json"
            path.write_text(json.dumps({
                "id": "default", "engineFactory": "recommendation",
                "datasource": {"params": {
                    "app_name": APP, "stream": stream, "device": "cpu"}},
                "algorithms": [{"name": "als", "params": {
                    "rank": 6, "num_iterations": 3, "lam": 0.1, "seed": 3,
                    "device": "cpu"}}]}))
            pipeline.last_stats = None
            iid = create_workflow_main(WorkflowConfig(
                engine_variant=str(path)))
            assert (pipeline.last_stats is not None) == stream
            inst = TReg.Storage.get_meta_data_engine_instances().get(iid)
            assert inst.status == "COMPLETED"
            assert json.loads(inst.data_source_params)["params"][
                "stream"] is stream
            blob = TReg.Storage.get_model_data_models().get(iid).models
            (models[stream],) = TR.RecommendationEngineFactory.apply(
            ).deserialize_models(blob, iid)
        s, b = models[True], models[False]
        assert list(s.user_ix.ids) == list(b.user_ix.ids)
        assert list(s.item_ix.ids) == list(b.item_ix.ids)
        assert np.array_equal(s.als.user_factors, b.als.user_factors)
        assert np.array_equal(s.als.item_factors, b.als.item_factors)
