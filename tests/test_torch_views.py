"""Port parity: the view layer (`data/view.py`: `BatchView`,
`create_view`, `data_view`) vs the JAX package's, over one store.

Both packages read the same SQLite store (the `tmp_env` environment,
written once by the JAX package with seeded events of fixed times and
ids), and every view must be equal, exactly: event lists as their wire
dicts, property maps field for field, column tables array for array
(dtypes included), the per-entity ordered folds value for value. The
`.npz` cache of `create_view` is held too: a second call reads the cache
without converting, a version bump converts again, and a cache file one
package wrote reads back through the other.
"""

import datetime as dt
from dataclasses import dataclass

import numpy as np
import pytest

from predictionio_tpu.data import datamap as JDM
from predictionio_tpu.data import event as JE
from predictionio_tpu.data import view as JV
from predictionio_tpu.data.storage import base as JB
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu_torch.data import view as TV
from predictionio_tpu_torch.data.storage import registry as TReg

VIEWS = {"jax": JV, "port": TV}
UTC = dt.timezone.utc
UNTIL = dt.datetime(2027, 1, 1, tzinfo=UTC)


def at(sec):
    return dt.datetime(2026, 1, 1, 0, 0, sec, tzinfo=UTC)


@pytest.fixture()
def store(tmp_env):
    """A seeded app (`viewapp`, with channel `side`) in one SQLite store
    both packages read."""
    TReg.clear_cache()
    S = JReg.Storage
    app_id = S.get_meta_data_apps().insert(JB.App(0, "viewapp"))
    chan = S.get_meta_data_channels().insert(JB.Channel(0, "side", app_id))
    ev = S.get_events()
    rng = np.random.default_rng(5)
    events = [JE.Event(event="$set", entity_type="user", entity_id="u1",
                       properties=JDM.DataMap({"a": 1, "tags": ["x"]}),
                       event_time=at(0), event_id="s0")]
    for k in range(40):
        u, i = int(rng.integers(0, 6)), int(rng.integers(0, 9))
        name = ["rate", "view", "buy"][k % 3]
        props = {"rating": float(rng.integers(1, 6))} if name == "rate" \
            else {}
        events.append(JE.Event(
            event=name, entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id=f"i{i}",
            properties=JDM.DataMap(props), event_time=at(1 + k),
            event_id=f"e{k:02d}", pr_id="pr7" if k == 5 else None))
    events += [
        JE.Event(event="$set", entity_type="item", entity_id="i1",
                 properties=JDM.DataMap({"cat": "c1", "price": 2.5}),
                 event_time=at(50), event_id="s1"),
        JE.Event(event="$unset", entity_type="user", entity_id="u1",
                 properties=JDM.DataMap({"a": None}), event_time=at(51),
                 event_id="s2"),
        JE.Event(event="$set", entity_type="user", entity_id="u2",
                 properties=JDM.DataMap({"b": 2}), event_time=at(52),
                 event_id="s3"),
    ]
    ev.insert_batch(events, app_id)
    ev.insert(JE.Event(event="view", entity_type="user", entity_id="u9",
                       target_entity_type="item", target_entity_id="i9",
                       event_time=at(53), event_id="c0"), app_id, chan)
    yield tmp_env
    TReg.clear_cache()


def wire(events):
    return [e.to_dict() for e in events]


def table_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tolist() == b[k].tolist(), k


@pytest.mark.parametrize("kw", [
    {}, {"channel_name": "side"}, {"start_time": at(10)},
    {"start_time": at(5), "until_time": at(30)}])
def test_batch_view_snapshot_and_filters(store, kw):
    bv = {pkg: V.BatchView("viewapp", **kw) for pkg, V in VIEWS.items()}
    assert wire(bv["port"].events) == wire(bv["jax"].events)
    assert bv["port"].events
    for f in ({"event_names": ["rate", "view"]}, {"entity_id": "u1"},
              {"start_time": at(20), "until_time": at(25)},
              {"target_entity_id": "i1"}, {"entity_type": "item"}):
        assert wire(bv["port"].filter(**f)) == wire(bv["jax"].filter(**f))


@pytest.mark.parametrize("window", [(None, None), (None, at(10)),
                                    (at(51), None), (None, at(0))])
def test_batch_view_aggregate_properties(store, window):
    start, until = window
    out = {}
    for pkg, V in VIEWS.items():
        bv = V.BatchView("viewapp")
        out[pkg] = {et: {k: v.fields for k, v in bv.aggregate_properties(
            et, start_time=start, until_time=until).items()}
            for et in ("user", "item")}
    assert out["port"] == out["jax"]


def test_batch_view_ordered_fold(store):
    out = {}
    for pkg, V in VIEWS.items():
        bv = V.BatchView("viewapp")
        out[pkg] = [
            bv.aggregate_by_entity_ordered(
                init=(), op=lambda acc, e: acc + (e.event, e.event_id)),
            bv.aggregate_by_entity_ordered(
                init=0.0, op=lambda acc, e: acc + e.properties.get_opt(
                    "rating", float) if e.event == "rate" else acc,
                event_names=["rate"])]
    assert out["port"] == out["jax"]
    assert out["port"][0]["u1"][:2] == ("$set", "s0")


@pytest.mark.parametrize("channel", [None, "side"])
def test_data_view(store, channel):
    tables = {pkg: V.data_view("viewapp", channel_name=channel)
              for pkg, V in VIEWS.items()}
    table_equal(tables["jax"], tables["port"])
    assert tables["port"]["eventTimeMillis"].dtype == np.int64
    assert "pr7" in tables["port"]["prId"].tolist() or channel


@dataclass
class RateRow:
    user: str
    item: str
    rating: float
    stars: int
    liked: bool


def rate_row(e):
    if e.event != "rate":
        return None
    r = e.properties.get("rating", float)
    return RateRow(e.entity_id, e.target_entity_id, r, int(r), r >= 4)


@pytest.mark.parametrize("conversion", ["dataclass", "mapping",
                                        "namedtuple", "empty"])
def test_create_view(store, tmp_path, conversion):
    import collections
    NT = collections.namedtuple("NT", "ev who t")
    conv = {
        "dataclass": rate_row,
        "mapping": lambda e: {"ev": e.event, "who": e.entity_id},
        "namedtuple": lambda e: NT(e.event, e.entity_id,
                                   e.event_time.second),
        "empty": lambda e: None,
    }[conversion]
    calls = {}
    views = {}
    for pkg, V in VIEWS.items():
        n = {"n": 0}

        def counted(e, n=n):
            n["n"] += 1
            return conv(e)

        kw = dict(name="rates", version="1", until_time=UNTIL,
                  start_time=at(3), cache_dir=str(tmp_path / pkg))
        views[pkg] = V.create_view("viewapp", counted, **kw)
        first = n["n"]
        again = V.create_view("viewapp", counted, **kw)
        assert n["n"] == first                  # read from the .npz
        table_equal(again.columns, views[pkg].columns)
        V.create_view("viewapp", counted, **dict(kw, version="2"))
        assert n["n"] == 2 * first              # a new version converts
        calls[pkg] = first
    assert calls["port"] == calls["jax"] > 0
    table_equal(views["jax"].columns, views["port"].columns)
    assert len(views["port"]) == len(views["jax"])
    if conversion == "mapping":
        sub = {pkg: v.filter(v["ev"] == "rate") for pkg, v in views.items()}
        table_equal(sub["jax"].columns, sub["port"].columns)


def test_a_cached_view_reads_back_through_the_other_package(store,
                                                            tmp_path):
    kw = dict(name="x", version="1", until_time=UNTIL,
              cache_dir=str(tmp_path))
    made = JV.create_view("viewapp", rate_row, **kw)
    read = TV.create_view("viewapp", lambda e: pytest.fail("converted"),
                          **kw)
    table_equal(made.columns, read.columns)
    with pytest.raises(ValueError, match="ragged"):
        TV.ColumnarView({"a": np.zeros(2), "b": np.zeros(3)})
    with pytest.raises(TypeError):
        TV.create_view("viewapp", lambda e: 1, name="bad", version="1",
                       until_time=UNTIL, cache_dir=str(tmp_path))
