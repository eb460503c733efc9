"""Port parity: the remote events DAO (`eventserver_client.RemoteEvents`,
the registry type `eventserver`) vs the JAX package's.

Each package's client talks to each package's event server: four
combinations, each over an app of its own (with its key and a channel
`side`) in its server's SQLite store. Every case runs the same calls,
with the same events, through all four and holds the results equal,
exactly (nothing here is a float computed two ways): events as their
wire dicts (without the ids a server mints where the case lets it mint
them), column dicts array for array, raised error types and statuses.
A case that reads a server's store holds the remote read equal to the
store's own.

The cases are `tests/test_eventserver_client.py`'s: CRUD, the batch
write past the server's cap, the find filters, channels by name, the app
scope, client-side ids, removal, columnar pages by time window (a page
of 8 rows), the chunked read, gzip on the wire, the entity-filtered read
and the bulk writes. Then the retries of `tests/test_resilience.py`
(503 with `Retry-After` against a scripted server, the schedule the
client sleeps, the cap on a server's `Retry-After`) and the trace
context a request carries. Every server binds port 0.
"""

import dataclasses
import datetime as dt
import gzip
import http.client
import json
import re

import numpy as np
import pytest

from predictionio_tpu.data import columnar as JCol
from predictionio_tpu.data import datamap as JDM
from predictionio_tpu.data import event as JE
from predictionio_tpu.data.api import event_server as JES
from predictionio_tpu.data.storage import base as JB
from predictionio_tpu.data.storage import eventserver_client as JC
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.data.storage import sqlite as JSQL
from predictionio_tpu.obs import trace as JTrace
from predictionio_tpu.utils import http as JHttp
from predictionio_tpu_torch.data import columnar as TCol
from predictionio_tpu_torch.data import datamap as TDM
from predictionio_tpu_torch.data import event as TE
from predictionio_tpu_torch.data.api import event_server as TES
from predictionio_tpu_torch.data.storage import base as TB
from predictionio_tpu_torch.data.storage import eventserver_client as TC
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage import sqlite as TSQL
from predictionio_tpu_torch.obs import trace as TTrace
from predictionio_tpu_torch.utils import http as THttp

PKGS = {
    "jax": dict(event=JE, dm=JDM, base=JB, col=JCol, client=JC, reg=JReg,
                sql=JSQL, es=JES, trace=JTrace, http=JHttp),
    "port": dict(event=TE, dm=TDM, base=TB, col=TCol, client=TC, reg=TReg,
                 sql=TSQL, es=TES, trace=TTrace, http=THttp),
}
COMBOS = [(c, s) for c in PKGS for s in PKGS]     # (client, server)
UTC = dt.timezone.utc
CREATED = dt.datetime(2026, 2, 1, tzinfo=UTC)


def t(sec):
    return dt.datetime(2026, 1, 1, 0, 0, sec, tzinfo=UTC)


def mk(pkg, event="rate", eid="u1", sec=1, props=None, **kw):
    m = PKGS[pkg]
    return m["event"].Event(
        event=event, entity_type="user", entity_id=eid, event_time=t(sec),
        properties=m["dm"].DataMap(props or {}), creation_time=CREATED,
        **kw)


def wire(events, ids=True, created=True):
    out = [e.to_dict() for e in events]
    for d in out:
        if not ids:
            d.pop("eventId", None)
        if not created:
            d.pop("creationTime", None)
    return out


def cols(c):
    """A column dict as plain lists (NaN as None), for equality."""
    return {k: [None if isinstance(x, float) and x != x else x
                for x in v.tolist()] for k, v in sorted(c.items())}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both packages' event servers, each over its own SQLite store."""
    root = tmp_path_factory.mktemp("client_servers")
    out = {}
    for pkg, m in PKGS.items():
        client = m["sql"].StorageClient(m["reg"].StorageClientConfig(
            "SQLITE", "sqlite", {"URL": str(root / f"{pkg}.db")}))
        daos = {k: client.get_data_object(k, ns) for k, ns in (
            ("access_keys", "pio_meta"), ("channels", "pio_meta"),
            ("events", "pio_event"))}
        extra = {"spill": False} if pkg == "jax" else {}
        srv = m["es"].EventServer(m["es"].EventServerConfig(
            ip="127.0.0.1", port=0, **extra), **daos)
        srv.start()
        out[pkg] = dict(server=srv, client=client, daos=daos,
                        apps=client.get_data_object("apps", "pio_meta"))
    yield out
    for s in out.values():
        s["server"].stop()
        s["client"].close()


_seq = iter(range(10 ** 6))


@pytest.fixture()
def combos(servers):
    """{(client pkg, server pkg): (RemoteEvents, app id, channel id, the
    server store's events DAO)}, each over a fresh app."""
    out = {}
    for cpkg, spkg in COMBOS:
        s, m = servers[spkg], PKGS[spkg]
        name = f"app{next(_seq)}"
        app_id = s["apps"].insert(m["base"].App(0, name))
        s["daos"]["access_keys"].insert(
            m["base"].AccessKey(f"{name}-key", app_id, []))
        chan = s["daos"]["channels"].insert(
            m["base"].Channel(0, "side", app_id))
        s["daos"]["events"].init(app_id)
        s["daos"]["events"].init(app_id, chan)
        c = PKGS[cpkg]["client"].StorageClient(
            PKGS[cpkg]["reg"].StorageClientConfig(
                "REMOTE", "eventserver",
                {"URL": f"http://127.0.0.1:{s['server'].config.port}",
                 "ACCESS_KEY": f"{name}-key", "CHANNELS": f"{chan}=side"}))
        out[(cpkg, spkg)] = (c.get_data_object("events", "ignored"),
                             app_id, chan, s["daos"]["events"])
    yield out
    for ev, *_ in out.values():
        ev.close()


def same(combos, fn):
    """fn(client pkg, remote DAO, app id, channel id, store DAO) through
    every combination; all four results must be equal."""
    r = {k: fn(k[0], *v) for k, v in combos.items()}
    first = r[COMBOS[0]]
    for k in COMBOS[1:]:
        assert r[k] == first, (k, r[k], first)
    return first


# ---------------------------------------------------------------------------
# CRUD and find
# ---------------------------------------------------------------------------

def test_insert_get_delete(combos):
    def run(pkg, ev, app, chan, direct):
        eid = ev.insert(mk(pkg, props={"rating": 5}), app)
        got = ev.get(eid, app)
        out = [wire([got], ids=False), direct.get(eid, app).to_dict()
               == got.to_dict(), ev.delete(eid, app), ev.get(eid, app),
               ev.delete(eid, app)]
        return out
    assert same(combos, run)[1:] == [True, True, None, False]


def test_batch_past_the_server_cap_and_filters(combos):
    def run(pkg, ev, app, chan, direct):
        ids = ev.insert_batch([mk(pkg, eid=f"u{i}", sec=i % 50,
                                  event_id=f"b{i:03d}")
                               for i in range(120)], app)
        ev.remove(app)
        ev.insert_batch([
            mk(pkg, "rate", "u1", 1, target_entity_type="item",
               target_entity_id="i1", event_id="e1"),
            mk(pkg, "buy", "u1", 2, target_entity_type="item",
               target_entity_id="i2", event_id="e2"),
            mk(pkg, "rate", "u2", 3, target_entity_type="item",
               target_entity_id="i1", event_id="e3"),
            mk(pkg, "$set", "u1", 4, props={"a": 1}, event_id="e4"),
        ], app)
        A = PKGS[pkg]["base"].ABSENT
        finds = [dict(event_names=["rate"]), dict(entity_id="u1"),
                 dict(start_time=t(2), until_time=t(4)),
                 dict(target_entity_id="i1"), dict(target_entity_type=A),
                 dict(entity_type="user", entity_id="u1",
                      reversed_order=True), dict(limit=2)]
        # the columnar write route stamps the creation time server-side
        return [ids, [wire(ev.find(app, **kw), created=False)
                      for kw in finds],
                wire(direct.find(app)) == wire(ev.find(app))]
    r = same(combos, run)
    assert len(r[0]) == 120 and r[2] is True


def test_channels_scope_ids_and_remove(combos):
    def run(pkg, ev, app, chan, direct):
        eid = ev.insert(mk(pkg, event_id="c1"), app, chan)
        out = [ev.get(eid, app), ev.get(eid, app, chan).event_id,
               wire(ev.find(app)), len(list(ev.find(app, chan)))]
        for bad in (lambda: ev.insert(mk(pkg), app, 999),
                    lambda: ev.insert(mk(pkg), app + 1000),
                    lambda: list(ev.find(app + 1000))):
            with pytest.raises(ValueError) as ei:
                bad()
            out.append(re.sub(r"\d+", "N", str(ei.value)))
        # a client-side id makes a re-send overwrite, not duplicate
        e = mk(pkg, eid="twice")
        eid = ev.insert(e, app)
        ev.insert(e.with_id(eid), app)
        out.append(len(list(ev.find(app))))
        out += [ev.remove(app), wire(ev.find(app)), ev.init(app)]
        return out
    r = same(combos, run)
    assert r[:4] == [None, "c1", [], 1] and r[7] == 1


def test_auth_failure_surfaces(combos):
    def run(pkg, ev, app, chan, direct):
        bad = PKGS[pkg]["client"].RemoteEvents(
            f"http://{ev.host}:{ev.port}", "WRONGKEY")
        try:
            with pytest.raises(PKGS[pkg]["client"].RemoteError) as ei:
                bad.insert(mk(pkg), app)
            return ei.value.status
        finally:
            bad.close()
    assert same(combos, run) == 401


# ---------------------------------------------------------------------------
# columnar reads
# ---------------------------------------------------------------------------

def seed_columnar(pkg, ev, app, n=30):
    ev.insert_batch([mk(pkg, eid=f"u{i % 7}", sec=i % 50,
                        target_entity_type="item",
                        target_entity_id=f"i{i % 5}",
                        props={"rating": float(i % 5) + 0.5},
                        event_id=f"c{i:03d}") for i in range(n)], app)
    ev.insert(mk(pkg, "view", "u9", 55, target_entity_type="item",
                 target_entity_id="i1", event_id="v0"), app)


@pytest.mark.parametrize("page", [None, 8])
def test_find_columnar_matches_the_store(combos, page, monkeypatch):
    """The remote columnar read (in pages of `page` rows: boundary
    milliseconds refetched whole) equals the server store's own."""
    for pkg in PKGS:
        if page:
            monkeypatch.setattr(PKGS[pkg]["client"].RemoteEvents,
                                "COLUMNAR_PAGE", page)

    def run(pkg, ev, app, chan, direct):
        seed_columnar(pkg, ev, app, 72)
        got = [ev.find_columnar(app, property_field="rating"),
               ev.find_columnar(app, event_names=["view"]),
               ev.find_columnar(app, property_field="rating", limit=50),
               ev.find_columnar(app, property_field="rating",
                                event_names=["nosuch"])]
        ref = direct.find_columnar(app, property_field="rating")
        assert cols(got[0]) == cols(ref)
        return [cols(c) for c in got]
    r = same(combos, run)
    assert len(r[2]["t"]) == 50 and r[1]["event"] == ["view"]


@pytest.mark.parametrize("chunk_rows", [1, 8, 1000])
def test_find_columnar_chunked(combos, chunk_rows):
    def run(pkg, ev, app, chan, direct):
        seed_columnar(pkg, ev, app, 40)
        chunks = list(ev.find_columnar_chunked(
            app, property_field="rating", chunk_rows=chunk_rows,
            start_time=t(3)))
        whole = ev.find_columnar(app, property_field="rating",
                                 start_time=t(3))
        cat = {k: np.concatenate([c[k] for c in chunks]) for k in whole}
        assert cols(cat) == cols(whole)
        return [len(c["t"]) for c in chunks], cols(whole)
    same(combos, run)


def test_find_columnar_by_entities(combos):
    def run(pkg, ev, app, chan, direct):
        seed_columnar(pkg, ev, app, 40)
        kw = dict(entity_ids=["u1", "u3"], target_entity_ids=["i0"],
                  property_field="rating")
        got = ev.find_columnar_by_entities(app, **kw)
        assert cols(got) == cols(direct.find_columnar_by_entities(app, **kw))
        wide = ev.find_columnar_by_entities(
            app, entity_ids=[f"u{i}" for i in range(3000)])
        none = ev.find_columnar_by_entities(app)
        return [cols(got), len(wide["t"]), len(none["t"])]
    assert same(combos, run)[1:] == [41, 0]


def test_columnar_rides_gzip(combos):
    """Each server gzips a columnar body only for a client that asks, and
    each client decodes it."""
    def run(pkg, ev, app, chan, direct):
        seed_columnar(pkg, ev, app, 300)
        conn = http.client.HTTPConnection("127.0.0.1", ev.port, timeout=10)
        out = []
        try:
            for hdrs in ({"Accept-Encoding": "gzip"}, {},
                         {"accept-encoding": "gzip"},
                         {"Accept-Encoding": "gzip;q=0, identity"}):
                conn.request("GET", f"/events/columnar.json?accessKey="
                             f"{ev.access_key}&limit=-1", headers=hdrs)
                r = conn.getresponse()
                raw = r.read()
                enc = r.headers.get("Content-Encoding")
                body = json.loads(gzip.decompress(raw) if enc else raw)
                out.append((enc, len(body["t"])))
        finally:
            conn.close()
        return out + [len(ev.find_columnar(app)["t"])]
    assert same(combos, run) == [("gzip", 301), (None, 301), ("gzip", 301),
                                 (None, 301), 301]


# ---------------------------------------------------------------------------
# bulk writes
# ---------------------------------------------------------------------------

def test_bulk_writes(combos):
    """`insert_batch` (one columnar POST a page, ids assigned client-side)
    and `insert_columnar` land each event once, as the store reads
    them."""
    def run(pkg, ev, app, chan, direct):
        C = PKGS[pkg]["col"].ColumnarBatch
        ids = ev.insert_batch([mk(pkg, "rate", f"u{i}", i % 50,
                                  target_entity_type="item",
                                  target_entity_id=f"i{i % 3}",
                                  props={"rating": float(i % 5)})
                               for i in range(64)], app)
        cids = ev.insert_columnar(C(
            3, "view", "user", ["v1", "v2", "v3"], "item",
            ["i1", "i2", "i3"], [{"n": 1}, {}, {"s": "x"}],
            "2026-01-01T00:00:59.000Z", ["k1", "k2", "k3"]), app)
        stored = list(direct.find(app))
        assert sorted(e.event_id for e in stored) == sorted(ids + cids)
        assert len(set(ids)) == 64
        return [cids, wire(sorted(stored, key=lambda e: (
            e.event_time, e.entity_id)), ids=False, created=False)]
    same(combos, run)


# ---------------------------------------------------------------------------
# retries and the trace context, against a scripted server
# ---------------------------------------------------------------------------

@pytest.fixture(params=sorted(PKGS))
def scripted(request):
    """An event-server stub (the named package's HttpServer) whose POST
    /events.json answers 503 with `Retry-After` until `fail_remaining`
    reaches 0, and records each request's headers."""
    m = PKGS[request.param]
    state = {"fail_remaining": 0, "retry_after": "0", "headers": []}
    r = m["http"].Router()

    def create(req):
        state["headers"].append({k.lower(): v
                                 for k, v in req.headers.items()})
        if state["fail_remaining"] > 0:
            state["fail_remaining"] -= 1
            return m["http"].Response(
                503, {"message": "overloaded"},
                headers={"Retry-After": state["retry_after"]})
        return m["http"].Response(201, {"eventId": req.json()["eventId"]})

    r.add("POST", "/events.json", create)
    srv = m["http"].HttpServer(r, "127.0.0.1", 0)
    srv.start()
    yield srv, state
    srv.stop()


def with_sleeps(client):
    """The client with its retry sleeps recorded instead of slept."""
    slept = []
    client._retry = dataclasses.replace(client._retry, sleep=slept.append)
    return slept


@pytest.mark.parametrize("retry_after,fails,retries", [
    ("0", 2, 4), ("1.5", 1, 3), ("3600", 1, 3), ("", 2, 4),
    ("0", 10, 2)])
def test_503_retries_honour_retry_after(scripted, retry_after, fails,
                                        retries):
    srv, state = scripted
    out = {}
    for pkg in PKGS:
        state.update(fail_remaining=fails, retry_after=retry_after,
                     headers=[])
        client = PKGS[pkg]["client"].RemoteEvents(
            f"http://127.0.0.1:{srv.port}", "k", retries=retries)
        slept = with_sleeps(client)
        try:
            eid = client.insert(mk(pkg, event_id="r1"), app_id=1)
            result = eid
        except PKGS[pkg]["client"].RemoteError as e:
            result = e.status
        finally:
            client.close()
        out[pkg] = (result, len(state["headers"]),
                    slept if retry_after else len(slept))
    assert out["port"] == out["jax"]
    result, n_requests, slept = out["port"]
    if fails < retries:
        assert result == "r1" and n_requests == fails + 1
    else:
        assert result == 503 and n_requests == retries
    if retry_after == "1.5":
        assert slept == [1.5]
    if retry_after == "3600":   # capped: a server cannot park a trainer
        assert slept == [TC.RemoteEvents.MAX_RETRY_AFTER_S]


def test_requests_carry_the_active_trace(scripted):
    srv, state = scripted
    seen = {}
    for pkg in PKGS:
        tr = PKGS[pkg]["trace"]
        state["headers"] = []
        client = PKGS[pkg]["client"].RemoteEvents(
            f"http://127.0.0.1:{srv.port}", "k")
        try:
            client.insert(mk(pkg, event_id="n1"), app_id=1)
            with tr.TRACER.trace("client_probe") as trace:
                client.insert(mk(pkg, event_id="t1"), app_id=1)
        finally:
            client.close()
        outside, inside = state["headers"]
        assert tr.TRACE_HEADER.lower() not in outside
        assert inside[tr.TRACE_HEADER.lower()] == trace.trace_id
        parent = inside[tr.PARENT_SPAN_HEADER.lower()]
        seen[pkg] = (tr.TRACE_HEADER, tr.PARENT_SPAN_HEADER,
                     parent.split(":")[0].isdigit())
    assert seen["port"] == seen["jax"]
