"""Port parity: the REST event server (`data/api/event_server.py`) vs the
JAX reference's, on the CPU.

Each scenario of the table sends the same requests, in order, to a JAX
and a port event server, each over its own temporary SQLite store set up
alike (an input blocker that vetoes entity `blocked`; for each scenario
an app of its own with a key, a key for rate events only, and channel
`chan1`). Status codes and bodies must be equal, exactly, apart from
what is minted: event ids (a list of ids is compared by its length),
`traceId` (each server mints its own; `test_torch_obs_e2e.py` holds the
ids), and the creation time and window start the servers stamp.
A later request may name the id an earlier one was given as `{idN}`.

Beyond the table: rows the port writes read back equal through the JAX
package's storage, and an access key made by either package
authenticates on the other's server; the access-key cache's TTL
semantics (as `tests/test_event_server.py::TestAuthCache`); 8 concurrent
clients through the admission batcher write the same rows as serial
posts; a leader whose insert raises hands the error to every follower;
the diagnostics routes answer as the reference's, gated alike by
`--stats`; `spill=False` is accepted and `/fleet/status.json` lists the
server as a live member.
Every HTTP call carries a timeout and every server binds port 0.
"""

import base64
import json
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request

import pytest

from predictionio_tpu.data.api import event_server as JES
from predictionio_tpu.data.api import plugins as JP
from predictionio_tpu.data.storage import base as JB
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.data.storage import sqlite as JSQL
from predictionio_tpu_torch.data.api import event_server as TES
from predictionio_tpu_torch.data.api import plugins as TP
from predictionio_tpu_torch.data.storage import base as TB
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage import sqlite as TSQL

TIMEOUT_S = 10
EVENT = {"event": "rate", "entityType": "user", "entityId": "u1",
         "targetEntityType": "item", "targetEntityId": "i1",
         "properties": {"rating": 4.5},
         "eventTime": "2026-01-02T03:04:05.678Z"}
KEY = "?accessKey={key}"
LIMITED = "?accessKey={limited}"
MINTED = ("eventId", "traceId", "creationTime", "startTime")


def call(port, method, path, body=None, headers=None):
    data = (json.dumps(body).encode() if isinstance(body, (dict, list))
            else body)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def scrub(body):
    """The body without what either server mints."""
    if isinstance(body, list):
        return [scrub(x) for x in body]
    if isinstance(body, dict):
        out = {}
        for k, v in body.items():
            if k in MINTED:
                continue
            out[k] = len(v) if k == "eventIds" else scrub(v)
        return out
    return body


def make_veto(base, blocker):
    class Veto(base):
        plugin_name = "veto"
        plugin_description = "vetoes entity 'blocked'"
        input_type = blocker

        def process(self, event_info, context):
            if event_info["event"].get("entityId") == "blocked":
                raise ValueError("blocked by the veto plugin")
    return Veto()


def store(pkg, path):
    """A fresh SQLite store: (client, its access key, channel and event
    DAOs, a function that adds a scenario's app, keys and channel)."""
    sql, base, reg = pkg
    client = sql.StorageClient(reg.StorageClientConfig(
        "SQLITE", "sqlite", {"URL": str(path)}))
    apps = client.get_data_object("apps", "pio_meta")
    keys = client.get_data_object("access_keys", "pio_meta")
    chans = client.get_data_object("channels", "pio_meta")
    events = client.get_data_object("events", "pio_event")

    def add_app(name: str) -> None:
        app_id = apps.insert(base.App(0, name))
        keys.insert(base.AccessKey(f"{name}-key", app_id, []))
        keys.insert(base.AccessKey(f"{name}-limited", app_id, ["rate"]))
        chans.insert(base.Channel(0, "chan1", app_id))

    return client, dict(access_keys=keys, channels=chans,
                        events=events), add_app


JAX_PKG = (JSQL, JB, JReg)
PORT_PKG = (TSQL, TB, TReg)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both servers, each over its own store, for the whole table."""
    root = tmp_path_factory.mktemp("event_servers")
    jc, jdaos, j_add = store(JAX_PKG, root / "jax.db")
    tc, tdaos, t_add = store(PORT_PKG, root / "port.db")
    jctx = JP.EventServerPluginContext()
    jctx.register(make_veto(JP.EventServerPlugin, JP.INPUT_BLOCKER))
    tctx = TP.EventServerPluginContext()
    tctx.register(make_veto(TP.EventServerPlugin, TP.INPUT_BLOCKER))
    j = JES.EventServer(JES.EventServerConfig(ip="127.0.0.1", port=0,
                                              stats=True, spill=False),
                        plugin_context=jctx, **jdaos)
    t = TES.EventServer(TES.EventServerConfig(ip="127.0.0.1", port=0,
                                              stats=True),
                        plugin_context=tctx, **tdaos)
    j.start()
    t.start()
    try:
        yield j, t, j_add, t_add
    finally:
        t.stop()
        j.stop()
        jc.close()
        tc.close()


def basic(key: str) -> dict:
    return {"Authorization": "Basic "
            + base64.b64encode(f"{key}:".encode()).decode()}


#: a step's headers that name the scenario's key at drive time
BASIC_KEY = {"Authorization": "Basic {key}"}


def ev(**kw):
    return dict(EVENT, **kw)


def seeded(*extra):
    """Three rate/buy events a second apart, then `extra`."""
    return [("POST", "/events.json" + KEY,
             ev(event=e, entityId=u, eventTime=f"2026-01-02T03:04:0{s}.000Z"),
             None) for e, u, s in (("rate", "u1", 5), ("buy", "u1", 6),
                                   ("rate", "u2", 7))] + list(extra)


FORM = {"type": "subscribe", "fired_at": "2026-03-26 21:35:57",
        "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
        "data[email]": "api@mailchimp.com", "data[email_type]": "html",
        "data[merges][EMAIL]": "api@mailchimp.com",
        "data[merges][FNAME]": "MailChimp", "data[merges][LNAME]": "API",
        "data[ip_opt]": "10.20.10.30", "data[ip_signup]": "10.20.10.30"}
FORM_HDR = {"Content-Type": "application/x-www-form-urlencoded"}
COLUMNS = {"event": ["rate", "$invalid", "rate", "rate"],
           "entityType": "user", "entityId": ["c1", "c2", "blocked", "c4"],
           "targetEntityType": "item",
           "targetEntityId": ["i1", "i2", "i3", "i4"],
           "properties": [{"rating": 1.0}, {"rating": 2.0},
                          {"rating": 3.0}, {}],
           "eventTime": "2026-01-02T03:04:05.000Z", "returnIds": True}

SCENARIOS = {
    "status": [("GET", "/", None, None)],
    "unknown_route_and_method": [
        ("GET", "/nope.json", None, None),
        ("PUT", "/events.json" + KEY, EVENT, None)],
    "create_get_delete": [
        ("POST", "/events.json" + KEY, EVENT, None),
        ("GET", "/events/{id0}.json" + KEY, None, None),
        ("DELETE", "/events/{id0}.json" + KEY, None, None),
        ("GET", "/events/{id0}.json" + KEY, None, None),
        ("DELETE", "/events/{id0}.json" + KEY, None, None)],
    "auth": [
        ("POST", "/events.json", EVENT, None),
        ("POST", "/events.json?accessKey=wrong", EVENT, None),
        ("POST", "/events.json", EVENT, BASIC_KEY),
        ("POST", "/events.json", EVENT, {"authorization": "Basic {key}"}),
        ("POST", "/events.json", EVENT, basic("wrong")),
        ("POST", "/events.json", EVENT, {"Authorization": "Basic !!"}),
        ("GET", "/events/{id2}.json", None, BASIC_KEY)],
    "whitelist": [
        ("POST", "/events.json" + LIMITED, EVENT, None),
        ("POST", "/events.json" + LIMITED, ev(event="buy"), None)],
    "invalid_events": [
        ("POST", "/events.json" + KEY, ev(event="$invalid"), None),
        ("POST", "/events.json" + KEY, ev(entityId=""), None),
        ("POST", "/events.json" + KEY,
         {k: v for k, v in EVENT.items() if k != "event"}, None),
        ("POST", "/events.json" + KEY, [EVENT], None),
        ("POST", "/events.json" + KEY, b"{not json", None),
        ("POST", "/events.json" + KEY,
         {k: v for k, v in EVENT.items() if k != "targetEntityType"},
         None),
        ("POST", "/events.json" + KEY, ev(properties=[1]), None),
        ("POST", "/events.json" + KEY, ev(eventTime="yesterday"), None)],
    "reserved_events": [
        ("POST", "/events.json" + KEY, ev(entityType="pio_user"), None),
        ("POST", "/events.json" + KEY, ev(properties={"pio_x": 1}), None),
        ("POST", "/events.json" + KEY, ev(event="$set"), None),
        ("POST", "/events.json" + KEY,
         {"event": "$unset", "entityType": "user", "entityId": "u1"}, None),
        ("POST", "/events.json" + KEY,
         {"event": "predict", "entityType": "pio_pr", "entityId": "p1",
          "properties": {"query": {"user": "u1"}},
          "eventTime": "2026-01-02T03:04:05.678Z"}, None),
        ("GET", "/events/{id4}.json" + KEY, None, None)],
    "channels": [
        ("POST", "/events.json" + KEY + "&channel=chan1", EVENT, None),
        ("GET", "/events.json" + KEY, None, None),
        ("GET", "/events.json" + KEY + "&channel=chan1", None, None),
        ("POST", "/events.json" + KEY + "&channel=nope", EVENT, None),
        ("GET", "/events/{id0}.json" + KEY, None, None),
        ("GET", "/events/{id0}.json" + KEY + "&channel=chan1", None, None)],
    "find_filters": seeded(
        ("GET", "/events.json" + KEY, None, None),
        ("GET", "/events.json" + KEY + "&event=rate", None, None),
        ("GET", "/events.json" + KEY + "&event=rate,buy&limit=2", None,
         None),
        ("GET", "/events.json" + KEY + "&entityType=user&entityId=u1"
         "&reversed=true", None, None),
        ("GET", "/events.json" + KEY + "&limit=1", None, None),
        ("GET", "/events.json" + KEY + "&startTime=2026-01-02T03:04:06"
         ".000Z", None, None),
        ("GET", "/events.json" + KEY + "&untilTime=2026-01-02T03:04:06"
         ".000Z", None, None),
        ("GET", "/events.json" + KEY + "&targetEntityType=", None, None),
        ("GET", "/events.json" + KEY + "&targetEntityId=i1", None, None),
        ("GET", "/events.json" + KEY + "&entityId=nobody", None, None),
        ("GET", "/events.json" + KEY + "&reversed=true", None, None)),
    "batch": [
        ("POST", "/batch/events.json" + KEY,
         [EVENT, ev(event="$invalid"), ev(entityId="u9"), {"event": "x"},
          ev(entityId="blocked")], None),
        ("POST", "/batch/events.json" + LIMITED,
         [EVENT, ev(event="buy")], None),
        ("POST", "/batch/events.json" + KEY, [EVENT] * 51, None),
        ("POST", "/batch/events.json" + KEY, [EVENT] * 50, None),
        ("POST", "/batch/events.json" + KEY, EVENT, None),
        ("GET", "/events.json" + KEY + "&limit=-1", None, None)],
    "columnar_write": [
        ("POST", "/events/columnar.json" + KEY, COLUMNS, None),
        ("POST", "/events/columnar.json" + KEY,
         {"event": "rate", "entityType": "user", "entityId": ["d1", "d2"],
          "targetEntityType": "item", "targetEntityId": ["i9", "i9"],
          "properties": [{"rating": 4.0}, {"rating": 5.0}],
          "eventTime": ["2026-01-02T03:04:05.000Z", None]}, None),
        ("GET", "/events.json" + KEY + "&event=rate&untilTime="
         "2026-01-02T03:04:06.000Z&limit=-1", None, None)],
    "columnar_malformed": [
        ("POST", "/events/columnar.json" + KEY,
         dict(COLUMNS, extra=1), None),
        ("POST", "/events/columnar.json" + KEY,
         dict(COLUMNS, entityId=["a"]), None),
        ("POST", "/events/columnar.json" + KEY,
         dict(COLUMNS, event="$bad"), None),
        ("POST", "/events/columnar.json" + KEY,
         dict(COLUMNS, entityId="a"), None),
        ("POST", "/events/columnar.json" + LIMITED,
         dict(COLUMNS, event="buy"), None),
        ("POST", "/events/columnar.json" + KEY,
         dict(COLUMNS, eventTime=["x", None, None, None]), None),
        ("POST", "/events/columnar.json" + KEY, [1], None)],
    "columnar_read": seeded(
        ("GET", "/events/columnar.json" + KEY, None, None),
        ("GET", "/events/columnar.json" + KEY + "&propertyField=rating"
         "&event=rate", None, None),
        ("GET", "/events/columnar.json" + KEY + "&limit=1", None, None),
        ("POST", "/events/columnar.json" + KEY,
         {"entityIds": ["u1"], "propertyField": "rating"}, None),
        ("POST", "/events/columnar.json" + KEY,
         {"targetEntityIds": ["i1"], "events": ["buy"],
          "entityType": "user"}, None)),
    "stats": seeded(
        ("POST", "/events.json" + KEY, ev(event="$invalid"), None),
        ("POST", "/events/columnar.json" + KEY, COLUMNS, None),
        ("GET", "/stats.json" + KEY, None, None),
        ("GET", "/stats.json" + LIMITED, None, None),
        ("GET", "/stats.json", None, None)),
    "webhook_segmentio": [
        ("POST", "/webhooks/segmentio.json" + KEY,
         {"type": "track", "userId": "user123", "event": "Signed Up",
          "properties": {"plan": "Pro"}, "context": {"ip": "1.2.3.4"},
          "timestamp": "2026-01-02T03:04:05.000Z"}, None),
        ("POST", "/webhooks/segmentio.json" + KEY,
         {"type": "identify", "userId": "user9", "traits": {"a": 1},
          "timestamp": "2026-01-02T03:04:06.000Z"}, None),
        ("POST", "/webhooks/segmentio.json" + KEY,
         {"type": "track", "event": "x"}, None),
        ("POST", "/webhooks/segmentio.json" + KEY, {"type": "bogus",
                                                     "userId": "u"}, None),
        ("GET", "/events.json" + KEY + "&event=track,identify", None,
         None)],
    "webhook_mailchimp": [
        ("POST", "/webhooks/mailchimp" + KEY,
         urllib.parse.urlencode(FORM).encode(), FORM_HDR),
        ("POST", "/webhooks/mailchimp" + KEY,
         urllib.parse.urlencode({"type": "subscribe"}).encode(), FORM_HDR),
        ("POST", "/webhooks/mailchimp" + KEY,
         urllib.parse.urlencode({"type": "nope"}).encode(), FORM_HDR),
        ("GET", "/events.json" + KEY + "&event=subscribe", None, None)],
    "webhook_unknown": [
        ("POST", "/webhooks/nope.json" + KEY, {}, None),
        ("GET", "/webhooks/segmentio.json" + KEY, None, None),
        ("GET", "/webhooks/mailchimp.json" + KEY, None, None),
        ("GET", "/webhooks/nope.json" + KEY, None, None),
        ("POST", "/webhooks/nope" + KEY, b"a=b", FORM_HDR),
        ("POST", "/webhooks/segmentio.json", {}, None)],
    "plugin_veto": [
        ("GET", "/plugins.json", None, None),
        ("POST", "/events.json" + KEY, ev(entityId="blocked"), None),
        ("GET", "/events.json" + KEY, None, None)],
}


def drive(port: int, steps, app: str) -> list:
    out = []
    names = {"key": f"{app}-key", "limited": f"{app}-limited"}
    b64 = base64.b64encode(f"{app}-key:".encode()).decode()
    for k, (method, path, body, headers) in enumerate(steps):
        headers = {h: v.format(key=b64) for h, v in (headers or {}).items()}
        code, got = call(port, method, path.format(**names), body, headers)
        if isinstance(got, dict) and "eventId" in got:
            names[f"id{k}"] = got["eventId"]
        out.append((code, scrub(got)))
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_the_port_answers_each_request_as_the_reference(servers, scenario):
    j, t, j_add, t_add = servers
    j_add(scenario)
    t_add(scenario)
    want = drive(j.config.port, SCENARIOS[scenario], scenario)
    got = drive(t.config.port, SCENARIOS[scenario], scenario)
    for k, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"{scenario} step {k}: port {g} != reference {w}"


def test_the_ports_rows_read_back_through_the_reference(tmp_env):
    """One store for both packages: what the port's server writes, the
    JAX package's storage reads back equal; a key each package makes
    authenticates on the other's server."""
    JReg.clear_cache()
    TReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(TB.App(0, "shared"))
    TReg.Storage.get_meta_data_access_keys().insert(
        TB.AccessKey("portkey", app_id, ()))
    JReg.Storage.get_meta_data_access_keys().insert(
        JB.AccessKey("jaxkey", app_id, []))
    t = TES.EventServer(TES.EventServerConfig(ip="127.0.0.1", port=0))
    j = JES.EventServer(JES.EventServerConfig(ip="127.0.0.1", port=0,
                                              spill=False))
    t.start()
    j.start()
    try:
        for port, key in ((t.config.port, "jaxkey"),
                          (j.config.port, "portkey")):
            code, _ = call(port, "POST", f"/events.json?accessKey={key}",
                           EVENT)
            assert code == 201
        batch = [ev(entityId=f"u{k}", properties={"rating": k / 2},
                    eventTime=f"2026-01-02T03:04:{k:02d}.125Z",
                    tags=["a", "b"], prId=f"p{k}") for k in range(10)]
        code, body = call(t.config.port, "POST",
                          "/batch/events.json?accessKey=portkey", batch)
        assert code == 200 and all(r["status"] == 201 for r in body)
        code, body = call(t.config.port, "POST",
                          "/events/columnar.json?accessKey=portkey",
                          {"event": "view", "entityType": "user",
                           "entityId": ["v1", "v2"],
                           "targetEntityType": "item",
                           "targetEntityId": ["i1", "i2"],
                           "eventTime": "2026-01-03T00:00:00.000Z"})
        assert code == 201
    finally:
        t.stop()
        j.stop()
    mine = [e.to_dict() for e in TReg.Storage.get_events().find(app_id)]
    theirs = [e.to_dict() for e in JReg.Storage.get_events().find(app_id)]
    assert len(mine) == 14 and mine == theirs
    assert {e["prId"] for e in mine if "prId" in e} == {
        f"p{k}" for k in range(10)}


class TestAuthCache:
    """The port's access-key cache, as the reference's TestAuthCache."""

    @pytest.fixture()
    def server(self, tmp_env):
        TReg.clear_cache()
        app_id = TReg.Storage.get_meta_data_apps().insert(
            TB.App(0, "esapp"))
        TReg.Storage.get_meta_data_access_keys().insert(
            TB.AccessKey("testkey", app_id, ()))
        s = TES.EventServer(TES.EventServerConfig(ip="127.0.0.1", port=0))
        s.start()
        yield s
        s.stop()
        TReg.clear_cache()

    def test_revocation_honored_within_ttl_semantics(self, server):
        p = server.config.port
        server.auth_cache_ttl_s = 3.0
        assert call(p, "POST", "/events.json?accessKey=testkey", EVENT)[0] == 201
        TReg.Storage.get_meta_data_access_keys().delete("testkey")
        assert call(p, "POST", "/events.json?accessKey=testkey", EVENT)[0] == 201
        server.auth_cache_ttl_s = 0.0
        assert call(p, "POST", "/events.json?accessKey=testkey", EVENT)[0] == 401

    def test_expiry_picks_up_new_state(self, server):
        import time
        p = server.config.port
        server.auth_cache_ttl_s = 0.05
        code, _ = call(p, "POST", "/events.json?accessKey=ghostkey", EVENT)
        assert code == 401
        app_id = TReg.Storage.get_meta_data_apps().get_by_name("esapp").id
        TReg.Storage.get_meta_data_access_keys().insert(
            TB.AccessKey("ghostkey", app_id, ()))
        time.sleep(0.06)
        code, _ = call(p, "POST", "/events.json?accessKey=ghostkey", EVENT)
        assert code == 201

    def test_env_sets_the_ttl(self, tmp_env, monkeypatch):
        monkeypatch.setenv("PIO_ACCESSKEY_CACHE_S", "0")
        assert TES.EventServer(TES.EventServerConfig()).auth_cache_ttl_s \
            == 0.0
        monkeypatch.setenv("PIO_ACCESSKEY_CACHE_S", "soon")
        assert TES.EventServer(TES.EventServerConfig()).auth_cache_ttl_s \
            == 3.0


def rows(events, app_id) -> list:
    return sorted((e.entity_id, e.target_entity_id, e.event,
                   json.dumps(e.properties.fields, sort_keys=True),
                   e.event_time.isoformat())
                  for e in events.find(app_id))


def test_concurrent_clients_write_what_serial_posts_write(tmp_env):
    """8 clients x 12 posts at once (a 10 us switch interval) go through
    the admission batcher (its grouped `insert_batch`, counted) and land
    the rows the same posts write one after another."""
    TReg.clear_cache()
    apps = TReg.Storage.get_meta_data_apps()
    keys = TReg.Storage.get_meta_data_access_keys()
    ids = {}
    for name in ("conc", "serial"):
        ids[name] = apps.insert(TB.App(0, name))
        keys.insert(TB.AccessKey(name, ids[name], ()))
    events = TReg.Storage.get_events()
    grouped = []
    real = events.insert_batch

    def counting(evs, app_id, channel_id=None):
        grouped.append(len(evs))
        return real(evs, app_id, channel_id)

    s = TES.EventServer(TES.EventServerConfig(ip="127.0.0.1", port=0))
    s.start()
    bodies = [[ev(entityId=f"u{c}", targetEntityId=f"i{k}",
                  properties={"rating": float(k % 5)},
                  eventTime=f"2026-01-02T03:{c:02d}:{k:02d}.000Z")
               for k in range(12)] for c in range(8)]
    switch = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-5)
        events.insert_batch = counting
        start = threading.Barrier(8)
        errors = []

        def client(c):
            start.wait()
            for b in bodies[c]:
                code, _ = call(s.config.port, "POST",
                               "/events.json?accessKey=conc", b)
                if code != 201:
                    errors.append(code)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads) and not errors
        for c in range(8):
            for b in bodies[c]:
                assert call(s.config.port, "POST",
                            "/events.json?accessKey=serial", b)[0] == 201
    finally:
        sys.setswitchinterval(switch)
        del events.insert_batch
        s.stop()
    assert rows(events, ids["conc"]) == rows(events, ids["serial"])
    assert len(rows(events, ids["conc"])) == 96
    assert sum(grouped) <= 96


def test_a_failed_group_insert_reaches_every_follower():
    """A leader whose `insert_batch` raises hands the error to every
    waiter of its group: no follower hangs."""

    class Failing:
        def insert(self, *a):
            raise AssertionError("a grouped submit went inline")

        def insert_batch(self, evs, app_id, channel_id=None):
            raise OSError("database is locked")

    # without the spill, which would acknowledge the events instead
    s = TES.EventServer(TES.EventServerConfig(spill=False),
                        events=Failing(), access_keys=object(),
                        channels=object())
    batcher = s._batcher
    n = 4
    for _ in range(n):
        batcher.enter()
    got = []

    def submit():
        try:
            batcher.submit(object(), 1, None)
        except OSError as e:
            got.append(str(e))

    threads = [threading.Thread(target=submit) for _ in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert got == ["database is locked"] * n


def test_spill_off_is_accepted_and_the_fleet_lists_this_server(tmp_env):
    """`spill=False` is a config field, as in the reference; once bound,
    the server is a live fleet member that `/fleet/status.json` lists
    with this process's pid and its port, and `stop` removes it."""
    import os
    s = TES.EventServer(TES.EventServerConfig(ip="127.0.0.1", port=0,
                                              stats=True, spill=False))
    s.start()
    try:
        status, body = call(s.config.port, "GET", "/fleet/status.json")
        assert status == 200
        (m,) = body["members"]
        assert (m["memberId"], m["role"], m["pid"], m["port"],
                m["alive"]) == (f"event_server-{os.getpid()}",
                                "event_server", os.getpid(),
                                s.config.port, True)
        assert (body["alive"], body["dead"]) == (1, 0)
    finally:
        s.stop()
    assert TES.fleet.get_fleet().members() == []


def shape(body):
    """A body's keys, nested, with list lengths: what the routes must
    agree on (their values are process state)."""
    if isinstance(body, dict):
        return {k: shape(v) for k, v in body.items()}
    if isinstance(body, list):
        return [len(body)]
    return type(body).__name__


# each route the port answered 404 before the diagnostics plane: (path,
# method, body, keys the reference has and the port not yet)
DIAG_ROUTES = [
    ("/traces.json?kind=no_such_kind", "GET", None, ()),
    ("/flight.json?kind=no_such_kind", "GET", None, ()),
    ("/health.json", "GET", None, ()),
    ("/incidents.json", "GET", None, ()),
    ("/profile.json?action=report", "GET", None, ()),
]


@pytest.mark.parametrize("path,method,body,unported", DIAG_ROUTES,
                         ids=[r[0].split("?")[0] for r in DIAG_ROUTES])
@pytest.mark.parametrize("stats", [True, False])
def test_diagnostics_routes_answer_as_the_reference(tmp_env, monkeypatch,
                                                    path, method, body,
                                                    unported, stats):
    monkeypatch.setenv("PIO_INCIDENTS_DIR", str(tmp_env / "incidents"))
    got = {}
    for name, mod in (("jax", JES), ("port", TES)):
        srv = mod.EventServer(mod.EventServerConfig(ip="127.0.0.1", port=0,
                                                    stats=stats))
        srv.start()
        try:
            got[name] = call(srv.config.port, method, path, body)
        finally:
            srv.stop()
    (sj, bj), (st, bt) = got["jax"], got["port"]
    gated = path.split("?")[0] != "/health.json"
    assert st == sj == (404 if gated and not stats else 200)
    if st == 404:
        assert bt == bj
        return
    bj = {k: v for k, v in bj.items() if k not in unported}
    if path.startswith("/profile.json"):
        # the sampler's own counts differ between the two processes
        assert sorted(bt) == sorted(bj)
    else:
        assert shape(bt) == shape(bj)
