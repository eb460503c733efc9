"""Port parity: the event-collection commands of the port's command line
(`app`, `accesskey`, `export`, `import`, `trim`, `status`) vs the JAX
package's `pio`, on the CPU.

Each command runs through both packages' `cli.main` (what `python -m
predictionio_tpu_torch` and `bin/pio` run), each over its own temporary
store, in the same order; what each prints and its exit code must be
equal, with access keys and file paths masked. A few run as `python -m
predictionio_tpu_torch` subprocesses, as a user runs them. The stores
then hold the same apps, keys (by app and whitelist), channels and
events, and an export of either is the same JSON lines (event ids and
creation times the import minted masked); the port's commands read the
JAX package's store as its own commands do. `import --format movielens`
takes a tiny synthesized `u.data`; the parquet pair runs when pyarrow is
installed. The export -> import round trip of events a few milliseconds
around 128,003 ms (where `to_millis(from_millis(k))` is `k - 1`, ROADMAP
§C) lands the port's rows where the reference's own round trip lands
them. `status` checks the storage as the reference's does and, with no
CUDA device, exits 1 and says so.
"""

import contextlib
import datetime as dt
import json
import re
import subprocess
import sys

import pytest

from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.tools import cli as jcli
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.tools import cli as tcli

KEY = re.compile(r"[A-Za-z0-9_-]{64}")


def env_of(root) -> dict:
    return {
        "PIO_FS_BASEDIR": str(root),
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio_meta",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQLITE",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio_event",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQLITE",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOCALFS",
        "PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQLITE_URL": str(root / "pio.db"),
        "PIO_STORAGE_SOURCES_LOCALFS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_LOCALFS_HOSTS": str(root / "models"),
    }


@pytest.fixture()
def stores(tmp_path, monkeypatch, capsys):
    """run(pkg, *args) -> (exit code, printed text) over that package's
    store (`pkg` "jax" or "port"); `on` names the store to use."""
    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}

    @contextlib.contextmanager
    def on(name):
        for k, v in env_of(roots[name]).items():
            monkeypatch.setenv(k, v)
        JReg.clear_cache()
        TReg.clear_cache()
        try:
            yield roots[name]
        finally:
            JReg.clear_cache()
            TReg.clear_cache()

    def run(pkg, *args, store=None):
        with on(store or pkg) as root:
            capsys.readouterr()
            main = jcli.main if pkg == "jax" else tcli.main
            try:
                rc = main([a.replace("{root}", str(root)) for a in args])
            except SystemExit as e:
                rc = e.code
            text = capsys.readouterr().out.replace(str(root), "{root}")
        return rc, KEY.sub("<key>", text)

    run.on = on
    run.roots = roots
    return run


def both(run, *args, **kw):
    """Run `args` in both packages; their output must be equal."""
    j = run("jax", *args, **kw)
    t = run("port", *args, **kw)
    assert t == j, f"{args}: port {t} != reference {j}"
    return t


def port_subprocess(root, *args):
    return subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch", *args],
        env=dict(__import__("os").environ, **env_of(root)),
        capture_output=True, text=True, timeout=120)


def event_lines(n_rate: int = 30) -> list:
    """JSON lines of events: rates (most with ids and creation times,
    some without), $set items, and views at times a few ms around
    128,003 ms."""
    out = []
    base = dt.datetime(2026, 5, 1, tzinfo=dt.timezone.utc)
    for k in range(n_rate):
        d = {"event": "rate", "entityType": "user", "entityId": f"u{k % 7}",
             "targetEntityType": "item", "targetEntityId": f"i{k % 5}",
             "properties": {"rating": float(1 + k % 5)},
             "eventTime": (base + dt.timedelta(seconds=k)).isoformat()}
        if k % 4:
            d.update(eventId=f"{k:032x}", creationTime=d["eventTime"])
        out.append(d)
    for k in range(5):
        out.append({"event": "$set", "entityType": "item",
                    "entityId": f"i{k}", "eventId": f"{100 + k:032x}",
                    "properties": {"categories": [f"c{k % 2}"]},
                    "eventTime": "2026-04-01T00:00:00.000Z",
                    "creationTime": "2026-04-01T00:00:00.000Z"})
    for ms in range(127_995, 128_012):
        t = dt.datetime.fromtimestamp(ms / 1000, tz=dt.timezone.utc)
        out.append({"event": "view", "entityType": "user",
                    "entityId": f"early{ms}", "targetEntityType": "item",
                    "targetEntityId": "i1", "eventId": f"{ms:032x}",
                    "eventTime": t.isoformat(timespec="milliseconds"),
                    "creationTime": t.isoformat(timespec="milliseconds")})
    return out


GIVEN_IDS = {d["eventId"] for d in event_lines() if "eventId" in d}


def scrubbed_export(path) -> list:
    """An export's events, the ids and creation times an import minted
    masked, sorted."""
    out = []
    for line in open(path):
        d = json.loads(line)
        if d["eventId"] not in GIVEN_IDS:
            d["eventId"] = d["creationTime"] = "<minted>"
        out.append(json.dumps(d, sort_keys=True))
    return sorted(out)


def test_app_and_accesskey_commands_match_the_reference(stores):
    run = stores
    rc, text = both(run, "app", "new", "shop", "--description", "a shop")
    assert rc == 0 and "App Name: shop" in text and "<key>" in text
    assert both(run, "app", "new", "shop")[0] == 1
    both(run, "app", "new", "other", "--id", "7", "--access-key", "fixed")
    assert both(run, "app", "new", "third", "--id", "7")[0] == 1
    both(run, "app", "channel-new", "shop", "chan1")
    assert both(run, "app", "channel-new", "shop", "chan1")[0] == 1
    assert both(run, "app", "channel-new", "shop", "bad name!")[0] == 1
    assert both(run, "app", "channel-new", "nope", "c")[0] == 1
    both(run, "accesskey", "new", "shop", "--event", "rate", "--event",
         "buy")
    both(run, "accesskey", "new", "shop", "--key", "k2")
    assert both(run, "accesskey", "new", "shop", "--key", "k2")[0] == 1
    assert both(run, "accesskey", "new", "nope")[0] == 1
    rc, text = both(run, "accesskey", "list", "shop")
    assert "k2 | app 1 | (all)" in text and "rate,buy" in text
    both(run, "accesskey", "list")
    both(run, "app", "list")
    rc, text = both(run, "app", "show", "shop")
    assert "Channel: chan1 (id 1)" in text
    assert both(run, "app", "show", "nope")[0] == 1
    both(run, "accesskey", "delete", "k2")
    assert both(run, "accesskey", "delete", "k2")[0] == 1
    both(run, "app", "data-delete", "shop", "-f")
    both(run, "app", "data-delete", "shop", "--channel", "chan1", "-f")
    assert both(run, "app", "data-delete", "shop", "--channel", "zz",
                "-f")[0] == 1
    both(run, "app", "data-delete", "shop", "--all", "-f")
    both(run, "app", "channel-delete", "shop", "chan1", "-f")
    assert both(run, "app", "channel-delete", "shop", "chan1", "-f")[0] == 1
    both(run, "app", "delete", "other", "-f")
    assert both(run, "app", "delete", "other", "-f")[0] == 1
    # the port reads the reference's store as the reference does
    for args in (("app", "list"), ("accesskey", "list"),
                 ("app", "show", "shop")):
        assert run("port", *args, store="jax") == run("jax", *args)
    # a user's subprocess sees the same store
    out = port_subprocess(run.roots["jax"], "app", "list")
    assert out.returncode == 0
    assert KEY.sub("<key>", out.stdout) == run("jax", "app", "list")[1]


def test_import_export_and_trim_match_the_reference(stores, tmp_path):
    run = stores
    src = tmp_path / "events.json"
    src.write_text("".join(json.dumps(d) + "\n" for d in event_lines()))
    both(run, "app", "new", "shop")
    both(run, "app", "new", "copy")
    both(run, "app", "new", "window")
    rc, text = both(run, "import", "--appid", "1", "--input", str(src))
    assert rc == 0 and text.strip() == f"Imported {len(event_lines())} " \
        "events."
    for pkg in ("jax", "port"):
        rc, text = run(pkg, "export", "--appid", "1", "--output",
                       "{root}/out.json")
        assert rc == 0 and text.strip() == \
            f"Exported {len(event_lines())} events to {{root}}/out.json."
    exported = {pkg: scrubbed_export(run.roots[pkg] / "out.json")
                for pkg in ("jax", "port")}
    assert exported["port"] == exported["jax"]
    # the round trip: export -> import into another app -> export
    both(run, "import", "--appid", "2", "--input", "{root}/out.json")
    for pkg in ("jax", "port"):
        run(pkg, "export", "--appid", "2", "--output", "{root}/again.json")
    again = {pkg: scrubbed_export(run.roots[pkg] / "again.json")
             for pkg in ("jax", "port")}
    assert again["port"] == again["jax"]
    # the epoch rows move by the same millisecond in both packages
    early = [json.loads(x) for x in again["port"] if "early" in x]
    first = {json.loads(x)["eventId"]: json.loads(x)["eventTime"]
             for x in exported["port"] if "early" in x}
    moved = [e for e in early if e["eventTime"] != first[e["eventId"]]]
    assert len(early) == 17 and 0 < len(moved) < 17
    both(run, "trim", "--src-appid", "1", "--dst-appid", "3", "--start",
         "2026-05-01T00:00:10Z", "--until", "2026-05-01T00:00:20Z")
    assert both(run, "trim", "--src-appid", "1", "--dst-appid", "3")[0] == 1
    assert both(run, "trim", "--src-appid", "1", "--dst-appid", "99")[0] \
        == 1
    for pkg in ("jax", "port"):
        run(pkg, "export", "--appid", "3", "--output", "{root}/win.json")
    win = {pkg: scrubbed_export(run.roots[pkg] / "win.json")
           for pkg in ("jax", "port")}
    assert win["port"] == win["jax"] and len(win["port"]) == 10
    # a user's import subprocess lands what the in-process one did
    out = port_subprocess(run.roots["port"], "import", "--appid", "3",
                          "--input", str(src))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"Imported {len(event_lines())} events."


def test_movielens_import_matches_the_reference(stores, tmp_path):
    run = stores
    udata = tmp_path / "u.data"
    udata.write_text("".join(
        f"{1 + k % 9}\t{1 + (7 * k) % 13}\t{1 + k % 5}\t{881250949 + k}\n"
        for k in range(40)))
    both(run, "app", "new", "ml")
    rc, text = both(run, "import", "--appid", "1", "--input", str(udata),
                    "--format", "movielens")
    assert rc == 0 and text.strip() == "Imported 40 events."
    for pkg in ("jax", "port"):
        run(pkg, "export", "--appid", "1", "--output", "{root}/ml.json")
    got = {pkg: scrubbed_export(run.roots[pkg] / "ml.json")
           for pkg in ("jax", "port")}
    assert got["port"] == got["jax"] and len(got["port"]) == 40


def test_parquet_pair_matches_the_reference(stores, tmp_path):
    pytest.importorskip("pyarrow")
    run = stores
    src = tmp_path / "events.json"
    src.write_text("".join(json.dumps(d) + "\n" for d in event_lines(12)))
    both(run, "app", "new", "pq")
    both(run, "app", "new", "back")
    both(run, "import", "--appid", "1", "--input", str(src))
    rc, text = both(run, "export", "--appid", "1", "--output",
                    "{root}/ev.parquet", "--format", "parquet")
    assert rc == 0
    both(run, "import", "--appid", "2", "--input", "{root}/ev.parquet",
         "--format", "parquet")
    for pkg in ("jax", "port"):
        run(pkg, "export", "--appid", "2", "--output", "{root}/back.json")
    got = {pkg: scrubbed_export(run.roots[pkg] / "back.json")
           for pkg in ("jax", "port")}
    assert got["port"] == got["jax"] and len(got["port"]) == 34


def test_parquet_without_pyarrow_names_it(stores, monkeypatch):
    from predictionio_tpu_torch.tools import export_import as EI
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError, match="pyarrow"):
        EI.export_events_parquet(1, "unused.parquet")


def test_status_checks_storage_and_needs_a_card(stores):
    import torch
    run = stores
    _, jtext = run("jax", "status")
    out = port_subprocess(run.roots["port"], "status")
    lines = out.stdout.splitlines()
    assert lines[:4] == jtext.splitlines()[:4]
    assert lines[4] == "Inspecting CUDA devices..."
    if torch.cuda.is_available():
        assert out.returncode == 0 and "cuda:0" in lines[5]
    else:
        assert out.returncode == 1 and "no CUDA device" in lines[5]
