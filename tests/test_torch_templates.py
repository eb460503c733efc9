"""Port parity: `template list/get` (`tools/templates.py` and the CLI) vs
the JAX package's `bin/pio template`.

Each case runs the same command line through both packages' CLIs, in
this process, against the same `file://` gallery, and holds the exit
codes, the printed lines and the written directories equal (a directory
as its files' relative paths and bytes). The built-in families are the
reference's: the same names and descriptions, and engine.json params
equal apart from the port's own keys (`device` on every algorithm,
`solver` on the recommendation and similar-product ALS). A gallery's
remote content is refused alike: a tar member that escapes the
directory, a link, an index path outside the root, a corrupt archive,
bad JSON, an unregistered scheme; a refused archive writes nothing.
"""

import io
import json
import os
import tarfile

import pytest

from predictionio_tpu.tools import cli as JCLI
from predictionio_tpu.tools import templates as JT
from predictionio_tpu_torch.tools import cli as TCLI
from predictionio_tpu_torch.tools import templates as TT

CLIS = {"jax": JCLI.main, "port": TCLI.main}
#: the port's own params (ROADMAP's "Params" note)
PORT_PARAMS = {"device", "solver"}


def run(pkg, capsys, *args):
    rc = CLIS[pkg](list(args))
    return rc, capsys.readouterr().out


def tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def member(name, data=b"", kind=tarfile.REGTYPE, link=""):
    ti = tarfile.TarInfo(name)
    ti.type = kind
    ti.linkname = link
    ti.size = len(data) if kind == tarfile.REGTYPE else 0
    return ti, (io.BytesIO(data) if kind == tarfile.REGTYPE else None)


def archive(*members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for ti, data in members:
            tf.addfile(ti, data)
    return buf.getvalue()


@pytest.fixture()
def gallery(tmp_path, monkeypatch):
    monkeypatch.delenv("PIO_TEMPLATE_GALLERY", raising=False)
    g = tmp_path / "gallery"
    g.mkdir()
    (g / "custom.tar.gz").write_bytes(archive(
        member("engine.json", b'{"engineFactory": "recommendation"}'),
        member("src", kind=tarfile.DIRTYPE),
        member("src/main.py", b"print('hi')\n")))
    (g / "escape.tar.gz").write_bytes(archive(
        member("ok.txt", b"fine"), member("../evil.txt", b"evil")))
    (g / "link.tar.gz").write_bytes(archive(
        member("engine.json", b"{}"),
        member("link", kind=tarfile.SYMTYPE, link="/etc/passwd")))
    (g / "corrupt.tar.gz").write_bytes(b"not a gzip")
    (g / "index.json").write_text(json.dumps({"templates": [
        {"name": "custom", "description": "custom desc",
         "archive": "custom.tar.gz"},
        {"name": "escape", "archive": "escape.tar.gz"},
        {"name": "link", "archive": "link.tar.gz", "description": None},
        {"name": "corrupt", "archive": "corrupt.tar.gz"},
        {"name": "missing", "archive": "missing.tar.gz"},
        {"name": "recommendation", "description": "shadowed",
         "archive": "custom.tar.gz"}]}))
    return g


def both(capsys, *args):
    return {pkg: run(pkg, capsys, *args) for pkg in CLIS}


def test_builtin_families_match_the_reference():
    assert sorted(TT.TEMPLATES) == sorted(JT.TEMPLATES)
    for name, jt in JT.TEMPLATES.items():
        tt = TT.TEMPLATES[name]
        assert tt["description"] == jt["description"]
        assert tt["query_example"] == jt["query_example"]
        j, t = jt["engine_json"], tt["engine_json"]
        assert {k: v for k, v in t.items() if k != "algorithms"} == \
            {k: v for k, v in j.items() if k != "algorithms"}
        for ja, ta in zip(j["algorithms"], t["algorithms"]):
            assert ta["name"] == ja["name"]
            assert {k: v for k, v in ta["params"].items()
                    if k not in PORT_PARAMS} == ja["params"]
            assert ta["params"]["device"] is None
            assert set(ta["params"]) - set(ja["params"]) <= PORT_PARAMS


@pytest.mark.parametrize("with_gallery", [False, True])
def test_list(gallery, capsys, monkeypatch, with_gallery):
    args = ["template", "list"]
    if with_gallery:
        args += ["--gallery", f"file://{gallery}"]
    r = both(capsys, *args)
    assert r["port"] == r["jax"] and r["port"][0] == 0
    assert ("custom" in r["port"][1]) is with_gallery
    # the environment names the gallery too
    monkeypatch.setenv("PIO_TEMPLATE_GALLERY", f"file://{gallery}")
    r = both(capsys, "template", "list")
    assert r["port"] == r["jax"] and "custom desc" in r["port"][1]


@pytest.mark.parametrize("name", ["custom", "recommendation"])
def test_get_from_the_gallery(gallery, capsys, tmp_path, name):
    out = {}
    for pkg in CLIS:
        d = tmp_path / pkg / "eng"
        rc, said = run(pkg, capsys, "template", "get", name, str(d),
                       "--gallery", f"file://{gallery}")
        out[pkg] = (rc, said.replace(str(d), "DIR"), tree(d))
    assert out["port"] == out["jax"] and out["port"][0] == 0
    assert out["port"][2]["src/main.py"] == b"print('hi')\n"


@pytest.mark.parametrize("name", sorted(JT.TEMPLATES))
def test_get_a_builtin(capsys, tmp_path, monkeypatch, name):
    monkeypatch.delenv("PIO_TEMPLATE_GALLERY", raising=False)
    out = {}
    for pkg in CLIS:
        d = tmp_path / pkg
        rc, said = run(pkg, capsys, "template", "get", name, str(d))
        out[pkg] = (rc, said.replace(str(d), "DIR"),
                    json.loads((d / "engine.json").read_text()),
                    sorted(os.listdir(d)))
    assert out["port"][:2] == out["jax"][:2] and out["port"][0] == 0
    assert out["port"][3] == out["jax"][3] == ["README.md", "engine.json"]
    assert out["port"][2] == TT.TEMPLATES[name]["engine_json"]
    assert "python -m predictionio_tpu_torch train" in (
        tmp_path / "port" / "README.md").read_text()


@pytest.mark.parametrize("name", ["escape", "link", "corrupt", "missing"])
def test_refused_archives_write_nothing(gallery, capsys, tmp_path, name):
    out = {}
    for pkg in CLIS:
        d = tmp_path / pkg / "out"
        rc, said = run(pkg, capsys, "template", "get", name, str(d),
                       "--gallery", f"file://{gallery}")
        out[pkg] = (rc, said.split(":")[0], tree(d) if d.exists() else None)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1 and not out["port"][2]
    assert not (tmp_path / "port" / "evil.txt").exists()


@pytest.mark.parametrize("index", [
    "{not json", {"templates": [{"name": "x"}]},
    {"templates": [{"name": "x", "archive": "../outside.tar.gz"}]},
    {"templates": [{"name": "x", "archive": "/abs.tar.gz"}]}])
def test_bad_indexes_fail_cleanly(tmp_path, capsys, index):
    g = tmp_path / "g"
    g.mkdir()
    (g / "index.json").write_text(index if isinstance(index, str)
                                  else json.dumps(index))
    for args in (("template", "list"),
                 ("template", "get", "x", str(tmp_path / "o"))):
        r = both(capsys, *args, "--gallery", f"file://{g}")
        assert r["port"] == r["jax"] and r["port"][0] == 1
        assert r["port"][1].startswith("Template gallery error: ")


@pytest.mark.parametrize("uri", ["file:///nowhere/at/all", "gs://nope/x"])
def test_missing_index_and_unknown_scheme(capsys, uri):
    r = both(capsys, "template", "list", "--gallery", uri)
    assert r["port"] == r["jax"] and r["port"][0] == 1


def test_unknown_template(capsys, tmp_path, monkeypatch):
    monkeypatch.delenv("PIO_TEMPLATE_GALLERY", raising=False)
    out = {pkg: run(pkg, capsys, "template", "get", "nope",
                    str(tmp_path / pkg)) for pkg in CLIS}
    assert out["port"][0] == out["jax"][0] == 1
    assert out["port"][1] == "Unknown template 'nope'. Try `template list`.\n"
