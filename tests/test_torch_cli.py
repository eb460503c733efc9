"""The port's command line, `python -m predictionio_tpu_torch`, driven as
a user drives it: subprocesses on a tiny seeded store, on the CPU (the
engine.json names `"device": "cpu"`).

`train` prints the reference's message and records a COMPLETED instance
whose factor tables equal, bit for bit, those of `create_workflow_main`
run in this process on the same variant; without a device it raises
RuntimeError (no card here). `deploy` serves the latest instance and
answers a query exactly as an in-process server does (`--port 0`: the
port it bound is read from the line it prints); `undeploy` stops it and
the process exits 0; a deploy onto a port a stale server holds stops
that server first. `--stop-after-read/-prepare` stop the train
there and leave the instance ABORTED. `version` prints the port's
version, and `--help` names the port's commands and those still only in
the JAX package; a deployed server answers a repeated query from its
result cache.
"""

import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import predictionio_tpu_torch
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main)

REPO = pathlib.Path(__file__).resolve().parent.parent
APP = "cliapp"
QUERY = {"user": "u3", "num": 4, "categories": ["c1"]}


def run(*args, timeout=120):
    return subprocess.run([sys.executable, "-m", "predictionio_tpu_torch",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


LIVE = re.compile(r"Engine API is live at http://127\.0\.0\.1:(\d+)\.")


def deploy(variant, port: int, log: pathlib.Path) -> subprocess.Popen:
    """`deploy` in a subprocess, its output into `log`."""
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch", "deploy", "-v",
             str(variant), "--ip", "127.0.0.1", "--port", str(port)],
            cwd=REPO, stdout=f, stderr=subprocess.STDOUT, text=True)


def bound_port(proc, log: pathlib.Path, timeout_s=60.0) -> int:
    """The port a deploy printed once it had bound."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        m = LIVE.search(log.read_text())
        if m:
            return int(m.group(1))
        if proc.poll() is not None:
            raise AssertionError(f"deploy exited {proc.returncode}: "
                                 f"{log.read_text()}")
        time.sleep(0.2)
    raise AssertionError(f"deploy printed no address: {log.read_text()}")


def wait_alive(port: int, proc=None, log=None, timeout_s=60.0) -> dict:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"deploy exited {proc.returncode}: "
                                 f"{log.read_text()}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                        timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"nothing answered on port {port}")


def query(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A seeded store, an engine.json on the CPU, and an instance trained
    by `python -m predictionio_tpu_torch train`."""
    root = tmp_path_factory.mktemp("cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_FS_BASEDIR", str(root / "pio"))
        for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
            mp.delenv(k)
        TReg.clear_cache()
        app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
        rng = np.random.default_rng(5)
        n = 500
        ev = TReg.Storage.get_events()
        ev.insert_columnar(ColumnarBatch(
            n, "rate", "user", [f"u{x}" for x in rng.integers(0, 25, n)],
            "item", [f"i{x}" for x in rng.integers(0, 20, n)],
            [{"rating": float(x)} for x in rng.integers(1, 6, n)],
            ["1970-01-01T00:00:%02d.%03dZ" % divmod(k, 1000)
             for k in range(n)]), app_id)
        ev.insert_columnar(ColumnarBatch(
            20, "$set", "item", [f"i{k}" for k in range(20)],
            properties=[{"categories": [f"c{k % 3}"]} for k in range(20)],
            event_time="1970-01-01T01:00:00.000Z"), app_id)
        algo = dict(rank=5, num_iterations=3, lam=0.1, seed=2)
        paths = {}
        for name, extra in (("cpu", {"device": "cpu"}), ("card", {})):
            paths[name] = root / f"engine_{name}.json"
            paths[name].write_text(json.dumps({
                "id": "default", "engineFactory": "recommendation",
                "datasource": {"params": {"app_name": APP,
                                          "read_items": True}},
                "algorithms": [{"name": "als",
                                "params": dict(algo, **extra)}]}))
        out = run("train", "-v", str(paths["cpu"]))
        yield dict(root=root, paths=paths, train=out)
        TReg.clear_cache()


def tables(iid):
    blob = TReg.Storage.get_model_data_models().get(iid).models
    (m,) = TR.RecommendationEngineFactory.apply().deserialize_models(blob,
                                                                     iid)
    return m.als.user_factors, m.als.item_factors


def test_train_prints_the_message_and_matches_the_workflow(store):
    out = store["train"]
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("Training completed. Engine instance ID: ")
    iid = line.rsplit(" ", 1)[1]
    inst = TReg.Storage.get_meta_data_engine_instances().get(iid)
    assert inst.status == "COMPLETED"
    assert inst.engine_variant == str(store["paths"]["cpu"])
    again = create_workflow_main(WorkflowConfig(
        engine_variant=str(store["paths"]["cpu"])))
    for a, b in zip(tables(iid), tables(again)):
        np.testing.assert_array_equal(a, b)


def test_train_without_a_device_needs_the_card(store):
    out = run("train", "-v", str(store["paths"]["card"]))
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr
    assert "CUDA is not available" in out.stderr


def test_deploy_serves_like_in_process_and_undeploy_stops_it(store,
                                                            tmp_path):
    log = tmp_path / "deploy.log"
    proc = deploy(store["paths"]["cpu"], 0, log)
    try:
        port = bound_port(proc, log)
        status = wait_alive(port, proc, log)
        local = EngineServer(ServerConfig(
            port=0, engine_variant=str(store["paths"]["cpu"]))).load()
        try:
            assert status["engineInstanceId"] == local.engine_instance.id
            assert query(port, QUERY) == local.answer(QUERY)
            # a stock deploy answers the repeat from its result cache
            assert query(port, QUERY) == local.answer(QUERY)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/stats.json", timeout=30) as r:
                cache = json.loads(r.read())["resultCache"]
            assert (cache["hits"], cache["misses"], cache["entries"]) == \
                (1, 1, 1)
        finally:
            local.stop()
        out = run("undeploy", "--ip", "127.0.0.1", "--port", str(port))
        assert out.returncode == 0
        assert out.stdout.strip() == \
            f"Undeployed engine server at 127.0.0.1:{port}."
        rc = proc.wait(timeout=30)
        assert rc == 0, f"deploy exited {rc}: {log.read_text()}"
        assert "Engine is deployed and running. Engine API is live at " \
            f"http://127.0.0.1:{port}." in log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_deploy_stops_a_stale_server_first(store, tmp_path):
    stale = EngineServer(ServerConfig(
        port=0, engine_variant=str(store["paths"]["cpu"])))
    stale.load().start()
    port = stale.config.port
    log = tmp_path / "deploy.log"
    proc = deploy(store["paths"]["cpu"], port, log)
    try:
        deadline = time.time() + 60
        while stale._httpd is not None and time.time() < deadline:
            time.sleep(0.1)
        assert stale._httpd is None, "the stale server was not stopped"
        wait_alive(port, proc, log)
        assert query(port, QUERY)["itemScores"]
        assert cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                         str(port)]) == 0
        assert proc.wait(timeout=30) == 0
        assert f"Undeployed a stale engine server on port {port}." in \
            log.read_text()
    finally:
        stale.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("stage", ["read", "prepare"])
def test_train_stops_after_a_stage_and_aborts_the_instance(store, stage,
                                                           capsys):
    instances = TReg.Storage.get_meta_data_engine_instances()
    before = {i.id for i in instances.get_all()}
    assert cli.main(["train", "-v", str(store["paths"]["cpu"]),
                     f"--stop-after-{stage}", "--batch", "b1"]) == 0
    assert capsys.readouterr().out.strip() == \
        f"Training interrupted by StopAfter{stage.title()}Interruption."
    (new,) = [i for i in instances.get_all() if i.id not in before]
    assert new.status == "ABORTED" and new.batch == "b1"


def test_undeploy_with_nothing_deployed_fails(capsys):
    with socket.socket() as held:      # bound, not listening: refused
        held.bind(("127.0.0.1", 0))
        port = held.getsockname()[1]
        assert cli.main(["undeploy", "--port", str(port)]) == 1
    assert capsys.readouterr().out.startswith("Undeploy failed: ")


def test_version_prints_the_ports_version():
    out = run("version")
    assert out.returncode == 0
    assert out.stdout.strip() == predictionio_tpu_torch.__version__


def test_help_names_the_commands_still_in_the_jax_package(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    for word in ("train", "deploy", "undeploy", "app", "accesskey",
                 "import", "eventserver", "build", "template"):
        assert word in text
    assert "Still only in the JAX package's bin/pio" in text
    assert "version, status, train, eval, deploy, undeploy, update, " \
        "rollback, eventserver, app, accesskey, export, import, trim, " \
        "cache, incidents, profile, fleet, faults, spill, template. Still " \
        "only in the JAX package's " \
        "bin/pio: build" in text
