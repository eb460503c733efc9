"""Two processes of the port over gloo on the CPU: the process group and
its counted collectives, the data-parallel train (bit-equal to the
single-process train, and within the ALS parity tolerance of the JAX
package's train on its 8 fake devices), the sharded top-k with each
process holding one of two shards (against a dense ranking and the JAX
package's), and `python -m predictionio_tpu_torch train` and `deploy`
across two processes on one store: every answer the float64 host
ranking's, and a killed worker turns the next query into a 503 within
the broadcast timeout, then every query after it, with `/stats.json`
and `/metrics` reading poisoned.

Every child runs under a deadline of its own (`communicate(timeout=)`,
the HTTP clients' timeouts), so a hung collective fails its test and
does not stall the run.
"""

import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 150
FACTOR_TOL = 1e-4
SCORE_TOL = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_env(pid: int, port: int, **extra) -> dict:
    env = dict(os.environ, PIO_COORDINATOR=f"127.0.0.1:{port}",
               PIO_NUM_PROCESSES="2", PIO_PROCESS_ID=str(pid),
               PYTHONPATH=str(REPO), **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def run_two(prog: str, **extra):
    """`prog` in two processes of one group; their outputs, each process
    held to `CHILD_TIMEOUT_S`."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", prog],
                              env=mesh_env(pid, port, **extra), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        assert f"OK proc {i}" in out, out[-3000:]
    return outs


MESH_PROG = textwrap.dedent("""
    import json, numpy as np, torch
    from predictionio_tpu_torch.parallel import collective_stats as CS
    from predictionio_tpu_torch.parallel.dataset import \\
        sharded_from_process_local
    from predictionio_tpu_torch.parallel.mesh import (
        all_gather, all_reduce, init_distributed, make_mesh, process_index,
        world_size)
    init_distributed(device="cpu")
    pid = process_index()
    assert world_size() == 2
    mesh = make_mesh(8, model_parallelism=2, device="cpu")
    assert mesh.owned_parts("model") == range(pid, pid + 1)
    local = np.full((4, 2), pid, dtype=np.float32)
    arr = sharded_from_process_local(local, 8, mesh)
    assert len(arr.tensors) == 2 and not arr.is_fully_addressable
    total = torch.tensor([float(t.sum()) for t in arr.tensors]).sum()
    all_reduce(total)
    assert float(total) == 8.0, total   # 8 zeros from 0, 8 ones from 1
    got = torch.cat(all_gather(torch.tensor([pid, 10 + pid])))
    assert got.tolist() == [0, 10, 1, 11], got
    assert arr.full().shape == (8, 2)
    print(json.dumps(CS.collective_stats()))
    print(f"OK proc {pid}")
""")


def test_two_process_mesh_and_its_collective_counts():
    for out in run_two(MESH_PROG):
        stats = json.loads(out.strip().splitlines()[-2])
        # one all-reduce of one float32, two all-gathers (the int pair
        # and the full() of the split array)
        assert stats["all-reduce"] == {"count": 1, "bytes": 4}
        assert stats["all-gather"]["count"] == 2
        assert stats["all-gather"]["bytes"] == 2 * 2 * 8 + 2 * 4 * 2 * 4
        assert stats["total"]["count"] == 3


def ratings_args():
    rng = np.random.default_rng(11)
    n_u, n_i, nnz = 40, 24, 400
    return (rng.integers(0, n_u, nnz).astype(np.int32),
            rng.integers(0, n_i, nnz).astype(np.int32),
            (1 + 4 * rng.random(nnz)).astype(np.float32), n_u, n_i)


ALS_PROG = textwrap.dedent("""
    import os, numpy as np
    from predictionio_tpu_torch.parallel.mesh import (
        init_distributed, model_mesh, process_index)
    init_distributed(device="cpu")
    pid = process_index()
    from predictionio_tpu_torch.ops.als import ALSConfig, als_train
    from predictionio_tpu_torch.ops.ratings import RatingsCOO
    rng = np.random.default_rng(11)
    n_u, n_i, nnz = 40, 24, 400
    r = RatingsCOO(rng.integers(0, n_u, nnz).astype(np.int32),
                   rng.integers(0, n_i, nnz).astype(np.int32),
                   (1 + 4 * rng.random(nnz)).astype(np.float32), n_u, n_i)
    tel = {}
    m = als_train(r, ALSConfig(rank=6, iterations=3, lam=0.1, seed=4,
                               work_budget=256, factor_sharding="model",
                               keep_sharded=True, solver=os.environ["SOLVER"]),
                  device="cpu", mesh=model_mesh(2, "cpu"), telemetry=tel)
    ref = np.load(os.environ["PIO_TEST_REF_NPZ"])
    U, V = m.user_factors, m.item_factors
    assert len(U._dev.tensors) == 1 and U._dev.offsets == (pid * 32,)
    np.testing.assert_array_equal(U.to_numpy(), ref["u"])
    np.testing.assert_array_equal(V.to_numpy(), ref["v"])
    assert tel["solver_calls"] < ref["calls"], tel["solver_calls"]
    print(f"OK proc {pid}")
""")


@pytest.mark.parametrize("solver", ["cg", "cholesky"])
def test_two_process_train_matches_one_process_and_the_reference(
        tmp_path, mesh8, solver):
    """The data-parallel train over two processes ends with the
    single-process train's tables, bit for bit (each row solved by one
    process, summed exactly), each process solving part of every
    half-sweep; the single-process train is the JAX package's within
    the ALS parity tolerance."""
    from predictionio_tpu.ops.als import ALSConfig as JConfig
    from predictionio_tpu.ops.als import als_train as j_train
    from predictionio_tpu.ops.ratings import RatingsCOO as JCOO
    from predictionio_tpu_torch.ops import als as TA
    from predictionio_tpu_torch.ops.ratings import RatingsCOO as TCOO
    kw = dict(rank=6, iterations=3, lam=0.1, seed=4, work_budget=256)
    tel = {}
    one = TA.als_train(TCOO(*ratings_args()),
                       TA.ALSConfig(solver=solver, **kw), device="cpu",
                       telemetry=tel)
    ref = j_train(JCOO(*ratings_args()), JConfig(**kw), mesh8)
    for a, b in ((ref.user_factors, one.user_factors),
                 (ref.item_factors, one.item_factors)):
        assert np.abs(np.asarray(a) - b).max() <= \
            FACTOR_TOL * np.abs(a).max()
    path = str(tmp_path / "ref.npz")
    np.savez(path, u=one.user_factors, v=one.item_factors,
             calls=tel["solver_calls"])
    run_two(ALS_PROG, PIO_TEST_REF_NPZ=path, SOLVER=solver)


SERVE_PROG = textwrap.dedent("""
    import os, numpy as np, torch
    from predictionio_tpu_torch.parallel.mesh import (
        init_distributed, model_mesh, process_index)
    init_distributed(device="cpu")
    pid = process_index()
    from predictionio_tpu_torch.ops import als as A
    from predictionio_tpu_torch.parallel.sharded_table import ShardedTable
    os.environ["PIO_SERVE_PACK"] = "exact"
    rng = np.random.default_rng(5)
    U = rng.standard_normal((30, 6)).astype(np.float32)
    V = rng.standard_normal((20, 6)).astype(np.float32)
    mesh = model_mesh(2, "cpu")
    model = A.ALSModel(U, V, 6, torch.device("cpu"))
    ref = np.load(os.environ["PIO_TEST_REF_NPZ"])
    for qi, user in enumerate((0, 7, 29)):
        s, i = A.recommend_products_sharded(model, user, 5, mesh=mesh)
        np.testing.assert_array_equal(i, ref[f"i{qi}"])
        np.testing.assert_allclose(s, ref[f"s{qi}"], rtol=1e-5, atol=1e-5)
    # the batched serve path: this process holds one item shard
    full = ShardedTable.from_host(V, 2)
    mine = ShardedTable([full.shards[pid]], [full.offsets[pid]], 20,
                        full.padded_rows, 2)
    sh = A.ALSModel(ShardedTable.from_host(U, 2), mine, 6,
                    torch.device("cpu"))
    s, i = A.users_topk_serve(sh, [0, 7, 29], 5)
    assert len(sh.item_factors._dev.tensors) == 1
    for qi in range(3):
        keep = np.isfinite(s[qi])
        np.testing.assert_array_equal(i[qi][keep][:5], ref[f"i{qi}"])
    print(f"OK proc {pid}")
""")


def test_two_process_sharded_serving_matches_host(tmp_path, mesh8):
    """Each process holds one of two item shards; both answer as a dense
    float64 ranking and as the JAX package's sharded top-k does."""
    from predictionio_tpu.ops.als import ALSModel as JModel
    from predictionio_tpu.ops.als import recommend_products_sharded as jrps
    from predictionio_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(5)
    U = rng.standard_normal((30, 6)).astype(np.float32)
    V = rng.standard_normal((20, 6)).astype(np.float32)
    jm = JModel(U, V, 6)
    ref = {}
    for qi, user in enumerate((0, 7, 29)):
        scores = V.astype(np.float64) @ U[user].astype(np.float64)
        order = np.argsort(-scores, kind="stable")[:5]
        js, ji = jrps(jm, user, 5, mesh=make_mesh(model_parallelism=2))
        np.testing.assert_array_equal(ji, order)
        ref[f"s{qi}"] = scores[order].astype(np.float32)
        ref[f"i{qi}"] = order.astype(np.int32)
    path = str(tmp_path / "serve_ref.npz")
    np.savez(path, **ref)
    run_two(SERVE_PROG, PIO_TEST_REF_NPZ=path)


# -- train and deploy through the CLI ----------------------------------------

APP = "meshapp"
LIVE = re.compile(r"Engine API is live at http://127\.0\.0\.1:(\d+)\.")


@pytest.fixture(scope="module")
def mesh_store(tmp_path_factory):
    """A seeded store, an `als-mesh` engine.json on the CPU (two shards),
    and an instance trained by two `train` processes."""
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.storage import registry as TReg
    from predictionio_tpu_torch.data.storage.base import App
    root = tmp_path_factory.mktemp("mesh")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_FS_BASEDIR", str(root / "pio"))
        for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
            mp.delenv(k)
        TReg.clear_cache()
        app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
        rng = np.random.default_rng(5)
        n = 600
        TReg.Storage.get_events().insert_columnar(ColumnarBatch(
            n, "rate", "user", [f"u{x}" for x in rng.integers(0, 30, n)],
            "item", [f"i{x}" for x in rng.integers(0, 24, n)],
            [{"rating": float(x)} for x in rng.integers(1, 6, n)],
            ["2030-01-01T00:00:%02d.%03dZ" % divmod(k, 1000)
             for k in range(n)]), app_id)
        variant = root / "engine.json"
        variant.write_text(json.dumps({
            "id": "default", "engineFactory": "recommendation",
            "datasource": {"params": {"app_name": APP}},
            "algorithms": [{"name": "als-mesh", "params": {
                "rank": 5, "num_iterations": 3, "lam": 0.1, "seed": 2,
                "factor_sharding": "model", "model_shards": 2,
                "device": "cpu"}}]}))
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch", "train", "-v",
             str(variant)], env=mesh_env(pid, port), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(2)]
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
        yield dict(root=root, variant=variant, procs=procs, outs=outs)
        TReg.clear_cache()


def test_two_process_train_records_one_sharded_instance(mesh_store):
    from predictionio_tpu_torch.core.persistence import \
        PersistentModelManifest
    from predictionio_tpu_torch.data.storage import registry as TReg
    from predictionio_tpu_torch.models import recommendation as TR
    from predictionio_tpu_torch.utils.checkpoint import checkpoint_dir
    for p, out in zip(mesh_store["procs"], mesh_store["outs"]):
        assert p.returncode == 0, out[-3000:]
    assert "Mesh train worker: done." in mesh_store["outs"][1]
    line = mesh_store["outs"][0].strip().splitlines()[-1]
    assert line.startswith("Training completed. Engine instance ID: ")
    iid = line.rsplit(" ", 1)[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_FS_BASEDIR", str(mesh_store["root"] / "pio"))
        TReg.clear_cache()
        instances = TReg.Storage.get_meta_data_engine_instances()
        assert len(instances.get_all()) == 1
        blob = TReg.Storage.get_model_data_models().get(iid).models
        (manifest,) = TR.RecommendationEngineFactory.apply() \
            .deserialize_models(blob, iid)
        assert isinstance(manifest, PersistentModelManifest)
        files = sorted(os.listdir(os.path.join(checkpoint_dir(iid),
                                               "factors")))
        TReg.clear_cache()
    assert files == ["item_factors.shard0.npy", "item_factors.shard1.npy",
                     "manifest.json", "user_factors.shard0.npy",
                     "user_factors.shard1.npy"]


def deploy_two(mesh_store, log_dir: pathlib.Path, *extra):
    port = free_port()
    logs = [log_dir / f"deploy{pid}.log" for pid in range(2)]
    procs = []
    env = {"PIO_FS_BASEDIR": str(mesh_store["root"] / "pio"),
           "PIO_SERVE_PACK": "exact"}
    for pid in range(2):
        with open(logs[pid], "w") as f:
            e = mesh_env(pid, port, **env)
            for k in [k for k in e if k.startswith("PIO_STORAGE_")]:
                e.pop(k)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch", "deploy",
                 "-v", str(mesh_store["variant"]), "--ip", "127.0.0.1",
                 "--port", "0", *extra], env=e, cwd=REPO, stdout=f,
                stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + 90
    while time.time() < deadline:
        m = LIVE.search(logs[0].read_text())
        if m:
            return procs, logs, int(m.group(1))
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        p.kill()
    raise AssertionError("the mesh deploy did not come up:\n" + "\n---\n".join(
        log.read_text()[-2000:] for log in logs))


def http(port, path, body=None, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def host_truth(mesh_store):
    """The instance's tables, restored whole on the host, for the float64
    ranking the answers are held to."""
    from predictionio_tpu_torch.data.storage import registry as TReg
    from predictionio_tpu_torch.utils.checkpoint import (checkpoint_dir,
                                                         restore_sharded)
    iid = mesh_store["outs"][0].strip().splitlines()[-1].rsplit(" ", 1)[1]
    d = checkpoint_dir(iid, base=str(mesh_store["root"] / "pio" /
                                     "sharded_models"))
    tables = restore_sharded(os.path.join(d, "factors"))
    with np.load(os.path.join(d, "vocab.npz")) as z:
        users, items = list(z["users"]), list(z["items"])
    TReg.clear_cache()
    return tables["user_factors"], tables["item_factors"], users, items


def stop_all(procs, port):
    try:
        http(port, "/stop", body={}, timeout=20)
    except OSError:
        pass
    outs = []
    for p in procs:
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        outs.append(p.returncode)
    return outs


def test_two_process_deploy_answers_as_the_host(mesh_store, tmp_path):
    U, V, users, items = host_truth(mesh_store)
    procs, logs, port = deploy_two(mesh_store, tmp_path)
    try:
        for u in range(16):
            user = f"u{u}"
            got = json.loads(http(port, "/queries.json",
                                  {"user": user, "num": 5}))
            scores = V.astype(np.float64) @ U[users.index(user)].astype(
                np.float64)
            order = np.argsort(-scores, kind="stable")[:5]
            assert [s["item"] for s in got["itemScores"]] == \
                [items[j] for j in order]
            np.testing.assert_allclose(
                [s["score"] for s in got["itemScores"]], scores[order],
                rtol=SCORE_TOL, atol=SCORE_TOL)
        stats = json.loads(http(port, "/stats.json"))
        assert stats["meshCoordinator"] == {"processes": 2,
                                            "poisoned": False,
                                            "shutdown": False}
        assert stats["modelSharding"][0]["shards"] == 2
        coll = stats["meshCollectives"]
        assert coll["broadcast"]["count"] >= 16
        assert coll["all-gather"]["count"] >= 2 * 16
    finally:
        codes = stop_all(procs, port)
    assert codes == [0, 0], [log.read_text()[-2000:] for log in logs]
    assert "Mesh serve worker" in logs[1].read_text()


def test_a_killed_worker_poisons_the_mesh_loudly(mesh_store, tmp_path):
    procs, logs, port = deploy_two(mesh_store, tmp_path,
                                   "--mesh-broadcast-timeout", "5")
    try:
        assert json.loads(http(port, "/queries.json",
                               {"user": "u0", "num": 5}))["itemScores"]
        procs[1].kill()
        procs[1].wait()
        t0 = time.time()
        with pytest.raises(urllib.error.HTTPError) as ei:
            http(port, "/queries.json", {"user": "u1", "num": 5})
        assert ei.value.code == 503
        assert time.time() - t0 < 5 + 10
        assert "redeploy" in json.loads(ei.value.read())["message"]
        t0 = time.time()
        with pytest.raises(urllib.error.HTTPError) as ei:
            http(port, "/queries.json", {"user": "u2", "num": 5})
        assert ei.value.code == 503 and time.time() - t0 < 5
        stats = json.loads(http(port, "/stats.json"))
        assert stats["meshCoordinator"]["poisoned"] is True
        assert stats["meshCoordinator"]["processes"] == 2
        metrics = http(port, "/metrics").decode()
        assert "\npio_engine_mesh_poisoned 1\n" in metrics
        assert "\npio_engine_mesh_processes 2\n" in metrics
    finally:
        stop_all(procs, port)
    # the primary stopped through /stop without waiting on its gone peer
    assert "Engine API is live" in logs[0].read_text()
