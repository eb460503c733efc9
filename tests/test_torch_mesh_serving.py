"""The port's `MeshQueryCoordinator` against the JAX package's in one
process: the broadcast wire format (byte for byte), the single-process
pass-through, the health state, and a poisoned coordinator's surfaces
on a running server (503 naming the condition, `/metrics` gauges,
`/stats.json`). The two-process coordinator, its broadcast and its
watchdog are `test_torch_distributed.py`.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.serving import mesh_serving as JMS
from predictionio_tpu_torch.serving import mesh_serving as TMS
from predictionio_tpu_torch.serving.plugins import EngineServerPluginContext
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig

PAYLOADS = ({"user": "u1", "num": 5},
            [{"user": "a"}, {"user": "b", "filters": ["x"] * 50}],
            {"unicode": "événement ☃"})


class TestWireFormat:
    @pytest.mark.parametrize("obj", PAYLOADS)
    def test_encode_is_the_reference_buffer(self, obj):
        got = TMS.MeshQueryCoordinator(max_bytes=4096)._encode(obj)
        ref = JMS.MeshQueryCoordinator(max_bytes=4096)._encode(obj)
        assert got.shape == (4096,) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
        assert TMS.MeshQueryCoordinator._decode(got) == obj
        assert TMS.MeshQueryCoordinator._decode(ref) == \
            JMS.MeshQueryCoordinator._decode(got) == obj

    def test_payload_too_large_names_the_knob(self):
        for mod in (TMS, JMS):
            with pytest.raises(ValueError, match="max_bytes"):
                mod.MeshQueryCoordinator(max_bytes=64)._encode(
                    {"blob": "x" * 200})

    def test_shutdown_sentinel_decodes_to_none(self):
        assert TMS._SHUTDOWN == JMS._SHUTDOWN
        buf = np.zeros(128, np.uint8)
        buf[:4] = np.frombuffer(np.uint32(TMS._SHUTDOWN).tobytes(),
                                np.uint8)
        assert TMS.MeshQueryCoordinator._decode(buf) is None

    def test_a_widened_broadcast_comes_back_as_bytes(self, monkeypatch):
        """A backend that hands the buffer back widened (as the
        reference's CPU gloo returns int32) still decodes."""
        from predictionio_tpu_torch.parallel import mesh
        c = TMS.MeshQueryCoordinator(max_bytes=256)
        monkeypatch.setattr(mesh, "broadcast", lambda t, src=0: t.int())
        out = c._bcast(c._encode({"user": "u9"}))
        assert out.dtype == np.uint8
        assert c._decode(out) == {"user": "u9"}


class TestSingleProcess:
    def test_inactive_and_pass_through(self):
        for mod in (TMS, JMS):
            c = mod.MeshQueryCoordinator()
            assert c.n_processes == 1 and not c.multi_process
            ran = []
            with c.serialized({"q": 1}):
                ran.append(True)
            assert ran == [True]
            c.shutdown()
            assert c._down

    def test_create_if_distributed_is_none_in_one_process(self):
        assert TMS.MeshQueryCoordinator.create_if_distributed() is None
        assert JMS.MeshQueryCoordinator.create_if_distributed() is None

    def test_the_server_guard_is_a_no_op_without_a_coordinator(self):
        s = EngineServer(ServerConfig(port=0, micro_batch=0))
        with s._spmd_guard({"q": 1}):
            pass
        assert s.coordinator is None
        with pytest.raises(RuntimeError, match="multi-process"):
            s.serve_mesh_worker()

    def test_health_matches_the_reference(self):
        t, j = TMS.MeshQueryCoordinator(), JMS.MeshQueryCoordinator()
        assert t.health() == j.health() == {
            "processes": 1, "poisoned": False, "shutdown": False}
        t._poisoned = j._poisoned = True
        assert t.health() == j.health()

    def test_unavailable_answers_503(self):
        assert TMS.MeshServingUnavailable.http_status == \
            JMS.MeshServingUnavailable.http_status == 503


class _PoisonedCoordinator:
    """A coordinator after its watchdog fired: health reports poisoned
    and every `serialized` entry fails at once."""

    multi_process = True
    is_primary = True

    def health(self):
        return {"processes": 2, "poisoned": True, "shutdown": False}

    def serialized(self, payload):
        raise TMS.MeshServingUnavailable(
            "mesh coordinator is poisoned (an earlier broadcast never "
            "completed; worker dead?); redeploy the mesh")

    def shutdown(self):
        pass


class _Serving:
    def supplement(self, q):
        return q

    def serve(self, q, preds):
        return preds[0]


class _Algo:
    query_class = None

    def predict(self, model, q):
        return {"never": "reached"}

    def batch_predict(self, model, qs):
        return [(i, {"never": "reached"}) for i, _ in qs]


def call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(params=[1, 4], ids=["single", "batched"])
def poisoned_server(request):
    s = EngineServer(ServerConfig(ip="127.0.0.1", port=0,
                                  micro_batch=request.param),
                     plugin_context=EngineServerPluginContext(),
                     mesh_coordinator=_PoisonedCoordinator())
    s.algorithms = [_Algo()]
    s.models = [None]
    s.serving = _Serving()
    s.start()
    yield s
    s.stop()


class TestPoisonedMesh:
    def test_a_query_answers_503_naming_the_condition(self, poisoned_server):
        status, body = call(poisoned_server.config.port, "POST",
                            "/queries.json", {"user": "u1"})
        assert status == 503
        msg = json.loads(body)["message"]
        assert "poisoned" in msg and "redeploy" in msg

    def test_metrics_expose_the_gauges(self, poisoned_server):
        status, body = call(poisoned_server.config.port, "GET", "/metrics")
        assert status == 200
        assert "\npio_engine_mesh_poisoned 1\n" in body
        assert "\npio_engine_mesh_processes 2\n" in body

    def test_stats_carry_the_coordinator(self, poisoned_server):
        status, body = call(poisoned_server.config.port, "GET",
                            "/stats.json")
        assert status == 200
        mesh = json.loads(body)["meshCoordinator"]
        assert mesh["poisoned"] is True and mesh["processes"] == 2

    def test_multi_process_servers_run_no_cache_and_no_reload(
            self, poisoned_server):
        assert poisoned_server.result_cache is None
        status, body = call(poisoned_server.config.port, "POST", "/reload",
                            {})
        assert status == 400 and "redeploy" in json.loads(body)["message"]
