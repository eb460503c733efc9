"""The port's mesh, ingest, collective counters and two-phase top-k
(`parallel/mesh.py`, `parallel/dataset.py`,
`parallel/collective_stats.py`, `ops/topk.py`) against the JAX
package's on the same seeded inputs, the JAX side on its 8 fake CPU
devices (`tests/conftest.py`), the port's on the CPU (one process; the
multi-process cases are `test_torch_distributed.py`).

Tolerances: the sharded top-k returns the same indices as the JAX
version and as a dense numpy ranking, and scores within 1e-5 (float32
dot products of 8 terms summed in another order).
"""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.parallel import collective_stats as JCS
from predictionio_tpu.parallel import dataset as JD
from predictionio_tpu.parallel import mesh as JM
from predictionio_tpu_torch.parallel import collective_stats as TCS
from predictionio_tpu_torch.parallel import dataset as TD
from predictionio_tpu_torch.parallel import mesh as TM

SCORE_TOL = 1e-5


def port_mesh(devices=8, mp=1):
    return TM.make_mesh(devices, model_parallelism=mp, device="cpu")


class TestMesh:
    @pytest.mark.parametrize("mp", [1, 2, 4, 8])
    def test_axes_and_sizes_match_the_reference(self, mesh8, mp):
        import jax
        ref = JM.make_mesh(jax.devices(), model_parallelism=mp)
        got = port_mesh(8, mp)
        assert (got.n_devices, got.data_parallelism,
                got.model_parallelism) == (
            ref.n_devices, ref.data_parallelism, ref.model_parallelism)

    @pytest.mark.parametrize("mp", [3, 5])
    def test_model_parallelism_must_divide(self, mesh8, mp):
        import jax
        with pytest.raises(ValueError):
            JM.make_mesh(jax.devices(), model_parallelism=mp)
        with pytest.raises(ValueError):
            port_mesh(8, mp)

    @pytest.mark.parametrize("n", [1, 7, 13, 16, 33])
    def test_pad_to_multiple(self, mesh8, n):
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        got, gn = port_mesh().pad_to_multiple(x)
        ref, rn = mesh8.pad_to_multiple(x)
        np.testing.assert_array_equal(got, ref)
        assert gn == rn == n

    def test_put_batch_splits_over_the_data_axis(self, mesh8):
        x = np.arange(16, dtype=np.float32).reshape(16, 1)
        arr = port_mesh().put_batch(x)
        ref = mesh8.put_batch(x)
        assert len(arr.tensors) == len(ref.sharding.device_set) == 8
        assert arr.offsets == tuple(range(0, 16, 2))
        np.testing.assert_array_equal(TM.host_fetch(arr), np.asarray(ref))

    def test_put_stacked_splits_dim_one(self, mesh8):
        x = np.arange(2 * 16 * 3, dtype=np.float32).reshape(2, 16, 3)
        arr = port_mesh().put_stacked(x)
        assert arr.dim == 1 and len(arr.tensors) == 8
        np.testing.assert_array_equal(TM.host_fetch(arr),
                                      np.asarray(mesh8.put_stacked(x)))

    def test_use_mesh_context(self, mesh8):
        single = port_mesh(1)
        with TM.use_mesh(single):
            assert TM.current_mesh() is single
            assert TM.model_mesh(1, "cpu") is single
        assert TM.active_mesh() is not single

    def test_model_mesh_is_one_per_shard_count(self):
        a = TM.model_mesh(4, "cpu")
        assert TM.model_mesh(4, "cpu") is a
        assert TM.model_mesh(2, "cpu") is not a
        assert a.model_parallelism == 4 and a.n_processes == 1

    def test_entry_points_need_the_card_unless_asked(self):
        import torch
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError):
            TM.make_mesh(2, model_parallelism=2)

    def test_init_distributed_is_a_no_op_without_a_coordinator(
            self, monkeypatch):
        monkeypatch.delenv("PIO_COORDINATOR", raising=False)
        TM.init_distributed(device="cpu")
        assert TM.world_size() == 1 and TM.process_index() == 0


class TestIngest:
    @pytest.mark.parametrize("n", [10, 16, 3])
    def test_sharded_from_host_pads(self, mesh8, n):
        x = np.arange(n, dtype=np.float32)
        arr, got_n = TD.sharded_from_host(x, port_mesh())
        ref, ref_n = JD.sharded_from_host(x, mesh8)
        assert arr.shape == ref.shape and got_n == ref_n == n
        np.testing.assert_array_equal(TM.host_fetch(arr), np.asarray(ref))

    def test_sharded_from_process_local_single_process(self, mesh8):
        x = np.arange(16, dtype=np.float32).reshape(8, 2)
        arr = TD.sharded_from_process_local(x, 8, port_mesh())
        ref = JD.sharded_from_process_local(x, 8, mesh8)
        np.testing.assert_array_equal(TM.host_fetch(arr), np.asarray(ref))

    def test_events_to_ratings_arrays(self):
        from predictionio_tpu.data import DataMap as JDataMap
        from predictionio_tpu.data import Event as JEvent
        from predictionio_tpu_torch.data.datamap import DataMap
        from predictionio_tpu_torch.data.event import Event
        out = []
        for E, DM in ((Event, DataMap), (JEvent, JDataMap)):
            evs = [E(event="rate", entity_type="user", entity_id=f"u{i}",
                     target_entity_type="item", target_entity_id=f"i{i}",
                     properties=DM({"rating": float(i)}),
                     event_time=dt.datetime(2026, 1, 1, 0, 0, i,
                                            tzinfo=dt.timezone.utc))
                   for i in range(3)]
            mod = TD if E is Event else JD
            out.append(mod.events_to_ratings_arrays(
                evs, rating_of=lambda e: e.properties.get("rating", float)))
        for g, r in zip(*out):
            np.testing.assert_array_equal(g, r)
            assert g.dtype == r.dtype
        assert out[0][0].tolist() == ["u0", "u1", "u2"]
        assert out[0][3][1] - out[0][3][0] == 1000


class TestHostFetch:
    def test_host_fetch_sharded_round_trip(self):
        mesh = TM.model_mesh(4, "cpu")
        V = np.random.default_rng(0).standard_normal(
            (128, 4)).astype(np.float32)
        offsets, slices = TM.host_fetch_sharded(mesh.put_model_sharded(V))
        assert offsets == [0, 32, 64, 96]
        np.testing.assert_array_equal(np.concatenate(slices), V)

    def test_host_fetch_sharded_refuses_later_dims(self):
        mesh = TM.model_mesh(4, "cpu")
        arr = mesh.put(np.ones((8, 64), np.float32),
                       mesh.sharding(None, "model"))
        with pytest.raises(ValueError, match="dim 0"):
            TM.host_fetch_sharded(arr)

    def test_host_fetch_names_its_sibling(self):
        mesh = TM.model_mesh(4, "cpu")
        arr = mesh.put_model_sharded(np.zeros((64, 2), np.float32))
        np.testing.assert_array_equal(TM.host_fetch(arr),
                                      np.zeros((64, 2)))
        partial = TM.DeviceShards(arr.tensors[:1], arr.offsets[:1],
                                  arr.shape, 4)
        with pytest.raises(ValueError, match="host_fetch_sharded"):
            TM.host_fetch(partial)


class TestDeviceCache:
    def test_cached_put_identity(self, mesh8):
        import gc
        from predictionio_tpu.utils import device_cache as JC
        from predictionio_tpu_torch.utils import device_cache as TC
        for mod, put in ((JC, lambda a: JC.cached_put(a)),
                         (TC, lambda a: TC.cached_put(a, "cpu"))):
            mod.clear()
            x = np.arange(8, dtype=np.float32)
            a1, a2 = put(x), put(x)
            assert a1 is a2 and mod.cache_size() == 1
            y = np.arange(8, dtype=np.float32)
            assert put(y) is not a1
            before = mod.cache_size()
            del x, y
            gc.collect()
            assert mod.cache_size() <= before
            mod.clear()
            assert mod.cache_size() == 0


class TestCollectiveStats:
    HLO = """
ENTRY %main {
  %ag = f32[64,8]{1,0} all-gather(%x), replica_groups={{0,1}}
  %ar = (f32[16,8]{1,0}, s32[4]{0}) all-reduce(%y, %z), to_apply=%add
  %cp = bf16[128]{0} collective-permute(%w), source_target_pairs={{0,1}}
}
"""

    @pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
    def test_the_ring_model_matches_the_reference(self, n_devices):
        stats = JCS.collective_stats(self.HLO)
        got = TCS.ici_seconds(stats, n_devices, bytes_per_s=1e9)
        ref = JCS.ici_seconds(stats, n_devices, ici_bytes_per_s=1e9)
        assert got == ref
        assert (got == 0.0) == (n_devices == 1)

    def test_records_count_by_kind_and_since(self):
        base = TCS.snapshot()
        TCS.record("all-gather", 64 * 8 * 4)
        TCS.record("all-gather", 100)
        TCS.record("broadcast", 4096)
        got = TCS.collective_stats(since=base)
        assert got["all-gather"] == {"count": 2, "bytes": 64 * 8 * 4 + 100}
        assert got["broadcast"] == {"count": 1, "bytes": 4096}
        assert got["total"] == {"count": 3,
                                "bytes": 64 * 8 * 4 + 100 + 4096}
        assert set(got) <= set(TCS.KINDS) | {"total"}

    def test_bandwidth_has_no_default(self):
        with pytest.raises(TypeError):
            TCS.ici_seconds({"total": {"count": 0, "bytes": 0}}, 2)


def _jax_sharded(x, mesh, *axes):
    import jax
    return jax.device_put(x, mesh.sharding(*axes))


class TestShardedTopK:
    """`sharded_top_k` and `batched_sharded_top_k` against the JAX
    package's at S = 1, 2 and 4 shards, with and without masks."""

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("shards", [1, 2, 4])
    @pytest.mark.parametrize("k", [5, 20])
    def test_single_query_matches_the_reference(self, mesh8, shards,
                                                masked, k):
        import jax
        from predictionio_tpu.ops.topk import sharded_top_k as jtopk
        from predictionio_tpu_torch.ops.topk import sharded_top_k
        rng = np.random.default_rng(shards * 10 + int(masked))
        V = rng.standard_normal((64, 8)).astype(np.float32)
        q = rng.standard_normal(8).astype(np.float32)
        mask = np.ones(64, dtype=bool)
        dense = V @ q
        if masked:
            mask[np.argsort(-dense)[:3]] = False
        jm = JM.make_mesh(jax.devices(), model_parallelism=shards)
        tm = TM.model_mesh(shards, "cpu")
        rs, ri = jtopk(_jax_sharded(V, jm, "model", None), q, k, jm,
                       allowed_mask_sharded=_jax_sharded(mask, jm, "model"))
        gs, gi = sharded_top_k(tm.put_model_sharded(V), q, k, tm,
                               allowed_mask_sharded=tm.put(
                                   mask, tm.sharding("model")))
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_allclose(gs, rs, rtol=SCORE_TOL, atol=SCORE_TOL)
        allowed = np.flatnonzero(mask)
        want = allowed[np.argsort(-dense[allowed], kind="stable")][:k]
        np.testing.assert_array_equal(gi, want)

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("shards", [1, 2, 4])
    @pytest.mark.parametrize("filter_positive", [False, True])
    def test_batched_matches_the_reference(self, mesh8, shards, masked,
                                           filter_positive):
        import jax
        from predictionio_tpu.ops.topk import batched_sharded_top_k as jb
        from predictionio_tpu_torch.ops.topk import batched_sharded_top_k
        rng = np.random.default_rng(7 + shards)
        n_items, padded = 50, 64
        V = np.zeros((padded, 8), dtype=np.float32)
        V[:n_items] = rng.standard_normal((n_items, 8))
        Q = rng.standard_normal((4, 8)).astype(np.float32)
        masks = (rng.random((4, padded)) > 0.3) if masked else None
        jm = JM.make_mesh(jax.devices(), model_parallelism=shards)
        tm = TM.model_mesh(shards, "cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PIO_SERVE_PACK", "exact")
            rs, ri = jb(_jax_sharded(V, jm, "model", None), Q, n_items, 16,
                        jm, masks=masks, filter_positive=filter_positive)
            gs, gi = batched_sharded_top_k(
                tm.put_model_sharded(V), Q, n_items, 16, tm, masks=masks,
                filter_positive=filter_positive)
        for row in range(4):
            fr, fg = np.isfinite(rs[row]), np.isfinite(gs[row])
            np.testing.assert_array_equal(fg, fr)
            np.testing.assert_array_equal(gi[row][fg], ri[row][fr])
            np.testing.assert_allclose(gs[row][fg], rs[row][fr],
                                       rtol=SCORE_TOL, atol=SCORE_TOL)
            assert (gi[row][fg] < n_items).all()

    @pytest.mark.parametrize("padded,shards,k", [(64, 4, 5), (64, 8, 20),
                                                 (48, 3, 100), (1, 4, 1)])
    def test_k_split_matches_the_reference(self, padded, shards, k):
        from predictionio_tpu.ops.topk import sharded_k_split as jsplit
        from predictionio_tpu_torch.ops.topk import sharded_k_split
        assert sharded_k_split(k, padded, shards) == jsplit(k, padded,
                                                            shards)

    def test_begin_overlaps_and_finish_reads(self):
        from predictionio_tpu_torch.ops.topk import (
            batched_sharded_top_k_begin)
        rng = np.random.default_rng(3)
        V = rng.standard_normal((64, 4)).astype(np.float32)
        Q = rng.standard_normal((2, 4)).astype(np.float32)
        tm = TM.model_mesh(2, "cpu")
        finish = batched_sharded_top_k_begin(tm.put_model_sharded(V), Q, 64,
                                             16, tm)
        s, i = finish()
        np.testing.assert_array_equal(i[:, :5],
                                      np.argsort(-(Q @ V.T), axis=1)[:, :5])
