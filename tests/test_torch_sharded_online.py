"""The sharded online plane of the port against the JAX package's:
`ShardedTable` (the same operations on the same tables give the same
slices, offsets and errors), the layout-keyed upload cache and residency
slots, the model-sharded fold tick, the sharded serve routes, the gates
over sharded candidates, a hot swap of sharded versions under load, and
the warm-up's sharded dims.

Tolerances: a sharded fold tick of the port equals its replicated tick
bit for bit (the same solves on the same gathered tables), and the JAX
package's sharded tick within 1e-4 of the largest factor at lam = 0.1
(`tests/test_torch_fold_in.py`; both run CG, the JAX side's jnp CG on a
multi-device mesh). Served ids are equal and scores within 1e-5.
"""

import dataclasses
import json
import pickle
import threading
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.online import fold_in as JF
from predictionio_tpu.ops import als as JA
from predictionio_tpu.ops.ratings import RatingsCOO as JCOO
from predictionio_tpu.parallel import sharded_table as JS
from predictionio_tpu_torch.obs import torchmon
from predictionio_tpu_torch.online import fold_in as TF
from predictionio_tpu_torch.ops import als as TA
from predictionio_tpu_torch.ops.ratings import RatingsCOO as TCOO
from predictionio_tpu_torch.parallel import sharded_table as TS
from predictionio_tpu_torch.parallel.mesh import model_mesh
from predictionio_tpu_torch.utils import device_cache

N_SHARDS = 4
FACTOR_TOL = 1e-4
SCORE_TOL = 1e-5
CPU = torch.device("cpu")


def _coo(n_users=96, n_items=180, seed=3, nnz=1500):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, nnz).astype(np.int32),
            rng.integers(0, n_items, nnz).astype(np.int32),
            rng.uniform(1, 5, nnz).astype(np.float32), n_users, n_items)


def _tables(n_users=96, n_items=180, rank=8, seed=3):
    """Trained tables (by the port on the CPU) both packages start from."""
    args = _coo(n_users, n_items, seed)
    m = TA.als_train(TCOO(*args), TA.ALSConfig(rank=rank, iterations=3,
                                               seed=seed), device="cpu")
    return m.user_factors, m.item_factors, args


def _sharded(mod, U, V, rank=8, n=N_SHARDS):
    tables = (mod.ShardedTable.from_host(U, n),
              mod.ShardedTable.from_host(V, n))
    if mod is TS:
        return TA.ALSModel(*tables, rank, CPU)
    return JA.ALSModel(*tables, rank)


def _same_slices(got, ref):
    assert (got.offsets, got.n_rows, got.padded_rows, got.n_shards) == (
        ref.offsets, ref.n_rows, ref.padded_rows, ref.n_shards)
    assert len(got.shards) == len(ref.shards)
    for a, b in zip(got.shards, ref.shards):
        np.testing.assert_array_equal(a, b)


class TestShardedTable:
    @pytest.mark.parametrize("n_rows,padded", [(120, None), (40, 48),
                                               (256, None), (1, None)])
    def test_from_host_rows_and_to_numpy(self, n_rows, padded):
        arr = np.arange(n_rows * 4, dtype=np.float32).reshape(n_rows, 4)
        t = TS.ShardedTable.from_host(arr, N_SHARDS, padded_rows=padded)
        r = JS.ShardedTable.from_host(arr, N_SHARDS, padded_rows=padded)
        _same_slices(t, r)
        assert t.shape == r.shape == (n_rows, 4)
        assert (t.nbytes, t.per_shard_nbytes) == (r.nbytes,
                                                  r.per_shard_nbytes)
        idx = [0, n_rows - 1, n_rows // 2]
        np.testing.assert_array_equal(t.rows(idx), r.rows(idx))
        np.testing.assert_array_equal(t.to_numpy(), arr)

    def test_with_rows_copies_only_touched_shards(self):
        arr = np.zeros((256, 4), dtype=np.float32)
        t = TS.ShardedTable.from_host(arr, N_SHARDS)
        r = JS.ShardedTable.from_host(arr, N_SHARDS)
        vals = np.ones((2, 4), np.float32)
        t2, r2 = t.with_rows([3, 200], vals), r.with_rows([3, 200], vals)
        _same_slices(t2, r2)
        assert t2.shards[1] is t.shards[1]
        assert t2.shards[0] is not t.shards[0]
        np.testing.assert_array_equal(t.rows([3])[0], np.zeros(4))

    def test_grown_repartitions(self):
        arr = np.arange(100 * 2, dtype=np.float32).reshape(100, 2)
        t = TS.ShardedTable.from_host(arr, N_SHARDS)
        r = JS.ShardedTable.from_host(arr, N_SHARDS)
        _same_slices(t.grown(130, t.padded_rows * 2),
                     r.grown(130, r.padded_rows * 2))

    def test_pickle_drops_the_device_handle(self):
        t = TS.ShardedTable.from_host(np.ones((64, 4), np.float32),
                                      N_SHARDS)
        t.device(model_mesh(N_SHARDS, "cpu"))
        assert t._dev is not None and t.device_nbytes() > 0
        t2 = pickle.loads(pickle.dumps(t))
        assert t2._dev is None
        np.testing.assert_array_equal(t2.to_numpy(), t.to_numpy())

    def test_finite_and_norm_see_logical_rows_only(self):
        arr = np.full((10, 2), 2.0, dtype=np.float32)
        for mod in (TS, JS):
            t = mod.ShardedTable.from_host(arr, 2, padded_rows=16)
            assert t.all_finite()
            assert t.max_row_norm() == pytest.approx(np.sqrt(8.0))
            bad = t.with_rows([4], np.array([[np.nan, 1.0]], np.float32))
            assert not bad.all_finite()

    def test_partial_coverage_guards(self):
        for mod in (TS, JS):
            partial = mod.ShardedTable(
                [np.full((64, 2), 7.0, dtype=np.float32)], offsets=[64],
                n_rows=250, padded_rows=256, n_shards=4)
            np.testing.assert_array_equal(partial.rows([64, 127])[0],
                                          np.full(2, 7.0))
            for bad in ([10], [200]):
                with pytest.raises(IndexError):
                    partial.rows(bad)
            with pytest.raises(IndexError):
                partial.with_rows([10], np.zeros((1, 2), np.float32))
            with pytest.raises(ValueError):
                partial.to_numpy()
            with pytest.raises(ValueError):
                partial.grown(300, 512)

    def test_device_at_a_larger_bucket_zero_fills(self):
        arr = np.ones((40, 4), dtype=np.float32)
        t = TS.ShardedTable.from_host(arr, N_SHARDS, padded_rows=48)
        mesh = model_mesh(N_SHARDS, "cpu")
        dev = t.device(mesh, target_rows=64)
        assert dev.shape == (64, 4) and t.padded_rows == 48
        host = torch.cat(dev.tensors).numpy()
        np.testing.assert_array_equal(host[:40], arr)
        np.testing.assert_array_equal(host[48:], np.zeros((16, 4)))
        assert t.device(mesh, target_rows=64) is dev
        assert t.drop_device() == 16 * 4 * 4 * N_SHARDS
        assert t.device_nbytes() == 0

    def test_layout_and_meta_helpers(self):
        arr = np.ones((8, 2), dtype=np.float32)
        t = TS.ShardedTable.from_host(arr, 2)
        r = JS.ShardedTable.from_host(arr, 2)
        assert TS.layout_of(t) == JS.layout_of(r) == "model:2"
        assert TS.layout_of(arr) == JS.layout_of(arr) == "replicated"
        assert TS.sharding_meta([TA.ALSModel(t, t, 2, CPU)]) == \
            JS.sharding_meta([JA.ALSModel(r, r, 2)])
        assert TS.sharding_meta([TA.ALSModel(arr, arr, 2, CPU)]) is None
        np.testing.assert_array_equal(TS.table_rows(t, [1]),
                                      JS.table_rows(r, [1]))


class TestShardingKeyedCache:
    def test_whole_and_split_uploads_never_alias(self):
        mesh = model_mesh(N_SHARDS, "cpu")
        arr = np.random.default_rng(1).standard_normal(
            (64, 4)).astype(np.float32)
        plain = device_cache.cached_put_rows(arr, 64, "cpu")
        split = device_cache.cached_put_rows(
            arr, 64, sharding=mesh.model_sharded(2))
        assert plain is not split and len(split.tensors) == N_SHARDS
        assert device_cache.cached_put_rows(arr, 64, "cpu") is plain
        assert device_cache.cached_put_rows(
            arr, 64, sharding=mesh.model_sharded(2)) is split

    def test_equal_layouts_share_one_entry(self):
        mesh = model_mesh(N_SHARDS, "cpu")
        arr = np.ones((64, 4), dtype=np.float32)
        a = device_cache.cached_put_rows(arr, 64,
                                         sharding=mesh.model_sharded(2))
        b = device_cache.cached_put_rows(arr, 64,
                                         sharding=mesh.model_sharded(2))
        assert a is b
        assert device_cache._sharding_key(mesh.model_sharded(2)) == \
            device_cache._sharding_key(mesh.model_sharded(2))
        assert device_cache._row_shards(mesh.model_sharded(2)) == N_SHARDS
        assert device_cache._row_shards(None) == 1

    def test_residency_is_keyed_by_the_layout_token(self):
        key_arr = np.ones((4, 2), dtype=np.float32)
        device_cache.put_resident("shard_test", (key_arr,), {"x": 1},
                                  sharding="replicated")
        assert device_cache.get_resident(
            "shard_test", (key_arr,), sharding="replicated") == {"x": 1}
        assert device_cache.get_resident(
            "shard_test", (key_arr,), sharding="model:4") is None
        device_cache.put_resident("shard_test", (key_arr,), {"x": 2},
                                  sharding="model:4")
        assert device_cache.get_resident(
            "shard_test", (key_arr,), sharding="model:4") == {"x": 2}
        device_cache.drop_resident("shard_test")

    def test_the_budget_refuses_whole_and_admits_split(self, monkeypatch):
        from predictionio_tpu.utils import device_cache as JC
        arr = np.zeros((1024, 8), dtype=np.float32)      # 32 KiB
        monkeypatch.setenv("PIO_TABLE_BUDGET_BYTES", "16384")
        with pytest.raises(JC.TableBudgetExceeded):
            JC.cached_put_rows(arr, 1024)
        with pytest.raises(device_cache.TableBudgetExceeded):
            device_cache.cached_put_rows(arr, 1024, "cpu")
        t = TS.ShardedTable.from_host(arr, N_SHARDS)
        assert t.per_shard_nbytes == \
            JS.ShardedTable.from_host(arr, N_SHARDS).per_shard_nbytes
        t.device(model_mesh(N_SHARDS, "cpu"))

    def test_a_sharded_slot_reads_one_shard_a_logical_device(self):
        mesh = model_mesh(N_SHARDS, "cpu")
        arr = np.zeros((256, 8), dtype=np.float32)
        dev = TS.ShardedTable.from_host(arr, N_SHARDS).device(mesh)
        key = np.ones(1, dtype=np.float32)
        device_cache.put_resident("hbm_test", (key,), {"T": dev},
                                  sharding="model:4")
        assert device_cache.resident_sizes()["hbm_test"] == \
            arr.nbytes // N_SHARDS
        device_cache.drop_resident("hbm_test")


class TestShardedFold:
    @pytest.mark.parametrize("implicit", [False, True])
    def test_three_ticks_match_the_reference_and_the_replicated_tick(
            self, mesh8, implicit):
        U, V, args = _tables()
        cfg_r = TF.FoldInConfig(sweeps=2, implicit_prefs=implicit,
                                lam=0.1, solver="cg")
        cfg_s = dataclasses.replace(cfg_r, factor_sharding="model")
        jcfg = JF.FoldInConfig(sweeps=2, implicit_prefs=implicit, lam=0.1,
                               factor_sharding="model")
        rng = np.random.default_rng(7)
        cur_r = TA.ALSModel(U, V, 8, CPU)
        cur_s = _sharded(TS, U, V)
        cur_j = _sharded(JS, U, V)
        for tick in range(3):
            tu = rng.integers(0, args[3], 5)
            ti = rng.integers(0, args[4], 8)
            h0 = torchmon.thread_h2d_total()
            cur_r, st_r = TF.fold_in_coo(cur_r, TCOO(*args), tu, ti, cfg_r,
                                         device="cpu",
                                         resident_key=f"rep{implicit}")
            h_rep = torchmon.thread_h2d_total() - h0
            h0 = torchmon.thread_h2d_total()
            cur_s, st_s = TF.fold_in_coo(cur_s, TCOO(*args), tu, ti, cfg_s,
                                         device="cpu",
                                         resident_key=f"shd{implicit}")
            h_shd = torchmon.thread_h2d_total() - h0
            cur_j, st_j = JF.fold_in_coo(cur_j, JCOO(*args), tu, ti, jcfg,
                                         resident_key=f"j{implicit}")
            assert st_s.sharded and not st_r.sharded and st_j.sharded
            assert TS.is_sharded(cur_s.user_factors)
            for got, rep, ref in (
                    (cur_s.user_factors, cur_r.user_factors,
                     cur_j.user_factors),
                    (cur_s.item_factors, cur_r.item_factors,
                     cur_j.item_factors)):
                np.testing.assert_array_equal(got.to_numpy(), rep)
                want = ref.to_numpy()
                assert np.abs(got.to_numpy() - want).max() <= \
                    FACTOR_TOL * np.abs(want).max()
                assert got.padded_rows == ref.padded_rows
            for name in ("n_user_rows", "n_item_rows", "sweeps",
                         "resident_hit"):
                assert getattr(st_s, name) == getattr(st_j, name), name
            if tick:
                assert st_s.resident_hit
                # only the touched-row plans cross: a table upload would
                # add the table's padded bytes on top
                assert h_shd == h_rep

    def test_untouched_shards_keep_their_tensors(self):
        U, V, args = _tables()
        cur = _sharded(TS, U, V)
        cfg = TF.FoldInConfig(sweeps=1, factor_sharding="model")
        cur, _ = TF.fold_in_coo(cur, TCOO(*args), [1], [2], cfg,
                                device="cpu", resident_key="cow")
        before = cur.user_factors._dev
        out, st = TF.fold_in_coo(cur, TCOO(*args), [1], [2], cfg,
                                 device="cpu", resident_key="cow")
        after = out.user_factors._dev
        assert st.resident_hit
        assert after.tensors[1] is before.tensors[1]
        assert after.tensors[0] is not before.tensors[0]
        assert out.user_factors.shards[1] is cur.user_factors.shards[1]

    def test_vocab_growth_inside_the_bucket(self, mesh8):
        U, V, args = _tables(n_users=90, n_items=170)
        ui, ii, vv, n_u, n_i = args
        grown = (np.concatenate([ui, [90, 91, 0, 1]]).astype(np.int32),
                 np.concatenate([ii, [0, 1, 170, 171]]).astype(np.int32),
                 np.concatenate([vv, [3.0, 4.0, 5.0, 2.0]]
                                ).astype(np.float32), 92, 172)
        out, st = TF.fold_in_coo(_sharded(TS, U, V), TCOO(*grown),
                                 [90, 91, 0, 1], [170, 171, 0, 1],
                                 TF.FoldInConfig(sweeps=1, lam=0.1,
                                                 solver="cg",
                                                 factor_sharding="model"),
                                 device="cpu")
        ref, _ = JF.fold_in_coo(_sharded(JS, U, V), JCOO(*grown),
                                [90, 91, 0, 1], [170, 171, 0, 1],
                                JF.FoldInConfig(sweeps=1, lam=0.1,
                                                factor_sharding="model"))
        assert out.n_users == ref.n_users == 92
        assert out.user_factors.padded_rows == ref.user_factors.padded_rows
        assert np.abs(out.user_factors.rows([90, 91])).sum() > 0
        want = ref.user_factors.to_numpy()
        assert np.abs(out.user_factors.to_numpy() - want).max() <= \
            FACTOR_TOL * np.abs(want).max()

    def test_bucket_promotion_repartitions(self, mesh8):
        U, V, args = _tables(n_users=60, n_items=120)
        ui, ii, vv, n_u, n_i = args
        old = TS.ShardedTable.from_host(U, N_SHARDS).padded_rows
        n_new = old + 8
        grown = (np.concatenate([ui, np.arange(60, n_new)]).astype(np.int32),
                 np.concatenate([ii, np.zeros(n_new - 60, np.int32)]),
                 np.concatenate([vv, np.full(n_new - 60, 3.0, np.float32)]),
                 n_new, n_i)
        out, _ = TF.fold_in_coo(_sharded(TS, U, V), TCOO(*grown),
                                list(range(60, n_new)), [0],
                                TF.FoldInConfig(factor_sharding="model"),
                                device="cpu")
        ref, _ = JF.fold_in_coo(_sharded(JS, U, V), JCOO(*grown),
                                list(range(60, n_new)), [0],
                                JF.FoldInConfig(factor_sharding="model"))
        assert out.user_factors.padded_rows == \
            ref.user_factors.padded_rows > old
        assert out.user_factors.padded_rows % N_SHARDS == 0
        assert out.n_users == n_new
        assert len(out.user_factors._dev.tensors) == N_SHARDS

    def test_mixed_layouts_are_refused(self):
        U, V, args = _tables()
        mixed = TA.ALSModel(TS.ShardedTable.from_host(U, 2), V, 8, CPU)
        with pytest.raises(ValueError, match="layout"):
            TF.fold_in_coo(mixed, TCOO(*args), [1], [1],
                           TF.FoldInConfig(), device="cpu")


class TestShardedServeParity:
    def test_users_topk_matches_the_reference(self, mesh8):
        U, V, _ = _tables(seed=11)
        ixs = [0, 17, 33, 95]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PIO_SERVE_PACK", "exact")
            gs, gi = TA.users_topk_serve(_sharded(TS, U, V), ixs, 12)
            rs, ri = JA.users_topk_serve(_sharded(JS, U, V), ixs, 12)
            ps, pi = TA.users_topk_serve(TA.ALSModel(U, V, 8, CPU), ixs, 12)
        for row in range(len(ixs)):
            fg, fr = np.isfinite(gs[row]), np.isfinite(rs[row])
            np.testing.assert_array_equal(gi[row][fg][:12],
                                          ri[row][fr][:12])
            np.testing.assert_array_equal(gi[row][fg][:12],
                                          pi[row][np.isfinite(ps[row])][:12])
            np.testing.assert_allclose(gs[row][fg][:12], rs[row][fr][:12],
                                       rtol=SCORE_TOL, atol=SCORE_TOL)

    def test_masked_topk_matches_the_reference(self, mesh8):
        from predictionio_tpu.ops.similarity import \
            masked_top_k_batch as jmasked
        from predictionio_tpu_torch.ops.similarity import masked_top_k_batch
        U, V, _ = _tables(seed=13)
        rng = np.random.default_rng(5)
        q = U[[2, 9, 40]]
        masks = rng.random((3, V.shape[0])) > 0.3
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PIO_SERVE_PACK", "exact")
            gs, gi = masked_top_k_batch(TS.ShardedTable.from_host(V, 4), q,
                                        masks, 8, filter_positive=False,
                                        device="cpu")
            rs, ri = jmasked(JS.ShardedTable.from_host(V, 4), q, masks, 8,
                             filter_positive=False)
        for row in range(3):
            fg, fr = np.isfinite(gs[row]), np.isfinite(rs[row])
            np.testing.assert_array_equal(gi[row][fg][:8], ri[row][fr][:8])
            np.testing.assert_allclose(gs[row][fg][:8], rs[row][fr][:8],
                                       rtol=SCORE_TOL, atol=SCORE_TOL)

    def test_predict_ratings_reads_the_host_shards(self):
        U, V, args = _tables(seed=5)
        sh = _sharded(TS, U, V)
        rep = TA.ALSModel(U, V, 8, CPU)
        np.testing.assert_allclose(
            TA.predict_ratings(sh, args[0], args[1]),
            TA.predict_ratings(rep, args[0], args[1]), rtol=1e-5,
            atol=1e-5)


def _rec_models(seed=29):
    from predictionio_tpu.data.bimap import EntityIdIxMap as JIx
    from predictionio_tpu.models import recommendation as JR
    from predictionio_tpu_torch.data.bimap import EntityIdIxMap
    from predictionio_tpu_torch.models import recommendation as TR
    U, V, _ = _tables(seed=seed)
    users = np.array([f"u{i}" for i in range(U.shape[0])])
    items = np.array([f"i{i}" for i in range(V.shape[0])])
    t_ix = (EntityIdIxMap.build_with_indices(users)[0],
            EntityIdIxMap.build_with_indices(items)[0])
    j_ix = (JIx.build_with_indices(users)[0],
            JIx.build_with_indices(items)[0])

    def port(als):
        return TR.RecommendationModel(als, *t_ix)

    def ref(als):
        return JR.RecommendationModel(als, *j_ix)
    return (U, V, port, ref,
            TR.ALSAlgorithm(TR.ALSAlgorithmParams(rank=8, device="cpu")),
            JR.ALSAlgorithm(JR.ALSAlgorithmParams(rank=8)))


class TestShardedGates:
    def test_real_verdicts_as_the_reference(self, mesh8):
        from predictionio_tpu.guard.gates import QualityGatekeeper as JG
        from predictionio_tpu_torch.guard.gates import QualityGatekeeper
        U, V, port, ref, talgo, jalgo = _rec_models()
        cand = U.copy()
        cand[0] *= 1.01
        got = QualityGatekeeper().evaluate(
            [port(_sharded(TS, cand, V))], [port(_sharded(TS, U, V))],
            [talgo])
        want = JG().evaluate([ref(_sharded(JS, cand, V))],
                             [ref(_sharded(JS, U, V))], [jalgo])
        verdicts = {g["gate"]: g["verdict"] for g in got["gates"]}
        assert got["passed"] == want["passed"] is True
        assert verdicts == {g["gate"]: g["verdict"] for g in want["gates"]}
        for gate in ("finite", "norm_drift", "score_drift",
                     "golden_queries"):
            assert verdicts[gate] == "pass", got

    def test_nan_in_one_shard_fails_finite(self, mesh8):
        from predictionio_tpu.guard.gates import QualityGatekeeper as JG
        from predictionio_tpu_torch.guard.gates import QualityGatekeeper
        U, V, port, ref, talgo, jalgo = _rec_models()
        bad = V.copy()
        bad[-1] = np.nan
        got = QualityGatekeeper().evaluate(
            [port(_sharded(TS, U, bad))], [port(_sharded(TS, U, V))],
            [talgo])
        want = JG().evaluate([ref(_sharded(JS, U, bad))],
                             [ref(_sharded(JS, U, V))], [jalgo])
        assert not got["passed"] and not want["passed"]
        assert any(g["gate"] == "finite" and g["verdict"] == "fail"
                   for g in got["gates"])


RANK = 4
VERSION_CONSTS = (1.0, 2.0, 3.0)
ALLOWED_SCORES = {RANK * c for c in VERSION_CONSTS}


class TestShardedHotSwap:
    def test_no_torn_reads_across_sharded_swaps(self, tmp_env):
        """Three sharded versions swapped in under three clients: every
        answer comes from one version (its scores one constant), and
        `/stats.json` reports the layout as the reference's server
        does."""
        from predictionio_tpu.serving.server import EngineServer as JServer
        from predictionio_tpu.serving.server import ServerConfig as JConfig
        from predictionio_tpu_torch.data.storage import registry as TReg
        from predictionio_tpu_torch.data.storage.base import App
        from predictionio_tpu_torch.data.storage.registry import Storage
        from predictionio_tpu_torch.data.columnar import ColumnarBatch
        from predictionio_tpu_torch.models import recommendation as TR
        from predictionio_tpu_torch.serving.server import (EngineServer,
                                                           ServerConfig)
        from predictionio_tpu_torch.workflow import run_train
        from predictionio_tpu_torch.core import EngineParams
        TReg.clear_cache()
        app_id = Storage.get_meta_data_apps().insert(App(0, "shardswap"))
        users = [f"u{u}" for u in range(4) for _ in range(6)]
        items = [f"i{i}" for _ in range(4) for i in range(6)]
        ratings = [float(1 + (u + i) % 5) for u in range(4)
                   for i in range(6)]
        Storage.get_events().insert_columnar(ColumnarBatch(
            len(users), "rate", "user", users, "item", items,
            [{"rating": r} for r in ratings]), app_id)
        ep = EngineParams(
            data_source_params=("", TR.DataSourceParams(
                app_name="shardswap")),
            preparator_params=("", TR.PreparatorParams()),
            algorithm_params_list=[("als", TR.ALSAlgorithmParams(
                rank=RANK, num_iterations=2, lam=0.1, seed=1,
                device="cpu"))],
            serving_params=("", None))
        engine = TR.RecommendationEngineFactory.apply()
        run_train(engine, ep, engine_id="shardswap", engine_version="1",
                  engine_variant="v1", engine_factory="recommendation")
        server = EngineServer(ServerConfig(
            ip="127.0.0.1", port=0, engine_id="shardswap",
            engine_version="1", engine_variant="v1", result_cache=False))
        server.load()
        server.start()
        stop = threading.Event()
        try:
            base = server.models[0]
            n_u, n_i = base.als.n_users, base.als.n_items
            versions = [dataclasses.replace(base, als=TA.ALSModel(
                TS.ShardedTable.from_host(
                    np.full((n_u, RANK), c, np.float32), N_SHARDS),
                TS.ShardedTable.from_host(
                    np.ones((n_i, RANK), np.float32), N_SHARDS),
                RANK, CPU)) for c in VERSION_CONSTS]
            port = server.config.port
            failures, n_ok = [], [0]

            def call(body):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/queries.json",
                    data=json.dumps(body).encode(), method="POST")
                with urllib.request.urlopen(req, timeout=15) as resp:
                    return resp.status, json.loads(resp.read())

            def hammer():
                while not stop.is_set():
                    pre = server.swap_count
                    try:
                        st, body = call({"user": "u1", "num": 3})
                    except Exception as e:
                        failures.append(("transport", repr(e)))
                        continue
                    scores = {s["score"] for s in body["itemScores"]}
                    if len(scores) > 1 and (pre > 0
                                            or scores & ALLOWED_SCORES):
                        failures.append(("torn-read", sorted(scores)))
                    n_ok[0] += 1

            threads = [threading.Thread(target=hammer) for _ in range(3)]
            for t in threads:
                t.start()
            for k, m in enumerate(versions):
                server.swap_models([m], version=f"shard-v{k}")
                target = n_ok[0] + 15
                while n_ok[0] < target and not failures:
                    pass
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert not failures, failures[:5]
            assert n_ok[0] > 30
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/stats.json",
                    timeout=15) as resp:
                stats = json.loads(resp.read())
            layout = stats["modelSharding"][0]
            assert layout["layout"] == "model"
            assert layout["shards"] == N_SHARDS
            jserver = JServer(JConfig(port=0, micro_batch=0))
            jserver.models = [dataclasses.replace(
                base, als=JA.ALSModel(
                    JS.ShardedTable.from_host(
                        np.full((n_u, RANK), 1.0, np.float32), N_SHARDS),
                    JS.ShardedTable.from_host(
                        np.ones((n_i, RANK), np.float32), N_SHARDS),
                    RANK))]
            want = jserver._model_sharding()[0]
            assert {k: layout[k] for k in want if k != "resident"} == \
                {k: v for k, v in want.items() if k != "resident"}
        finally:
            stop.set()
            server.stop()
            TReg.clear_cache()


class TestShardedWarmSpecs:
    def test_batch_predict_dims_match_the_reference(self):
        U, V, _ = _tables(seed=31)
        got = TA.batch_predict_dims(_sharded(TS, U, V), 16, 10)
        ref = JA.batch_predict_dims(_sharded(JS, U, V), 16, 10)
        assert got == ref
        assert got["s"] == N_SHARDS and "u" not in got
        rep = TA.batch_predict_dims(TA.ALSModel(U, V, 8, CPU), 16, 10)
        assert "s" not in rep and "u" in rep

    def test_the_warm_captures_the_sharded_executables(self, monkeypatch):
        from predictionio_tpu_torch.compile.aot import (get_aot,
                                                        warm_models)
        from predictionio_tpu_torch.obs import costmon
        monkeypatch.setenv("PIO_AOT_WARM", "on")
        U, V, port, _, talgo, _ = _rec_models(seed=37)
        model = port(_sharded(TS, U, V))
        specs = talgo.aot_warm_specs(model, batch_hint=4)
        assert specs and all(d.get("s") == N_SHARDS for _, d, _ in specs)
        summary = warm_models([talgo], [model], batch_hint=4)
        assert summary["compiled"] == len(specs)
        label, dims, bound = specs[0]
        assert label == costmon.BATCH_PREDICT
        assert get_aot().lookup(label, dims, bound) is not None
