"""The model-sharded train and serve path of the port against the JAX
package's: `als_train(factor_sharding='model', keep_sharded=True)`,
`recommend_products_sharded`, `MeshALSAlgorithm` and
`ShardedALSModelCheckpoint` (the port: one `.npy` file a shard and a
manifest; a restore re-shards to the reader's shard count), and the
weights carried over from the reference's sharded tables and
checkpoint directory (`weights.from_jax_model`,
`from_jax_sharded_checkpoint`).

Both packages serve the same factor tables here, so the sharded top-k
returns the same items and scores within 1e-5 (float32 dot products
summed in another order). The sharded trains are held as
`tests/test_torch_als.py` holds the replicated ones: 1e-4 of the largest
factor at lam = 0.1 (`scripts/torch_als_rounding.py`), the JAX side's
multi-device train running its jnp CG, the port's CG on the CPU.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as JA
from predictionio_tpu.ops.ratings import RatingsCOO as JCOO
from predictionio_tpu.parallel.mesh import make_mesh as j_make_mesh
from predictionio_tpu_torch.data.bimap import BiMap, EntityIdIxMap
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.ops import als as TA
from predictionio_tpu_torch.ops.ratings import RatingsCOO as TCOO
from predictionio_tpu_torch.parallel.mesh import model_mesh
from predictionio_tpu_torch.parallel.sharded_table import (ShardedTable,
                                                           is_sharded)

SCORE_TOL = 1e-5
FACTOR_TOL = 1e-4
CPU = torch.device("cpu")


def coo_arrays(seed=7, n_u=48, n_i=32, nnz=800):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_u, nnz).astype(np.int32),
            rng.integers(0, n_i, nnz).astype(np.int32),
            (1 + 4 * rng.random(nnz)).astype(np.float32), n_u, n_i)


@pytest.fixture(scope="module")
def trained(mesh8):
    """The JAX package's trained tables, served by both packages."""
    jm = JA.als_train(JCOO(*coo_arrays()),
                      JA.ALSConfig(rank=8, iterations=4, lam=0.1, seed=1,
                                   work_budget=512), mesh8)
    tm = TA.ALSModel(np.asarray(jm.user_factors),
                     np.asarray(jm.item_factors), 8, CPU)
    return jm, tm


class TestShardedServe:
    @pytest.mark.parametrize("shards", [1, 2, 4])
    def test_matches_the_reference_and_the_replicated_path(self, trained,
                                                           shards):
        jm, tm = trained
        jmesh = j_make_mesh(model_parallelism=shards)
        for user in (0, 7, 23):
            rs, ri = JA.recommend_products_sharded(jm, user, 5, mesh=jmesh)
            gs, gi = TA.recommend_products_sharded(
                tm, user, 5, mesh=model_mesh(shards, "cpu"))
            ps, pi = TA.recommend_products(tm, user, 5)
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_array_equal(gi, pi)
            np.testing.assert_allclose(gs, rs, rtol=SCORE_TOL,
                                       atol=SCORE_TOL)

    def test_k_exceeds_shard_rows(self, trained):
        jm, tm = trained
        k = 20
        rs, ri = JA.recommend_products_sharded(
            jm, 5, k, mesh=j_make_mesh(model_parallelism=8))
        gs, gi = TA.recommend_products_sharded(
            tm, 5, k, mesh=model_mesh(8, "cpu"))
        assert len(gi) == len(ri) == k
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_allclose(gs, rs, rtol=SCORE_TOL, atol=SCORE_TOL)

    def test_allowed_mask(self, trained):
        jm, tm = trained
        allowed = np.zeros(tm.n_items, dtype=bool)
        allowed[[1, 5, 9, 13]] = True
        _, ri = JA.recommend_products_sharded(
            jm, 2, 3, mesh=j_make_mesh(model_parallelism=4),
            allowed_mask=allowed)
        _, gi = TA.recommend_products_sharded(
            tm, 2, 3, mesh=model_mesh(4, "cpu"), allowed_mask=allowed)
        assert set(gi) <= {1, 5, 9, 13}
        np.testing.assert_array_equal(gi, ri)

    def test_exclude(self, trained):
        jm, tm = trained
        mesh = model_mesh(4, "cpu")
        _, first = TA.recommend_products_sharded(tm, 3, 5, mesh=mesh)
        excl = first[:2]
        _, gi = TA.recommend_products_sharded(tm, 3, 5, mesh=mesh,
                                              exclude=excl)
        _, ri = JA.recommend_products_sharded(
            jm, 3, 5, mesh=j_make_mesh(model_parallelism=4), exclude=excl)
        assert not set(excl) & set(gi)
        np.testing.assert_array_equal(gi, ri)

    def test_tables_are_split_into_tensors_of_their_own(self, trained):
        _, tm = trained
        t = ShardedTable.from_host(tm.item_factors, 4)
        dev = t.device(model_mesh(4, "cpu"))
        shapes = {tuple(x.shape) for x in dev.tensors}
        assert shapes == {(t.padded_rows // 4, 8)}
        ptrs = {x.untyped_storage().data_ptr() for x in dev.tensors}
        assert len(ptrs) == 4


class TestShardedTrain:
    @pytest.mark.parametrize("shards", [2, 4])
    def test_keep_sharded_train_matches_the_reference(self, mesh8, shards):
        ui, ii, vv, n_u, n_i = coo_arrays(seed=11, n_u=60, n_i=40,
                                          nnz=900)
        kw = dict(rank=8, iterations=3, lam=0.1, seed=4, work_budget=256,
                  factor_sharding="model", keep_sharded=True)
        jm = JA.als_train(JCOO(ui, ii, vv, n_u, n_i), JA.ALSConfig(**kw),
                          j_make_mesh(model_parallelism=shards))
        tm = TA.als_train(TCOO(ui, ii, vv, n_u, n_i),
                          TA.ALSConfig(solver="cg", **kw), device="cpu",
                          mesh=model_mesh(shards, "cpu"))
        for a, b in ((jm.user_factors, tm.user_factors),
                     (jm.item_factors, tm.item_factors)):
            assert is_sharded(b) and b.n_shards == a.n_shards == shards
            ref = a.to_numpy()
            assert b.shape == ref.shape
            assert np.abs(b.to_numpy() - ref).max() <= \
                FACTOR_TOL * np.abs(ref).max()
            assert len(b._dev.tensors) == shards

    def test_sharded_train_is_the_replicated_train(self):
        ui, ii, vv, n_u, n_i = coo_arrays(seed=3)
        r = TCOO(ui, ii, vv, n_u, n_i)
        cfg = TA.ALSConfig(rank=8, iterations=3, seed=3)
        rep = TA.als_train(r, cfg, device="cpu")
        tel = {}
        sh = TA.als_train(r, dataclasses.replace(
            cfg, factor_sharding="model", keep_sharded=True), device="cpu",
            mesh=model_mesh(4, "cpu"), telemetry=tel)
        np.testing.assert_array_equal(sh.user_factors.to_numpy(),
                                      rep.user_factors)
        np.testing.assert_array_equal(sh.item_factors.to_numpy(),
                                      rep.item_factors)
        assert tel["solver_calls"] > 0
        with pytest.raises(TypeError, match="sharded"):
            sh.tables()

    def test_bad_sharding_is_refused(self):
        with pytest.raises(ValueError, match="factor_sharding"):
            TA.ALSConfig(factor_sharding="rows")


def _prepared(n_u=24, n_i=16, nnz=300, seed=1):
    rng = np.random.default_rng(seed)
    args = (rng.integers(0, n_u, nnz).astype(np.int32),
            rng.integers(0, n_i, nnz).astype(np.int32),
            (1 + 4 * rng.random(nnz)).astype(np.float32), n_u, n_i)
    users = {f"u{i}": i for i in range(n_u)}
    items = {f"i{i}": i for i in range(n_i)}
    return args, users, items


class TestMeshAlgorithm:
    def test_trains_sharded_and_answers_as_the_reference(self, mesh8):
        from predictionio_tpu.data.bimap import BiMap as JBiMap
        from predictionio_tpu.data.bimap import EntityIdIxMap as JIx
        from predictionio_tpu.models import recommendation as JR
        from predictionio_tpu.parallel.mesh import use_mesh as j_use_mesh
        args, users, items = _prepared()
        talgo = TR.MeshALSAlgorithm(TR.ALSAlgorithmParams(
            rank=4, num_iterations=3, lam=0.1, seed=0, device="cpu",
            model_shards=2))
        assert talgo.placement == "mesh"
        tmodel = talgo.train(TR.PreparedData(
            TCOO(*args), EntityIdIxMap(BiMap(users)),
            EntityIdIxMap(BiMap(items))))
        assert is_sharded(tmodel.als.user_factors)
        jalgo = JR.MeshALSAlgorithm(JR.ALSAlgorithmParams(
            rank=4, num_iterations=3, lam=0.1, seed=0))
        with j_use_mesh(j_make_mesh(model_parallelism=2)):
            jmodel = jalgo.train(JR.PreparedData(
                JCOO(*args), JIx(JBiMap(users)), JIx(JBiMap(items))))
        ref = np.asarray(jmodel.als.user_factors)
        assert np.abs(tmodel.als.user_factors.to_numpy() - ref).max() \
            <= FACTOR_TOL * np.abs(ref).max()
        for user in ("u3", "u11", "nobody"):
            got = talgo.predict(tmodel, TR.Query(user=user, num=3))
            want = jalgo.predict(jmodel, JR.Query(user=user, num=3))
            assert [s.item for s in got.item_scores] == \
                [s.item for s in want.item_scores]
            batch = dict(talgo.batch_predict(
                tmodel, [(0, TR.Query(user=user, num=3))]))[0]
            assert [s.item for s in batch.item_scores] == \
                [s.item for s in got.item_scores]
        from predictionio_tpu_torch.core import PersistentModel
        assert isinstance(talgo.make_persistent_model(tmodel),
                          PersistentModel)

    @pytest.mark.parametrize("saved,restored", [(2, 2), (2, 4), (4, 1)])
    def test_checkpoint_round_trip(self, tmp_path, monkeypatch, saved,
                                   restored):
        from predictionio_tpu.data.bimap import BiMap as JBiMap
        from predictionio_tpu.data.bimap import EntityIdIxMap as JIx
        from predictionio_tpu.models import recommendation as JR
        from predictionio_tpu_torch.core.persistence import (
            PersistentModelManifest, load_persistent_model)
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
        rng = np.random.default_rng(2)
        U = rng.standard_normal((12, 4)).astype(np.float32)
        V = rng.standard_normal((9, 4)).astype(np.float32)
        users = {f"u{i}": i for i in range(12)}
        items = {f"i{i}": i for i in range(9)}
        model = TR.RecommendationModel(
            TA.ALSModel(ShardedTable.from_host(U, saved),
                        ShardedTable.from_host(V, saved), 4, CPU),
            EntityIdIxMap(BiMap(users)), EntityIdIxMap(BiMap(items)))
        ckpt = TR.ShardedALSModelCheckpoint(model)
        assert ckpt.save("inst42", None)
        params = TR.ALSAlgorithmParams(rank=4, device="cpu",
                                       model_shards=restored)
        back = load_persistent_model(
            PersistentModelManifest(type(ckpt).loader_name()), "inst42",
            params)
        assert back.als.user_factors.n_shards == restored
        np.testing.assert_array_equal(back.als.user_factors.to_numpy(), U)
        np.testing.assert_array_equal(back.als.item_factors.to_numpy(), V)
        assert back.user_ix["u7"] == 7 and back.item_ix.id_of(3) == "i3"
        # the reference's round trip of the same tables answers the same
        jmodel = JR.RecommendationModel(JA.ALSModel(U, V, 4),
                                        JIx(JBiMap(users)),
                                        JIx(JBiMap(items)))
        jckpt = JR.ShardedALSModelCheckpoint(jmodel)
        assert jckpt.save("jinst", None)
        jback = JR.ShardedALSModelCheckpoint().load("jinst", None)
        talgo = TR.MeshALSAlgorithm(params)
        back = talgo.place_model(back)
        jalgo = JR.MeshALSAlgorithm(JR.ALSAlgorithmParams(rank=4))
        for user in ("u1", "u7"):
            a = talgo.predict(back, TR.Query(user=user, num=3))
            b = jalgo.predict(jback, JR.Query(user=user, num=3))
            assert [s.item for s in a.item_scores] == \
                [s.item for s in b.item_scores]
            np.testing.assert_allclose(
                [s.score for s in a.item_scores],
                [s.score for s in b.item_scores], rtol=SCORE_TOL,
                atol=SCORE_TOL)

    def test_engine_json_names_the_mesh_algorithm(self):
        engine = TR.RecommendationEngineFactory.apply()
        ep = engine.json_to_engine_params({
            "algorithms": [{"name": "als-mesh", "params": {
                "rank": 4, "factor_sharding": "model", "model_shards": 2,
                "device": "cpu"}}]})
        name, params = ep.algorithm_params_list[0]
        assert name == "als-mesh" and params.factor_sharding == "model"


class TestWeights:
    def test_reference_sharded_tables_come_over_shard_for_shard(self):
        from predictionio_tpu.parallel.sharded_table import \
            ShardedTable as JST
        from predictionio_tpu_torch.weights import from_jax_model
        rng = np.random.default_rng(5)
        U = rng.standard_normal((30, 6)).astype(np.float32)
        V = rng.standard_normal((20, 6)).astype(np.float32)
        ju, jv = JST.from_host(U, 2), JST.from_host(V, 2)
        users = [f"u{i}" for i in range(30)]
        items = [f"i{i}" for i in range(20)]
        model = from_jax_model(ju, jv, users, items, 6, device="cpu")
        for got, ref in ((model.als.user_factors, ju),
                         (model.als.item_factors, jv)):
            assert is_sharded(got)
            assert (got.offsets, got.n_rows, got.padded_rows,
                    got.n_shards) == (ref.offsets, ref.n_rows,
                                      ref.padded_rows, ref.n_shards)
            for a, b in zip(got.shards, ref.shards):
                np.testing.assert_array_equal(a, b)
        assert model.als.item_factors._dev is not None
        whole = from_jax_model(U, V, users, items, 6, device="cpu",
                               n_shards=4)
        assert whole.als.user_factors.n_shards == 4
        np.testing.assert_array_equal(whole.als.user_factors.to_numpy(), U)

    def test_reference_checkpoint_directory(self, tmp_path, monkeypatch):
        """The reference's `ShardedALSModelCheckpoint` writes orbax when
        it can, else `arrays.npz`: the npz form is read directly; the
        orbax form through the reference's restore."""
        import sys
        from predictionio_tpu.data.bimap import BiMap as JBiMap
        from predictionio_tpu.data.bimap import EntityIdIxMap as JIx
        from predictionio_tpu.models import recommendation as JR
        from predictionio_tpu.utils.checkpoint import (checkpoint_dir,
                                                       restore_sharded)
        from predictionio_tpu_torch.weights import (
            from_jax_model, from_jax_sharded_checkpoint)
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
        rng = np.random.default_rng(9)
        U = rng.standard_normal((14, 4)).astype(np.float32)
        V = rng.standard_normal((11, 4)).astype(np.float32)
        jmodel = JR.RecommendationModel(
            JA.ALSModel(U, V, 4),
            JIx(JBiMap({f"u{i}": i for i in range(14)})),
            JIx(JBiMap({f"i{i}": i for i in range(11)})))
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "orbax.checkpoint", None)
            assert JR.ShardedALSModelCheckpoint(jmodel).save("npz", None)
        d = checkpoint_dir("npz")
        assert os.path.exists(os.path.join(d, "factors", "arrays.npz"))
        model = from_jax_sharded_checkpoint(d, 2, device="cpu")
        np.testing.assert_array_equal(model.als.user_factors.to_numpy(), U)
        np.testing.assert_array_equal(model.als.item_factors.to_numpy(), V)
        assert model.user_ix["u9"] == 9
        assert JR.ShardedALSModelCheckpoint(jmodel).save("ox", None)
        d = checkpoint_dir("ox")
        if not os.path.exists(os.path.join(d, "factors", "arrays.npz")):
            with pytest.raises(ValueError, match="orbax"):
                from_jax_sharded_checkpoint(d, 2, device="cpu")
        arrays = restore_sharded(os.path.join(d, "factors"))
        model = from_jax_model(arrays["user_factors"],
                               arrays["item_factors"],
                               [f"u{i}" for i in range(14)],
                               [f"i{i}" for i in range(11)], 4,
                               device="cpu", n_shards=2)
        np.testing.assert_array_equal(model.als.item_factors.to_numpy(), V)
