"""Port parity: the fold-in core (`online/fold_in.py`, the vocabulary
growth, the row buckets and the fold's sentinel) vs the JAX reference.

Both packages fold the same seeded tables and ratings on the CPU (the
reference on a one-device mesh, so its solve plans are the port's), with
the solver each resolves there ('auto' -> Cholesky in both). Tolerances:
factors within 1e-4 of the largest factor magnitude at lam=0.1 and 4e-4
at lam=0.01, as tests/test_torch_als.py holds the train (4x the f32-vs-f64
reading of scripts/torch_als_rounding.py); rows a fold does not touch are
held bit for bit, as are the maps, buckets, padded plans, stats and
sentinel verdicts.
"""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.compile import buckets as JBuckets
from predictionio_tpu.data.bimap import EntityIdIxMap as JMap
from predictionio_tpu.guard import sentinels as JS
from predictionio_tpu.online import fold_in as JF
from predictionio_tpu.ops import als as JA
from predictionio_tpu.ops.ratings import RatingsCOO as JCOO
from predictionio_tpu.ops.ratings import build_solve_plan as j_plan
from predictionio_tpu.parallel.mesh import make_mesh
from predictionio_tpu_torch.data.bimap import EntityIdIxMap as TMap
from predictionio_tpu_torch.data.synthetic import small_ratings
from predictionio_tpu_torch.guard import sentinels as TS
from predictionio_tpu_torch.obs import torchmon
from predictionio_tpu_torch.online import fold_in as TF
from predictionio_tpu_torch.ops import als as TA
from predictionio_tpu_torch.ops.ratings import RatingsCOO as TCOO
from predictionio_tpu_torch.ops.ratings import build_solve_plan as t_plan
from predictionio_tpu_torch.compile import buckets as TBuckets
from predictionio_tpu_torch.utils import device_cache

RANK = 16
FACTOR_TOL = {0.1: 1e-4, 0.01: 4e-4}
NEW_USERS, NEW_ITEMS = 3, 2


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(jax.devices()[:1])


def fold_case(seed: int = 0, implicit: bool = False, every_user=False):
    """A deployed model (seeded tables) and the data of a tick: the
    seeded ratings plus NEW_USERS new users with 5 ratings each on old
    and NEW_ITEMS new items; touched: 10 old users (or every user), the
    new users, 5 old items and the new items."""
    ui, ii, vv, n_u, n_i = small_ratings()
    rng = np.random.default_rng(seed)
    U = (np.abs(rng.standard_normal((n_u, RANK))) / 4).astype(np.float32)
    V = (np.abs(rng.standard_normal((n_i, RANK))) / 4).astype(np.float32)
    eu = np.repeat(np.arange(n_u, n_u + NEW_USERS), 5)
    ei = rng.integers(0, n_i + NEW_ITEMS, eu.size)
    ev = (rng.integers(1, 4, eu.size) if implicit
          else rng.integers(1, 6, eu.size)).astype(np.float32)
    coo = (np.concatenate([ui, eu]).astype(np.int32),
           np.concatenate([ii, ei]).astype(np.int32),
           np.concatenate([vv, ev]).astype(np.float32),
           n_u + NEW_USERS, n_i + NEW_ITEMS)
    tu = np.concatenate([rng.choice(n_u, 10, replace=False),
                         np.arange(n_u, n_u + NEW_USERS)])
    if every_user:
        tu = np.arange(n_u + NEW_USERS)
    ti = np.concatenate([rng.choice(n_i, 5, replace=False),
                         np.arange(n_i, n_i + NEW_ITEMS)])
    return U, V, coo, tu, ti


def both_folds(mesh1, implicit, lam, every_user=False, work_budget=512):
    U, V, coo, tu, ti = fold_case(implicit=implicit, every_user=every_user)
    cfg = dict(lam=lam, implicit_prefs=implicit, sweeps=2,
               work_budget=work_budget)
    mj, sj = JF.fold_in_coo(JA.ALSModel(U, V, RANK), JCOO(*coo), tu, ti,
                            JF.FoldInConfig(**cfg), mesh=mesh1)
    mt, st = TF.fold_in_coo(TA.ALSModel(U, V, RANK, None), TCOO(*coo), tu,
                            ti, TF.FoldInConfig(**cfg), device="cpu")
    return (U, V, tu, ti), (mj, sj), (mt, st)


@pytest.mark.parametrize("lam,every_user,work_budget", [
    (0.1, False, 512), (0.01, False, 512),
    (0.1, True, 128)])     # every user touched: plans with inert batches
@pytest.mark.parametrize("implicit", [False, True])
def test_fold_in_coo_matches_reference(mesh1, implicit, lam, every_user,
                                       work_budget):
    (U, V, tu, ti), (mj, sj), (mt, st) = both_folds(
        mesh1, implicit, lam, every_user, work_budget)
    for a, b in ((mj.user_factors, mt.user_factors),
                 (mj.item_factors, mt.item_factors)):
        assert a.shape == b.shape and b.dtype == np.float32
        assert np.abs(a - b).max() <= FACTOR_TOL[lam] * np.abs(a).max()
    for name in ("n_user_rows", "n_item_rows", "n_new_users",
                 "n_new_items", "nnz_user_side", "nnz_item_side", "sweeps",
                 "degenerate", "resident_hit", "sentinel_rollback"):
        assert getattr(sj, name) == getattr(st, name), name
    assert st.n_new_users == NEW_USERS and st.n_new_items == NEW_ITEMS
    assert st.solver_calls > 0
    # rows the tick did not touch are the deployed rows, bit for bit
    keep_u = np.setdiff1d(np.arange(U.shape[0]), tu)
    keep_i = np.setdiff1d(np.arange(V.shape[0]), ti)
    assert np.array_equal(mt.user_factors[keep_u], U[keep_u])
    assert np.array_equal(mt.item_factors[keep_i], V[keep_i])
    # the folded model's device tables are its host tables
    Ud, Vd = mt.tables()
    assert np.array_equal(Ud.numpy(), mt.user_factors)
    assert np.array_equal(Vd.numpy(), mt.item_factors)


@pytest.mark.parametrize("lam", [0.1, 0.01])
@pytest.mark.parametrize("implicit", [False, True])
def test_solve_rows_matches_reference(mesh1, implicit, lam):
    U, V, coo, tu, _ = fold_case(seed=1, implicit=implicit)
    ui, ii, vv, _, _ = coo
    sel = np.isin(ui, tu[:8])
    owner = np.searchsorted(np.sort(tu[:8]), ui[sel])
    kw = dict(lam=lam, implicit_prefs=implicit, work_budget=512)
    counter = np.vstack([V, np.zeros((NEW_ITEMS, RANK), np.float32)])
    xj = JF.solve_rows(counter, owner, ii[sel], vv[sel], 8,
                       JF.FoldInConfig(**kw), mesh=mesh1)
    xt = TF.solve_rows(counter, owner, ii[sel], vv[sel], 8,
                       TF.FoldInConfig(**kw), device="cpu")
    assert xt.shape == (8, RANK) and xt.dtype == np.float32
    assert np.abs(xj - xt).max() <= FACTOR_TOL[lam] * np.abs(xj).max()
    # an entity-free call is all zeros, as the reference's
    empty = TF.solve_rows(counter, owner[:0], ii[:0], vv[:0], 4,
                          TF.FoldInConfig(**kw), device="cpu")
    assert empty.shape == (4, RANK) and not empty.any()


@pytest.mark.parametrize("case", ["no_touched", "zero_ratings",
                                  "no_data_for_touched"])
def test_degenerate_tick_returns_the_model_itself(mesh1, case):
    U, V, coo, tu, ti = fold_case()
    ui, ii, vv, n_u, n_i = coo
    if case == "no_touched":
        tu, ti = tu[:0], ti[:0]
    elif case == "zero_ratings":
        vv = np.zeros_like(vv)
    else:   # touched ids past every rating's owner
        tu, ti = np.array([n_u + 50]), np.array([n_i + 50])
    args = (tu, ti)
    cfg = dict(lam=0.1, sweeps=2, work_budget=512)
    jm = JA.ALSModel(U, V, RANK)
    tm = TA.ALSModel(U, V, RANK, None)
    out_j, sj = JF.fold_in_coo(jm, JCOO(ui, ii, vv, n_u, n_i), *args,
                               JF.FoldInConfig(**cfg), mesh=mesh1)
    before = torchmon.thread_h2d_total()
    out_t, st = TF.fold_in_coo(tm, TCOO(ui, ii, vv, n_u, n_i), *args,
                               TF.FoldInConfig(**cfg), device="cpu",
                               resident_key="degenerate")
    assert out_j is jm and sj.degenerate
    assert out_t is tm and st.degenerate and st.solver_calls == 0
    assert torchmon.h2d_delta(before) == 0   # no table went to the device


@pytest.mark.parametrize("implicit", [False, True])
def test_second_tick_hits_the_residency_slot(implicit):
    """Tick 2 against tick 1's published model reuses its device tables
    (and Grams) and uploads only its plans; the answer equals a cold
    fold of the same model; a foreign model with equal values misses."""
    U, V, coo, tu, ti = fold_case(seed=2, implicit=implicit)
    cfg = TF.FoldInConfig(lam=0.1, implicit_prefs=implicit, sweeps=2,
                          work_budget=512)
    key = f"test-slot-{implicit}"
    h0 = torchmon.thread_h2d_total()
    m1, s1 = TF.fold_in_coo(TA.ALSModel(U, V, RANK, None), TCOO(*coo), tu,
                            ti, cfg, device="cpu", resident_key=key)
    h1 = torchmon.thread_h2d_total() - h0
    assert not s1.resident_hit
    # the next tick: other touched rows of the same data
    tu2, ti2 = tu[:4], ti[-3:]
    m2, s2 = TF.fold_in_coo(m1, TCOO(*coo), tu2, ti2, cfg, device="cpu",
                            resident_key=key)
    h2 = torchmon.thread_h2d_total() - h0 - h1
    assert s2.resident_hit
    tables = (m1.user_factors.size + m1.item_factors.size) * 4
    assert h1 > tables and h2 < tables / 10, (h1, h2, tables)
    cold = TA.ALSModel(m1.user_factors.copy(), m1.item_factors.copy(), RANK,
                       None)
    m3, s3 = TF.fold_in_coo(cold, TCOO(*coo), tu2, ti2, cfg, device="cpu",
                            resident_key=key)
    assert not s3.resident_hit          # a foreign model misses
    tol = 1e-5 * np.abs(m3.user_factors).max()
    assert np.abs(m2.user_factors - m3.user_factors).max() <= tol
    assert np.abs(m2.item_factors - m3.item_factors).max() <= tol
    if implicit:
        # the carried Gram (rank-k corrected twice) against a recompute
        slot = device_cache.get_resident(key, (m3.user_factors,
                                               m3.item_factors),
                                         sharding="replicated")
        for g, t in ((slot["GU"], slot["U"]), (slot["GV"], slot["V"])):
            ref = (t.double().T @ t.double())
            assert (g.double() - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_vocabulary_growth_inside_its_bucket_hits_the_slot():
    U, V, coo, tu, ti = fold_case(seed=3)
    ui, ii, vv, n_u, n_i = coo
    cfg = TF.FoldInConfig(lam=0.1, sweeps=1, work_budget=512)
    m1, _ = TF.fold_in_coo(TA.ALSModel(U, V, RANK, None),
                           TCOO(ui, ii, vv, n_u, n_i), tu, ti, cfg,
                           device="cpu", resident_key="grow-slot")
    assert TBuckets.bucket_rows(n_u + 1) == TBuckets.bucket_rows(n_u)
    ui2 = np.concatenate([ui, [n_u, n_u]]).astype(np.int32)
    ii2 = np.concatenate([ii, [0, 1]]).astype(np.int32)
    vv2 = np.concatenate([vv, [4.0, 5.0]]).astype(np.float32)
    m2, s2 = TF.fold_in_coo(m1, TCOO(ui2, ii2, vv2, n_u + 1, n_i), [n_u],
                            [], cfg, device="cpu", resident_key="grow-slot")
    assert s2.resident_hit and s2.n_new_users == 1
    assert m2.user_factors.shape == (n_u + 1, RANK)
    assert np.abs(m2.user_factors[n_u]).max() > 0


def test_padded_fold_plan_matches_reference():
    U, V, coo, tu, _ = fold_case(every_user=True)
    ui, ii, vv, _, _ = coo
    sel = np.isin(ui, tu)
    owner = np.searchsorted(np.sort(tu), ui[sel])
    n_slot = TBuckets.bucket_rows(tu.size, floor=16)
    args = (owner.astype(np.int64), ii[sel], vv[sel], n_slot)
    kw = dict(work_budget=128, bucket_ratio=2.0)
    pj = JF._pad_plan_batches(j_plan(*args, **kw))
    pt = TF._pad_plan_batches(t_plan(*args, **kw))
    assert len(pj.batches) == len(pt.batches)
    for bj, bt in zip(pj.batches, pt.batches):
        for f in ("rows", "idx", "val", "mask"):
            assert np.array_equal(getattr(bj, f), getattr(bt, f)), f
    # inert batches: rows -1, mask 0; the B of every batch a pow2 >= 16
    assert any((b.rows < 0).all() for b in pt.batches)
    assert all(b.shape[0] >= 16 and b.shape[0] & (b.shape[0] - 1) == 0
               for b in pt.batches)


def test_inert_batches_solve_to_zero_on_the_dummy_row():
    """A whole inert batch (rows -1, mask 0) lands on the dummy tail row
    as exact zeros, and no real row moves."""
    V = torch.rand(20, RANK, dtype=torch.float32)
    B, K = 16, 8
    batch = (torch.full((B,), -1, dtype=torch.long),
             torch.zeros((B, K), dtype=torch.long),
             torch.zeros((B, K)), torch.zeros((B, K)))
    out = torch.full((5, RANK), 7.0)
    out[-1] = 3.0
    cfg = TA.ALSConfig(rank=RANK, lam=0.1)
    TA._run_side([batch], out, V, cfg, "cholesky")
    assert bool((out[:-1] == 7.0).all()) and bool((out[-1] == 0).all())


@pytest.mark.parametrize("ids", [["d", "a", "e", "d"], ["a", "b"], [],
                                 ["zz", "0", "b"]])
def test_grow_matches_reference(ids):
    keys = ["b", "a", "c"]
    jg, jn = JMap.build(keys).grow(ids)
    tg, tn = TMap.build(keys).grow(ids)
    assert list(jn) == list(tn)
    assert [jg.id_of(i) for i in range(len(jg))] == list(tg.ids)
    probe = np.array(keys + ids + ["nope"], dtype=str)
    assert np.array_equal(jg.to_indices_array(probe),
                          tg.to_indices_array(probe))


def test_grown_map_does_not_inherit_its_parents_sorted_view():
    m = TMap.build(["a", "b", "c"])
    m.to_indices_array(np.array(["a"]))        # the parent caches a view
    g, _ = m.grow(["0"])
    assert list(g.to_indices_array(np.array(["0", "c", "a"]))) == [3, 2, 0]
    assert m.grow(["a"])[0] is m


@pytest.mark.parametrize("floor", [64, 16, 1])
def test_bucket_rows_matches_reference(floor):
    for n in list(range(0, 300)) + [138_501, 26_746, 1 << 20]:
        assert TBuckets.bucket_rows(n, floor=floor) == JBuckets.bucket_rows(
            n, floor=floor)
    assert TBuckets.ROWS_FLOOR == JBuckets.ROWS_FLOOR
    assert TBuckets.bucket_rows(138_501) == 262_144


@pytest.mark.parametrize("case", ["clean", "non_finite", "exploded",
                                  "empty", "guard_off"])
def test_sentinel_check_rows_matches_reference(case, monkeypatch):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((40, RANK)).astype(np.float32)
    idx = np.array([3, 7, 11, 30], dtype=np.int32)
    if case == "non_finite":
        table[7, 2] = np.nan
    elif case == "exploded":
        table[30] *= 1e6
    elif case == "empty":
        idx = idx[:0]
    elif case == "guard_off":
        table[11, 0] = np.inf
        monkeypatch.setenv("PIO_GUARD", "off")
    base = TS.host_max_norm(table[:3])
    assert base == JS.host_max_norm(table[:3])
    js = JS.SweepSentinel("fold_in", base, norm_ratio=10.0, norm_floor=1.0)
    ts = TS.SweepSentinel("fold_in", base, norm_ratio=10.0, norm_floor=1.0)
    fj = js.check_rows(jax.numpy.asarray(table), idx, "user-side solve")
    ft = ts.check_rows(torch.from_numpy(table), idx, "user-side solve")
    assert (fj is None) == (ft is None)
    if ft is not None:
        assert type(ft).__name__ == "NumericalFault"
        assert ft.detail.split(" max_row_norm")[0] == \
            fj.detail.split(" max_row_norm")[0]
    assert ts.breaches == js.breaches
    assert abs(ts.observed_max - js.observed_max) <= 1e-6 * max(
        js.observed_max, 1.0)


def test_fold_raises_numerical_fault_without_a_clean_sweep():
    U, V, coo, tu, ti = fold_case(seed=5)
    cfg = TF.FoldInConfig(lam=0.1, sweeps=2, work_budget=512,
                          sentinel_norm_ratio=0.0, sentinel_norm_floor=1e-9)
    with pytest.raises(TS.NumericalFault):
        TF.fold_in_coo(TA.ALSModel(U, V, RANK, None), TCOO(*coo), tu, ti,
                       cfg, device="cpu")


def _template_case(template: str):
    """A trained reference model and a tick's training data (each as both
    packages' objects), for the templates' own `fold_in`."""
    from predictionio_tpu.models import recommendation as JR
    from predictionio_tpu.models import similarproduct as JSP
    from predictionio_tpu.models.common import RatingsData as JRD
    from predictionio_tpu_torch.models import recommendation as TR
    from predictionio_tpu_torch.models import similarproduct as TSP
    from predictionio_tpu_torch.models.common import RatingsData as TRD
    rng = np.random.default_rng(8)
    n = 400
    users = np.array([f"u{x}" for x in rng.integers(0, 30, n)])
    items = np.array([f"i{x}" for x in rng.integers(0, 25, n)])
    vals = (rng.integers(1, 6, n) if template != "like"
            else rng.choice([-1.0, 1.0], n)).astype(np.float32)
    ts = np.arange(n, dtype=np.int64)
    # the tick: new users on old and new items, a known user's new rating
    fu = np.array(["nu0"] * 4 + ["nu1"] * 3 + ["u1", "u2"])
    fi = np.array(["i1", "i2", "ni0", "ni0", "i3", "ni0", "i4", "i5",
                   "ni0"])
    fv = (np.array([5, 4, 3, 5, 2, 4, 1, 5, 4]) if template != "like"
          else np.array([1, -1, 1, 1, -1, 1, 1, -1, 1])).astype(np.float32)
    all_u, all_i = np.concatenate([users, fu]), np.concatenate([items, fi])
    all_v = np.concatenate([vals, fv])
    all_t = np.arange(all_v.size, dtype=np.int64)
    touched_u = ["u1", "u2", "nu0", "nu1", "u7"]
    touched_i = ["i1", "i2", "i3", "i4", "i5", "ni0", "only"]
    if template.startswith("recommendation"):
        p = dict(rank=RANK, num_iterations=4, lam=0.1, seed=1)
        ja = JR.ALSAlgorithm(JR.ALSAlgorithmParams(**p))
        ta = TR.ALSAlgorithm(TR.ALSAlgorithmParams(device="cpu", **p))
        props = {f"i{k}": {"categories": [f"c{k % 3}"],
                           "creationYear": 1990 + k} for k in range(25)}
        jm = ja.train(JR.RecommendationPreparator().prepare(JR.TrainingData(
            JRD(users, items, vals, ts), items=props)))
        new_props = {"ni0": {"categories": ["c9"], "creationYear": 2024},
                     "only": {"categories": ["c8"]}, **{
                         i: props[i] for i in touched_i if i in props}}
        tds = (JR.TrainingData(JRD(all_u, all_i, all_v, all_t),
                               items=new_props, touched_only=True),
               TR.TrainingData(TRD(all_u, all_i, all_v, all_t),
                               items=new_props, touched_only=True))
        return ja, ta, jm, tds, touched_u, touched_i
    p = dict(rank=RANK, num_iterations=4, lam=0.1, alpha=1.0, seed=1)
    like = template == "like"
    cls_j = JSP.LikeAlgorithm if like else JSP.ALSAlgorithm
    cls_t = TSP.LikeAlgorithm if like else TSP.ALSAlgorithm
    ja = cls_j(JSP.ALSAlgorithmParams(**p))
    ta = cls_t(TSP.ALSAlgorithmParams(device="cpu", **p))
    jitems = {f"i{k}": JSP.Item((f"c{k % 3}",), {"year": 2000 + k})
              for k in range(25)}
    ev = JRD(users, items, np.ones(n, np.float32), ts)
    lk = JRD(users, items, vals, ts)
    jm = ja.train(JSP.PreparedData(JSP.TrainingData(
        {}, jitems, ev, lk if like else None)))
    fresh_items = {"ni0": (("c9",), {"year": 2024}),
                   "only": (("c8",), {})}
    def td(mod, rd):
        its = {k: mod.Item(*v) for k, v in fresh_items.items()}
        its.update({i: mod.Item(jitems[i].categories,
                                dict(jitems[i].properties))
                    for i in touched_i if i in jitems})
        views = rd(all_u, all_i, np.ones(all_v.size, np.float32), all_t)
        likes = rd(all_u, all_i, all_v, all_t) if like else None
        return mod.TrainingData({}, its, views, likes, touched_only=True)
    return ja, ta, jm, (td(JSP, JRD), td(TSP, TRD)), touched_u, touched_i


@pytest.mark.parametrize("template", ["recommendation",
                                      "recommendation_excluded",
                                      "similarproduct", "like"])
def test_template_fold_in_matches_reference(template, tmp_path):
    """Both templates' own `fold_in` (vocabulary growth of entities with
    events only, the preparator's exclusion list, new items' properties,
    the entity-filtered read's metadata merge) on a model trained by the
    reference and carried across."""
    from predictionio_tpu.models import recommendation as JR
    from predictionio_tpu_torch.models import recommendation as TR
    from predictionio_tpu_torch.models import similarproduct as TSP
    from predictionio_tpu_torch.weights import (
        from_jax_model, from_jax_similarproduct_model)
    ja, ta, jm, (jtd, ttd), tu, ti = _template_case(template)
    jkw = tkw = {}
    if template == "recommendation_excluded":
        path = tmp_path / "exclude.txt"
        path.write_text("i2\nni0\n")
        jkw = {"preparator_params": JR.PreparatorParams(
            exclude_items_file=str(path))}
        tkw = {"preparator_params": TR.PreparatorParams(
            exclude_items_file=str(path))}
    if template.startswith("recommendation"):
        tm = from_jax_model(jm.als.user_factors, jm.als.item_factors,
                            list(jm.user_ix._ids), list(jm.item_ix._ids),
                            RANK, device="cpu",
                            item_properties=jm.item_properties)
    else:
        tm = from_jax_similarproduct_model(
            jm.item_factors_normalized, list(jm.item_ix._ids),
            {k: TSP.Item(v.categories, v.properties)
             for k, v in jm.items.items()},
            item_factors_raw=jm.item_factors_raw,
            user_factors=jm.user_factors, user_ids=list(jm.user_ix._ids),
            device="cpu")
    nj, rj = ja.fold_in(jm, jtd, tu, ti, **jkw)
    nt, rt = ta.fold_in(tm, ttd, tu, ti, **tkw)
    assert set(rt) == set(rj) | {"solverCalls", "launches"}
    for k in ("userRows", "itemRows", "newUsers", "newItems"):
        assert rj[k] == rt[k], k
    assert abs(rj["loss"] - rt["loss"]) <= 1e-4 * rj["loss"]
    assert list(nt.user_ix.ids) == list(nj.user_ix._ids)
    assert list(nt.item_ix.ids) == list(nj.item_ix._ids)
    assert "only" not in set(nt.user_ix.ids)      # a $set mints no user
    if template.startswith("recommendation"):
        pairs = ((nj.als.user_factors, nt.als.user_factors),
                 (nj.als.item_factors, nt.als.item_factors))
        assert nt.item_properties == nj.item_properties
        assert "only" not in set(nt.item_ix.ids)
        if template == "recommendation_excluded":
            assert "ni0" not in set(nt.item_ix.ids)
    else:
        pairs = ((nj.user_factors, nt.user_factors),
                 (nj.item_factors_raw, nt.item_factors_raw),
                 (nj.item_factors_normalized, nt.item_factors_normalized))
        assert nt.item_categories == nj.item_categories
        assert set(nt.items) == set(nj.items)   # untouched metadata kept
    for a, b in pairs:
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= FACTOR_TOL[0.1] * np.abs(a).max()
