"""Port parity: the ALS config fields `fuse_iteration`, `factor_dtype`
and `dual_solve` (ops/als.py), `FoldInConfig.dual_solve`, and the
templates' `fuse_iteration` param, vs the JAX reference on the CPU.

Tolerances, each from the reference's own tests or the port's parity
note:
- fuse_iteration (explicit and implicit, sweep_chunk 2 and 3) against the
  reference's fused run: rtol=2e-4, atol=2e-5, the bound
  tests/test_als.py holds its fused runs to against its unfused one. On
  the CPU the port's fused train is its eager loop, so it also equals the
  port's unfused train bit for bit.
- factor_dtype='bfloat16' against the reference's bf16 run: train RMSE
  within 1e-3, and factors within 4 bf16 ulps of the table's largest
  magnitude after 3 iterations (each side rounds every solved row to
  bf16, so one ulp of rounding can differ between them and grow over the
  iterations). The host tables are float32 (tests/test_solve.py:302).
- dual_solve='never' against the reference's 'never' at lam=0.1: within
  1e-4 of the largest factor (the ALS parity tolerance of
  tests/test_torch_als.py); against the port's own 'auto' the reference's
  bounds of tests/test_als.py:447-500 (1e-3 and 2e-3 of the scale).
- FoldInConfig.dual_solve: `solve_rows` against the reference's at 1e-4
  of the scale (lam=0.1), and the fold's 'never' against its 'auto' at
  1e-3.
"""

import copy
import json

import jax
import numpy as np
import pytest

from predictionio_tpu.online import fold_in as JF
from predictionio_tpu.ops.als import ALSConfig as JConfig
from predictionio_tpu.ops.als import als_rmse as j_rmse
from predictionio_tpu.ops.als import als_train as j_train
from predictionio_tpu.ops.ratings import RatingsCOO as JCOO
from predictionio_tpu.parallel.mesh import make_mesh
from predictionio_tpu.tools.templates import TEMPLATES
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.synthetic import small_ratings
from predictionio_tpu_torch.models import get_engine_factory
from predictionio_tpu_torch.online import fold_in as TF
from predictionio_tpu_torch.ops import als as TA
from predictionio_tpu_torch.ops.ratings import RatingsCOO as TCOO
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main)

FUSED_RTOL, FUSED_ATOL = 2e-4, 2e-5
BF16_ULPS = 4
BF16_RMSE_TOL = 1e-3
PARITY_TOL = 1e-4          # of the largest factor, at lam = 0.1


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(jax.devices()[:1])


def fused_data():
    """tests/test_als.py's data for its fused and chunked runs."""
    rng = np.random.default_rng(13)
    n_u, n_i, nnz = 500, 150, 7000
    ui = rng.integers(0, n_u, nnz)
    ii = rng.integers(0, n_i, nnz)
    vv = rng.uniform(1, 5, nnz).astype(np.float32)
    return ui, ii, vv, n_u, n_i


def train_both(data, mesh, **kw):
    ui, ii, vv, n_u, n_i = data
    mj = j_train(JCOO(ui, ii, vv, n_u, n_i), JConfig(**kw), mesh=mesh)
    mt = TA.als_train(TCOO(ui, ii, vv, n_u, n_i), TA.ALSConfig(**kw),
                      device="cpu")
    return mj, mt


@pytest.mark.parametrize("chunk", [2, 3])
@pytest.mark.parametrize("implicit", [False, True])
def test_fuse_iteration_matches_the_reference_fused_run(mesh1, implicit,
                                                        chunk):
    kw = dict(rank=8, iterations=3, lam=0.05, seed=2, work_budget=512,
              implicit_prefs=implicit, sweep_chunk=chunk)
    mj, mt = train_both(fused_data(), mesh1, fuse_iteration=True, **kw)
    np.testing.assert_allclose(mt.user_factors, mj.user_factors,
                               rtol=FUSED_RTOL, atol=FUSED_ATOL)
    np.testing.assert_allclose(mt.item_factors, mj.item_factors,
                               rtol=FUSED_RTOL, atol=FUSED_ATOL)
    ui, ii, vv, n_u, n_i = fused_data()
    plain = TA.als_train(TCOO(ui, ii, vv, n_u, n_i), TA.ALSConfig(**kw),
                         device="cpu")
    assert np.array_equal(plain.user_factors, mt.user_factors)
    assert np.array_equal(plain.item_factors, mt.item_factors)


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at magnitude x (8 mantissa bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("implicit", [False, True])
def test_bf16_tables_match_the_reference_bf16_run(mesh1, implicit):
    ui, ii, vv, n_u, n_i = small_ratings()
    kw = dict(rank=16, iterations=3, lam=0.1, seed=2, work_budget=512,
              implicit_prefs=implicit, factor_dtype="bfloat16")
    mj, mt = train_both((ui, ii, vv, n_u, n_i), mesh1, **kw)
    assert mt.user_factors.dtype == np.float32
    assert mt.item_factors.dtype == np.float32
    # every host value is a bf16 value: the tables were stored in bf16
    assert np.array_equal(
        mt.user_factors,
        mt.user_factors.astype(jax.numpy.bfloat16).astype(np.float32))
    for j, t in ((mj.user_factors, mt.user_factors),
                 (mj.item_factors, mt.item_factors)):
        tol = BF16_ULPS * bf16_ulp(np.abs(j).max())
        assert np.abs(j - t).max() <= tol, (np.abs(j - t).max(), tol)
    if not implicit:
        coo = TCOO(ui, ii, vv, n_u, n_i)
        r_j = j_rmse(mj, JCOO(ui, ii, vv, n_u, n_i))
        assert abs(TA.als_rmse(mt, coo) - r_j) < BF16_RMSE_TOL
        # and, as the reference's test holds it, near the f32 run
        m32 = TA.als_train(coo, TA.ALSConfig(**dict(
            kw, factor_dtype="float32")), device="cpu")
        assert abs(TA.als_rmse(m32, coo) - TA.als_rmse(mt, coo)) < 0.02


@pytest.mark.parametrize("implicit", [False, True])
def test_dual_solve_never_matches_the_reference(mesh1, implicit):
    ui, ii, vv, n_u, n_i = small_ratings()
    kw = dict(rank=16, iterations=3, lam=0.1, seed=2, work_budget=512,
              implicit_prefs=implicit, dual_solve="never")
    mj, mt = train_both((ui, ii, vv, n_u, n_i), mesh1, **kw)
    for j, t in ((mj.user_factors, mt.user_factors),
                 (mj.item_factors, mt.item_factors)):
        assert np.abs(j - t).max() <= PARITY_TOL * np.abs(j).max()


def test_implicit_dual_solve_matches_primal():
    """tests/test_als.py:447 on the port: the eig-SMW dual is exact
    algebra, with dislikes among the signals."""
    rng = np.random.default_rng(7)
    n_u, n_i, nnz = 400, 120, 6000
    ui = rng.integers(0, n_u, nnz)
    ii = rng.integers(0, n_i, nnz)
    vv = rng.integers(1, 6, nnz).astype(np.float32)
    vv[rng.random(nnz) < 0.1] *= -1
    r = TCOO(ui, ii, vv, n_u, n_i)
    kw = dict(rank=16, iterations=5, lam=0.05, seed=1,
              implicit_prefs=True, alpha=0.8)
    m_primal = TA.als_train(r, TA.ALSConfig(dual_solve="never", **kw),
                            device="cpu")
    m_dual = TA.als_train(r, TA.ALSConfig(dual_solve="auto", **kw),
                          device="cpu")
    scale = np.abs(m_primal.user_factors).max()
    assert np.abs(m_primal.user_factors
                  - m_dual.user_factors).max() < 1e-3 * scale
    assert np.abs(m_primal.item_factors
                  - m_dual.item_factors).max() < 1e-3 * scale


@pytest.mark.parametrize("implicit,alpha", [(False, 1.0), (True, 20.0)])
def test_dual_solve_large_k_buckets(implicit, alpha):
    """tests/test_als.py:472 on the port: duals with K of 32-128 below
    rank 150, against the primal through Cholesky."""
    rng = np.random.default_rng(11)
    n_u, n_i, rank = 60, 500, 150
    ui, ii, vv = [], [], []
    for u in range(n_u):
        k = int(rng.integers(30, 120))
        for i in rng.choice(n_i, size=k, replace=False):
            ui.append(u)
            ii.append(int(i))
            vv.append(float(rng.integers(1, 6)))
    r = TCOO(np.array(ui), np.array(ii), np.array(vv, dtype=np.float32),
             n_u, n_i)
    kw = dict(rank=rank, iterations=2, lam=0.05, seed=1,
              implicit_prefs=implicit, alpha=alpha)
    m_exact = TA.als_train(r, TA.ALSConfig(dual_solve="never",
                                           solver="cholesky", **kw),
                           device="cpu")
    m_dual = TA.als_train(r, TA.ALSConfig(dual_solve="auto", solver="cg",
                                          **kw), device="cpu")
    scale = np.abs(m_exact.user_factors).max()
    assert np.abs(m_exact.user_factors
                  - m_dual.user_factors).max() < 2e-3 * scale


def test_implicit_never_forms_g_without_its_eigh(monkeypatch):
    calls = []
    real = TA.gram_eig
    monkeypatch.setattr(TA, "gram_eig",
                        lambda f: calls.append(f.shape[0]) or real(f))
    ui, ii, vv, n_u, n_i = small_ratings()
    TA.als_train(TCOO(ui, ii, vv, n_u, n_i),
                 TA.ALSConfig(rank=16, iterations=2, work_budget=512,
                              implicit_prefs=True, dual_solve="never"),
                 device="cpu")
    assert calls == []


@pytest.mark.parametrize("kw,match", [
    (dict(factor_dtype="float16"), "factor_dtype"),
    (dict(factor_dtype="bfloat16", dtype="float64"), "dtype"),
    (dict(dual_solve="always"), "dual_solve")])
def test_config_rejects_bad_field_values(kw, match):
    with pytest.raises(ValueError, match=match):
        TA.ALSConfig(**kw)


def fold_rows(implicit: bool):
    ui, ii, vv, n_u, n_i = small_ratings()
    rng = np.random.default_rng(4)
    V = (np.abs(rng.standard_normal((n_i, 16))) / 4).astype(np.float32)
    touched = np.arange(12)
    sel = np.isin(ui, touched)
    return V, np.searchsorted(touched, ui[sel]), ii[sel], vv[sel], 12


@pytest.mark.parametrize("implicit", [False, True])
def test_fold_dual_solve_never(mesh1, implicit):
    V, owner, idx, vals, n = fold_rows(implicit)
    kw = dict(lam=0.1, implicit_prefs=implicit, work_budget=512)
    xj = JF.solve_rows(V, owner, idx, vals, n,
                       JF.FoldInConfig(dual_solve="never", **kw),
                       mesh=mesh1)
    xt = TF.solve_rows(V, owner, idx, vals, n,
                       TF.FoldInConfig(dual_solve="never", **kw),
                       device="cpu")
    scale = np.abs(xj).max()
    assert np.abs(xj - xt).max() <= PARITY_TOL * scale
    xa = TF.solve_rows(V, owner, idx, vals, n, TF.FoldInConfig(**kw),
                       device="cpu")
    assert np.abs(xa - xt).max() <= 1e-3 * scale
    assert TF.FoldInConfig().dual_solve == JF.FoldInConfig().dual_solve


APP = "fieldsapp"


@pytest.fixture()
def fields_store(tmp_env):
    TReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
    rng = np.random.default_rng(3)
    n = 400
    ev = TReg.Storage.get_events()
    ev.insert_columnar(ColumnarBatch(
        n, "rate", "user", [f"u{x}" for x in rng.integers(0, 30, n)],
        "item", [f"i{x}" for x in rng.integers(0, 25, n)],
        [{"rating": float(x)} for x in rng.integers(1, 6, n)],
        ["1970-01-01T00:00:%02d.%03dZ" % divmod(k, 1000)
         for k in range(n)]), app_id)
    yield tmp_env
    TReg.clear_cache()


@pytest.mark.parametrize("template", sorted(TEMPLATES))
def test_every_scaffold_parses_through_the_port(template):
    variant = TEMPLATES[template]["engine_json"]
    engine = get_engine_factory(variant["engineFactory"]).apply()
    ep = engine.json_to_engine_params(variant)
    assert engine.engine_params_to_json(ep)["algorithms"][0]["name"] == \
        variant["algorithms"][0]["name"]


def test_an_engine_json_with_fuse_iteration_trains(fields_store):
    variant = copy.deepcopy(TEMPLATES["recommendation"]["engine_json"])
    variant["datasource"]["params"]["app_name"] = APP
    variant["algorithms"][0]["params"].update(
        rank=4, num_iterations=2, fuse_iteration=True, device="cpu")
    path = fields_store / "engine.json"
    path.write_text(json.dumps(variant))
    iid = create_workflow_main(WorkflowConfig(engine_variant=str(path)))
    inst = TReg.Storage.get_meta_data_engine_instances().get(iid)
    assert inst.status == "COMPLETED"
    assert json.loads(inst.algorithms_params)[0]["params"][
        "fuse_iteration"] is True
