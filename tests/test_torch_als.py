"""Port parity: predictionio_tpu_torch.ops.als (explicit ALS train) vs the
JAX reference on a one-device mesh (batch_multiple=1 on both sides, so
the solve plans are identical).

Tolerances: factors within 1e-4 of the largest factor magnitude and
train RMSE within 1e-5 — the same plans, initial tables and solver
arithmetic in f32, with sums taken in a different order — at lam=0.1.
At the main path's lam=0.01 these small systems amplify f32 rounding:
the port's own train in f32 and in f64 differs by 9.1e-5 (CG) and
1.0e-4 (Cholesky) of the largest factor there
(scripts/torch_als_rounding.py), so that case holds factors to 4e-4,
four times the rounding reading.
"""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.als import ALSConfig as JConfig
from predictionio_tpu.ops.als import als_rmse as j_rmse
from predictionio_tpu.ops.als import als_train as j_train
from predictionio_tpu.ops.ratings import RatingsCOO as JCOO
from predictionio_tpu.ops.ratings import plan_for_items, plan_for_users
from predictionio_tpu.parallel.mesh import make_mesh
from predictionio_tpu_torch.data.synthetic import small_ratings
from predictionio_tpu_torch.guard.sentinels import NumericalFault
from predictionio_tpu_torch.ops import als as TA
from predictionio_tpu_torch.ops.ratings import RatingsCOO as TCOO

RANK = 16
FACTOR_TOL = 1e-4
FACTOR_TOL_MAIN_LAM = 4e-4    # 4x the f32-vs-f64 reading at lam=0.01
RMSE_TOL = 1e-5


def ratings():
    """Lognormal activity: heavy users (K >= rank, primal) and light ones
    (K < rank, the dual route) on both sides."""
    return small_ratings()


@pytest.fixture(scope="module")
def data():
    ui, ii, vv, n_u, n_i = ratings()
    r = JCOO(ui, ii, vv, n_u, n_i)
    for plan in (plan_for_users(r, work_budget=512),
                 plan_for_items(r, work_budget=512)):
        ks = {b.shape[1] for b in plan.batches}
        assert min(ks) < RANK <= max(ks), ks   # both routes are exercised
    return ui, ii, vv, n_u, n_i


def assert_train_matches_reference(data, solver, lam, factor_tol):
    ui, ii, vv, n_u, n_i = data
    kw = dict(rank=RANK, iterations=3, lam=lam, seed=2, work_budget=512,
              solver=solver)
    mj = j_train(JCOO(ui, ii, vv, n_u, n_i), JConfig(**kw),
                 mesh=make_mesh(jax.devices()[:1]))
    rt = TCOO(ui, ii, vv, n_u, n_i)
    mt = TA.als_train(rt, TA.ALSConfig(**kw), device="cpu")
    for a, b in ((mj.user_factors, mt.user_factors),
                 (mj.item_factors, mt.item_factors)):
        assert a.shape == b.shape and b.dtype == np.float32
        assert np.abs(a - b).max() <= factor_tol * np.abs(a).max()
    assert abs(j_rmse(mj, JCOO(ui, ii, vv, n_u, n_i))
               - TA.als_rmse(mt, rt)) <= RMSE_TOL


@pytest.mark.parametrize("solver", ["cg", "cholesky"])
def test_als_train_matches_reference(data, solver):
    assert_train_matches_reference(data, solver, 0.1, FACTOR_TOL)


@pytest.mark.parametrize("solver", ["cg", "cholesky"])
def test_als_train_matches_reference_at_main_path_lam(data, solver):
    assert_train_matches_reference(data, solver, 0.01, FACTOR_TOL_MAIN_LAM)


@pytest.mark.parametrize("lam,bound", [(0.1, 1e-5), (0.01, 2e-4)])
def test_float64_train_reads_float32_rounding(data, lam, bound):
    """The f64 train is the rounding yardstick the tolerances come from:
    it differs from the f32 train by about the readings above."""
    r = TCOO(*data)
    kw = dict(rank=RANK, iterations=3, lam=lam, seed=2, work_budget=512,
              solver="cg")
    m32 = TA.als_train(r, TA.ALSConfig(**kw), device="cpu")
    m64 = TA.als_train(r, TA.ALSConfig(dtype="float64", **kw), device="cpu")
    assert m64.user_factors.dtype == np.float64
    ref = m64.item_factors
    assert np.abs(m32.item_factors - ref).max() <= bound * np.abs(ref).max()
    with pytest.raises(ValueError, match="dtype"):
        TA.ALSConfig(dtype="float16")


def test_telemetry_counts_every_solver_call(data):
    ui, ii, vv, n_u, n_i = data
    r = TCOO(ui, ii, vv, n_u, n_i)
    tel = {}
    TA.als_train(r, TA.ALSConfig(rank=RANK, iterations=2, work_budget=512),
                 device="cpu", telemetry=tel)
    n_batches = (len(plan_for_users(r, work_budget=512).batches)
                 + len(plan_for_items(r, work_budget=512).batches))
    assert tel["solver_calls"] == 2 * n_batches
    for key in ("plan_s", "upload_s", "iters_s", "s_per_iter", "fetch_s"):
        assert tel[key] >= 0.0


def test_dual_cutoff_routes_small_k_to_the_plain_cg(data):
    """`dual_plain_below` keeps the reference's K < 32 escape hatch as an
    option; the math is unchanged (plain CG == the kernel's CPU path)."""
    ui, ii, vv, n_u, n_i = data
    r = TCOO(ui, ii, vv, n_u, n_i)
    kw = dict(rank=RANK, iterations=2, work_budget=512, solver="cg_cuda")
    a = TA.als_train(r, TA.ALSConfig(**kw), device="cpu")
    b = TA.als_train(r, TA.ALSConfig(dual_plain_below=32, **kw),
                     device="cpu")
    np.testing.assert_array_equal(a.user_factors, b.user_factors)


def test_implicit_prefs_not_ported_yet(data):
    """Implicit ALS is ported now (tests/test_torch_implicit.py holds it
    to the reference): `implicit_prefs=True` trains instead of raising,
    and gives other factors than the explicit train of the same data."""
    ui, ii, vv, n_u, n_i = data
    kw = dict(rank=RANK, iterations=2, work_budget=512, solver="cholesky")
    implicit = TA.als_train(TCOO(ui, ii, vv, n_u, n_i),
                            TA.ALSConfig(implicit_prefs=True, **kw),
                            device="cpu")
    explicit = TA.als_train(TCOO(ui, ii, vv, n_u, n_i), TA.ALSConfig(**kw),
                            device="cpu")
    assert np.isfinite(implicit.item_factors).all()
    assert not np.allclose(implicit.item_factors, explicit.item_factors)


def test_sentinel_raises_on_first_iteration_breach(data):
    """A NaN rating poisons the CG solves (Cholesky would refuse the
    system instead); with no clean iteration to roll back to, the train
    raises."""
    ui, ii, vv, n_u, n_i = data
    bad = vv.copy()
    bad[0] = np.nan
    with pytest.raises(NumericalFault):
        TA.als_train(TCOO(ui, ii, bad, n_u, n_i),
                     TA.ALSConfig(rank=RANK, iterations=2, work_budget=512,
                                  solver="cg"), device="cpu")


def test_serve_topk_matches_numpy(data, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")   # f32 scores
    ui, ii, vv, n_u, n_i = data
    m = TA.als_train(TCOO(ui, ii, vv, n_u, n_i),
                     TA.ALSConfig(rank=RANK, iterations=2), device="cpu")
    users = np.array([0, 5, 17])
    scores, idx = TA.users_topk_serve(m, users, 7)
    scores, idx = scores[:, :7], idx[:, :7]     # k pads to its bucket
    ref = m.user_factors[users] @ m.item_factors.T
    np.testing.assert_array_equal(idx, np.argsort(-ref, axis=1)[:, :7])
    np.testing.assert_allclose(scores, np.sort(ref, axis=1)[:, ::-1][:, :7],
                               rtol=1e-5, atol=1e-5)
    s1, i1 = TA.recommend_products(m, 5, 7, exclude=np.array([idx[1, 0]]))
    np.testing.assert_array_equal(i1[:6], idx[1, 1:7])
    assert isinstance(s1, np.ndarray) and torch.is_tensor(m.tables()[0])
