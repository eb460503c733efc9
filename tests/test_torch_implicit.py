"""Port parity: implicit (Hu-Koren) ALS in predictionio_tpu_torch.ops.als
vs the JAX reference on a one-device mesh (batch_multiple=1 on both
sides, so the solve plans are identical).

The data is `small_ratings()` read as view counts (1..5 per pair), rank
16, so both the primal (K >= rank) and the eig-SMW dual (K < rank) routes
occur on both sides. The port trains with solver 'chol_cuda' on the CPU,
which takes the plain blocked Cholesky (`chol_solve`), against the
reference's 'chol_blocked'; and with 'cholesky' against the reference's
'cholesky'.

Tolerance: factors within 1.5e-5 of the largest factor magnitude. The
port's own implicit train in f32 vs f64 on the CPU differs by up to
3.7e-6 of it (scripts/torch_als_rounding.py, the `implicit` lines), so
1.5e-5 is 4x that reading, the rule the explicit parity tests follow.
"""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.als import ALSConfig as JConfig
from predictionio_tpu.ops.als import als_train as j_train
from predictionio_tpu.ops.ratings import RatingsCOO as JCOO
from predictionio_tpu.ops.ratings import plan_for_items, plan_for_users
from predictionio_tpu.parallel.mesh import make_mesh
from predictionio_tpu_torch.data.synthetic import small_ratings
from predictionio_tpu_torch.ops import als as TA
from predictionio_tpu_torch.ops import solve as TS
from predictionio_tpu_torch.ops.ratings import RatingsCOO as TCOO

RANK = 16
FACTOR_TOL = 1.5e-5


@pytest.fixture(scope="module")
def counts():
    ui, ii, vv, n_u, n_i = small_ratings()
    r = JCOO(ui, ii, vv, n_u, n_i)
    for plan in (plan_for_users(r, work_budget=512),
                 plan_for_items(r, work_budget=512)):
        ks = {b.shape[1] for b in plan.batches}
        assert min(ks) < RANK <= max(ks), ks   # both routes are exercised
    return ui, ii, vv, n_u, n_i


def with_negatives(data):
    """Every fifth pair a dislike (-count): confidence with preference 0."""
    ui, ii, vv, n_u, n_i = data
    vv = vv.copy()
    vv[::5] *= -1
    return ui, ii, vv, n_u, n_i


def train_both(data, j_solver, t_solver, **kw):
    ui, ii, vv, n_u, n_i = data
    kw = {**dict(rank=RANK, iterations=3, lam=0.01, seed=2,
                 work_budget=512, implicit_prefs=True, alpha=1.0), **kw}
    mj = j_train(JCOO(ui, ii, vv, n_u, n_i),
                 JConfig(solver=j_solver, compute_dtype="float32", **kw),
                 mesh=make_mesh(jax.devices()[:1]))
    mt = TA.als_train(TCOO(ui, ii, vv, n_u, n_i),
                      TA.ALSConfig(solver=t_solver, **kw), device="cpu")
    return mj, mt


def assert_factors_close(mj, mt, tol=FACTOR_TOL):
    for a, b in ((mj.user_factors, mt.user_factors),
                 (mj.item_factors, mt.item_factors)):
        assert a.shape == b.shape and b.dtype == np.float32
        assert np.abs(a - b).max() <= tol * np.abs(a).max()


@pytest.mark.parametrize("negatives", [False, True])
@pytest.mark.parametrize("scaling", ["nratings", "constant"])
def test_implicit_train_through_the_cholesky_kernel_path(counts, negatives,
                                                         scaling):
    data = with_negatives(counts) if negatives else counts
    before = TS.COUNTS.chol_solve_plain
    mj, mt = train_both(data, "chol_blocked", "chol_cuda",
                        lambda_scaling=scaling)
    assert TS.COUNTS.chol_solve_plain > before
    assert_factors_close(mj, mt)


@pytest.mark.parametrize("negatives", [False, True])
def test_implicit_train_with_lapack_cholesky(counts, negatives):
    data = with_negatives(counts) if negatives else counts
    assert_factors_close(*train_both(data, "cholesky", "cholesky"))


@pytest.mark.parametrize("alpha", [0.5, 5.0])
def test_implicit_train_other_alpha(counts, alpha):
    assert_factors_close(*train_both(counts, "chol_blocked", "chol_cuda",
                                     alpha=alpha))


def test_every_solve_goes_to_the_named_solver(counts):
    """solver_calls counts every batch of both half-sweeps; on the CPU
    each one is a call of the plain Cholesky (the kernel on the card)."""
    ui, ii, vv, n_u, n_i = counts
    r = TCOO(ui, ii, vv, n_u, n_i)
    TS.COUNTS.reset()
    tel = {}
    TA.als_train(r, TA.ALSConfig(rank=RANK, iterations=2, work_budget=512,
                                 implicit_prefs=True, solver="chol_cuda"),
                 device="cpu", telemetry=tel)
    n_batches = (len(plan_for_users(r, work_budget=512).batches)
                 + len(plan_for_items(r, work_budget=512).batches))
    assert tel["solver_calls"] == 2 * n_batches
    assert TS.COUNTS.chol_solve_plain == tel["solver_calls"]
    assert TS.COUNTS.cg_solve_plain == TS.COUNTS.cg_solve == 0
    assert len(tel["iter_s"]) == 2


@pytest.mark.parametrize("negatives", [False, True])
def test_eig_smw_dual_equals_the_primal_system(counts, negatives):
    """The dual route is exact algebra: on a K < rank batch it gives the
    rows a direct solve of the primal implicit system gives, in f64."""
    ui, ii, vv, n_u, n_i = with_negatives(counts) if negatives else counts
    plan = plan_for_users(TCOO(ui, ii, vv, n_u, n_i), work_budget=512)
    batch = next(b for b in plan.batches if b.shape[1] < RANK)
    rng = np.random.default_rng(0)
    V = torch.from_numpy(rng.standard_normal((n_i, RANK)) / 4)
    gram = TA.gram_eig(V)
    args = (V, gram, torch.from_numpy(batch.idx).long(),
            torch.from_numpy(batch.val).double(),
            torch.from_numpy(batch.mask).double(), 0.01, 2.0)
    kind, M, rhs, to_rows = TA.implicit_equations(*args, rank=RANK)
    assert kind == "dual" and M.shape[1] == batch.shape[1]
    x_dual = to_rows(TS.cholesky_solve(M, rhs))
    kind, A, b, _ = TA.implicit_equations(*args, rank=batch.shape[1])
    assert kind == "primal" and A.shape[1] == RANK
    torch.testing.assert_close(x_dual, TS.cholesky_solve(A, b), rtol=0,
                               atol=1e-10)


def test_gram_uses_the_real_rows_only(counts, monkeypatch):
    """The dummy tail row (the scatter target of padding) never enters G,
    and the Grams alternate V (before the user sweep), U (before the item
    sweep)."""
    ui, ii, vv, n_u, n_i = counts
    F = torch.randn(n_i, RANK, dtype=torch.float64)
    G, w, Q = TA.gram_eig(F)
    torch.testing.assert_close(G, F.T @ F)
    torch.testing.assert_close(Q @ torch.diag(w) @ Q.T, G)
    rows = []
    real = TA.gram_eig
    monkeypatch.setattr(TA, "gram_eig",
                        lambda f: rows.append(f.shape[0]) or real(f))
    m = TA.als_train(TCOO(ui, ii, vv, n_u, n_i),
                     TA.ALSConfig(rank=RANK, iterations=2, work_budget=512,
                                  implicit_prefs=True, solver="chol_cuda"),
                     device="cpu")
    assert rows == [n_i, n_u, n_i, n_u]
    assert np.isfinite(m.user_factors).all()
    assert m.user_factors.shape == (n_u, RANK)
