"""Port parity: ALS with the Schulz solver, bf16 compute and sweep-chunk
merging in predictionio_tpu_torch.ops.als vs the JAX reference (one-device
mesh, so the solve plans are identical).

Tolerances are computed per case from the port's own rounding reading:
max(1e-4, 4x the largest factor difference between the port's train in
float32 and the same train in float64, over the largest factor), the rule
of the other parity tests. With bf16 compute the float64 train rounds the
same operands to bf16 and back, so the reading is what the order of the
float32 sums moves through the bf16 roundings (scripts/torch_als_rounding.py
prints these readings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.guard.sentinels import NumericalFault as JFault
from predictionio_tpu.ops import als as JA
from predictionio_tpu.ops.ratings import RatingsCOO as JCOO
from predictionio_tpu.ops.ratings import plan_for_items as j_plan_items
from predictionio_tpu.ops.ratings import plan_for_users as j_plan_users
from predictionio_tpu.parallel.mesh import make_mesh
from predictionio_tpu_torch.data.synthetic import (small_ratings,
                                                   synthetic_ml20m)
from predictionio_tpu_torch.guard.sentinels import NumericalFault
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.models import similarproduct as sp
from predictionio_tpu_torch.ops import als as TA
from predictionio_tpu_torch.ops import solve as TS
from predictionio_tpu_torch.ops.ratings import RatingsCOO as TCOO
from predictionio_tpu_torch.ops.ratings import (dedup_ratings,
                                                plan_for_items,
                                                plan_for_users)

RANK = 16
TOL_FLOOR = 1e-4
ROUNDING_FACTOR = 4


def mesh1():
    return make_mesh(jax.devices()[:1])


def spread(m, ref) -> float:
    """max |m - ref| over max |ref|, across both factor tables."""
    return max(float(np.abs(a.astype(np.float64) - b).max()
                     / np.abs(b).max())
               for a, b in ((m.user_factors, ref.user_factors),
                            (m.item_factors, ref.item_factors)))


def train_both(data, **kw):
    """(reference model, port model, tolerance) for one configuration."""
    ui, ii, vv, n_u, n_i = data
    kw = {**dict(rank=RANK, iterations=3, seed=2, work_budget=512), **kw}
    mj = JA.als_train(JCOO(ui, ii, vv, n_u, n_i), JA.ALSConfig(**kw),
                      mesh=mesh1())
    r = TCOO(ui, ii, vv, n_u, n_i)
    mt = TA.als_train(r, TA.ALSConfig(**kw), device="cpu")
    m64 = TA.als_train(r, TA.ALSConfig(dtype="float64", **kw), device="cpu")
    return mj, mt, max(TOL_FLOOR, ROUNDING_FACTOR * spread(mt, m64))


@pytest.mark.parametrize("lam,cd", [(0.1, "float32"), (0.1, "bfloat16"),
                                    (0.01, "float32")])
def test_explicit_schulz_train_matches_reference(lam, cd):
    """Both routes (primal K >= 16, Woodbury dual K < 16) through the
    plain Schulz solve, the primal at `compute_dtype`, the dual at bf16."""
    mj, mt, tol = train_both(small_ratings(), solver="schulz", lam=lam,
                             compute_dtype=cd)
    assert mt.user_factors.dtype == np.float32
    assert spread(mt, mj) <= tol


def test_explicit_bf16_schulz_diverges_like_the_reference(tmp_env,
                                                          monkeypatch):
    """At lam 0.01 this small rank-16 data gives primal systems too
    ill-conditioned for bf16 products (bf16's relative rounding, 2^-9,
    exceeds their lambda_min / ||A||): the reference's Schulz iteration
    diverges and its sentinel raises on iteration 0, and so does the
    port's. (At the ML-20M shape, rank 200, the same configuration stays
    finite on the card.) The reference's flight record goes to
    `tmp_env`'s store; its incident bundle, written by a thread that may
    outlive the test, is turned off."""
    monkeypatch.setenv("PIO_INCIDENTS", "off")
    data = small_ratings()
    kw = dict(rank=RANK, iterations=3, seed=2, work_budget=512,
              solver="schulz", lam=0.01, compute_dtype="bfloat16")
    with pytest.raises(JFault):
        JA.als_train(JCOO(*data), JA.ALSConfig(**kw), mesh=mesh1())
    with pytest.raises(NumericalFault):
        TA.als_train(TCOO(*data), TA.ALSConfig(**kw), device="cpu")


def test_implicit_schulz_train_matches_reference():
    """Implicit ALS, bf16 compute, through the eig-SMW dual and the primal,
    every solve by the plain Schulz solve."""
    mj, mt, tol = train_both(small_ratings(), solver="schulz", lam=0.01,
                             implicit_prefs=True, alpha=1.0,
                             compute_dtype="bfloat16")
    assert spread(mt, mj) <= tol


def test_solver_iters_none_reaches_each_solver_as_its_default(monkeypatch):
    """The primal Schulz solve runs its own 18 steps (not CG's 48) at the
    train's compute dtype; the dual runs K+8 steps at bf16 whatever the
    train's compute dtype, as the reference's `_dual_system_solve` does;
    a primal CG solve still runs 48."""
    calls = []

    def spy(name, real):
        def fn(A, b, iters, *rest):
            calls.append((name, A.shape[-1], iters, *rest))
            return real(A, b, iters, *rest)
        return fn

    monkeypatch.setattr(TS, "schulz_solve", spy("schulz", TS.schulz_solve))
    monkeypatch.setattr(TS, "cg_solve", spy("cg", TS.cg_solve))
    r = TCOO(*small_ratings())
    for solver in ("schulz", "cg"):
        TA.als_train(r, TA.ALSConfig(rank=RANK, iterations=1, lam=0.1,
                                     work_budget=512, solver=solver),
                     device="cpu")
    primal = [c for c in calls if c[1] == RANK]
    dual = [c for c in calls if c[1] < RANK]
    assert primal and dual
    assert {c for c in primal if c[0] == "schulz"} == {
        ("schulz", RANK, 18, "float32")}
    assert {c[:3] for c in primal if c[0] == "cg"} == {("cg", RANK, 48)}
    for name, K, iters, *rest in dual:
        assert iters == K + 8
        assert rest == (["bfloat16"] if name == "schulz" else [])


# ---------------------------------------------------------------------------
# bf16 normal equations in isolation (Cholesky solve, so only the Gram
# rounding differs from the f32 equations)
# ---------------------------------------------------------------------------

def batch_cases():
    ui, ii, vv, n_u, n_i = small_ratings()
    plan = plan_for_users(TCOO(ui, ii, vv, n_u, n_i), work_budget=512)
    primal = next(b for b in plan.batches if b.shape[1] >= RANK)
    dual = max((b for b in plan.batches if b.shape[1] < RANK),
               key=lambda b: b.shape[0])
    return n_i, primal, dual


def reference_rows(batch, V, gram, implicit, lam, alpha):
    out = JA._solve_batch(
        jnp.zeros((batch.rows.size + 1, RANK), jnp.float32), jnp.asarray(V),
        gram, jnp.where(batch.rows >= 0, jnp.arange(batch.rows.size), -1),
        batch.idx, batch.val, batch.mask, np.float32(lam),
        np.float32(alpha), nratings_reg=True, implicit=implicit, rank=RANK,
        compute_dtype="bfloat16", solver="cholesky")
    return np.asarray(out)[:-1][batch.rows >= 0]


def port_rows(batch, V, gram, implicit, lam, alpha, cd, dtype):
    args = (torch.from_numpy(batch.idx).long(),
            torch.from_numpy(batch.val).to(dtype),
            torch.from_numpy(batch.mask).to(dtype), lam)
    Vt = torch.from_numpy(V).to(dtype)
    if implicit:
        G, w, Q = (torch.tensor(np.asarray(t), dtype=dtype) for t in gram)
        kind, A, rhs, to_rows = TA.implicit_equations(
            Vt, (G, w, Q), *args, alpha, RANK, compute_dtype=cd)
    else:
        kind, A, rhs, to_rows = TA.normal_equations(Vt, *args, RANK,
                                                    compute_dtype=cd)
    x = to_rows(TS.cholesky_solve(A, rhs)).numpy()
    return kind, x[batch.rows >= 0]


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("route", ["primal", "dual"])
def test_bf16_equations_match_reference_solve_batch(implicit, route):
    """The port's bf16 normal equations (explicit; implicit primal and
    eig-SMW dual, on the same G, w, Q) solved by Cholesky against the
    reference's `_solve_batch(solver='cholesky', compute_dtype=bf16)`.
    The check sees the rounding: the f32 equations' rows miss the bf16
    ones by more than 10 tolerances."""
    n_i, primal, dual = batch_cases()
    batch = primal if route == "primal" else dual
    V = (np.abs(np.random.default_rng(4).standard_normal((n_i + 1, RANK)))
         / 2).astype(np.float32)
    gram = JA._gram_eig_impl(V[:n_i]) if implicit else None
    lam, alpha = 0.1, 2.0
    kind, x = port_rows(batch, V, gram, implicit, lam, alpha, "bfloat16",
                        torch.float32)
    assert kind == route
    _, x64 = port_rows(batch, V, gram, implicit, lam, alpha, "bfloat16",
                       torch.float64)
    tol = max(TOL_FLOOR, ROUNDING_FACTOR * float(
        np.abs(x - x64).max() / np.abs(x64).max()))
    ref = reference_rows(batch, V, gram, implicit, lam, alpha)
    assert np.abs(x - ref).max() <= tol * np.abs(ref).max()
    _, x32 = port_rows(batch, V, gram, implicit, lam, alpha, "float32",
                       torch.float32)
    assert np.abs(x32 - ref).max() > 10 * tol * np.abs(ref).max()


# ---------------------------------------------------------------------------
# sweep_chunk
# ---------------------------------------------------------------------------

CHUNK_BUDGET = 64     # small enough that shapes repeat (up to 24 times)


def test_merge_batches_groups_as_the_reference_upload_plan():
    """At chunk 4 the port's merged batches are, in order, the scan steps
    of the reference's `_upload_plan(mesh, plan, 4)`: the same rows,
    indices, ratings and masks. The plans hold shapes that repeat 1 to 24
    times, so full chunks, a chunk of fewer than 4 and remainders all
    occur."""
    data = small_ratings()
    for j_plan, t_plan in ((j_plan_users, plan_for_users),
                           (j_plan_items, plan_for_items)):
        jp = j_plan(JCOO(*data), work_budget=CHUNK_BUDGET)
        groups = JA._upload_plan(mesh1(), jp, 4)
        steps = [tuple(np.asarray(t[n]) for t in g) for g in groups
                 for n in range(g[0].shape[0])]
        merged = TA.merge_batches(t_plan(TCOO(*data),
                                         work_budget=CHUNK_BUDGET), 4)
        assert len(merged) == len(steps) < len(jp.batches)
        for ours, theirs in zip(merged, steps):
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)


def test_merge_batches_remainder_rule():
    """n same-shape batches at chunk c: m = min(c, n) per merge, and the
    n mod m left over stay batches of their own."""
    plan = plan_for_users(TCOO(*small_ratings()), work_budget=CHUNK_BUDGET)
    by_shape = {}
    for b in plan.batches:
        by_shape.setdefault(b.shape, []).append(b)
    assert {len(v) for v in by_shape.values()} >= {1, 4, 5, 6}
    want = []
    for B, K in sorted(by_shape):
        n = len(by_shape[(B, K)])
        m = min(4, n)
        want += [(m * B, K)] * (n // m) + [(B, K)] * (n % m)
    assert [b[1].shape for b in TA.merge_batches(plan, 4)] == want
    assert TA.merge_batches(plan, 1)[0][0] is plan.batches[0].rows


@pytest.mark.parametrize("solver,cd", [("cholesky", "float32"),
                                       ("schulz", "bfloat16")])
def test_sweep_chunk_changes_calls_not_factors(solver, cd):
    """Merging changes only how many solver calls there are: the factors
    at chunk 4 equal those at chunk 1 exactly (each system's arithmetic
    is the same), and `solver_calls` counts the merged calls, the
    reference's scan steps."""
    data = small_ratings()
    kw = dict(rank=RANK, iterations=2, lam=0.1, seed=2,
              work_budget=CHUNK_BUDGET, solver=solver, compute_dtype=cd)
    r = TCOO(*data)
    tel1, tel4 = {}, {}
    m1 = TA.als_train(r, TA.ALSConfig(**kw), device="cpu", telemetry=tel1)
    m4 = TA.als_train(r, TA.ALSConfig(sweep_chunk=4, **kw), device="cpu",
                      telemetry=tel4)
    np.testing.assert_array_equal(m1.user_factors, m4.user_factors)
    np.testing.assert_array_equal(m1.item_factors, m4.item_factors)
    steps = sum(g[0].shape[0] for plan in (
        j_plan_users(JCOO(*data), work_budget=CHUNK_BUDGET),
        j_plan_items(JCOO(*data), work_budget=CHUNK_BUDGET))
        for g in JA._upload_plan(mesh1(), plan, 4))
    assert tel4["solver_calls"] == 2 * steps < tel1["solver_calls"]


def test_resolve_sweep_chunk_and_config_checks():
    assert TA.resolve_sweep_chunk(0) == 1
    assert TA.resolve_sweep_chunk(4) == 4
    with pytest.raises(ValueError, match="sweep_chunk"):
        TA.ALSConfig(sweep_chunk=-1)
    with pytest.raises(ValueError, match="compute_dtype"):
        TA.ALSConfig(compute_dtype="float16")


@pytest.mark.parametrize("module", [rec, sp])
def test_template_params_reach_the_train(module, monkeypatch):
    """compute_dtype None means float32 (the reference's answer off the
    TPU); a named dtype and sweep_chunk pass through to ALSConfig."""
    seen = []

    def fake_train(coo, cfg, device=None, telemetry=None):
        seen.append(cfg)
        raise RuntimeError("stop")

    monkeypatch.setattr(module, "als_train", fake_train)
    ui, ii, vv, n_u, n_i = small_ratings()
    for params in (module.ALSAlgorithmParams(),
                   module.ALSAlgorithmParams(compute_dtype="bfloat16",
                                             sweep_chunk=4,
                                             solver="schulz_cuda")):
        algo = module.ALSAlgorithm(params)
        if module is rec:
            pd = rec.PreparedData(TCOO(ui, ii, vv, n_u, n_i), None, None)
        else:
            pd = sp.PreparedData(sp.TrainingData(
                users={}, items={"0": sp.Item()},
                view_events=rec.RatingsData(ui.astype(str), ii.astype(str),
                                            vv)))
        with pytest.raises(RuntimeError, match="stop"):
            algo.train(pd)
    assert [(c.compute_dtype, c.sweep_chunk, c.solver) for c in seen] == [
        ("float32", 0, "auto"), ("bfloat16", 4, "schulz_cuda")]


@pytest.fixture(scope="module")
def ml20m_plans():
    """The headline shape's solve plans, built once for this module:
    synthetic ML-20M, `latest` dedup, work budget 1M (~11 s, ~2 GB)."""
    n_users, n_items = 138_493, 26_744
    u, i, v = synthetic_ml20m(n_users, n_items, 20_000_000, seed=0)
    # every id occurs, so the preparator's sorted vocabularies are the
    # identity and its indices are the ids themselves
    assert np.bincount(i, minlength=n_items).min() > 0
    ui, ii, vals = dedup_ratings(u, i, v, None, "latest")
    coo = TCOO(ui, ii, vals, n_users, n_items)
    return (coo, plan_for_users(coo, work_budget=1 << 20),
            plan_for_items(coo, work_budget=1 << 20))


def test_ml20m_plan_has_98_distinct_shapes_per_iteration(ml20m_plans):
    """The headline shape (synthetic ML-20M, `latest` dedup, work budget
    1M): 33 user-side and 65 item-side batches, every one of its own
    shape, so `sweep_chunk=4` merges nothing there and the Schulz path
    makes 98 solver calls per iteration. The shapes chip_smoke.py holds
    the Schulz kernel at are the path's own."""
    coo, pu, pi = ml20m_plans
    assert coo.nnz == 11_305_133
    assert (len(pu.batches), len(pi.batches)) == (33, 65)
    shapes = [b.shape for b in pu.batches + pi.batches]
    assert len(set(shapes)) == 98
    assert len(TA.merge_batches(pu, 4)) + len(TA.merge_batches(pi, 4)) == 98
    assert {(4375, 8), (5957, 176)} <= set(shapes)
    assert next(b.shape for b in pi.batches if b.shape[1] >= 200) == (960,
                                                                       208)
    assert max((b.shape for b in pi.batches if b.shape[1] < 200),
               key=lambda s: s[0]) == (2966, 48)


def test_chip_smoke_schulz_shapes_are_the_path_duals(ml20m_plans):
    """Every (K, B) at which chip_smoke.py holds the Schulz kernel is a
    dual batch of the ML-20M plan (K < rank 200), and they include the
    two batches that carry half of the Schulz path's flops, (5,957, 176)
    and (6,778, 144), by 4 steps R^3 per system with K + 8 steps."""
    import chip_smoke
    _, pu, pi = ml20m_plans
    duals = {(b.shape[1], b.shape[0]) for b in pu.batches + pi.batches
             if b.shape[1] < chip_smoke.RANK}
    held = set(chip_smoke.SCHULZ_DUAL_SHAPES)
    assert held <= duals
    assert {(176, 5957), (144, 6778)} <= held

    def flops(K, B, steps):
        return 4 * steps * K ** 3 * B

    R = chip_smoke.RANK   # a primal batch (K >= R) solves R x R systems
    total = sum(flops(R, B, chip_smoke.SCHULZ_STEPS) if K >= R
                else flops(K, B, K + 8)
                for B, K in (b.shape for b in pu.batches + pi.batches))
    top2 = flops(176, 5957, 184) + flops(144, 6778, 152)
    assert 0.45 < top2 / total < 0.55, top2 / total
