"""Port parity: the example engines (`predictionio_tpu_torch/examples/`)
vs the JAX package's `examples/`, on the CPU (`device="cpu"`).

Tolerances:
- helloworld: exact (host Python on both sides).
- regression: coefficients within 1e-5 of JAX's and of a float64
  `numpy.linalg.lstsq` (both solve an 80 x 3 float32 least squares whose
  coefficients are O(1)), and the same best grid point and MSE within
  1e-8 (the MSE is ~1e-4 and the residuals agree to ~1e-6).
- keyword similarity: exact (sums of small integer weights are exact in
  float32).
- SimRank: within 1e-6 of JAX's and of the float64 fixed point (entries
  lie in [0, 1]; five iterations of two float32 products over a 12-node
  graph), unit diagonal and a symmetric S.
- stock: the indicators exact (the same numpy on both sides); the
  batched OLS within 1e-5 of JAX's and of a float64 solve of the same
  ridged normal equations, relative to the coefficients' scale; the
  walk-forward backtest's daily NAV within 1e-6 relative of JAX's.
- quickstart: each family in a subprocess per package. The answers hold
  the same items, and scores within 2**-10 of their size plus 1e-6 (both
  servers send f16 scores by default: one f16 step of each of two f32
  scores that agree to ~1e-6); the order must match wherever
  neighbouring scores are further apart than that.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from examples import friend_recommendation as JF
from examples import local_engines as JL
from examples import stock_backtesting as JS
from predictionio_tpu.core import EngineParams as JEngineParams
from predictionio_tpu.core import MetricEvaluator as JMetricEvaluator
from predictionio_tpu_torch.core import EngineParams, MetricEvaluator
from predictionio_tpu_torch.examples import friend_recommendation as TF
from predictionio_tpu_torch.examples import local_engines as TL
from predictionio_tpu_torch.examples import stock_backtesting as TS

REPO = pathlib.Path(__file__).resolve().parent.parent
REG_TOL = 1e-5
SIMRANK_TOL = 1e-6
OLS_TOL = 1e-5
NAV_RTOL = 1e-6


# ---------------------------------------------------------------------------
# local engines
# ---------------------------------------------------------------------------

def test_helloworld_is_exact(tmp_path):
    path = tmp_path / "data.csv"
    path.write_text("Mon,75\nTue,80\nWed,70\nMon,65\nSun,50\nTue,81.5\n")
    out = {}
    for pkg, m, EP in (("jax", JL, JEngineParams), ("port", TL,
                                                    EngineParams)):
        tr = m.helloworld_engine().train(EP(
            data_source_params=("", m.HWDataSourceParams(
                filepath=str(path))),
            algorithm_params_list=[("", None)]))
        algo, model = tr.algorithms[0], tr.models[0]
        out[pkg] = [algo.predict(model, {"day": d})
                    for d in ("Mon", "Tue", "Wed", "Sun")]
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"temperature": 70.0}


def test_regression_coefficients_and_grid(tmp_path):
    path = str(tmp_path / "reg.txt")
    TL._write_sample_data(path)
    rows = np.loadtxt(path)
    t_grid = TL.regression_grid(path, device="cpu")
    j_grid = [JEngineParams(
        data_source_params=("", JL.RegDataSourceParams(filepath=path)),
        preparator_params=("", JL.RegPreparatorParams(n=n, k=k)),
        algorithm_params_list=[("", None)]) for n, k in TL.GRID]
    t_eng, j_eng = TL.regression_engine(), JL.regression_engine()
    for tep, jep, (n, k) in zip(t_grid, j_grid, TL.GRID):
        keep = (np.arange(len(rows)) % n != k) if n else \
            np.ones(len(rows), bool)
        ref, *_ = np.linalg.lstsq(rows[keep, 1:], rows[keep, 0],
                                  rcond=None)
        tc = t_eng.train(tep).models[0]
        jc = j_eng.train(jep).models[0]
        assert tc.dtype == np.float64
        np.testing.assert_allclose(tc, jc, rtol=0, atol=REG_TOL)
        np.testing.assert_allclose(tc, ref, rtol=0, atol=REG_TOL)
    t_res = MetricEvaluator(TL.MeanSquareError()).evaluate_base(t_eng,
                                                               t_grid)
    j_res = JMetricEvaluator(JL.MeanSquareError()).evaluate_base(j_eng,
                                                                 j_grid)
    assert t_res.best_idx == j_res.best_idx
    assert t_res.best_score.score == pytest.approx(j_res.best_score.score,
                                                   abs=1e-8)


def test_regression_preparator_drop_rule():
    td = TL.RegTrainingData(x=np.arange(12).reshape(6, 2).astype(float),
                            y=np.arange(6).astype(float))
    out = TL.RegPreparator(TL.RegPreparatorParams(n=3, k=1)).prepare(td)
    ref = JL.RegPreparator(JL.RegPreparatorParams(n=3, k=1)).prepare(
        JL.RegTrainingData(x=td.x, y=td.y))
    np.testing.assert_array_equal(out.y, ref.y)
    np.testing.assert_array_equal(out.x, ref.x)
    np.testing.assert_array_equal(out.y, [0, 2, 3, 5])


# ---------------------------------------------------------------------------
# friend recommendation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def friend_files(tmp_path_factory):
    base = tmp_path_factory.mktemp("friends")
    TF.write_demo_files(str(base))
    return JF.write_demo_files(str(base))


def train(m, EP, files, algo_params):
    dsp = m.FriendDataSourceParams(
        item_file=files.item_file,
        user_keyword_file=files.user_keyword_file,
        user_action_file=files.user_action_file)
    eng = m.keyword_engine() if "Keyword" in type(algo_params).__name__ \
        else m.simrank_engine()
    tr = eng.train(EP(data_source_params=("", dsp),
                      algorithm_params_list=[("", algo_params)]))
    return tr.algorithms[0], tr.models[0]


def test_keyword_scores_are_exact(friend_files):
    ja, jm = train(JF, JEngineParams, friend_files,
                   JF.KeywordSimParams(threshold=4.0))
    ta, tm = train(TF, EngineParams, friend_files,
                   TF.KeywordSimParams(threshold=4.0, device="cpu"))
    users = sorted(tm.user_ids)
    for u in users:
        np.testing.assert_array_equal(ta.score_all_items(tm, u),
                                      ja.score_all_items(jm, u))
    U, I = ta._tables(tm)
    block = TF._user_items(U, I, torch.as_tensor(
        [tm.user_ids[u] for u in users])).numpy()
    np.testing.assert_array_equal(
        block, np.stack([ja.score_all_items(jm, u) for u in users]))
    for u in users + ["nobody"]:
        for i in sorted(tm.item_ids) + ["noitem"]:
            q = TF.FriendQuery(u, i)
            assert ta.predict(tm, q).to_dict() == ja.predict(
                jm, JF.FriendQuery(u, i)).to_dict()


def test_simrank_matches_jax_and_float64(friend_files):
    ja, jm = train(JF, JEngineParams, friend_files, JF.SimRankParams())
    ta, tm = train(TF, EngineParams, friend_files,
                   TF.SimRankParams(device="cpu"))
    assert tm.user_ids == jm.user_ids
    S = tm.scores
    np.testing.assert_allclose(S, jm.scores, rtol=0, atol=SIMRANK_TOL)
    import torch
    td = TF.FriendDataSource(TF.FriendDataSourceParams(
        item_file=friend_files.item_file,
        user_keyword_file=friend_files.user_keyword_file,
        user_action_file=friend_files.user_action_file)).read_training()
    W64 = TF.adjacency(td.edges, len(td.user_ids), "cpu", torch.float64)
    S64 = TF._simrank(W64, 5, 0.8).numpy()
    np.testing.assert_allclose(S, S64, rtol=0, atol=SIMRANK_TOL)
    np.testing.assert_array_equal(np.diag(S), 1.0)
    np.testing.assert_allclose(S, S.T, rtol=0, atol=SIMRANK_TOL)
    assert (S >= 0).all() and (S <= 1).all()
    for a in ("u0", "u1", "u5"):
        for b in ("u2", "u3", "nobody"):
            got = ta.predict(tm, TF.FriendQuery(a, b)).to_dict()
            ref = ja.predict(jm, JF.FriendQuery(a, b)).to_dict()
            assert got["acceptance"] == ref["acceptance"]
            assert got["confidence"] == pytest.approx(ref["confidence"],
                                                      abs=SIMRANK_TOL)


def test_simrank_on_a_symmetric_graph():
    """An undirected graph (every edge both ways): S symmetric, unit
    diagonal, and equal to the JAX fixed point."""
    rng = np.random.default_rng(4)
    n = 40
    pairs = {tuple(sorted(p)) for p in rng.integers(0, n, (120, 2))
             if p[0] != p[1]}
    edges = np.array([(a, b, 1.0) for a, b in pairs]
                     + [(b, a, 1.0) for a, b in pairs], np.float32)
    W = TF.adjacency(edges, n, "cpu")
    S = TF._simrank(W, 5, 0.8).numpy()
    J = np.asarray(JF._simrank(W.numpy(), 5, 0.8))
    np.testing.assert_allclose(S, J, rtol=0, atol=SIMRANK_TOL)
    np.testing.assert_allclose(S, S.T, rtol=0, atol=SIMRANK_TOL)
    np.testing.assert_array_equal(np.diag(S), 1.0)


# ---------------------------------------------------------------------------
# stock backtesting
# ---------------------------------------------------------------------------

def test_indicators_are_exact():
    frame = TS.synthetic_prices(300, 12, seed=2)
    jframe = JS.synthetic_prices(300, 12, seed=2)
    np.testing.assert_array_equal(frame.prices, jframe.prices)
    lp = frame.log_prices
    for tind, jind in ((TS.ShiftReturn(5), JS.ShiftReturn(5)),
                       (TS.EMAReturn(15), JS.EMAReturn(15)),
                       (TS.RSI(14), JS.RSI(14))):
        np.testing.assert_array_equal(tind.compute(lp), jind.compute(lp))


def test_batched_ols_matches_jax_and_float64():
    rng = np.random.default_rng(0)
    N, W, F = 24, 200, 4
    X = rng.normal(size=(N, W, F)).astype(np.float32)
    X[..., -1] = 1.0
    true = rng.normal(size=(N, F))
    y = (np.einsum("nwf,nf->nw", X, true)
         + 0.01 * rng.normal(size=(N, W))).astype(np.float32)
    got = TS._batched_ols(X, y, device="cpu")
    ref = np.asarray(JS._batched_ols(X, y))
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    G = np.einsum("nwf,nwg->nfg", X64, X64) + 1e-6 * np.eye(F)
    f64 = np.linalg.solve(G, np.einsum("nwf,nw->nf", X64, y64)[..., None])
    scale = np.abs(f64[..., 0]).max()
    assert got.dtype == np.float32 and got.shape == (N, F)
    np.testing.assert_allclose(got, ref, rtol=0, atol=OLS_TOL * scale)
    np.testing.assert_allclose(got, f64[..., 0], rtol=0,
                               atol=OLS_TOL * scale)
    # and numpy's float64 least squares per ticker (the 1e-6 ridge moves
    # these well-conditioned fits by far less than the tolerance)
    for n in range(N):
        ls, *_ = np.linalg.lstsq(X64[n], y64[n], rcond=None)
        np.testing.assert_allclose(got[n], ls, rtol=0, atol=OLS_TOL * scale)


def test_walk_forward_backtest_matches_jax():
    frame = TS.synthetic_prices(400, 8, seed=3)
    jframe = JS.synthetic_prices(400, 8, seed=3)
    strat = TS.RegressionStrategy(TS.RegressionStrategyParams(device="cpu"))
    jstrat = JS.RegressionStrategy()
    params = TS.BacktestingParams(enter_threshold=0.0005)
    got = TS.backtest(frame, strat, params, 250, 400)
    ref = JS.backtest(jframe, jstrat,
                      JS.BacktestingParams(enter_threshold=0.0005), 250, 400)
    assert [d.t for d in got.daily] == [d.t for d in ref.daily]
    assert [d.position_count for d in got.daily] == \
        [d.position_count for d in ref.daily]
    np.testing.assert_allclose([d.nav for d in got.daily],
                               [d.nav for d in ref.daily], rtol=NAV_RTOL)
    np.testing.assert_allclose([d.market for d in got.daily],
                               [d.market for d in ref.daily], rtol=0,
                               atol=0)
    for k in ("ret", "vol", "sharpe", "maxDrawdown"):
        assert got.to_dict()[k] == pytest.approx(ref.to_dict()[k],
                                                 rel=NAV_RTOL, abs=1e-12)
    m_t, m_j = strat.train(frame, 300), jstrat.train(jframe, 300)
    scale = np.abs(m_j.coefs).max()
    np.testing.assert_allclose(m_t.coefs, m_j.coefs, rtol=0,
                               atol=OLS_TOL * scale)
    p_t, p_j = strat.predict(m_t, frame, 300), jstrat.predict(m_j, jframe,
                                                              300)
    assert list(p_t) == list(p_j)


def test_an_empty_training_window_is_refused():
    frame = TS.synthetic_prices(100, 4, seed=1)
    with pytest.raises(ValueError, match="empty training window"):
        TS.RegressionStrategy(TS.RegressionStrategyParams(
            device="cpu")).train(frame, 20)


# ---------------------------------------------------------------------------
# the examples' command lines
# ---------------------------------------------------------------------------

def run_module(args, env_extra=None, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               **(env_extra or {}))
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def scores_of(body: dict):
    key = "similarUserScores" if "similarUserScores" in body \
        else "itemScores"
    who = "user" if key == "similarUserScores" else "item"
    return [(s[who], s["score"]) for s in body.get(key, [])]


def tol(s: float) -> float:
    return 2.0 ** -10 * abs(s) + 1e-6


@pytest.mark.parametrize("family", [
    "recommendation", "classification", "similarproduct",
    "ecommercerecommendation", "recommendeduser"])
def test_quickstart_answers_like_the_reference(family, tmp_path):
    port = run_module(["-m", "predictionio_tpu_torch.examples.quickstart",
                       family, "--device", "cpu"],
                      {"TMPDIR": str(tmp_path)})
    jax = run_module(["examples/quickstart.py", family],
                     {"TMPDIR": str(tmp_path)})
    answers = {}
    for pkg, proc in (("port", port), ("jax", jax)):
        out = finish(proc)
        line = [x for x in out.splitlines() if x.startswith("Result ")][-1]
        answers[pkg] = json.loads(line[len("Result "):])
    got, ref = answers["port"], answers["jax"]
    if family == "classification":
        assert got == ref
        return
    g, r = scores_of(got), scores_of(ref)
    assert len(g) == len(r) == 4
    assert sorted(i for i, _ in g) == sorted(i for i, _ in r)
    ref_score = dict(r)
    for item, s in g:
        assert abs(s - ref_score[item]) <= tol(ref_score[item]), (item, s)
    # the order, wherever neighbours are further apart than the tolerance
    for k in range(len(r) - 1):
        if r[k][1] - r[k + 1][1] > 2 * tol(r[k][1]):
            assert {i for i, _ in g[:k + 1]} == {i for i, _ in r[:k + 1]}


@pytest.mark.parametrize("args,want", [
    (["local_engines", "helloworld"], "Mon -> {'temperature': 70.0}"),
    (["local_engines", "regression"], "coefficients: [ 2.  -1.   0.5]"),
    (["friend_recommendation", "simrank"], "'acceptance': True"),
    (["stock_backtesting"], "final NAV over 150 days"),
])
def test_examples_run_as_modules(args, want):
    proc = run_module(["-m", f"predictionio_tpu_torch.examples.{args[0]}",
                       *args[1:], "--device", "cpu"])
    assert want in finish(proc)


def test_examples_default_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.lstsq(np.eye(3), np.ones(3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS._batched_ols(np.ones((1, 4, 2), np.float32),
                        np.ones((1, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TF.adjacency(np.zeros((0, 3), np.float32), 3)
