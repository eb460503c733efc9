"""Stock backtesting engine.

The port's copy of `examples/stock_backtesting.py`, the reference's
experimental scala-stock engine as a behavioral spec
(examples/experimental/scala-stock/src/main/scala/:
RegressionStrategy.scala, a per-ticker OLS of the 1-day-forward log
return on shift/EMA/RSI indicators; BackTestingMetrics.scala, enter and
exit thresholds -> daily position changes -> a NAV series -> overall
return, volatility and sharpe; YahooDataSource.scala supplies [time,
ticker] price frames).

  * The indicators are vectorized over the whole [T, N] log-price frame
    (numpy on the host, as in the reference package).
  * The per-ticker regressions become ONE batched normal-equation solve
    on the device the strategy names: the Gram G = X^T X + 1e-6 I
    [N, F, F] and b = X^T y [N, F] as f32 einsums, then one
    `torch.linalg.solve` over the ticker batch (the reference package's
    is XLA's `jnp.linalg.solve`, not a hand-written kernel).
  * No network data source: a geometric-Brownian synthetic frame
    generator stands in for YahooDataSource.

Usage:
    python -m predictionio_tpu_torch.examples.stock_backtesting \
        [--device cuda|cpu]
"""

import argparse
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# data: [T, N] price frame (YahooDataSource role, synthetic)
# ---------------------------------------------------------------------------


@dataclass
class PriceFrame:
    tickers: Tuple[str, ...]
    prices: np.ndarray         # [T, N] float32, strictly positive
    market: str = "SPY"        # market ticker for the benchmark column

    @property
    def log_prices(self) -> np.ndarray:
        return np.log(self.prices)

    def market_col(self) -> int:
        return self.tickers.index(self.market)


def synthetic_prices(n_days: int = 500, n_tickers: int = 8,
                     seed: int = 0) -> PriceFrame:
    """GBM with per-ticker drift/vol + a market factor."""
    rng = np.random.default_rng(seed)
    tickers = tuple(["SPY"] + [f"T{i}" for i in range(n_tickers - 1)])
    drift = rng.uniform(-0.0002, 0.0008, n_tickers)
    vol = rng.uniform(0.005, 0.02, n_tickers)
    beta = np.concatenate([[1.0], rng.uniform(0.3, 1.5, n_tickers - 1)])
    mkt = rng.standard_normal(n_days) * 0.008
    eps = rng.standard_normal((n_days, n_tickers))
    rets = drift[None, :] + beta[None, :] * mkt[:, None] \
        + vol[None, :] * eps
    prices = 100.0 * np.exp(np.cumsum(rets, axis=0))
    return PriceFrame(tickers, prices.astype(np.float32))


# ---------------------------------------------------------------------------
# indicators (Indicators.scala) — vectorized over the whole frame
# ---------------------------------------------------------------------------


class ShiftReturn:
    """d-day log return: logP[t] - logP[t-d] (getRet in the reference)."""

    def __init__(self, days: int):
        self.days = days
        self.min_window = days

    def compute(self, log_prices: np.ndarray) -> np.ndarray:
        out = np.zeros_like(log_prices)
        out[self.days:] = log_prices[self.days:] - log_prices[:-self.days]
        return out


class EMAReturn:
    """EMA of 1-day log returns over `days` (EMAIndicator role)."""

    def __init__(self, days: int):
        self.days = days
        self.min_window = days

    def compute(self, log_prices: np.ndarray) -> np.ndarray:
        r1 = np.zeros_like(log_prices)
        r1[1:] = np.diff(log_prices, axis=0)
        alpha = 2.0 / (self.days + 1)
        out = np.zeros_like(r1)
        acc = np.zeros(r1.shape[1], r1.dtype)
        for t in range(r1.shape[0]):
            acc = alpha * r1[t] + (1 - alpha) * acc
            out[t] = acc
        return out


class RSI:
    """Relative Strength Index over `days`, scaled to [0, 1]
    (RSIIndicator role)."""

    def __init__(self, days: int = 14):
        self.days = days
        self.min_window = days + 1

    def compute(self, log_prices: np.ndarray) -> np.ndarray:
        r1 = np.zeros_like(log_prices)
        r1[1:] = np.diff(log_prices, axis=0)
        gain = np.maximum(r1, 0.0)
        loss = np.maximum(-r1, 0.0)
        alpha = 1.0 / self.days
        avg_g = np.zeros_like(r1)
        avg_l = np.zeros_like(r1)
        ag = np.zeros(r1.shape[1], r1.dtype)
        al = np.zeros(r1.shape[1], r1.dtype)
        for t in range(r1.shape[0]):
            ag = alpha * gain[t] + (1 - alpha) * ag
            al = alpha * loss[t] + (1 - alpha) * al
            avg_g[t] = ag
            avg_l[t] = al
        rs = avg_g / np.maximum(avg_l, 1e-12)
        return (100.0 - 100.0 / (1.0 + rs)) / 100.0


# ---------------------------------------------------------------------------
# regression strategy (RegressionStrategy.scala): batched OLS on the device
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RegressionStrategyParams:
    indicators: Tuple = (("s5", ShiftReturn(5)), ("s22", ShiftReturn(22)),
                         ("ema15", EMAReturn(15)))
    training_window: int = 200
    device: Optional[str] = None   # None = the card; "cpu" only if asked


@dataclass
class StrategyModel:
    tickers: Tuple[str, ...]
    coefs: np.ndarray          # [N, F+1] per-ticker OLS coefficients


def ols_solve(X, y):
    """The batched normal equations on X's device, in X's dtype:
    X [N, W, F] (bias included), y [N, W] -> coefs [N, F]."""
    import torch
    G = torch.einsum("nwf,nwg->nfg", X, X)
    b = torch.einsum("nwf,nw->nf", X, y)
    G = G + 1e-6 * torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    return torch.linalg.solve(G, b[..., None])[..., 0]


def _batched_ols(X: np.ndarray, y: np.ndarray, device=None) -> np.ndarray:
    """Per-ticker OLS through batched normal equations in f32 on the
    device: every ticker trains in one solve (the reference loops nak's
    LinearRegression per ticker)."""
    import torch
    from predictionio_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    Xd = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    yd = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    return ols_solve(Xd, yd).cpu().numpy()


class RegressionStrategy:
    def __init__(self, params: Optional[RegressionStrategyParams] = None):
        self.params = params or RegressionStrategyParams()
        self._feat_cache: Dict[int, np.ndarray] = {}

    def _features(self, frame: PriceFrame) -> np.ndarray:
        """[T, N, F+1] indicator values + bias column. Features depend
        only on the immutable frame — computed once and cached, so the
        daily predict loop indexes a row instead of re-running every
        indicator over the whole history."""
        cached = self._feat_cache.get(id(frame))
        if cached is not None:
            return cached
        lp = frame.log_prices
        cols = [ind.compute(lp) for _, ind in self.params.indicators]
        feats = np.stack(cols, axis=-1)                  # [T, N, F]
        bias = np.ones(feats.shape[:2] + (1,), feats.dtype)
        out = np.concatenate([feats, bias], axis=-1)
        self._feat_cache = {id(frame): out}              # hold one frame
        return out

    def train(self, frame: PriceFrame, end_t: int) -> StrategyModel:
        """Fit on the window ending at `end_t` (exclusive), regressing
        next-day log return on today's indicators."""
        p = self.params
        lo = max(self._warmup(), end_t - p.training_window)
        if lo >= end_t - 1:
            raise ValueError(
                f"empty training window: end_t={end_t} must exceed the "
                f"indicator warmup ({self._warmup()}) by at least 2")
        feats = self._features(frame)                    # [T, N, F+1]
        lp = frame.log_prices
        r_fwd = np.zeros_like(lp)
        r_fwd[:-1] = lp[1:] - lp[:-1]                    # 1d forward ret
        X = feats[lo:end_t - 1].transpose(1, 0, 2)       # [N, W, F+1]
        y = r_fwd[lo:end_t - 1].transpose(1, 0)          # [N, W]
        return StrategyModel(frame.tickers,
                             _batched_ols(X, y, p.device))

    def predict(self, model: StrategyModel, frame: PriceFrame,
                t: int) -> Dict[str, float]:
        """pValue per ticker: predicted next-day log return at day t."""
        feats = self._features(frame)[t]                 # [N, F+1]
        p = np.einsum("nf,nf->n", feats, model.coefs)
        return dict(zip(model.tickers, p.astype(float)))

    def _warmup(self) -> int:
        return max(ind.min_window for _, ind in self.params.indicators) + 1


# ---------------------------------------------------------------------------
# backtesting (BackTestingMetrics.scala)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BacktestingParams:
    enter_threshold: float = 0.001
    exit_threshold: float = 0.0
    max_positions: int = 3
    init_cash: float = 1_000_000.0


@dataclass
class DailyStat:
    t: int
    nav: float
    ret: float
    market: float
    position_count: int


@dataclass
class BacktestingResult:
    daily: List[DailyStat]
    ret: float                  # overall return over the test range
    vol: float                  # daily return stddev (annualization-free)
    sharpe: float               # mean/std of daily returns
    max_drawdown: float
    days: int

    def to_dict(self) -> dict:
        return {"ret": self.ret, "vol": self.vol, "sharpe": self.sharpe,
                "maxDrawdown": self.max_drawdown, "days": self.days}


def backtest(frame: PriceFrame, strategy: RegressionStrategy,
             params: BacktestingParams, start_t: int, end_t: int,
             retrain_every: int = 20) -> BacktestingResult:
    """Rolling-window walk-forward: retrain every `retrain_every` days,
    daily enter/exit by thresholds (sorted by pValue, reference
    evaluateUnit), equal-weight cash allocation capped at max_positions,
    NAV marked to market daily (reference evaluateAll)."""
    prices = frame.prices
    mkt = frame.market_col()
    cash = params.init_cash
    positions: Dict[int, float] = {}        # ticker col -> share count
    col_of = {t: i for i, t in enumerate(frame.tickers)}
    daily: List[DailyStat] = []
    model = None
    prev_nav = params.init_cash
    peak = params.init_cash
    max_dd = 0.0
    for t in range(start_t, end_t):
        if model is None or (t - start_t) % retrain_every == 0:
            model = strategy.train(frame, t)
        pvals = strategy.predict(model, frame, t)
        ranked = sorted(pvals.items(), key=lambda kv: -kv[1])
        to_enter = [k for k, v in ranked if v >= params.enter_threshold
                    and k != frame.market]
        to_exit = {k for k, v in pvals.items()
                   if v <= params.exit_threshold}
        # exits first (at today's price)
        for tic in list(positions):
            if frame.tickers[tic] in to_exit:
                cash += positions.pop(tic) * prices[t, tic]
        # enters: equal share of remaining cash across free slots
        free = params.max_positions - len(positions)
        candidates = [col_of[k] for k in to_enter
                      if col_of[k] not in positions][:free]
        if candidates and cash > 0:
            per = cash / len(candidates)
            for tic in candidates:
                positions[tic] = per / prices[t, tic]
            cash = 0.0
        nav = cash + sum(sh * prices[t, tic]
                         for tic, sh in positions.items())
        ret = nav / prev_nav - 1.0
        market = (prices[t, mkt] / prices[t - 1, mkt] - 1.0) if t else 0.0
        daily.append(DailyStat(t=t, nav=float(nav), ret=float(ret),
                               market=float(market),
                               position_count=len(positions)))
        peak = max(peak, nav)
        max_dd = max(max_dd, 1.0 - nav / peak)
        prev_nav = nav
    rets = np.array([d.ret for d in daily[1:]])
    vol = float(rets.std()) if len(rets) else 0.0
    sharpe = float(rets.mean() / vol) if vol > 0 else 0.0
    return BacktestingResult(
        daily=daily, ret=float(prev_nav / params.init_cash - 1.0),
        vol=vol, sharpe=sharpe, max_drawdown=float(max_dd),
        days=len(daily))


def main(device=None):
    frame = synthetic_prices(n_days=400, n_tickers=8, seed=3)
    strategy = RegressionStrategy(RegressionStrategyParams(device=device))
    result = backtest(frame, strategy,
                      BacktestingParams(enter_threshold=0.0005),
                      start_t=250, end_t=400)
    print("backtest:", result.to_dict())
    print(f"final NAV over {result.days} days; "
          f"daily sharpe {result.sharpe:.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    main(ap.parse_args().device)
