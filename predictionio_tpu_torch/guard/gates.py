"""Pre-swap quality gates: a folded model is published only if it passes.

The port's counterpart of `predictionio_tpu/guard/gates.py` (`GateConfig`,
`GateRejected`, `QualityGatekeeper` with `evaluate` and
`check_publishable`). The online fold has no human between fold and
deploy, so the gatekeeper compares each candidate model with the live
one it would replace and returns a report; the scheduler refuses to
publish on any failure and the registry runs the finiteness gate as its
last line.

Gates (each verdict `pass`/`fail`/`skip` with a detail):

- `finite`         every factor table of the candidate is finite;
- `norm_drift`     the candidate's max row norm of each table within
                   `max(norm_floor, max_norm_ratio x live)`;
- `score_drift`    the scores of a seeded sample of users x items must
                   not shift more than `max_score_shift` live standard
                   deviations nor spread more than
                   `max_score_spread_ratio` of them;
- `golden_queries` queries answered by both models (configured, or for a
                   user-keyed template a seeded sample of its users) keep
                   at least `golden_min_overlap` of the live top-k.

The samples come from `np.random.default_rng(cfg.seed)` drawn as the
reference draws them, so both packages' reports agree number for number
on the same tables. Models are duck-typed: an `ALSModel`, a model with an
`.als`, or a dataclass holding 2-D float numpy tables (similar-product);
a model with none skips the factor gates. Each verdict is counted in
`pio_guard_gate_verdicts_total{gate,verdict}`, and the golden queries'
replays run under the `gates_probe` executable label (`obs/costmon`), so
what a probe costs is not booked to serving.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.guard.sentinels import guard_enabled
from predictionio_tpu_torch.ops.als import ALSModel

logger = logging.getLogger(__name__)


class GateRejected(RuntimeError):
    """A candidate model failed a pre-swap quality gate."""

    def __init__(self, report: dict):
        failed = [g["gate"] for g in report.get("gates", ())
                  if g.get("verdict") == "fail"]
        super().__init__("model publish rejected by quality gate(s): "
                         + (", ".join(failed) or "unknown"))
        self.report = report


@dataclass(frozen=True)
class GateConfig:
    """The gates' knobs (the reference's defaults)."""
    enabled: bool = True
    require_finite: bool = True
    max_norm_ratio: float = 10.0       # candidate vs live max row norm
    norm_floor: float = 1e3            # absolute norm slack near zero
    sample_entities: int = 128         # users x items of the score probe
    max_score_shift: float = 3.0       # |mean shift| in live std units
    max_score_spread_ratio: float = 10.0
    # std floor as a fraction of the live mean magnitude: near-constant
    # live scores must not fail every candidate on a tiny shift
    score_std_floor_frac: float = 0.05
    golden_queries: Tuple[dict, ...] = ()
    golden_min_overlap: float = 0.5    # retained fraction of live top-k
    golden_num: int = 10               # k of the derived queries
    auto_golden: int = 8               # users sampled without a set
    seed: int = 0


def _factor_tables(model) -> Dict[str, np.ndarray]:
    """The 2-D float factor tables a model carries, by attribute name;
    {} for an unknown shape (the factor gates skip, never guess)."""
    if isinstance(model, ALSModel):
        return {"user_factors": model.user_factors,
                "item_factors": model.item_factors}
    als = getattr(model, "als", None)
    if isinstance(als, ALSModel):
        return {"user_factors": als.user_factors,
                "item_factors": als.item_factors}
    return {k: v for k, v in getattr(model, "__dict__", {}).items()
            if isinstance(v, np.ndarray) and v.ndim == 2
            and np.issubdtype(v.dtype, np.floating)}


def _score_pair(tables: Dict[str, np.ndarray]
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(user-like, item-like) tables for the score probe."""
    u = tables.get("user_factors")
    v = tables.get("item_factors")
    if v is None:
        v = tables.get("item_factors_raw")
    if u is None or v is None or u.shape[1] != v.shape[1]:
        return None
    return u, v


def _is_sharded(t) -> bool:
    from predictionio_tpu_torch.parallel.sharded_table import is_sharded
    return is_sharded(t)


def _all_finite(t) -> bool:
    """Finiteness over either layout: a `ShardedTable`'s host shards
    scanned one by one (no device involved), numpy otherwise."""
    if _is_sharded(t):
        return t.all_finite()
    return bool(np.isfinite(t).all())


def _probe_rows(t, idx) -> np.ndarray:
    """Sampled rows for the score probe, from a sharded table's host
    shards or by indexing: the gates run the same statistics over both
    layouts."""
    from predictionio_tpu_torch.parallel.sharded_table import table_rows
    return table_rows(t, idx)


def _max_row_norm(t) -> float:
    if _is_sharded(t):
        return t.max_row_norm()
    if t.size == 0:
        return 0.0
    with np.errstate(over="ignore", invalid="ignore"):
        return float(np.sqrt(np.max(np.einsum("ij,ij->i", t, t))))


def _max_row_norm_cached(model, name: str, t: np.ndarray) -> float:
    """The max row norm of a table, kept on the model object: this
    tick's candidate is the next tick's live model, so a steady tick
    scans only the candidate."""
    memo = getattr(model, "_pio_guard_norms", None)
    if memo is None:
        memo = {}
        try:
            object.__setattr__(model, "_pio_guard_norms", memo)
        except (AttributeError, TypeError):
            memo = None
    if memo is not None and name in memo:
        return memo[name]
    v = _max_row_norm(t)
    if memo is not None:
        memo[name] = v
    return v


def _result_items(result) -> Optional[List[str]]:
    """Ranked item ids of a predict result (an ItemScoreResult or its
    wire dict); None for another shape."""
    scores = getattr(result, "item_scores", None)
    if scores is not None:
        return [s.item for s in scores]
    if isinstance(result, dict) and "itemScores" in result:
        return [s.get("item") for s in result["itemScores"]]
    return None


def _result_scores(result) -> List[float]:
    scores = getattr(result, "item_scores", None)
    if scores is not None:
        return [float(s.score) for s in scores]
    if isinstance(result, dict) and "itemScores" in result:
        return [float(s.get("score", 0.0)) for s in result["itemScores"]]
    return []


class QualityGatekeeper:
    """Runs every configured gate for each (candidate, live) model pair
    and returns `{"passed": bool, "gates": [...]}`."""

    def __init__(self, config: Optional[GateConfig] = None, registry=None):
        self.config = config or GateConfig()
        if registry is None:
            from predictionio_tpu_torch.obs import get_registry
            registry = get_registry()
        self._c_verdicts = registry.counter(
            "pio_guard_gate_verdicts_total",
            "Pre-swap quality-gate verdicts by gate and verdict",
            labelnames=("gate", "verdict"))

    # -- the gates ---------------------------------------------------------
    @staticmethod
    def _gate_finite(cand_tables: Dict[str, np.ndarray]) -> dict:
        if not cand_tables:
            return {"gate": "finite", "verdict": "skip",
                    "detail": "no factor tables"}
        bad = [name for name, t in cand_tables.items()
               if t.size and not _all_finite(t)]
        if bad:
            return {"gate": "finite", "verdict": "fail",
                    "detail": f"non-finite values in {', '.join(bad)}"}
        return {"gate": "finite", "verdict": "pass",
                "detail": f"{len(cand_tables)} table(s) finite"}

    def _gate_norm_drift(self, cand, live, cand_tables,
                         live_tables) -> dict:
        cfg = self.config
        shared = [n for n in cand_tables if n in live_tables]
        if not shared:
            return {"gate": "norm_drift", "verdict": "skip",
                    "detail": "no comparable tables"}
        for name in shared:
            cn = _max_row_norm_cached(cand, name, cand_tables[name])
            ln = _max_row_norm_cached(live, name, live_tables[name])
            bound = max(cfg.norm_floor, cfg.max_norm_ratio * ln)
            if not np.isfinite(cn) or cn > bound:
                return {"gate": "norm_drift", "verdict": "fail",
                        "detail": f"{name} max row norm {cn:.4g} exceeds "
                                  f"bound {bound:.4g}"}
        return {"gate": "norm_drift", "verdict": "pass",
                "detail": f"{len(shared)} table(s) within "
                          f"{cfg.max_norm_ratio:g}x"}

    def _gate_score_drift(self, cand_tables, live_tables) -> dict:
        cfg = self.config
        cand = _score_pair(cand_tables)
        live = _score_pair(live_tables)
        if cand is None or live is None:
            return {"gate": "score_drift", "verdict": "skip",
                    "detail": "no (user, item) factor pair"}
        cu, cv = cand
        lu, lv = live
        nu = min(cu.shape[0], lu.shape[0])
        ni = min(cv.shape[0], lv.shape[0])
        if nu == 0 or ni == 0:
            return {"gate": "score_drift", "verdict": "skip",
                    "detail": "empty shared vocabulary"}
        rng = np.random.default_rng(cfg.seed)
        iu = rng.choice(nu, size=min(cfg.sample_entities, nu),
                        replace=False)
        iv = rng.choice(ni, size=min(cfg.sample_entities, ni),
                        replace=False)
        with np.errstate(over="ignore", invalid="ignore"):
            s_live = _probe_rows(lu, iu) @ _probe_rows(lv, iv).T
            s_cand = _probe_rows(cu, iu) @ _probe_rows(cv, iv).T
        if not np.isfinite(s_cand).all():
            return {"gate": "score_drift", "verdict": "fail",
                    "detail": "candidate probe scores non-finite"}
        live_mean = float(np.mean(s_live))
        live_std = max(float(np.std(s_live)),
                       cfg.score_std_floor_frac * (abs(live_mean) + 1.0),
                       1e-6)
        shift = abs(float(np.mean(s_cand)) - live_mean)
        spread = float(np.std(s_cand))
        if shift > cfg.max_score_shift * live_std:
            return {"gate": "score_drift", "verdict": "fail",
                    "detail": f"mean score shifted {shift:.4g} "
                              f"(> {cfg.max_score_shift:g} x live std "
                              f"{live_std:.4g})"}
        if spread > cfg.max_score_spread_ratio * live_std:
            return {"gate": "score_drift", "verdict": "fail",
                    "detail": f"score spread {spread:.4g} widened past "
                              f"{cfg.max_score_spread_ratio:g} x live "
                              f"std {live_std:.4g}"}
        return {"gate": "score_drift", "verdict": "pass",
                "detail": f"shift {shift:.4g} / spread {spread:.4g} "
                          f"within bounds"}

    def _golden_query_set(self, live_model, algo) -> List[dict]:
        cfg = self.config
        if cfg.golden_queries:
            return list(cfg.golden_queries)
        # a user-keyed template: a seeded sample of its known users
        user_ix = getattr(live_model, "user_ix", None)
        qc = getattr(algo, "query_class", None)
        if user_ix is None or len(user_ix) == 0 or qc is None \
                or "user" not in getattr(qc, "__dataclass_fields__", {}):
            return []
        rng = np.random.default_rng(cfg.seed)
        n = min(cfg.auto_golden, len(user_ix))
        picks = rng.choice(len(user_ix), size=n, replace=False)
        return [{"user": user_ix.id_of(int(ix)), "num": cfg.golden_num}
                for ix in picks]

    def _gate_golden(self, candidate, live, algo) -> dict:
        cfg = self.config
        if algo is None or getattr(algo, "query_class", None) is None:
            return {"gate": "golden_queries", "verdict": "skip",
                    "detail": "no query-capable algorithm"}
        queries = self._golden_query_set(live, algo)
        if not queries:
            return {"gate": "golden_queries", "verdict": "skip",
                    "detail": "no golden queries (configure "
                              "gate_config.golden_queries)"}
        qc = algo.query_class
        worst = 1.0
        compared = 0
        try:
            qs = [qc.from_dict(qd) for qd in queries]
            live_results = self._replay(algo, live, qs)
            cand_results = self._replay(algo, candidate, qs)
        except Exception as e:
            return {"gate": "golden_queries", "verdict": "fail",
                    "detail": f"golden replay raised: {e}"}
        for qd, live_r, cand_r in zip(queries, live_results,
                                      cand_results):
            if any(not np.isfinite(s) for s in _result_scores(cand_r)):
                return {"gate": "golden_queries", "verdict": "fail",
                        "detail": f"non-finite score for {qd!r}"}
            live_items = _result_items(live_r)
            cand_items = _result_items(cand_r)
            if not live_items or cand_items is None:
                continue    # unanswerable on the live model
            compared += 1
            overlap = (len(set(live_items) & set(cand_items))
                       / max(len(live_items), 1))
            worst = min(worst, overlap)
            if overlap < cfg.golden_min_overlap:
                return {"gate": "golden_queries", "verdict": "fail",
                        "detail": f"{qd!r}: top-k overlap {overlap:.2f} "
                                  f"< {cfg.golden_min_overlap:g}"}
        if compared == 0:
            return {"gate": "golden_queries", "verdict": "skip",
                    "detail": "no comparable golden answers"}
        return {"gate": "golden_queries", "verdict": "pass",
                "detail": f"{compared} quer(ies), worst overlap "
                          f"{worst:.2f}"}

    @staticmethod
    def _replay(algo, model, qs) -> List[Any]:
        """Every golden query against one model: one `batch_predict` when
        the algorithm has it, else a predict loop."""
        from predictionio_tpu_torch.obs import costmon
        with costmon.executable(costmon.GATES_PROBE):
            bp = getattr(algo, "batch_predict", None)
            if bp is not None:
                by_ix = dict(bp(model, list(enumerate(qs))))
                return [by_ix.get(i) for i in range(len(qs))]
            return [algo.predict(model, q) for q in qs]

    # -- aggregation -------------------------------------------------------
    def _count(self, gates: Sequence[dict]) -> None:
        for g in gates:
            self._c_verdicts.labels(gate=g["gate"],
                                    verdict=g["verdict"]).inc()

    def evaluate(self, candidates: Sequence[Any], live: Sequence[Any],
                 algorithms: Optional[Sequence[Any]] = None) -> dict:
        """Gate every candidate against its live counterpart. Returns
        `{"passed", "gates"}`; disabled (config or PIO_GUARD), a pass
        with one skip entry."""
        if not self.config.enabled or not guard_enabled():
            return {"passed": True,
                    "gates": [{"gate": "all", "verdict": "skip",
                               "detail": "gates disabled"}]}
        gates: List[dict] = []
        algorithms = list(algorithms or [None] * len(candidates))
        for i, (cand, live_m) in enumerate(zip(candidates, live)):
            if cand is live_m:
                continue    # not refreshed by this publish
            algo = algorithms[i] if i < len(algorithms) else None
            ct = _factor_tables(cand)
            lt = _factor_tables(live_m)
            if self.config.require_finite:
                gates.append(self._gate_finite(ct))
            if gates and gates[-1].get("verdict") == "fail":
                break   # non-finite tables poison every later comparison
            gates.append(self._gate_norm_drift(cand, live_m, ct, lt))
            gates.append(self._gate_score_drift(ct, lt))
            gates.append(self._gate_golden(cand, live_m, algo))
        self._count(gates)
        return {"passed": all(g["verdict"] != "fail" for g in gates),
                "gates": gates}

    def check_publishable(self, models: Sequence[Any]) -> None:
        """The registry's last line: refuse non-finite factor tables even
        with no live model to compare against. Raises `GateRejected`."""
        if not self.config.enabled or not guard_enabled() \
                or not self.config.require_finite:
            return
        gates = [self._gate_finite(_factor_tables(m)) for m in models]
        gates = [g for g in gates if g["verdict"] != "skip"]
        self._count(gates)
        if any(g["verdict"] == "fail" for g in gates):
            raise GateRejected({"passed": False, "gates": gates})
