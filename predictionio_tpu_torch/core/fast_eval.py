"""FastEvalEngine: a params sweep with per-stage memoization.

The port's copy of `predictionio_tpu/core/fast_eval.py` (the reference's
FastEvalEngine.scala: prefix keys :50-83, caches :283-302): a stage whose
params prefix is unchanged reuses its cached result, so a sweep over
algorithm params reads and prepares the data once. `counters` counts
each stage's cache misses (and `serving` every eval).
"""

from __future__ import annotations

import json
from typing import Any, Dict

from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.core.params import params_to_dict


def _key(*parts) -> str:
    def norm(p):
        if isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], str):
            name, params = p
            return [name, params if isinstance(params, dict)
                    else params_to_dict(params)]
        if isinstance(p, (list, tuple)):
            return [norm(x) for x in p]
        return p
    return json.dumps([norm(p) for p in parts], sort_keys=True, default=repr)


class FastEvalEngine(Engine):
    """Drop-in Engine whose batch_eval memoizes per-stage results keyed by
    params prefix. Cache-hit counters are exposed for tests, mirroring
    FastEvalEngineTest's assertions."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._ds_cache: Dict[str, Any] = {}
        self._prep_cache: Dict[str, Any] = {}
        self._algo_cache: Dict[str, Any] = {}
        self.counters = {"dataSource": 0, "preparator": 0, "algorithms": 0,
                         "serving": 0}

    # -- stage getters (FastEvalEngine.scala:85-281) -----------------------
    def _data_source_result(self, ep: EngineParams):
        k = _key(ep.data_source_params)
        if k not in self._ds_cache:
            self.counters["dataSource"] += 1
            ds = self.make_data_source(ep)
            self._ds_cache[k] = ds.read_eval()
        return self._ds_cache[k]

    def _preparator_result(self, ep: EngineParams):
        k = _key(ep.data_source_params, ep.preparator_params)
        if k not in self._prep_cache:
            self.counters["preparator"] += 1
            eval_sets = self._data_source_result(ep)
            prep = self.make_preparator(ep)
            self._prep_cache[k] = [
                (prep.prepare(td), ei, list(qa)) for td, ei, qa in eval_sets]
        return self._prep_cache[k]

    def _algorithms_result(self, ep: EngineParams):
        k = _key(ep.data_source_params, ep.preparator_params,
                 list(ep.algorithm_params_list))
        if k not in self._algo_cache:
            self.counters["algorithms"] += 1
            prepared_sets = self._preparator_result(ep)
            per_set = []
            for pd, ei, qa_list in prepared_sets:
                algorithms = self.make_algorithms(ep)
                models = [a.train(pd) for a in algorithms]
                indexed = list(enumerate(q for q, _ in qa_list))
                per_algo = [dict(a.batch_predict(m, indexed))
                            for a, m in zip(algorithms, models)]
                per_set.append((ei, qa_list, per_algo))
            self._algo_cache[k] = per_set
        return self._algo_cache[k]

    def eval(self, engine_params: EngineParams):
        self.counters["serving"] += 1
        serving = self.make_serving(engine_params)
        out = []
        for ei, qa_list, per_algo in self._algorithms_result(engine_params):
            qpa = []
            for ix, (q, a) in enumerate(qa_list):
                preds = [pa[ix] for pa in per_algo]
                qpa.append((q, serving.serve(q, preds), a))
            out.append((ei, qpa))
        return out

    def clear(self):
        self._ds_cache.clear()
        self._prep_cache.clear()
        self._algo_cache.clear()
