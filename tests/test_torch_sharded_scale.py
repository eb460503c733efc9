"""A vocabulary past one logical device's table budget, trained, folded
over several ticks and served only because its tables are model-sharded
(the JAX package's `tests/test_sharded_scale.py` scenario, cut to a size
the tier-1 run affords): the replicated upload and the replicated fold
refuse the budget in both packages; the sharded train holds one shard
per logical device under it and matches the JAX package's sharded train
within 1e-4 of the largest factor (lam = 0.1, both CG); steady fold
ticks move only their touched-row plans to the device; the table gauge
reads 1/N of the padded tables; and the served top-k is the host
ranking's (scores within 1e-5).
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as JA
from predictionio_tpu.ops.ratings import RatingsCOO as JCOO
from predictionio_tpu.parallel.mesh import make_mesh as j_make_mesh
from predictionio_tpu.utils import device_cache as JC
from predictionio_tpu_torch.compile.buckets import bucket_rows
from predictionio_tpu_torch.obs import torchmon
from predictionio_tpu_torch.online.fold_in import FoldInConfig, fold_in_coo
from predictionio_tpu_torch.ops import als as TA
from predictionio_tpu_torch.ops.ratings import RatingsCOO as TCOO
from predictionio_tpu_torch.parallel.mesh import model_mesh
from predictionio_tpu_torch.utils import device_cache
from predictionio_tpu_torch.utils.device_cache import TableBudgetExceeded

N_USERS = 400
N_ITEMS = 8000
RANK = 8
NNZ = 12_000
SHARDS = 4
# the item table: 8000 x 8 x 4 B = 256,000 B logical, 262,144 B at its
# 8192-row bucket; a 4-way shard holds 65,536 B
BUDGET = 128 * 1024
FACTOR_TOL = 1e-4
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(1234)
    return (rng.integers(0, N_USERS, NNZ).astype(np.int32),
            rng.integers(0, N_ITEMS, NNZ).astype(np.int32),
            rng.uniform(1, 5, NNZ).astype(np.float32), N_USERS, N_ITEMS)


def test_train_fold_serve_past_one_devices_budget(corpus, monkeypatch,
                                                  mesh8):
    monkeypatch.setenv("PIO_TABLE_BUDGET_BYTES", str(BUDGET))
    big = np.zeros((N_ITEMS, RANK), dtype=np.float32)
    with pytest.raises(JC.TableBudgetExceeded):
        JC.cached_put_rows(big, bucket_rows(N_ITEMS))
    with pytest.raises(TableBudgetExceeded):
        device_cache.cached_put_rows(big, bucket_rows(N_ITEMS), "cpu")
    del big

    kw = dict(rank=RANK, iterations=2, seed=9, lam=0.1,
              factor_sharding="model", keep_sharded=True)
    model = TA.als_train(TCOO(*corpus), TA.ALSConfig(solver="cg", **kw),
                         device="cpu", mesh=model_mesh(SHARDS, "cpu"))
    V = model.item_factors
    assert V.n_shards == SHARDS
    assert V.per_shard_nbytes <= BUDGET < V.nbytes
    ref = JA.als_train(JCOO(*corpus), JA.ALSConfig(**kw),
                       j_make_mesh(model_parallelism=SHARDS))
    for got, want in ((model.user_factors, ref.user_factors),
                      (V, ref.item_factors)):
        w = want.to_numpy()
        assert np.abs(got.to_numpy() - w).max() <= \
            FACTOR_TOL * np.abs(w).max()

    # a replicated fold of the same tables refuses the budget
    replicated = TA.ALSModel(model.user_factors.to_numpy(), V.to_numpy(),
                             RANK, torch.device("cpu"))
    with pytest.raises(TableBudgetExceeded):
        fold_in_coo(replicated, TCOO(*corpus), [0], [0], FoldInConfig(),
                    device="cpu")

    cfg = FoldInConfig(sweeps=1, factor_sharding="model")
    rng = np.random.default_rng(77)
    table_bytes = (model.user_factors.padded_rows + V.padded_rows) \
        * RANK * 4
    cur, plan_h2d = model, []
    for tick in range(5):
        tu = rng.integers(0, N_USERS, 24)
        ti = rng.integers(0, N_ITEMS, 32)
        h0 = torchmon.thread_h2d_total()
        cur, st = fold_in_coo(cur, TCOO(*corpus), tu, ti, cfg,
                              device="cpu", resident_key="overbudget")
        plan_h2d.append(torchmon.thread_h2d_total() - h0)
        assert st.sharded and (tick == 0 or st.resident_hit)
    for h in plan_h2d:
        assert h < table_bytes / 4 and h < BUDGET, (plan_h2d, table_bytes)

    sizes = device_cache.resident_sizes()
    bucket_bytes = (cur.user_factors.padded_rows
                    + cur.item_factors.padded_rows) * RANK * 4
    assert sizes["overbudget"] == bucket_bytes // SHARDS

    users = [3, 200, 399]
    with monkeypatch.context() as mp:
        mp.setenv("PIO_SERVE_PACK", "exact")
        scores, idx = TA.users_topk_serve(cur, users, 20)
    items = cur.item_factors.to_numpy()
    for row, u in enumerate(users):
        want = cur.user_factors.rows([u])[0] @ items.T
        order = np.argsort(-want)[:20]
        keep = np.isfinite(scores[row])
        np.testing.assert_array_equal(idx[row][keep][:20], order)
        np.testing.assert_allclose(scores[row][keep][:20], want[order],
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
    assert cur.item_factors._dev is not None
    device_cache.drop_resident("overbudget")
