#!/usr/bin/env python3
"""How far float32 rounding alone moves a small ALS train.

    python3 scripts/torch_als_rounding.py

Trains `predictionio_tpu_torch`'s ALS on `small_ratings()` (the data of
tests/test_torch_als.py, tests/test_torch_implicit.py,
tests/test_torch_compute_dtype.py and tests/test_torch_cuda.py: rank 16,
3 iterations, work budget 512, seed 2): explicit at lam 0.1 and 0.01 with
solvers 'cg' and 'cholesky', and with 'schulz' at compute dtypes float32
and bfloat16; implicit (the values read as view counts, alpha 1, lam
0.01) with solvers 'chol_cuda' and 'cholesky', with and without negative
(dislike) entries, and with 'schulz' at bfloat16. Prints one JSON line per
case with the largest factor difference over the largest factor magnitude
between:

- `f32_vs_f64`: the float32 train and the float64 train on the CPU, the
  size of float32 rounding for this data (with bfloat16 compute both
  round the same operands to bf16, so it is what the order of the f32
  sums moves through those roundings);
- `card_vs_cpu` (only where a CUDA card is present): the float32 train on
  the card (every solve through the kernel: CG for explicit, Cholesky for
  implicit, Schulz for the Schulz cases) and on the CPU.

A train whose sentinel finds non-finite factors prints `diverged` instead
(explicit Schulz at lam 0.01 and bfloat16 does, as the reference's does).

The parity tests take their tolerances from these readings. A card
reading is printed with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from predictionio_tpu_torch.data.synthetic import small_ratings  # noqa: E402
from predictionio_tpu_torch.guard.sentinels import NumericalFault  # noqa
from predictionio_tpu_torch.ops import als as A  # noqa: E402
from predictionio_tpu_torch.ops.ratings import RatingsCOO  # noqa: E402


def spread(m, ref) -> float:
    """max |m - ref| over max |ref|, across both factor tables."""
    return max(float(np.abs(a.astype(np.float64) - b).max()
                     / np.abs(b).max())
               for a, b in ((m.user_factors, ref.user_factors),
                            (m.item_factors, ref.item_factors)))


def reading(coo, kw, card_solver, smi) -> dict:
    """f32 vs f64 on the CPU; card vs CPU with `card_solver` on the card
    when there is a card and a solver to run there."""
    try:
        f32 = A.als_train(coo, A.ALSConfig(**kw), device="cpu")
    except NumericalFault as fault:
        return {"diverged": str(fault)}
    f64 = A.als_train(coo, A.ALSConfig(dtype="float64", **kw), device="cpu")
    out = {"f32_vs_f64": spread(f32, f64)}
    if smi is not None and card_solver is not None:
        on_card = A.als_train(coo, A.ALSConfig(**{**kw,
                                                  "solver": card_solver}),
                              device="cuda")
        out["card_vs_cpu"] = spread(on_card, f32)
        out["nvidia_smi"] = smi
    return out


def main() -> int:
    coo = RatingsCOO(*small_ratings())
    smi = None
    if torch.cuda.is_available():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    for lam in (0.1, 0.01):
        for solver in ("cg", "cholesky"):
            kw = dict(rank=16, iterations=3, lam=lam, seed=2,
                      work_budget=512, solver=solver)
            line = {"lam": lam, "solver": solver}
            card_solver = "auto" if solver == "cg" else None
            print(json.dumps({**line, **reading(coo, kw, card_solver,
                                                smi)}), flush=True)
        for cd in ("float32", "bfloat16"):
            kw = dict(rank=16, iterations=3, lam=lam, seed=2,
                      work_budget=512, solver="schulz", compute_dtype=cd)
            line = {"lam": lam, "solver": "schulz", "compute_dtype": cd}
            print(json.dumps({**line, **reading(coo, kw, "schulz_cuda",
                                                smi)}), flush=True)
    for negatives in (False, True):
        vals = coo.rating.copy()
        if negatives:
            vals[::5] *= -1
        data = RatingsCOO(coo.user_idx, coo.item_idx, vals, coo.n_users,
                          coo.n_items)
        for solver in ("chol_cuda", "cholesky"):
            kw = dict(rank=16, iterations=3, lam=0.01, seed=2,
                      work_budget=512, solver=solver, implicit_prefs=True,
                      alpha=1.0)
            line = {"implicit": True, "negatives": negatives, "lam": 0.01,
                    "alpha": 1.0, "solver": solver}
            card_solver = "chol_cuda" if solver == "chol_cuda" else None
            print(json.dumps({**line, **reading(data, kw, card_solver,
                                                smi)}), flush=True)
    kw = dict(rank=16, iterations=3, lam=0.01, seed=2, work_budget=512,
              solver="schulz", compute_dtype="bfloat16",
              implicit_prefs=True, alpha=1.0)
    line = {"implicit": True, "negatives": False, "lam": 0.01,
            "alpha": 1.0, "solver": "schulz", "compute_dtype": "bfloat16"}
    print(json.dumps({**line, **reading(coo, kw, "schulz_cuda", smi)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
