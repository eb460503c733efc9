#!/usr/bin/env python3
"""Where one ALS iteration of the PyTorch/CUDA port spends device time.

    python3 scripts/profile_torch_als.py [--template recommendation]
        [--rank 200] [--lam 0.01] [--alpha 1.0] [--seed 0]
        [--solver auto] [--compute-dtype float32] [--sweep-chunk 0]

Builds synthetic MovieLens-20M-shaped ratings (seeded) and trains them
through the port's entry points, under `torch.profiler`, for 2
iterations:

- `--template recommendation` (default): explicit ALS through the
  preparator and `ALSAlgorithm.train`, solver 'auto', so every solve goes
  through the CG kernel;
- `--template similarproduct`: the same (user, item) pairs as view events
  (counts), every item $set with synthetic categories, implicit ALS
  through the data source, preparator and `ALSAlgorithm.train` with
  solver 'chol_cuda', so every solve goes through the Cholesky kernel.

`--solver`, `--compute-dtype` and `--sweep-chunk` override the
template's solver and pass the algorithm params of the same names; the
Schulz path is `--solver schulz_cuda --compute-dtype bfloat16
--sweep-chunk 4` (every solve through the Newton-Schulz kernel, the
normal equations' products on bf16 operands with f32 sums).

Reads the second iteration from its `als_iteration` span (the first
carries cuBLAS warm-up; the span also covers the implicit Grams and their
eigh) and prints one JSON line: the iteration's wall time, the device's
busy share (summed kernel time over wall time; kernels run on one
stream), device time by kernel and by kind, the same reading of the first
iteration (`iteration_1`, without the kernel list) beside it, the
second iteration's solver calls (`solver_iteration_2`: their count, the
solve kernel's summed device time and the calls' summed bound from
`chip_smoke.py`'s cost model), and the card's name and power limit as
nvidia-smi reports them. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from predictionio_tpu_torch.data.synthetic import (  # noqa: E402
    ML20M_ITEMS, ML20M_RATINGS, ML20M_USERS, synthetic_item_categories,
    synthetic_ml20m)
from predictionio_tpu_torch.device import resolve_device  # noqa: E402
from predictionio_tpu_torch.models.common import RatingsData  # noqa: E402
from predictionio_tpu_torch.models import recommendation as rec  # noqa
from predictionio_tpu_torch.models import similarproduct as sp  # noqa: E402
from predictionio_tpu_torch.ops import als as als_ops  # noqa: E402
from predictionio_tpu_torch.ops.solve import (  # noqa: E402
    CG_PRIMAL_ITERS, SCHULZ_ITERS, resolve_solver)
import chip_smoke  # noqa: E402  (the kernels' cost model and peak rates)


def record_solver_calls(calls: list):
    """Wrap the ALS module's `spd_solve` so that every call appends its
    (method, B, R, steps, compute dtype) to `calls`."""
    solve = als_ops.spd_solve

    def recording(A, b, method="auto", iters=None, compute_dtype="bfloat16"):
        calls.append((resolve_solver(method, A.device), A.shape[0],
                      A.shape[-1], iters, compute_dtype))
        return solve(A, b, method, iters, compute_dtype)
    als_ops.spd_solve = recording


def solver_bound_ms(calls) -> dict:
    """The summed bound of these solver calls (`chip_smoke.py`'s cost model:
    bytes over 3.35 TB/s or flops over the peak of their type, the larger
    of the two, per call), with the count of calls bound each way."""
    total, by = 0.0, {"bytes": 0, "operations": 0}
    for method, B, R, iters, cd in calls:
        if method == "cg_cuda":
            nbytes, flops = chip_smoke.cg_cost(B, R, iters or CG_PRIMAL_ITERS)
            rate = chip_smoke.F32_FLOPS_PER_S
        elif method == "chol_cuda":
            (nbytes, flops), rate = (chip_smoke.chol_cost(B, R),
                                     chip_smoke.F32_FLOPS_PER_S)
        elif method == "schulz_cuda":
            nbytes, flops = chip_smoke.schulz_cost(B, R,
                                                   iters or SCHULZ_ITERS)
            rate = (chip_smoke.BF16_FLOPS_PER_S if cd == "bfloat16"
                    else chip_smoke.F32_FLOPS_PER_S)
        else:
            continue
        ms, kind = chip_smoke.bound(nbytes, flops, rate)
        total += ms
        by[kind] += 1
    return {"calls": len(calls), "bound_ms": total, "bound_by": by}


def kind_of(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("cg_solve", "cg_reg_kernel", "cg_warp_kernel",
                            "cg_stream_kernel")):
        return "cg_solve kernel"
    if "chol_solve" in n:
        return "chol_solve kernel"
    if "schulz_solve" in n:
        return "schulz_solve kernel"
    if "syev" in n or "sytrd" in n or "stedc" in n or "ormtr" in n or \
            "orgtr" in n or "steqr" in n or "lapack" in n:
        return "eigh (cuSOLVER)"
    if "gemm" in n or "sm90" in n or "cutlass" in n or "xmma" in n:
        return "matmul (Gram, rhs, dual products)"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather / scatter"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "elementwise / reduction"


def breakdown(events, span) -> dict:
    """Device time by kernel inside one `als_iteration` span, and the
    span's wall time."""
    lo, hi = span.time_range.start, span.time_range.end
    by_name = defaultdict(float)
    launches = defaultdict(int)
    for ev in events:
        # the span's own device-side copy is not a kernel
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.name == "als_iteration"
                or not lo <= ev.time_range.start < hi):
            continue
        by_name[ev.name] += ev.time_range.elapsed_us() / 1e3
        launches[ev.name] += 1
    by_kind = defaultdict(float)
    for name, ms in by_name.items():
        by_kind[kind_of(name)] += ms
    device_ms = sum(by_name.values())
    wall_ms = (hi - lo) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms if device_ms > 0 else "not measured",
        "busy_share": (device_ms / wall_ms) if device_ms > 0
        else "not measured",
        "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms": ms, "launches": launches[n]}
                        for n, ms in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--template", default="recommendation",
                    choices=["recommendation", "similarproduct"])
    ap.add_argument("--rank", type=int, default=200)
    ap.add_argument("--lam", type=float, default=0.01)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--solver", default=None,
                    help="default: 'auto' (recommendation), 'chol_cuda' "
                         "(similarproduct)")
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--sweep-chunk", type=int, default=0)
    args = ap.parse_args()
    extra = dict(compute_dtype=args.compute_dtype,
                 sweep_chunk=args.sweep_chunk)
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()

    u, i, r = synthetic_ml20m(ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS,
                              seed=args.seed)
    if args.template == "recommendation":
        td = rec.RecommendationDataSource(
            rec.DataSourceParams(ratings=RatingsData(u, i, r))).read_training()
        pd = rec.RecommendationPreparator().prepare(td)
        algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(
            rank=args.rank, num_iterations=2, lam=args.lam, seed=args.seed,
            solver=args.solver or "auto", **extra))
    else:
        cats = synthetic_item_categories(ML20M_ITEMS, seed=args.seed)
        items = {str(k): sp.Item(c, properties={"categories": list(c)})
                 for k, c in enumerate(cats)}
        views = RatingsData(u.astype("U6"), i.astype("U5"),
                            np.ones(len(u), dtype=np.float32))
        td = sp.SimilarProductDataSource(sp.DataSourceParams(
            items=items, view_events=views)).read_training()
        pd = sp.SimilarProductPreparator().prepare(td)
        algo = sp.ALSAlgorithm(sp.ALSAlgorithmParams(
            rank=args.rank, num_iterations=2, lam=args.lam,
            alpha=args.alpha, seed=args.seed,
            solver=args.solver or "chol_cuda", **extra))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    calls = []
    record_solver_calls(calls)
    with torch.profiler.profile(activities=acts) as prof:
        algo.train(pd)
    events = prof.events()
    spans = sorted((ev for ev in events if ev.name == "als_iteration"
                    and ev.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda ev: ev.time_range.start)
    if len(spans) != 2:
        raise RuntimeError(f"expected 2 als_iteration spans, got "
                           f"{len(spans)}")
    first, second = (breakdown(events, span) for span in spans)
    tel = algo.last_train_telemetry
    if len(calls) != tel["solver_calls"] or len(calls) % 2:
        raise RuntimeError(f"recorded {len(calls)} solver calls, telemetry "
                           f"says {tel['solver_calls']}")
    solver = solver_bound_ms(calls[len(calls) // 2:])
    kernel = next((k for k in second["by_kind_ms"] if k.endswith("kernel")),
                  None)
    solver["kernel_ms"] = second["by_kind_ms"].get(kernel, "not measured")
    solver["kernel"] = kernel
    print(json.dumps({
        "what": f"iteration 2 of a 2-iteration {args.template} "
                "ALSAlgorithm.train (both half-sweeps)",
        "template": args.template, "rank": args.rank, "lam": args.lam,
        "solver": algo.params.solver,
        "compute_dtype": args.compute_dtype or "float32",
        "sweep_chunk": args.sweep_chunk,
        "alpha": args.alpha if args.template == "similarproduct" else None,
        "solver_calls": tel["solver_calls"], "iter_s": tel["iter_s"],
        **second, "solver_iteration_2": solver,
        "iteration_1": {k: v for k, v in first.items()
                        if k != "top_kernels"},
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
