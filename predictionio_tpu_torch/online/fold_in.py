"""Fold-in: re-solve only the touched factor rows of a deployed model.

The port's counterpart of `predictionio_tpu/online/fold_in.py`
(`FoldInConfig`, `FoldInStats`, `_als_config`, `solve_rows`,
`_pad_batch_rows`, `_pad_plan_batches`, `_prep_side`, `_solve_side`, the
scatter with its rank-k Gram correction, `_solver_gram` (here
`ops/als.solver_gram`), `fold_in_coo`)
on the replicated layout. The per-entity least-squares step of ALS with
the counterpart table held fixed is the batched solve the training sweep
already runs, so absorbing fresh events costs one mini-sweep over the
touched entities: the same solve plans (`ops/ratings.build_solve_plan`),
the same `ops/als._run_side` and `_solve_batch`, and so the same
`spd_solve`; on the card that is `csrc/cg_solve.cu` under the default
solver 'auto'.

  explicit  ALS-WR: x = argmin sum_S (r - x.v)^2 + lam * n |x|^2
  implicit  Hu-Koren: (G + V_S^T (C_S - I) V_S + lam n I) x = V_S^T C_S p
            with G = V^T V over the whole counterpart table.

A tick uploads the grown tables at most once (at the reference's pow2
row buckets), solves both sides and every sweep against the tables where
they live, and scatters the solved rows on the device between sides.
The implicit Gram rides along, corrected by G += sum(v_new v_new^T -
v_old v_old^T) over the scattered rows, and is recomputed from the table
on upload and every `_GRAM_REFRESH_EVERY` ticks. With a `resident_key`
the final tables stay in a residency slot (`utils/device_cache.py`)
keyed by the published host arrays, so the next tick against that model
uploads only its solve plans. Every byte the fold hands to its device is
counted in `obs/torchmon.record_h2d`, whose per-thread total the
scheduler's report reads (`h2dBytes`). Each side's solves run under the
`fold_side` executable label and `obs/costmon.device_timed`, so the
card's fold time is booked from CUDA events beside the serve path's; a
no-op tick counts in `pio_guard_fold_degenerate_total`.

A folded row is the exact least-squares answer given the current
counterpart rows; rows outside the touched set keep their deployed
values, so a folded model is one Gauss-Seidel half-step from a retrain,
which the scheduler's drift bound watches.

Differences from the reference, by design:
- Updates are out of place (`index_copy`), as the reference's functional
  scatter is: a checkpoint is a reference, and a published model's
  device tables may share the resident tensors without a later tick
  writing under a query.
- Scatter targets padded with `_DROP` are masked on the host before any
  index reaches the device: torch would raise (CPU) or hit a device
  assert (CUDA) where the reference's `mode="drop"` discards them.
- A plan batch uploads only its real rows; the padding rows and whole
  inert batches (rows -1, mask 0) are made on the device, so the kernel
  sees the reference's shapes and the link carries only data.
- The fold runs in its tables' dtype: float64 host tables on the CPU give
  the float64 reading of the same sweeps (`chip_smoke.py` replays the
  card's fold so).
- The model-sharded layout (`factor_sharding='model'`) and the chaos
  hooks are later slices (ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.obs import costmon, get_registry, torchmon
from predictionio_tpu_torch.guard.sentinels import (SweepSentinel,
                                                    guard_enabled,
                                                    host_max_norm)
from predictionio_tpu_torch.ops.als import (ALSConfig, ALSModel,
                                            DeviceBatch, _run_side,
                                            _upload_plan, merge_batches,
                                            resolve_sweep_chunk,
                                            solver_gram)
from predictionio_tpu_torch.ops.ratings import (RatingsCOO, SolveBatch,
                                                SolvePlan, build_solve_plan)
from predictionio_tpu_torch.ops.solve import resolve_solver
from predictionio_tpu_torch.utils import device_cache
from predictionio_tpu_torch.compile.buckets import bucket_batch, bucket_rows


@dataclass(frozen=True)
class FoldInConfig:
    """Hyperparameters of the touched-row solves; the defaults are
    `ops/als.ALSConfig`'s, so a fold against a model trained with
    default params runs the train's math. The reference's
    `factor_sharding` is not here: the port runs the replicated layout
    only."""
    lam: float = 0.01
    implicit_prefs: bool = False
    alpha: float = 1.0
    lambda_scaling: str = "nratings"   # 'nratings' (ALS-WR) | 'constant'
    solver: str = "auto"               # ops/solve.spd_solve methods
    compute_dtype: Optional[str] = None  # None = float32
    work_budget: int = 1 << 20
    sweep_chunk: int = 0
    # a pow2 segment-length ladder (train: 1.125): few, quickly
    # saturated K classes from tick to tick
    bucket_ratio: float = 2.0
    solver_iters: Optional[int] = None
    dual_iters_cap: Optional[int] = None
    dual_solve: str = "auto"           # ALSConfig.dual_solve
    # one sweep = user side, then item side; two let a new (user, item)
    # pair bootstrap (the first user-side solve sees a new item's zero row)
    sweeps: int = 1
    # after each side the solved rows must be finite and under
    # max(floor, ratio * the deployed max row norm); a breach rolls back
    # to the last clean sweep or raises NumericalFault (PIO_GUARD=off
    # disables)
    sentinel: bool = True
    sentinel_norm_ratio: float = 1e3
    sentinel_norm_floor: float = 1e4


@dataclass
class FoldInStats:
    """What one fold-in touched."""
    n_user_rows: int = 0
    n_item_rows: int = 0
    n_new_users: int = 0
    n_new_items: int = 0
    nnz_user_side: int = 0
    nnz_item_side: int = 0
    sweeps: int = 0
    wall_s: float = 0.0
    resident_hit: bool = False     # the tables came from the slot
    degenerate: bool = False       # nothing solvable: a clean no-op
    sentinel_rollback: bool = False
    guard_wall_s: float = 0.0      # wall seconds of the sentinel's work
    solver_calls: int = 0          # batched solves run (the port's count)


#: incremental Gram corrections before a recompute from the table
_GRAM_REFRESH_EVERY = 64

#: touched-row / scatter-length bucket floor
_TOUCHED_FLOOR = 16

#: scatter target of a padded entry (the reference's drop sentinel)
_DROP = np.int32(2 ** 31 - 1)

def _degenerate_counter():
    return get_registry().counter(
        "pio_guard_fold_degenerate_total",
        "Fold ticks that no-opped cleanly (empty touched set after "
        "filtering, or all-zero ratings) instead of building an empty "
        "solve plan")


def _put(arr: np.ndarray, device: torch.device,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Host -> device, counted in `obs/torchmon`."""
    arr = np.ascontiguousarray(arr)
    torchmon.record_h2d(arr.nbytes)
    t = torch.from_numpy(arr).to(device)
    return t if dtype is None else t.to(dtype)


def _als_config(cfg: FoldInConfig, rank: int, solver: str,
                dtype: str = "float32") -> ALSConfig:
    return ALSConfig(
        rank=rank, iterations=1, lam=cfg.lam,
        implicit_prefs=cfg.implicit_prefs, alpha=cfg.alpha,
        lambda_scaling=cfg.lambda_scaling, solver=solver,
        compute_dtype=cfg.compute_dtype or "float32",
        work_budget=cfg.work_budget, sweep_chunk=cfg.sweep_chunk,
        bucket_ratio=cfg.bucket_ratio, solver_iters=cfg.solver_iters,
        dual_iters_cap=cfg.dual_iters_cap, dual_solve=cfg.dual_solve,
        dtype=dtype)


def _table_dtype(*tables: np.ndarray) -> str:
    return ("float64" if all(t.dtype == np.float64 for t in tables)
            else "float32")


def _gram(table: torch.Tensor) -> torch.Tensor:
    return table.T @ table


def solve_rows(counter_factors: np.ndarray, owner_compact: np.ndarray,
               counter_idx: np.ndarray, values: np.ndarray, n_rows: int,
               cfg: FoldInConfig, device=None) -> np.ndarray:
    """One-sided normal-equation solve for `n_rows` entities, host in and
    host out: the counterpart table crosses to the device on every call
    (`fold_in_coo` is the resident tick built from the same parts). The
    reference the parity tests hold, and for ad-hoc callers.

    `owner_compact` [nnz] holds owner ids 0..n_rows-1, `counter_idx` and
    `values` each entry's counterpart row and rating. Returns the solved
    [n_rows, rank] rows; rows with no entries come back zero."""
    dev = resolve_device(device)
    dtype_name = _table_dtype(np.asarray(counter_factors))
    counter = np.ascontiguousarray(counter_factors, dtype=dtype_name)
    rank = counter.shape[1]
    solver = resolve_solver(cfg.solver, dev)
    plan = build_solve_plan(np.asarray(owner_compact, dtype=np.int64),
                            np.asarray(counter_idx, dtype=np.int32),
                            np.asarray(values, dtype=np.float32), n_rows,
                            work_budget=cfg.work_budget,
                            bucket_ratio=cfg.bucket_ratio)
    if not plan.batches:
        return np.zeros((n_rows, rank), dtype=counter.dtype)
    dtype = getattr(torch, dtype_name)
    groups = _upload_plan(plan, dev, dtype,
                          resolve_sweep_chunk(cfg.sweep_chunk))
    torchmon.record_h2d(sum(b.rows.nbytes + b.idx.nbytes + b.val.nbytes
                            + b.mask.nbytes for b in plan.batches))
    # +1 dummy tail row: where padding rows (-1) land
    out = torch.zeros((n_rows + 1, rank), dtype=dtype, device=dev)
    counter_dev = _put(counter, dev)
    als_cfg = _als_config(cfg, rank, solver, dtype_name)
    gram = (solver_gram(_gram(counter_dev), als_cfg)
            if cfg.implicit_prefs else None)
    _run_side(groups, out, counter_dev, als_cfg, solver, gram)
    return out[:n_rows].to("cpu", copy=True).numpy()


def _grown_table(table: np.ndarray, n_new: int) -> np.ndarray:
    """Old rows keep their indices; appended rows start at zero (a zero
    row scores 0 everywhere until its first solve)."""
    out = np.zeros((n_new, table.shape[1]), dtype=table.dtype)
    out[:table.shape[0]] = table
    return out


def _grown_dev(table: torch.Tensor, n_new: int) -> torch.Tensor:
    """Zero rows appended on the device (no host round trip)."""
    grow = n_new - int(table.shape[0])
    if grow <= 0:
        return table
    return torch.cat([table, table.new_zeros((grow, table.shape[1]))])


def _pad_batch_rows(b: SolveBatch, target: int) -> SolveBatch:
    """Pad one batch to `target` rows with the kernel's padding: rows -1
    land on the dummy tail row, mask 0 solves the pure-regularizer
    system to x = 0."""
    B, K = b.shape
    if target <= B:
        return b
    pad = target - B
    return SolveBatch(
        rows=np.concatenate([b.rows, np.full(pad, -1, dtype=b.rows.dtype)]),
        idx=np.vstack([b.idx, np.zeros((pad, K), dtype=b.idx.dtype)]),
        val=np.vstack([b.val, np.zeros((pad, K), dtype=b.val.dtype)]),
        mask=np.vstack([b.mask, np.zeros((pad, K), dtype=b.mask.dtype)]))


def _pad_plan_batches(plan: SolvePlan) -> SolvePlan:
    """The reference's shape-stable fold plan: every batch padded to its
    pow2 row bucket (floor `_TOUCHED_FLOOR`), every same-shape group
    padded to a pow2 count with inert batches, shapes in sorted order."""
    by_shape = {}
    for b in plan.batches:
        b = _pad_batch_rows(b, bucket_batch(b.shape[0],
                                            floor=_TOUCHED_FLOOR))
        by_shape.setdefault(b.shape, []).append(b)
    out = []
    for shape in sorted(by_shape):
        bs = by_shape[shape]
        out.extend(bs)
        target = bucket_batch(len(bs))
        if target > len(bs):
            B, K = shape
            inert = SolveBatch(rows=np.full(B, -1, dtype=np.int32),
                               idx=np.zeros((B, K), dtype=np.int32),
                               val=np.zeros((B, K), dtype=np.float32),
                               mask=np.zeros((B, K), dtype=np.float32))
            out.extend([inert] * (target - len(bs)))
    return SolvePlan(batches=out, n_entities=plan.n_entities, nnz=plan.nnz)


def _upload_fold_plan(plan: SolvePlan, device: torch.device,
                      dtype: torch.dtype, chunk: int) -> List[DeviceBatch]:
    """The padded plan on the device: each (merged) batch's real rows are
    uploaded, its padding rows are made there (rows -1, zeros). A batch's
    rows are independent systems, so moving the real ones to the front
    changes no answer."""
    out = []
    for rows, idx, val, mask in merge_batches(plan, chunk):
        B, K = idx.shape
        r = torch.full((B,), -1, dtype=torch.long, device=device)
        i = torch.zeros((B, K), dtype=torch.long, device=device)
        v = torch.zeros((B, K), dtype=dtype, device=device)
        m = torch.zeros((B, K), dtype=dtype, device=device)
        real = np.nonzero(rows >= 0)[0]
        n = real.size
        if n:
            r[:n] = _put(rows[real], device).long()
            i[:n] = _put(idx[real], device).long()
            v[:n] = _put(val[real], device, dtype)
            m[:n] = _put(mask[real], device, dtype)
        out.append((r, i, v, m))
    return out


@dataclass
class _SidePrep:
    """One side's tick constants, built once a tick: the solve plan on
    the device, and the scatter's rows of the solved [n_rows + 1] table
    (`src`) and of the full table (`dst`), padded to their bucket with
    `_DROP` targets as the reference pads them; `src_dev`/`dst_dev` are
    the real entries on the device."""
    groups: List[DeviceBatch]
    src: np.ndarray
    dst: np.ndarray
    dst_real: np.ndarray
    n_rows: int            # the touched-row bucket (solved height - 1)
    nnz: int
    src_dev: torch.Tensor
    dst_dev: torch.Tensor


def _prep_side(owner_idx: np.ndarray, counter_idx: np.ndarray,
               values: np.ndarray, touched: np.ndarray, cfg: FoldInConfig,
               device: torch.device, dtype: torch.dtype
               ) -> Optional[_SidePrep]:
    if touched.size == 0:
        return None
    sel = np.isin(owner_idx, touched)
    nnz = int(np.count_nonzero(sel))
    if nnz == 0:
        return None
    compact = np.searchsorted(touched, owner_idx[sel])
    n_slot = bucket_rows(int(touched.size), floor=_TOUCHED_FLOOR)
    plan = build_solve_plan(np.asarray(compact, dtype=np.int64),
                            np.asarray(counter_idx[sel], dtype=np.int32),
                            np.asarray(values[sel], dtype=np.float32),
                            n_slot, work_budget=cfg.work_budget,
                            bucket_ratio=cfg.bucket_ratio)
    if not plan.batches:
        return None
    groups = _upload_fold_plan(_pad_plan_batches(plan), device, dtype,
                               resolve_sweep_chunk(cfg.sweep_chunk))
    # only rows that had data are scattered: a touched entity whose
    # entries all vanished keeps its deployed row
    has_data = np.bincount(compact, minlength=touched.size) > 0
    src_real = np.nonzero(has_data)[0].astype(np.int32)
    dst_real = touched[has_data].astype(np.int32)
    plen = bucket_rows(max(int(src_real.size), 1), floor=_TOUCHED_FLOOR)
    src = np.zeros(plen, dtype=np.int32)
    src[:src_real.size] = src_real
    dst = np.full(plen, _DROP, dtype=np.int32)
    dst[:dst_real.size] = dst_real
    real = dst != _DROP    # masked here: no _DROP index reaches torch
    return _SidePrep(groups=groups, src=src, dst=dst, dst_real=dst_real,
                     n_rows=n_slot, nnz=nnz,
                     src_dev=_put(src[real], device).long(),
                     dst_dev=_put(dst[real], device).long())


def _scatter(table: torch.Tensor, gram: Optional[torch.Tensor],
             solved: torch.Tensor, prep: _SidePrep):
    """The solved rows onto their table rows, out of place; with a Gram,
    the rank-k correction over the rows that moved (the old rows read
    before the write)."""
    rows = solved[prep.src_dev]
    if gram is not None:
        old = table[prep.dst_dev]
        gram = gram + rows.T @ rows - old.T @ old
    return table.index_copy(0, prep.dst_dev, rows), gram


def _solve_side(prep: _SidePrep, counter_dev: torch.Tensor,
                counter_gram, out_dev: torch.Tensor, out_gram,
                als_cfg: ALSConfig, solver: str):
    """One side of one sweep on the device: solve the touched rows
    against the counterpart table into a zero [n_rows + 1, R] table
    (padding rows land on its last row), scatter them into the owned
    table, correct its Gram. Returns (out_dev, out_gram)."""
    solved = counter_dev.new_zeros((prep.n_rows + 1, counter_dev.shape[1]))
    with costmon.executable(costmon.FOLD_SIDE):
        costmon.device_timed(
            costmon.FOLD_SIDE, _run_side, prep.groups, solved, counter_dev,
            als_cfg, solver,
            None if counter_gram is None
            else solver_gram(counter_gram, als_cfg))
    return _scatter(out_dev, out_gram, solved, prep)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with `t` (on the CPU too)."""
    return t.detach().to("cpu", copy=True).numpy()


def fold_in_coo(als: ALSModel, coo: RatingsCOO,
                touched_users: Sequence[int], touched_items: Sequence[int],
                cfg: FoldInConfig, device=None,
                resident_key: Optional[str] = None
                ) -> Tuple[ALSModel, FoldInStats]:
    """Fold fresh data into a trained model: re-solve only the touched
    user and item rows against `coo`, the current deduplicated data,
    whose touched rows and columns must be complete (a partial history
    gives rows biased to the fresh slice).

    `coo.n_users`/`n_items` may exceed the model's: new rows are appended
    at zero and solved when touched, so no deployed dense index moves.
    `device` (default: the model's, else the card) runs the solves.
    `resident_key` names a residency slot: when the model's host tables
    are the ones a previous tick published under that key, its device
    tables (and implicit Grams) are reused and the tick uploads only its
    plans. Returns (the folded model, its stats); a degenerate tick
    returns the model itself."""
    t0 = time.perf_counter()
    dev = resolve_device(device if device is not None else als.device)
    rank = als.rank
    n_users = max(coo.n_users, als.n_users)
    n_items = max(coo.n_items, als.n_items)
    tu = np.unique(np.asarray(touched_users, dtype=np.int64))
    ti = np.unique(np.asarray(touched_items, dtype=np.int64))
    stats = FoldInStats(n_new_users=n_users - als.n_users,
                        n_new_items=n_items - als.n_items)
    implicit = cfg.implicit_prefs
    dtype_name = _table_dtype(als.user_factors, als.item_factors)
    dtype = getattr(torch, dtype_name)
    solver = resolve_solver(cfg.solver, dev)
    als_cfg = _als_config(cfg, rank, solver, dtype_name)

    degenerate = ((tu.size == 0 and ti.size == 0) or coo.rating.size == 0
                  # all-zero ratings would zero the deployed rows
                  or not np.any(coo.rating))
    prep_u = prep_i = None
    if not degenerate:
        prep_u = _prep_side(coo.user_idx, coo.item_idx, coo.rating, tu,
                            cfg, dev, dtype)
        prep_i = _prep_side(coo.item_idx, coo.user_idx, coo.rating, ti,
                            cfg, dev, dtype)
        degenerate = prep_u is None and prep_i is None
    if degenerate:
        _degenerate_counter().inc()
        stats.degenerate = True
        stats.wall_s = time.perf_counter() - t0
        return als, stats

    # the tables on the device, at pow2 row buckets: once a tick, or not
    # at all when the slot holds them
    n_users_b, n_items_b = bucket_rows(n_users), bucket_rows(n_items)
    payload = (device_cache.get_resident(
        resident_key, (als.user_factors, als.item_factors),
        sharding="replicated") if resident_key else None)
    if (payload is not None and payload["device"] == dev
            and payload["implicit"] == implicit
            and payload["U"].dtype == dtype):
        U_dev = _grown_dev(payload["U"], n_users_b)
        V_dev = _grown_dev(payload["V"], n_items_b)
        # appended zero rows add nothing to a Gram: carry it
        gram_u, gram_v = payload["GU"], payload["GV"]
        incr = payload["incr"]
        stats.resident_hit = True
    else:
        U_host = _grown_table(als.user_factors, n_users_b)
        V_host = _grown_table(als.item_factors, n_items_b)
        device_cache.check_table_budget(U_host.nbytes,
                                        table="fold user table")
        device_cache.check_table_budget(V_host.nbytes,
                                        table="fold item table")
        U_dev, V_dev = _put(U_host, dev), _put(V_host, dev)
        del U_host, V_host
        gram_u = gram_v = None
        incr = 0
    if implicit and (gram_u is None or gram_v is None
                     or incr >= _GRAM_REFRESH_EVERY):
        gram_u, gram_v = _gram(U_dev), _gram(V_dev)
        incr = 0

    sentinel = None
    if cfg.sentinel and guard_enabled():
        g0 = time.perf_counter()
        # an O(model) baseline only on a lineage's first tick: a folded
        # model carries the largest norm its checks saw
        baseline = getattr(als, "_pio_guard_norm", None)
        if baseline is None:
            baseline = host_max_norm(als.user_factors, als.item_factors)
        sentinel = SweepSentinel("fold_in", baseline,
                                 norm_ratio=cfg.sentinel_norm_ratio,
                                 norm_floor=cfg.sentinel_norm_floor)
        stats.guard_wall_s += time.perf_counter() - g0

    def check(table, idx, what):
        g0 = time.perf_counter()
        try:
            return sentinel.check_rows(table, idx, what)
        finally:
            stats.guard_wall_s += time.perf_counter() - g0

    ckpt = None        # the tables after the last clean sweep
    fault = None
    for _ in range(max(1, int(cfg.sweeps))):
        if prep_u is not None:
            U_dev, gram_u = _solve_side(prep_u, V_dev, gram_v, U_dev,
                                        gram_u, als_cfg, solver)
            stats.n_user_rows += len(prep_u.dst_real)
            stats.nnz_user_side += prep_u.nnz
            stats.solver_calls += len(prep_u.groups)
            if sentinel is not None:
                fault = check(U_dev, prep_u.dst_real, "user-side solve")
                if fault is not None:
                    break
        if prep_i is not None:
            V_dev, gram_v = _solve_side(prep_i, U_dev, gram_u, V_dev,
                                        gram_v, als_cfg, solver)
            stats.n_item_rows += len(prep_i.dst_real)
            stats.nnz_item_side += prep_i.nnz
            stats.solver_calls += len(prep_i.groups)
            if sentinel is not None:
                fault = check(V_dev, prep_i.dst_real, "item-side solve")
                if fault is not None:
                    break
        stats.sweeps += 1
        # every update is out of place: a checkpoint is references
        ckpt = (U_dev, V_dev, gram_u, gram_v)
    if fault is not None:
        if ckpt is None:
            raise fault    # the scheduler restores the tick's deltas
        U_dev, V_dev, gram_u, gram_v = ckpt
        stats.sentinel_rollback = True

    # published models carry exact-size host tables; the bucket padding
    # is the device's alone
    U_host, V_host = _to_host(U_dev[:n_users]), _to_host(V_dev[:n_items])
    if resident_key:
        device_cache.put_resident(
            resident_key, (U_host, V_host),
            {"U": U_dev, "V": V_dev, "GU": gram_u, "GV": gram_v,
             "device": dev, "implicit": implicit, "incr": incr + 1},
            sharding="replicated")
    stats.wall_s = time.perf_counter() - t0
    out = ALSModel(U_host, V_host, rank, dev,
                   _tables=(U_dev[:n_users], V_dev[:n_items]))
    if sentinel is not None:
        out._pio_guard_norm = sentinel.observed_max
    return out, stats
