"""Alternating least squares (explicit and implicit) on one CUDA card.

The port's counterpart of `predictionio_tpu/ops/als.py` (train:
`ALSConfig`, `ALSModel`, `_init_factors`, `_dual_system_solve`,
`_scatter_rows`, `_solve_batch`, `_gram_eig_impl`, `_run_side`,
`als_train`; serve: `recommend_products`, `batch_predict_dims`,
`register_aot_specs`, `users_topk_serve[_begin]` computing
`_users_topk_b` (the batched serve path, dispatched through the
executable registry of `compile/aot.py`), `predict_ratings`,
`als_rmse`; the sharded layout: `recommend_products_sharded`,
`_users_topk_serve_sharded_begin`).

Math parity with the reference (MLlib 1.3):
  explicit  ALS-WR: minimize sum (r - x.v)^2 + lam * (n_u |x|^2 + ...).
  implicit  Hu-Koren: confidence c = 1 + alpha |r|, preference
            p = 1(r > 0); solve (G + V^T (C - I) V + reg I) x = V^T C p
            with G = V^T V over the real rows, once per half-sweep.
            Negative ratings add confidence with preference 0.
Each half-iteration walks the host solve plan (ops/ratings.py) bucket by
bucket: gather the counterpart rows, form the normal equations, solve,
scatter. Buckets whose padded length K >= rank solve the [B, R, R] primal
system. Buckets with K < rank solve an exact K-dim dual: explicit, the
Woodbury (M M^T + reg I_K) z = y, x = M^T z; implicit, Sherman-Morrison-
Woodbury through the eigenbasis of G (`eigh` once per half-sweep), in the
D^1/2 form that stays exact where the confidence is 0. On the card the
solver named by `ALSConfig.solver` runs every solve, primal and dual:
'cg_cuda' (the 'auto' default) through `csrc/cg_solve.cu`, 'chol_cuda'
through `csrc/chol_solve.cu`, 'schulz_cuda' through `csrc/schulz_solve.cu`.

`ALSConfig.compute_dtype` is the operand dtype of the normal equations'
products, as in the reference: 'bfloat16' rounds every operand the
reference casts to bf16 and multiplies in float32 (a product of two bf16
values is exact there), so sums stay float32. The primal Schulz solve
follows it; the dual solves take `spd_solve`'s default, bf16, as the
reference's `_dual_system_solve` does. `ALSConfig.sweep_chunk` merges
that many same-shape batches of a half-sweep into one solver call.

Differences from the reference, by design:
- PyTorch runs eagerly: there is no scan/jit; the plan stays a list of
  per-batch device tensors, uploaded once per train.
- Factor tables are updated in place (`_scatter_rows`): a batch reads
  only the counterpart table, so the in-place write is safe, and it
  saves the table copy a functional update would make.
- Sums are float32 on both devices (TF32 is off, see device.py); the
  bf16 compute dtype rounds operands, it never multiplies in bf16.
- `fuse_iteration` captures one iteration's launches as CUDA graphs,
  the counterpart of the reference's one XLA program per iteration
  (`_FusedIteration`); the CPU has no graphs and runs the same loop
  eagerly.
- `factor_sharding='model'` trains on whole tables in every process
  (the gathers of a batch read any counterpart row) and, with
  `keep_sharded`, hands the tables out as `parallel/sharded_table.
  ShardedTable`s split S ways, each process keeping its shards as
  tensors of their own. Every bucket's solve runs through the process's
  own kernel ('auto' -> 'cg_cuda' on the card); the reference falls back
  to its jnp CG on a multi-device mesh because `pallas_call` cannot take
  GSPMD-sharded operands, a limit the port does not have.
- With P > 1 processes (`parallel/mesh.init_distributed`) the train is
  data-parallel: process p solves the batches p, p + P, ... of each
  half-sweep, and a sum over the processes (`mesh.all_reduce`, each row
  solved by exactly one process) hands every process the solved rows,
  so every process ends the half-sweep with the single-process table.

`ALSConfig.factor_dtype='bfloat16'` keeps the factor tables in bf16 on
the device: gathered rows are widened to the train's dtype before the
products, solved rows are rounded to bf16 as they are scattered, and the
model's host and serving tables are float32, as in the reference.
`ALSConfig.dual_solve='never'` solves every bucket's rank-dimension
primal system; implicit trains then form G without its `eigh`.
"""

from __future__ import annotations

import functools
import logging
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device, synchronize
from predictionio_tpu_torch.obs import costmon
from predictionio_tpu_torch.ops import readback
from predictionio_tpu_torch.ops.ratings import (RatingsCOO, SolvePlan,
                                                plan_for_items,
                                                plan_for_users)
from predictionio_tpu_torch.ops.solve import (COMPUTE_DTYPES,
                                              resolve_solver, round_operand,
                                              spd_solve)
from predictionio_tpu_torch.compile import buckets as B

logger = logging.getLogger(__name__)

FACTOR_DTYPES = ("float32", "bfloat16")
DUAL_SOLVES = ("auto", "never")
FACTOR_SHARDINGS = ("replicated", "model")


@dataclass(frozen=True)
class ALSConfig:
    rank: int = 10
    iterations: int = 10
    lam: float = 0.01                  # MLlib's lambda_
    implicit_prefs: bool = False
    alpha: float = 1.0                 # implicit confidence scale
    lambda_scaling: str = "nratings"   # 'nratings' (ALS-WR) | 'constant'
    seed: int = 0
    work_budget: int = 1 << 20         # B*K per solve batch
    solver: str = "auto"               # see ops/solve.py spd_solve
    solver_iters: Optional[int] = None
    # Primal solver steps; None = the solver's own default (CG 48,
    # Schulz 18). The dual solves run K+8 (or min(K+8, dual_iters_cap)).
    dual_iters_cap: Optional[int] = None  # cap on the dual CG's K+8
    dual_plain_below: int = 0
    # Dual systems with K below this go to the plain PyTorch CG instead of
    # the kernel. The reference sends K < 32 to its jnp CG on the TPU only
    # because a Pallas tile has a fixed overhead; on the card 0 keeps
    # every CG solve of the main path on the kernel.
    bucket_ratio: float = 1.125
    sentinel: bool = True              # per-iteration finite/norm check
    sentinel_norm_cap: float = 1e4
    dtype: str = "float32"
    # Factor and solve dtype. The card's kernels take float32 only;
    # 'float64' on the CPU gives the reading of float32 rounding
    # (scripts/torch_als_rounding.py); with compute_dtype='bfloat16' it
    # rounds operands to bf16 and back to float64.
    compute_dtype: str = "float32"
    # Operand dtype of the normal equations' products and the primal
    # Schulz solve (module docstring); 'float32' is the reference's
    # default off the TPU.
    sweep_chunk: int = 0
    # Merge this many same-shape batches of a half-sweep into one solver
    # call over chunk*B systems (the batches are independent). 0 = auto:
    # 1 (the reference's answer off a single TPU).
    factor_dtype: str = "float32"
    # Device storage dtype of the factor tables: 'float32' keeps them in
    # `dtype`; 'bfloat16' halves the gather bytes (module docstring). It
    # takes dtype='float32' only: bf16 tables under a float64 train would
    # round the float64 reading it exists to give.
    dual_solve: str = "auto"
    # 'auto': buckets with K < rank solve the K-dim dual; 'never': every
    # bucket solves the rank-dim primal (one [R, R] system an entity).
    fuse_iteration: bool = False
    # On the card, capture one iteration's launches (both half-sweeps and
    # the implicit Grams) as CUDA graphs and replay them each iteration
    # (`_FusedIteration`); a capture that fails raises. On the CPU the
    # same loop runs eagerly.
    factor_sharding: str = "replicated"
    # 'model' splits the trained tables' rows over the mesh's model axis
    # (module docstring); 'replicated' keeps one whole table.
    keep_sharded: bool = False
    # With factor_sharding='model': return the tables as ShardedTables
    # (per-shard host slices, the trained device shards attached), not
    # whole host arrays.

    def __post_init__(self):
        if self.dual_iters_cap is not None and self.dual_iters_cap < 1:
            raise ValueError("dual_iters_cap must be >= 1, got "
                             f"{self.dual_iters_cap}")
        if not self.bucket_ratio > 1.0:
            raise ValueError("bucket_ratio must be > 1.0, got "
                             f"{self.bucket_ratio}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError("dtype must be 'float32' or 'float64', got "
                             f"{self.dtype!r}")
        if self.lambda_scaling not in ("nratings", "constant"):
            raise ValueError("lambda_scaling must be 'nratings' or "
                             f"'constant', got {self.lambda_scaling!r}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{COMPUTE_DTYPES}, got {self.compute_dtype!r}")
        if self.sweep_chunk < 0:
            raise ValueError("sweep_chunk must be >= 0, got "
                             f"{self.sweep_chunk}")
        if self.factor_dtype not in FACTOR_DTYPES:
            raise ValueError(f"factor_dtype must be one of {FACTOR_DTYPES}, "
                             f"got {self.factor_dtype!r}")
        if self.factor_dtype == "bfloat16" and self.dtype != "float32":
            raise ValueError("factor_dtype='bfloat16' takes dtype='float32', "
                             f"got {self.dtype!r}")
        if self.dual_solve not in DUAL_SOLVES:
            raise ValueError(f"dual_solve must be one of {DUAL_SOLVES}, got "
                             f"{self.dual_solve!r}")
        if self.factor_sharding not in FACTOR_SHARDINGS:
            raise ValueError(f"factor_sharding must be one of "
                             f"{FACTOR_SHARDINGS}, got "
                             f"{self.factor_sharding!r}")

    @property
    def dual(self) -> bool:
        """Whether buckets with K < rank take the dual (`dual_solve`):
        what both equation builders and the implicit Grams read."""
        return self.dual_solve == "auto"


@dataclass
class ALSModel:
    """Trained factorization: host numpy tables plus their copies on
    `device`, which serving reads. `_tables` holds the train's own device
    tables; otherwise the copies are the upload cache's (uploaded at most
    once, `utils/device_cache.cached_table`). A model restored from
    storage has no device (`utils/arrays.to_host` drops it with
    `_tables`) until its algorithm places it."""
    user_factors: np.ndarray   # [n_users, rank] in the train's dtype
    item_factors: np.ndarray   # [n_items, rank] (float32 unless asked)
    rank: int
    device: Optional[torch.device]
    _tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(
        default=None, repr=False, compare=False)

    @property
    def n_users(self) -> int:
        return self.user_factors.shape[0]

    @property
    def n_items(self) -> int:
        return self.item_factors.shape[0]

    def tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(U, V) on the model's device: the train's tables, else views of
        the serve path's padded uploads, which the upload cache holds
        (tagged with the tenant in scope; a tenant's eviction drops
        them)."""
        if self._tables is not None:
            return self._tables
        from predictionio_tpu_torch.parallel.sharded_table import is_sharded
        if is_sharded(self.user_factors) or is_sharded(self.item_factors):
            raise TypeError(
                "a model with sharded tables has no whole device tables; "
                "serve it through users_topk_serve or "
                "recommend_products_sharded")
        if self.device is None:
            raise RuntimeError(
                "this ALSModel was restored without a device; its "
                "algorithm's place_model puts it on one")
        from predictionio_tpu_torch.utils.device_cache import cached_table
        return (cached_table(self.user_factors, self.device),
                cached_table(self.item_factors, self.device))


# ---------------------------------------------------------------------------
# One batch of normal equations
# ---------------------------------------------------------------------------

def _dual_system_solve(M: torch.Tensor, y: torch.Tensor, K: int,
                       solver: str, iters_cap: Optional[int] = None,
                       plain_below: int = 0) -> torch.Tensor:
    """Solve the K-dim dual system with K+8 solver steps (CG's finite
    termination <= K plus a roundoff margin), optionally capped. Like the
    reference it passes no compute dtype: a Schulz dual solve runs its
    products on bf16 operands whatever `ALSConfig.compute_dtype` is."""
    method = "cg" if (K < plain_below and solver == "cg_cuda") else solver
    iters = K + 8 if iters_cap is None else min(K + 8, iters_cap)
    return spd_solve(M, y, method=method, iters=iters)


def _scatter_rows(factors_out: torch.Tensor, rows: torch.Tensor,
                  x: torch.Tensor) -> None:
    """Write solved rows in place; padding rows (-1) land on the dummy
    tail row."""
    safe = torch.where(rows < 0, factors_out.shape[0] - 1, rows)
    factors_out[safe] = x.to(factors_out.dtype)


def _regularizer(mask: torch.Tensor, lam: float,
                 nratings_reg: bool) -> torch.Tensor:
    """Per-entity ridge: lam * max(n, 1) (ALS-WR) or lam."""
    n = mask.sum(dim=-1)                            # ratings per entity
    return lam * n.clamp(min=1.0) if nratings_reg else torch.full_like(n,
                                                                       lam)


def _primal(x: torch.Tensor) -> torch.Tensor:
    return x


def _gather(counter_factors: torch.Tensor, idx: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """The counterpart rows of a batch, widened to the train's dtype (a
    no-op unless the table is bf16, `ALSConfig.factor_dtype`)."""
    return counter_factors[idx].to(dtype)


def normal_equations(counter_factors: torch.Tensor, idx: torch.Tensor,
                     val: torch.Tensor, mask: torch.Tensor, lam: float,
                     rank: int, nratings_reg: bool = True,
                     compute_dtype: str = "float32", dual: bool = True):
    """The explicit system one [B, K] batch solves, its products on
    `compute_dtype` operands (the gathered rows, the masked ratings, the
    dual answer z) with sums in the ratings' dtype.

    Returns (kind, A, rhs, to_rows): ('dual', A [B,K,K], y [B,K]) with
    rows x = M^T z when `dual` and K < rank, else ('primal', A [B,R,R],
    b [B,R]); `to_rows` maps the solve's answer to the factor rows."""
    cd = compute_dtype
    Vc = round_operand(_gather(counter_factors, idx, val.dtype), cd)
    K = idx.shape[1]
    reg = _regularizer(mask, lam, nratings_reg)
    Vm = Vc * mask[..., None]                       # exact: mask is 0/1
    if dual and K < rank:
        A = torch.bmm(Vm, Vm.transpose(1, 2))       # [B, K, K]
        A.diagonal(dim1=1, dim2=2).add_(reg[:, None])
        return ("dual", A, val * mask,
                lambda z: torch.bmm(round_operand(z, cd).unsqueeze(1),
                                    Vm).squeeze(1))
    A = torch.bmm(Vm.transpose(1, 2), Vc)           # [B, R, R]
    A.diagonal(dim1=1, dim2=2).add_(reg[:, None])
    b = torch.bmm(round_operand(val * mask, cd).unsqueeze(1),
                  Vc).squeeze(1)
    return "primal", A, b, _primal


def implicit_equations(counter_factors: torch.Tensor, gram, idx, val,
                       mask, lam: float, alpha: float, rank: int,
                       nratings_reg: bool = True,
                       compute_dtype: str = "float32", dual: bool = True):
    """The implicit (Hu-Koren) system one [B, K] batch solves, with
    `gram` = (G, w, Q) of the counterpart table (`gram_eig`); w and Q
    are read only when `dual` and K < rank, and may be None otherwise
    (`solver_gram`).

    Primal (K >= rank): A = G + sum_k (alpha |r_k|) v_k v_k^T + reg I,
    b = sum_k (1 + alpha |r_k|) 1(r_k > 0) v_k, over the real entries.
    Dual (K < rank): with B = G + reg I = Q diag(w+ + reg) Q^T (w+ the
    eigenvalues clamped at 0) and D = diag(alpha |r|), Sherman-Morrison-
    Woodbury gives x = B^-1 b - B^-1 V^T D^1/2 z where
    (I_K + D^1/2 V B^-1 V^T D^1/2) z = D^1/2 V B^-1 b.
    Every operand the reference's `_solve_batch` casts to
    `compute_dtype` is rounded here (the gathered rows, the confidences,
    Q, b, V Q, 1/denom, B^-1 b's eigen coefficients, D^1/2 z, s/denom);
    sums stay in the factors' dtype.
    Returns (kind, A, rhs, to_rows) as `normal_equations`."""
    G, w, Q = gram
    cd = compute_dtype
    Vc = round_operand(_gather(counter_factors, idx, val.dtype), cd)
    K = idx.shape[1]
    reg = _regularizer(mask, lam, nratings_reg)
    absval = val.abs()
    conf_minus_1 = (alpha * absval) * mask          # c - 1, 0 on padding
    # preference p = 1(r > 0): negative signals add confidence to A only
    pos = (val > 0).to(val.dtype) * mask
    b = torch.bmm(round_operand((1.0 + alpha * absval) * pos,
                                cd).unsqueeze(1), Vc).squeeze(1)  # [B, R]
    if K >= rank or not dual:
        Vw = Vc * round_operand(conf_minus_1, cd)[..., None]
        A = G + torch.bmm(Vw.transpose(1, 2), Vc)
        A.diagonal(dim1=1, dim2=2).add_(reg[:, None])
        return "primal", A, b, _primal
    # G is PSD: clamp eigh's roundoff-negative tail, so a small reg never
    # meets a negative eigenvalue and flips the sign of 1/denom
    denom = w.clamp(min=0.0)[None, :] + reg[:, None]          # [B, R]
    inv = 1.0 / denom
    Qc = round_operand(Q, cd)
    Vq = round_operand(torch.matmul(Vc, Qc), cd)              # [B, K, R]
    del Vc
    bq_d = torch.matmul(round_operand(b, cd), Qc) * inv
    bq_c = round_operand(bq_d, cd)
    u = torch.matmul(bq_c, Qc.T)                              # B^-1 b
    W = torch.bmm(Vq * round_operand(inv, cd)[:, None, :],
                  Vq.transpose(1, 2))                         # [B, K, K]
    dhalf = torch.sqrt(conf_minus_1)                          # [B, K]
    M = dhalf[:, :, None] * W * dhalf[:, None, :]
    del W
    M.diagonal(dim1=1, dim2=2).add_(1.0)
    t = torch.bmm(Vq, bq_c.unsqueeze(-1)).squeeze(-1)         # V B^-1 b

    def to_rows(z: torch.Tensor) -> torch.Tensor:
        s = torch.bmm(round_operand(dhalf * z, cd).unsqueeze(1),
                      Vq).squeeze(1)
        return u - torch.matmul(round_operand(s * inv, cd), Qc.T)
    return "dual", M, dhalf * t, to_rows


def gram_eig(factors: torch.Tensor):
    """G = F^T F and its eigendecomposition (w ascending, Q columns), once
    per implicit half-sweep and shared by every entity's solve. `factors`
    holds the real rows only (not the dummy tail row)."""
    G = factors.T @ factors
    w, Q = torch.linalg.eigh(G)
    return G, w, Q


def solver_gram(G: torch.Tensor, cfg: "ALSConfig"):
    """(G, w, Q) of a Gram for `implicit_equations`: G's
    eigendecomposition when buckets take the dual (`ALSConfig.dual`),
    else (G, None, None), as the reference's `_gram` forms G without its
    eigh. The fold passes the Gram it carries."""
    if not cfg.dual:
        return G, None, None
    w, Q = torch.linalg.eigh(G)
    return G, w, Q


def gram_of(table: torch.Tensor, n: int, cfg: "ALSConfig",
            dtype: torch.dtype):
    """The implicit half-sweep's `solver_gram` of the table's first `n`
    rows, widened to `dtype` (through `gram_eig` when it takes the
    eigh)."""
    factors = table[:n].to(dtype)
    if cfg.dual:
        return gram_eig(factors)
    return solver_gram(factors.T @ factors, cfg)


def _solve_batch(factors_out, counter_factors, rows, idx, val, mask,
                 cfg: "ALSConfig", solver: str, gram=None) -> None:
    """Solve one [B, K] batch of normal equations (implicit when `gram`
    is given) and scatter the rows into `factors_out` (in place)."""
    nratings_reg = cfg.lambda_scaling == "nratings"
    if gram is not None:
        kind, A, rhs, to_rows = implicit_equations(
            counter_factors, gram, idx, val, mask, cfg.lam, cfg.alpha,
            cfg.rank, nratings_reg, cfg.compute_dtype, cfg.dual)
    else:
        kind, A, rhs, to_rows = normal_equations(
            counter_factors, idx, val, mask, cfg.lam, cfg.rank,
            nratings_reg, cfg.compute_dtype, cfg.dual)
    if kind == "dual":
        z = _dual_system_solve(A, rhs, idx.shape[1], solver,
                               iters_cap=cfg.dual_iters_cap,
                               plain_below=cfg.dual_plain_below)
    else:
        z = spd_solve(A, rhs, method=solver, iters=cfg.solver_iters,
                      compute_dtype=cfg.compute_dtype)
    del A
    _scatter_rows(factors_out, rows, to_rows(z))


DeviceBatch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def resolve_sweep_chunk(chunk: int) -> int:
    """0 (auto) -> 1: the reference merges by default only on a single
    TPU, where its solver calls carry a fixed cost; a caller asks for more
    by name."""
    return chunk or 1


HostBatch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def merge_batches(plan: SolvePlan, chunk: int) -> List[HostBatch]:
    """The plan's (rows, idx, val, mask) batches with every `chunk`
    same-shape batches concatenated into one of chunk*B systems, as the
    reference's `_upload_plan` groups them: shapes in sorted order, each
    shape's batches in plan order, m = min(chunk, n) batches per merge,
    and the n mod m that do not fill one stay batches of their own. The
    batches of a half-sweep are independent, so merging changes no
    answer. chunk <= 1 keeps the plan as it is."""
    batches = [(b.rows, b.idx, b.val, b.mask) for b in plan.batches]
    if chunk <= 1:
        return batches
    by_shape = {}
    for b in batches:
        by_shape.setdefault(b[1].shape, []).append(b)
    out = []
    for shape in sorted(by_shape):
        bs = by_shape[shape]
        m = min(chunk, len(bs))
        n_full = len(bs) // m * m
        for lo in range(0, n_full, m):
            out.append(tuple(np.concatenate([b[f] for b in bs[lo:lo + m]])
                             for f in range(4)))
        out.extend(bs[n_full:])
    return out


def _upload_plan(plan: SolvePlan, device: torch.device,
                 dtype: torch.dtype = torch.float32,
                 chunk: int = 1) -> List[DeviceBatch]:
    """Every (merged, see `merge_batches`) batch's (rows, idx, val, mask)
    on the device, once per train: the plan is constant across
    iterations."""
    return [(torch.from_numpy(rows).to(device).long(),
             torch.from_numpy(idx).to(device).long(),
             torch.from_numpy(val).to(device, dtype),
             torch.from_numpy(mask).to(device, dtype))
            for rows, idx, val, mask in merge_batches(plan, chunk)]


def _run_side(batches: Sequence[DeviceBatch], factors: torch.Tensor,
              counter_factors: torch.Tensor, cfg: ALSConfig,
              solver: str, gram=None) -> None:
    """One half-iteration: solve every batch of one side in place."""
    for rows, idx, val, mask in batches:
        _solve_batch(factors, counter_factors, rows, idx, val, mask, cfg,
                     solver, gram)


class _SideSync:
    """One half-sweep of a data-parallel train (P > 1 processes): the
    batches this process solves (every P-th, from its rank), and the sum
    over the processes that hands each process the rows the others
    solved. Each row is solved by exactly one batch, so the sum is
    exact: every process ends the half-sweep with the single-process
    table."""

    def __init__(self, batches: Sequence[DeviceBatch], mesh):
        n, r = mesh.n_processes, mesh.process
        self.mine = list(batches[r::n])

        def rows_of(bs):
            if not bs:
                return torch.zeros(0, dtype=torch.long, device=mesh.device)
            rows = torch.cat([b[0] for b in bs])
            return torch.unique(rows[rows >= 0])
        self.my_rows = rows_of(self.mine)
        self.all_rows = rows_of(list(batches))

    def run(self, table: torch.Tensor, counter: torch.Tensor,
            cfg: ALSConfig, solver: str, gram=None) -> None:
        from predictionio_tpu_torch.parallel.mesh import all_reduce
        _run_side(self.mine, table, counter, cfg, solver, gram)
        wide = torch.float32 if table.dtype == torch.bfloat16 \
            else table.dtype
        buf = torch.zeros(table.shape, dtype=wide, device=table.device)
        buf[self.my_rows] = table[self.my_rows].to(wide)
        all_reduce(buf)
        table[self.all_rows] = buf[self.all_rows].to(table.dtype)


def _iteration(U: torch.Tensor, V: torch.Tensor,
               user_batches: Sequence[DeviceBatch],
               item_batches: Sequence[DeviceBatch], cfg: ALSConfig,
               solver: str, n_users: int, n_items: int,
               dtype: torch.dtype, syncs=None) -> None:
    """One iteration in place: the user side against V, then the item
    side against the updated U (implicit: each after its counterpart's
    Gram). `syncs`, a data-parallel train's (user, item) `_SideSync`s,
    solve this process's share of each side and share the rows."""
    gram_v = gram_of(V, n_items, cfg, dtype) if cfg.implicit_prefs else None
    if syncs is None:
        _run_side(user_batches, U, V, cfg, solver, gram_v)
    else:
        syncs[0].run(U, V, cfg, solver, gram_v)
    gram_u = gram_of(U, n_users, cfg, dtype) if cfg.implicit_prefs else None
    if syncs is None:
        _run_side(item_batches, V, U, cfg, solver, gram_u)
    else:
        syncs[1].run(V, U, cfg, solver, gram_u)


def _gram_into(bufs: Tuple[torch.Tensor, ...], table: torch.Tensor,
               n: int, cfg: ALSConfig, dtype: torch.dtype) -> None:
    for dst, src in zip(bufs, gram_of(table, n, cfg, dtype)):
        dst.copy_(src)


class _FusedIteration:
    """One ALS iteration as CUDA graphs (`ALSConfig.fuse_iteration`).

    `parts` is the iteration in order, each (captured, fn): a captured
    part is recorded once into a graph and replayed, an eager one runs
    as it is each time. Only the implicit Grams under dual_solve='auto'
    are eager: their `torch.linalg.eigh` (cuSOLVER syevj) fails under
    stream capture, so that iteration is two graphs, the user side and
    the item side, each after its Gram's eager eigh into tensors the
    graph reads. Every other iteration is one graph.

    Before capture, `warmup` runs one iteration on copies of the tables
    on the device's capture stream (`compile/aot.capture_stream`), inside
    the process's capture slot, so the lazy set-up of libraries and handles happens
    outside the capture. Capture records without running; the kernel
    wrappers count their launches in Python as they are recorded, so the
    counts of the capture are taken back and `replay` adds them once a
    replay (`launches`, the wrappers' counts of one iteration). The
    tables and the plan's batches keep their addresses for the graphs'
    life: everything updates them in place. The warm-up and the capture
    count as one compile in `obs/torchmon`, booked to the enclosing
    executable label (`als_sweep` in `als_train`)."""

    def __init__(self, parts, warmup, device: torch.device):
        from predictionio_tpu_torch.compile.aot import (capture,
                                                        capture_slot,
                                                        capture_stream)
        from predictionio_tpu_torch.obs import torchmon
        from predictionio_tpu_torch.ops.solve import COUNTS
        t0 = time.perf_counter()
        self.parts = parts
        with capture_slot():
            side = capture_stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                warmup()
            torch.cuda.current_stream(device).wait_stream(side)
            synchronize(device)
            before = COUNTS.snapshot()
            pool = torch.cuda.graph_pool_handle()
            self.graphs = []
            for captured, fn in parts:
                graph = None
                if captured:
                    graph = torch.cuda.CUDAGraph()
                    capture(graph, fn, device, pool=pool)
                self.graphs.append(graph)
        self.launches = COUNTS.since(before)
        COUNTS.add(self.launches, -1)
        torchmon.record_compile(time.perf_counter() - t0)

    def replay(self) -> None:
        from predictionio_tpu_torch.ops.solve import COUNTS
        for (_, fn), graph in zip(self.parts, self.graphs):
            if graph is None:
                fn()
            else:
                graph.replay()
        COUNTS.add(self.launches)


def _fused_parts(U, V, user_batches, item_batches, cfg: ALSConfig,
                 solver: str, n_users: int, n_items: int,
                 dtype: torch.dtype) -> list:
    """`_FusedIteration`'s parts for this train."""
    if not cfg.implicit_prefs or not cfg.dual:
        return [(True, functools.partial(
            _iteration, U, V, user_batches, item_batches, cfg, solver,
            n_users, n_items, dtype))]
    parts = []
    for batches, out, counter, n in ((user_batches, U, V, n_items),
                                     (item_batches, V, U, n_users)):
        # buffers with the strides of the Gram's own outputs (eigh's Q is
        # column-major): each product then sees the layout, and so runs
        # the cuBLAS kernel, of the unfused train
        bufs = tuple(t.clone() for t in gram_of(counter, n, cfg, dtype))
        parts.append((False, functools.partial(_gram_into, bufs, counter,
                                               n, cfg, dtype)))
        parts.append((True, functools.partial(_run_side, batches, out,
                                              counter, cfg, solver, bufs)))
    return parts


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _init_factors(n: int, rank: int, seed: int, salt: int) -> np.ndarray:
    """The reference's initial table, byte for byte: |N(0,1)|/sqrt(rank)
    from the same numpy RNG stream, plus one trailing dummy row (the
    scatter target for padding)."""
    rng = np.random.default_rng(seed * 2654435761 % (2 ** 31) + salt)
    f = rng.standard_normal((n + 1, rank), dtype=np.float32)
    return np.abs(f) / np.sqrt(rank)


def _to_sharded(table: torch.Tensor, n_rows: int, mesh):
    """The first `n_rows` rows of a trained device table as a
    `ShardedTable` over `mesh`'s model axis, padded to its sharded row
    bucket: this process's shards, each a tensor of its own, attached as
    the resident handle. The host mirrors hold every shard: a train
    ends with the whole table in every process, so process 0 can persist
    it alone; a deployed process restores only its own."""
    from predictionio_tpu_torch.parallel.mesh import DeviceShards
    from predictionio_tpu_torch.parallel.sharded_table import ShardedTable
    n_shards = mesh.model_parallelism
    target = B.bucket_rows_sharded(n_rows, n_shards)
    per = target // n_shards
    owned = mesh.owned_parts(mesh.MODEL_AXIS)
    parts = []
    for j in owned:
        lo, hi = j * per, min((j + 1) * per, n_rows)
        part = table.new_zeros((per, table.shape[1]), dtype=torch.float32)
        if hi > lo:
            part[:hi - lo] = table[lo:hi]
        parts.append(part)
    dev = DeviceShards(parts, [j * per for j in owned],
                       (target, table.shape[1]), n_shards, 0, mesh)
    host = table.to("cpu", torch.float32).numpy()
    return ShardedTable.from_host(host, n_shards,
                                  padded_rows=target).attach_device(dev)


def _train_mesh(mesh, dev: torch.device, cfg: ALSConfig):
    """The mesh a train runs on: the one given, else the thread's active
    mesh on `dev`, else the process-wide mesh with one model shard a
    process; None for a replicated single-process train."""
    from predictionio_tpu_torch.parallel import mesh as M
    if mesh is not None:
        return mesh
    if cfg.factor_sharding != "model" and M.world_size() == 1:
        return None
    active = M.active_mesh()
    if active is not None and M._same_device(active.device, dev):
        return active
    return M.model_mesh(M.world_size(), dev)


def als_train(ratings: RatingsCOO, cfg: ALSConfig, device=None,
              telemetry: Optional[dict] = None, mesh=None) -> ALSModel:
    """Train explicit or implicit ALS on `device` (default: the mesh's,
    else the card).

    `mesh` (`parallel/mesh.MeshContext`) matters with
    `factor_sharding='model'` (its model axis splits the tables) and
    with more than one process (the train is data-parallel over them,
    module docstring); without one the thread's active mesh, else one
    model shard a process, is used.

    `telemetry`, when a dict, receives per-phase wall times (plan_s,
    upload_s, iters_s, s_per_iter, fetch_s, and iter_s, one per
    iteration), each closed by a device synchronize, and `solver_calls`,
    the number of batched solves the iterations ran (after `sweep_chunk`
    merging). A fused train on the card adds `capture_s` (the warm-up
    and the capture), `replays`, `warmup_calls` (the warm-up iteration's
    solves, launched on copies of the tables) and `captured_launches`
    (the kernel launches of one replay)."""
    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.device)
    mesh = _train_mesh(mesh, dev, cfg)
    solver = resolve_solver(cfg.solver, dev)
    t0 = time.perf_counter()
    user_plan = plan_for_users(ratings, work_budget=cfg.work_budget,
                               bucket_ratio=cfg.bucket_ratio)
    item_plan = plan_for_items(ratings, work_budget=cfg.work_budget,
                               bucket_ratio=cfg.bucket_ratio)
    logger.info(
        "ALS on %s (%s): %d users, %d items, %d ratings; %d user batches "
        "(pad %.2fx), %d item batches (pad %.2fx)", dev, solver,
        ratings.n_users, ratings.n_items, ratings.nnz,
        len(user_plan.batches), user_plan.padding_overhead,
        len(item_plan.batches), item_plan.padding_overhead)
    tel = telemetry if telemetry is not None else {}
    tel["plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # _init_factors divides by a numpy float64 scalar, so (as in the
    # reference, which casts to its factor dtype) cast to float32, then to
    # the table's dtype
    dtype = getattr(torch, cfg.dtype)
    table_dtype = (torch.bfloat16 if cfg.factor_dtype == "bfloat16"
                   else dtype)
    U = torch.from_numpy(_init_factors(ratings.n_users, cfg.rank, cfg.seed,
                                       1).astype(np.float32)).to(
                                           dev, table_dtype)
    V = torch.from_numpy(_init_factors(ratings.n_items, cfg.rank, cfg.seed,
                                       2).astype(np.float32)).to(
                                           dev, table_dtype)
    chunk = resolve_sweep_chunk(cfg.sweep_chunk)
    user_batches = _upload_plan(user_plan, dev, dtype, chunk)
    item_batches = _upload_plan(item_plan, dev, dtype, chunk)
    syncs = None
    if mesh is not None and mesh.n_processes > 1:
        syncs = (_SideSync(user_batches, mesh), _SideSync(item_batches,
                                                          mesh))
    synchronize(dev)
    tel["upload_s"] = time.perf_counter() - t0
    calls_per_iter = (len(user_batches) + len(item_batches) if syncs is None
                      else len(syncs[0].mine) + len(syncs[1].mine))
    step = functools.partial(_iteration, U, V, user_batches, item_batches,
                             cfg, solver, ratings.n_users, ratings.n_items,
                             dtype, syncs)
    # a graph holds no collective: a data-parallel train runs eagerly
    if cfg.fuse_iteration and dev.type == "cuda" and syncs is None:
        t0 = time.perf_counter()
        with costmon.executable(costmon.ALS_SWEEP, defer_to_outer=True):
            fused = _FusedIteration(
                _fused_parts(U, V, user_batches, item_batches, cfg, solver,
                             ratings.n_users, ratings.n_items, dtype),
                functools.partial(_iteration, U.clone(), V.clone(),
                                  user_batches, item_batches, cfg, solver,
                                  ratings.n_users, ratings.n_items, dtype),
                dev)
        step = fused.replay
        tel["capture_s"] = time.perf_counter() - t0
        tel["warmup_calls"] = calls_per_iter
        tel["captured_launches"] = dict(fused.launches)
        tel["replays"] = 0
    t0 = time.perf_counter()

    sentinel = None
    if cfg.sentinel:
        from predictionio_tpu_torch.guard.sentinels import (SweepSentinel,
                                                            device_copy,
                                                            guard_enabled)
        if guard_enabled():
            sentinel = SweepSentinel("train", 0.0,
                                     norm_floor=cfg.sentinel_norm_cap)
    last_good = None
    calls = 0
    tel["iter_s"] = []
    for it in range(cfg.iterations):
        t_it = time.perf_counter()
        # the span a profiler reads one iteration's device time from
        # (scripts/profile_torch_als.py); it ends after the synchronize
        # (the implicit Grams and their eigh run inside it)
        with torch.profiler.record_function("als_iteration"), \
                costmon.executable(costmon.ALS_SWEEP, defer_to_outer=True):
            step()
            calls += calls_per_iter
            synchronize(dev)
        tel["iter_s"].append(time.perf_counter() - t_it)
        if "replays" in tel:
            tel["replays"] += 1
        if sentinel is None:
            continue
        fault = (sentinel.check_table(U, f"iteration {it} user table")
                 or sentinel.check_table(V, f"iteration {it} item table"))
        if fault is None:
            # copies survive the next iteration's in-place updates
            last_good = (device_copy(U), device_copy(V))
            continue
        if last_good is None:
            raise fault
        logger.error("ALS %s — rolling back to iteration %d and stopping "
                     "early", fault, it - 1)
        # into the tables themselves: a fused train's graphs hold them
        U.copy_(last_good[0])
        V.copy_(last_good[1])
        break
    synchronize(dev)
    tel["iters_s"] = time.perf_counter() - t0
    tel["s_per_iter"] = tel["iters_s"] / max(cfg.iterations, 1)
    tel["solver_calls"] = calls
    t0 = time.perf_counter()
    # the model's tables are float32 whatever the train stored: the host
    # copy (as the reference's) and the serving copy
    U_dev = U[:ratings.n_users].to(dtype)
    V_dev = V[:ratings.n_items].to(dtype)
    if cfg.factor_sharding == "model" and cfg.keep_sharded:
        model = ALSModel(_to_sharded(U_dev, ratings.n_users, mesh),
                         _to_sharded(V_dev, ratings.n_items, mesh),
                         cfg.rank, dev)
        tel["fetch_s"] = time.perf_counter() - t0
        return model
    model = ALSModel(U_dev.cpu().numpy(), V_dev.cpu().numpy(), cfg.rank,
                     dev, _tables=(U_dev, V_dev))
    tel["fetch_s"] = time.perf_counter() - t0
    return model


# ---------------------------------------------------------------------------
# Scoring / prediction
# ---------------------------------------------------------------------------

def _users_topk_b(U: torch.Tensor, V: torch.Tensor, ixs: torch.Tensor,
                  n_items: int, k: int, p: int):
    """The serve program on bucket-padded tables: gather the users' rows,
    score every item, mask the padding rows past `n_items` (-inf, sorted
    last, dropped by the callers), top-k; with a pack mode `p` the one
    output is the readback payload (`ops/readback.pack_device`)."""
    scores = torch.matmul(U[ixs], V.T)
    if V.shape[0] > n_items:
        scores[:, n_items:] = float("-inf")
    s, i = torch.topk(scores, k, dim=1)
    return readback.pack_device(s, i, p) if p else (s, i)


def _aot_batch_predict_builder(bound, u: int = 0, i: int = 0, b: int = 0,
                               k: int = 0, r: int = 0, p: int = 0,
                               s: int = 0):
    """(program, example arguments) of one `batch_predict` bucket for the
    model `bound` names: its tables uploaded at the (u, i) row buckets,
    the batch of user indices the static input. `s` > 0 is the
    model-sharded layout: the item table's `s` shards at the row bucket
    `i`, the two-phase top-k (`ops/topk.py`), and the batch of user
    vectors (gathered from the host mirrors) the static input."""
    from predictionio_tpu_torch.utils.device_cache import cached_put_rows
    (model,) = bound
    if s:
        from predictionio_tpu_torch.compile.aot import sharded_aval
        from predictionio_tpu_torch.ops.topk import (
            _bound_program, make_batched_sharded_topk, sharded_k_split)
        from predictionio_tpu_torch.parallel.mesh import model_mesh
        mesh = model_mesh(s, model.device)
        k_local, k_final = sharded_k_split(k, i, s)
        fn = make_batched_sharded_topk(mesh, k_local, k_final, False,
                                       False, pack=p)
        V = model.item_factors.device(mesh, target_rows=i)
        return (functools.partial(_bound_program, fn, V, model.n_items),
                (sharded_aval((b, r), np.float32, mesh=mesh),))
    U = cached_put_rows(model.user_factors, u, model.device)
    V = cached_put_rows(model.item_factors, i, model.device)
    fn = functools.partial(_users_topk_b, U, V, n_items=model.n_items, k=k,
                           p=p)
    return fn, (torch.zeros(b, dtype=torch.int64, device=U.device),)


_aot_specs_registered = False


def register_aot_specs() -> None:
    """Register this module's executable spec with the compile plane
    (once; off import, so importing the module registers nothing)."""
    global _aot_specs_registered
    if _aot_specs_registered:
        return
    from predictionio_tpu_torch.compile.aot import get_aot
    get_aot().register(costmon.BATCH_PREDICT, _aot_batch_predict_builder)
    _aot_specs_registered = True


def batch_predict_dims(model: ALSModel, batch: int, k: int) -> dict:
    """The shape-bucket dims of one batched serve top-k over `model`,
    shared by the serve dispatch and the deploy warm-up: the tables' row
    buckets `u` and `i`, the batch bucket `b`, the top-k bucket `k` (a
    pow2 from 16, at most `i`), the rank `r` and the pack mode `p`. A
    model-sharded item table gets the sharded layout's dims: `s` (its
    shard count), `i` its sharded row bucket and no `u` (the user rows
    come from the host mirrors), so the two layouts never share a
    bucket."""
    from predictionio_tpu_torch.parallel.sharded_table import is_sharded
    if is_sharded(model.item_factors):
        V = model.item_factors
        i_b = max(V.padded_rows,
                  B.bucket_rows_sharded(model.n_items, V.n_shards))
        return {"i": i_b, "b": B.bucket_batch(batch),
                "k": min(B.bucket_batch(k, floor=B.K_FLOOR), i_b),
                "r": model.rank, "s": V.n_shards,
                "p": readback.pack_flag()}
    i_b = B.bucket_rows(model.n_items)
    return {"u": B.bucket_rows(model.n_users), "i": i_b,
            "b": B.bucket_batch(batch),
            "k": min(B.bucket_batch(k, floor=B.K_FLOOR), i_b),
            "r": model.rank, "p": readback.pack_flag()}


def users_topk_serve(model: ALSModel, user_ixs, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """`users_topk_serve_begin(...)()`."""
    return users_topk_serve_begin(model, user_ixs, k)()


def users_topk_serve_begin(model: ALSModel, user_ixs, k: int):
    """The serve path's batched top-k, in two stages: enqueue the work
    and the copy of its result to the host now, return `finish() ->
    (scores [n, k_b], idx [n, k_b])` that waits for that copy. The
    tables are uploaded at their row buckets (`cached_put_rows`, once per
    model), the batch pads to its bucket (with user 0) and k to its
    bucket (`batch_predict_dims`); slots past the model's items come back
    -inf, which the callers drop. The work dispatches through the
    executable registry (`compile/aot.py`): a bucket captured for this
    model replays its graph, another runs eagerly and is captured in the
    background. No next row bucket is captured ahead of growth (the
    reference's promotion): a graph is keyed on this model, whose buckets
    never change, and bakes in the addresses of its tables, so a grown
    model (a new object with new uploads) could never replay it; its
    first window misses and is captured under its own key. The result
    rides `PIO_SERVE_PACK`'s payload (`ops/readback.py`). `finish` may
    run on another thread; it is the only wait."""
    from predictionio_tpu_torch.compile.aot import get_aot
    from predictionio_tpu_torch.parallel.sharded_table import is_sharded
    from predictionio_tpu_torch.utils.device_cache import cached_put_rows
    register_aot_specs()
    user_ixs = np.asarray(user_ixs, dtype=np.int64)
    n = user_ixs.shape[0]
    dims = batch_predict_dims(model, n, k)
    if is_sharded(model.item_factors):
        return _users_topk_serve_sharded_begin(model, user_ixs, dims)
    ixs = np.zeros(dims["b"], dtype=np.int64)
    ixs[:n] = user_ixs
    U = cached_put_rows(model.user_factors, dims["u"], model.device)
    V = cached_put_rows(model.item_factors, dims["i"], model.device)
    k_b, p = dims["k"], dims["p"]
    # a gates probe's dispatch keeps its gates_probe attribution
    with costmon.executable(costmon.BATCH_PREDICT, defer_to_outer=True):
        out = get_aot().dispatch(
            costmon.BATCH_PREDICT, dims,
            functools.partial(_users_topk_b, U, V, n_items=model.n_items,
                              k=k_b, p=p),
            readback.to_device(ixs, U.device), bound=(model,))
    fetch = (readback.begin_fetch_packed(out, p) if p
             else readback.begin_fetch(*out))

    def finish() -> Tuple[np.ndarray, np.ndarray]:
        s, i = fetch()
        return s[:n], i[:n]
    return finish


def _users_topk_serve_sharded_begin(model: ALSModel, user_ixs: np.ndarray,
                                    dims: dict):
    """The sharded route of `users_topk_serve_begin`: the query vectors
    gathered from the user table's host mirrors (the user table takes no
    serving memory on the device), the item table's resident shards
    (uploaded at the bucket `i` when the table is padded below it; the
    published model is never changed from the serve path), and the
    two-phase top-k (`ops/topk.batched_sharded_top_k_begin`) dispatched
    under the same `batch_predict` label, keyed on the model and its
    shard layout. Returns `finish() -> (scores, idx)`."""
    from predictionio_tpu_torch.ops.topk import batched_sharded_top_k_begin
    from predictionio_tpu_torch.parallel.mesh import model_mesh
    from predictionio_tpu_torch.parallel.sharded_table import gather_rows
    V = model.item_factors
    mesh = model_mesh(V.n_shards, model.device)
    n = user_ixs.shape[0]
    q = np.zeros((dims["b"], model.rank), dtype=np.float32)
    q[:n] = gather_rows(model.user_factors, user_ixs)
    with costmon.executable(costmon.BATCH_PREDICT, defer_to_outer=True):
        fetch = batched_sharded_top_k_begin(
            V.device(mesh, target_rows=dims["i"]), q, model.n_items,
            dims["k"], mesh, label=costmon.BATCH_PREDICT, dims=dims,
            bound=(model,))

    def finish() -> Tuple[np.ndarray, np.ndarray]:
        s, i = fetch()
        return s[:n], i[:n]
    return finish


def recommend_products(model: ALSModel, user_ix: int, k: int,
                       exclude: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k items for one user (recommendProducts); `exclude`d item
    indices score -inf. Returns host (scores, item indices)."""
    U, V = model.tables()
    scores = torch.matmul(V, U[int(user_ix)])
    if exclude is not None and len(exclude):
        ex = torch.as_tensor(np.asarray(exclude, dtype=np.int64),
                             device=model.device)
        scores[ex] = -torch.inf
    s, i = torch.topk(scores, min(k, model.n_items))
    return s.cpu().numpy(), i.cpu().numpy()


def recommend_products_sharded(model: ALSModel, user_ix: int, k: int,
                               mesh=None,
                               exclude: Optional[np.ndarray] = None,
                               allowed_mask: Optional[np.ndarray] = None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k items for one user with the item table split over the
    mesh's model axis (a `ShardedTable`'s resident shards, or a whole
    host table's split upload at its sharded row bucket, made once,
    `cached_put_rows`): the user row from the host mirrors
    (`gather_rows`), then the two-phase top-k (`ops/topk.sharded_top_k`).
    `exclude`d items and those `allowed_mask` leaves out score -inf.
    Returns host (scores, item indices)."""
    from predictionio_tpu_torch.ops.topk import sharded_top_k
    from predictionio_tpu_torch.parallel.mesh import model_mesh
    from predictionio_tpu_torch.parallel.sharded_table import (gather_rows,
                                                               is_sharded)
    from predictionio_tpu_torch.utils.device_cache import cached_put_rows
    V = model.item_factors
    if mesh is None:
        mesh = model_mesh(V.n_shards if is_sharded(V) else 1, model.device)
    if is_sharded(V):
        V_dev = V.device(mesh)
    else:
        V_dev = cached_put_rows(
            V, B.bucket_rows_sharded(model.n_items, mesh.model_parallelism),
            sharding=mesh.model_sharded(2))
    mask = np.zeros(V_dev.shape[0], dtype=bool)
    mask[:model.n_items] = (True if allowed_mask is None
                            else np.asarray(allowed_mask,
                                            dtype=bool)[:model.n_items])
    if exclude is not None and len(np.atleast_1d(exclude)):
        mask[np.asarray(exclude, dtype=np.int64)] = False
    mask_dev = mesh.put(mask, mesh.sharding(mesh.MODEL_AXIS))
    u = gather_rows(model.user_factors, [int(user_ix)])[0]
    k_eff = min(k, model.n_items)
    scores, idx = sharded_top_k(V_dev, u, k_eff, mesh,
                                allowed_mask_sharded=mask_dev)
    return scores[:k_eff], idx[:k_eff]


def predict_ratings(model: ALSModel, user_ix: np.ndarray,
                    item_ix: np.ndarray, chunk: int = 1 << 20
                    ) -> np.ndarray:
    """Pointwise r_hat = u . v for parallel (user, item) index arrays. A
    model with sharded tables gathers the rows from its host mirrors."""
    from predictionio_tpu_torch.parallel.sharded_table import (is_sharded,
                                                               table_rows)
    if is_sharded(model.user_factors) or is_sharded(model.item_factors):
        out = np.empty(len(user_ix), dtype=np.float32)
        for lo in range(0, len(user_ix), chunk):
            sl = slice(lo, lo + chunk)
            out[sl] = np.sum(
                table_rows(model.user_factors, user_ix[sl])
                * table_rows(model.item_factors, item_ix[sl]), axis=-1)
        return out
    U, V = model.tables()
    out = np.empty(len(user_ix), dtype=np.float32)
    for lo in range(0, len(user_ix), chunk):
        sl = slice(lo, lo + chunk)
        ui = torch.as_tensor(np.asarray(user_ix[sl], dtype=np.int64),
                             device=model.device)
        ii = torch.as_tensor(np.asarray(item_ix[sl], dtype=np.int64),
                             device=model.device)
        out[sl] = (U[ui] * V[ii]).sum(dim=-1).cpu().numpy()
    return out


def als_rmse(model: ALSModel, ratings: RatingsCOO) -> float:
    pred = predict_ratings(model, ratings.user_idx, ratings.item_idx)
    return float(np.sqrt(np.mean((pred - ratings.rating) ** 2)))
