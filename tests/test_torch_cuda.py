"""The CUDA kernels on the card: each held against its plain PyTorch
version, and the ALS trains (explicit through the CG kernel, implicit
through the Cholesky kernel, explicit and implicit at bf16 compute through
the Schulz kernel) on the card against the same trains on the CPU, the
fold-in (every solve through the CG kernel) against the same fold on the
CPU, the recommendation and e-commerce templates' store ->
`create_workflow_main` -> `EngineServer.load` round trips on the card, the
recommended-user train through the CG kernel, the DIMSUM Gram on the
card against the CPU's, the fused (CUDA graph) trains and the bf16
tables, the naive Bayes counts and forest growth on the card against
the CPU's, the data plane's pinned staging (a copy stream, an event a
segment) and its executor on the card, the e2 library on the card
against the CPU, a feedback deploy on the card whose every answer
lands through the event server as a `predict` event, and the compile
plane: a captured serve graph's replay bit-equal to the eager program,
a new model's tables never served by the old model's graphs, two windows
in flight each reading their own outputs, and a sampled CUDA-event
device time inside its dispatch's wall; the diagnostics plane: the
torch.profiler device trace of a fold naming the CG kernel once a launch,
and a slow window's waterfall, its `device_sync` stage included, built
with no synchronize; the example engines: SimRank and the stock
engine's batched OLS on the card against float64; and an ALS train fed
by a nativelog `find_columnar`, every solve a CG kernel launch.

These tests need a CUDA card (a CUDA kernel has no CPU mode) and skip
without one. On a machine with a card and without JAX, run them with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`tests/conftest.py` configures JAX for the rest of the suite).
"""

import json
import os

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.data.synthetic import small_ratings
from predictionio_tpu_torch.ops import als as TA
from predictionio_tpu_torch.ops import solve as T
from predictionio_tpu_torch.ops.ratings import RatingsCOO

pytestmark = pytest.mark.cuda

CG_REL_TOL = 1e-4      # same algorithm and iterations, sums in another order
# Cholesky kernel vs its plain version: the same factorisation with sums in
# another order; the tolerance is 4x what f32 rounding moves the plain
# version (its f32 run against its f64 run), never below 1e-4
CHOL_REL_TOL = 1e-4
FAULT_MARGIN = 10      # a planted fault moves x by >= 10 tolerances
# ALS factors, of the largest factor magnitude, as test_torch_als: 1e-4 at
# lam=0.1; at lam=0.01, 4x the f32-vs-f64 reading of 1.0e-4
# (scripts/torch_als_rounding.py)
FACTOR_TOL = {0.1: 1e-4, 0.01: 4e-4}
# implicit ALS factors: 4x the f32-vs-f64 reading of 3.7e-6, as
# tests/test_torch_implicit.py
IMPLICIT_FACTOR_TOL = 1.5e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def hard_systems(B, R, seed, device):
    """The systems of chip_smoke.py's kernel phase: the Gram of 2R rows
    with a spectrum falling over a decade, a 1e-2 ridge, and a symmetric
    e^U(-1,1) scaling so the Jacobi preconditioner matters."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((B, 2 * R, R)) * np.logspace(0, -1, R)
    A = np.einsum("bkr,bks->brs", V, V) / (2 * R) + 1e-2 * np.eye(R)
    d = np.exp(rng.uniform(-1, 1, (B, R)))
    A = d[:, :, None] * A * d[:, None, :]
    b = rng.standard_normal((B, R))
    return (torch.tensor(A, dtype=torch.float32, device=device),
            torch.tensor(b, dtype=torch.float32, device=device))


def cg_unpreconditioned(A, b, iters):
    """A planted fault: the plain CG without its Jacobi preconditioner."""
    x, r = torch.zeros_like(b), b
    p, rr = r, (r * r).sum(dim=1)
    for _ in range(iters):
        Ap = torch.bmm(A, p.unsqueeze(-1)).squeeze(-1)
        alpha = rr / torch.clamp((p * Ap).sum(dim=1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rr2 = (r * r).sum(dim=1)
        p = r + (rr2 / torch.clamp(rr, min=1e-30))[:, None] * p
        rr = rr2
    return x


def rel(x, ref):
    return ((x - ref).abs().max() / ref.abs().max()).item()


CG_GEOMETRY = {8: "warp", 40: "registers", 200: "registers", 256: "global"}


@pytest.mark.parametrize("R,B,iters", [(8, 33, 16), (40, 17, 48),
                                       (200, 5, 48), (256, 3, 48)])
def test_cg_kernel_matches_plain(cuda, R, B, iters):
    """Held at every checkpoint, so the early iterates pin the algorithm;
    R = 8 packs four systems a warp, 40 and 200 hold A in registers, and
    R = 256 takes the branch that reads A from global memory."""
    A, b = hard_systems(B, R, seed=R, device=cuda)
    for k in sorted({1, 2, 4, iters // 2, iters}):
        xk = T.cg_solve_cuda(A, b, k)
        torch.cuda.synchronize()
        assert torch.isfinite(xk).all()
        assert rel(xk, T.cg_solve(A, b, k)) <= CG_REL_TOL
    assert T.cg_device_geometry(R) == CG_GEOMETRY[R] == T.cg_geometry(
        R, T.cg_smem_optin())


@pytest.mark.parametrize("R,B,iters", [(5, 3, 13), (16, 21, 24),
                                       (27, 37, 35), (32, 9, 40),
                                       (33, 11, 41), (104, 7, 48),
                                       (105, 5, 48), (197, 139, 48),
                                       (208, 4, 48), (209, 3, 48),
                                       (240, 3, 48), (241, 2, 48)])
def test_cg_kernel_at_geometry_borders(cuda, R, B, iters):
    """Each side of every geometry's border: the team sizes of the warp
    geometry (8, 16, 32 lanes; R = 27 not a multiple of 4), one and two
    lanes a row in the registers geometry (R = 104 / 105), its largest R
    (208), the shared-memory stream kernel (209, 240) and the
    global-memory one (241); B = 139 is more systems than SMs, so the
    persistent blocks take several systems each through the stage."""
    A, b = hard_systems(B, R, seed=R + 3, device=cuda)
    for k in sorted({1, 2, iters}):
        xk = T.cg_solve_cuda(A, b, k)
        torch.cuda.synchronize()
        assert rel(xk, T.cg_solve(A, b, k)) <= CG_REL_TOL
    assert T.cg_device_geometry(R) == T.cg_geometry(R, T.cg_smem_optin())


def test_cg_geometry_mirror_matches_the_kernel(cuda):
    """ops/solve.py:cg_geometry is the kernel's own choice at every R."""
    optin = T.cg_smem_optin()
    assert all(T.cg_geometry(R, optin) == T.cg_device_geometry(R)
               for R in range(1, T._cg_lib().pio_cg_solve_max_rank() + 1))


@pytest.mark.parametrize("R,B", [(8, 1001), (24, 301), (56, 140),
                                 (144, 140), (200, 300), (256, 5)])
def test_cg_kernel_is_deterministic(cuda, R, B):
    """Two launches are bit-equal in every geometry, with more systems
    than SMs (persistent blocks, packed teams)."""
    A, b = hard_systems(B, R, seed=R + 5, device=cuda)
    assert torch.equal(T.cg_solve_cuda(A, b, R + 8),
                       T.cg_solve_cuda(A, b, R + 8))


@pytest.mark.parametrize("R,iters", [(8, 16), (200, 48)])
def test_cg_check_sees_planted_faults(cuda, R, iters):
    """The kernel run with half its iterations, and a CG without the
    preconditioner, each miss the plain CG by far more than the
    tolerance at some checkpoint."""
    A, b = hard_systems(9, R, seed=R + 1, device=cuda)
    half = noprec = 0.0
    for k in sorted({1, 2, 4, iters // 2, iters}):
        xp = T.cg_solve(A, b, k)
        half = max(half, rel(T.cg_solve_cuda(A, b, k // 2), xp))
        noprec = max(noprec, rel(cg_unpreconditioned(A, b, k), xp))
    assert min(half, noprec) >= FAULT_MARGIN * CG_REL_TOL


def test_cg_kernel_padding_solves_to_zero(cuda):
    for R in (24, 8, 56, 200, 232, 256):
        A = (0.01 * torch.eye(R, device=cuda)).expand(4, R, R).contiguous()
        x = T.cg_solve_cuda(A, torch.zeros(4, R, device=cuda), 48)
        assert torch.equal(x, torch.zeros_like(x))


def test_cg_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    A, b = hard_systems(2, 16, seed=0, device=cuda)
    with pytest.raises(TypeError):
        T.cg_solve_cuda(A.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        T.cg_solve_cuda(A.transpose(1, 2), b)
    with pytest.raises(ValueError, match="one CUDA device"):
        T.cg_solve_cuda(A, b.cpu())


@pytest.mark.parametrize("lam", [0.1, 0.01])
def test_als_train_on_the_card_goes_through_the_kernel(cuda, lam):
    coo = RatingsCOO(*small_ratings())
    kw = dict(rank=16, iterations=3, lam=lam, work_budget=512, seed=2)
    T.COUNTS.reset()
    tel = {}
    on_card = TA.als_train(coo, TA.ALSConfig(**kw), device=cuda,
                           telemetry=tel)
    assert T.COUNTS.cg_solve == tel["solver_calls"] > 0
    assert T.COUNTS.cg_solve_plain == 0
    on_cpu = TA.als_train(coo, TA.ALSConfig(solver="cg", **kw), device="cpu")
    for a, b in ((on_cpu.user_factors, on_card.user_factors),
                 (on_cpu.item_factors, on_card.item_factors)):
        assert np.abs(a - b).max() <= FACTOR_TOL[lam] * np.abs(a).max()


@pytest.mark.parametrize("implicit,lam,every_user", [
    (False, 0.1, False), (False, 0.01, False), (True, 0.1, False),
    (False, 0.1, True)])    # every user touched: inert batches in the plan
def test_fold_in_on_the_card_goes_through_the_kernel(cuda, implicit, lam,
                                                     every_user):
    """A two-sweep fold of a small model on grown vocabularies: every
    solve, primal and dual, is a launch of the CG kernel (the template's
    'auto' solver); the rows match the same fold on the CPU through the
    plain CG, and the rows it did not touch are the deployed rows."""
    from predictionio_tpu_torch.online import fold_in as TF
    ui, ii, vv, n_u, n_i = small_ratings()
    rng = np.random.default_rng(7)
    U = (np.abs(rng.standard_normal((n_u, 16))) / 4).astype(np.float32)
    V = (np.abs(rng.standard_normal((n_i, 16))) / 4).astype(np.float32)
    eu = np.repeat(np.arange(n_u, n_u + 3), 5)
    ei = rng.integers(0, n_i + 2, eu.size)
    coo = RatingsCOO(np.concatenate([ui, eu]).astype(np.int32),
                     np.concatenate([ii, ei]).astype(np.int32),
                     np.concatenate([vv, rng.integers(1, 6, eu.size)]
                                    ).astype(np.float32), n_u + 3, n_i + 2)
    tu = (np.arange(n_u + 3) if every_user else
          np.concatenate([rng.choice(n_u, 10, replace=False),
                          np.arange(n_u, n_u + 3)]))
    ti = np.concatenate([rng.choice(n_i, 5, replace=False), [n_i, n_i + 1]])
    kw = dict(lam=lam, implicit_prefs=implicit, sweeps=2,
              work_budget=128 if every_user else 512)
    T.COUNTS.reset()
    on_card, stats = TF.fold_in_coo(TA.ALSModel(U, V, 16, None), coo, tu,
                                    ti, TF.FoldInConfig(**kw), device=cuda)
    assert T.COUNTS.cg_solve == stats.solver_calls > 0
    assert T.COUNTS.cg_solve_plain == T.COUNTS.chol_solve == 0
    assert on_card.tables()[0].device.type == "cuda"
    on_cpu, _ = TF.fold_in_coo(TA.ALSModel(U, V, 16, None), coo, tu, ti,
                               TF.FoldInConfig(solver="cg_cuda", **kw),
                               device="cpu")
    for a, b in ((on_cpu.user_factors, on_card.user_factors),
                 (on_cpu.item_factors, on_card.item_factors)):
        assert np.abs(a - b).max() <= FACTOR_TOL[lam] * np.abs(a).max()
    keep = np.setdiff1d(np.arange(n_u), tu)
    assert np.array_equal(on_card.user_factors[keep], U[keep])


def chol_tolerance(A, b):
    """max(CHOL_REL_TOL, 4x the plain version's f32-vs-f64 reading)."""
    x32 = T.chol_solve(A, b)
    rounding = rel(x32.double(), T.chol_solve(A.double(), b.double()))
    return x32, max(CHOL_REL_TOL, 4 * rounding)


@pytest.mark.parametrize("R,B", [(200, 37), (27, 41), (5, 9), (192, 16)])
def test_chol_kernel_matches_plain(cuda, R, B):
    """R = 200 (the primal route), 192 (a dual bucket), 27 (not a multiple
    of the panel width 8) and 5 (below one panel)."""
    A, b = hard_systems(B, R, seed=R + 7, device=cuda)
    xk = T.chol_solve_cuda(A, b)
    torch.cuda.synchronize()
    xp, tol = chol_tolerance(A, b)
    assert torch.isfinite(xk).all()
    assert rel(xk, xp) <= tol


@pytest.mark.parametrize("R,B", [(25, 17), (32, 9), (33, 13), (64, 7),
                                 (65, 7), (128, 5), (129, 5), (232, 4),
                                 (320, 2)])
def test_chol_kernel_at_geometry_borders(cuda, R, B):
    """Each side of the packed geometry's border (Rp = 32 / 40), of the
    64-, 128- and 256-thread blocks, R = 232 (the first kernel's limit)
    and the largest R the packed tiles fit (320 on an H100)."""
    if R > T.chol_max_rank(cuda):
        pytest.skip(f"R = {R} exceeds this card's shared memory")
    A, b = hard_systems(B, R, seed=R + 9, device=cuda)
    xk = T.chol_solve_cuda(A, b)
    torch.cuda.synchronize()
    xp, tol = chol_tolerance(A, b)
    assert rel(xk, xp) <= tol
    assert T.chol_device_threads(R) == T.chol_layout(R)[1]


def test_chol_layout_mirror_matches_the_kernel(cuda):
    """ops/solve.py's chol_layout and chol_rank_limit are the kernel's
    own threads and limit at every R."""
    max_rank = T.chol_max_rank(cuda)
    assert max_rank == T.chol_rank_limit(T.cg_smem_optin()) >= 232
    assert all(T.chol_device_threads(R) == T.chol_layout(R)[1]
               for R in range(1, max_rank + 1))


@pytest.mark.parametrize("R,B", [(8, 1001), (27, 301), (56, 140),
                                 (200, 300)])
def test_chol_kernel_is_deterministic(cuda, R, B):
    """Two launches are bit-equal, packed (8 systems a block) and one
    system a block, with more systems than SMs."""
    A, b = hard_systems(B, R, seed=R + 13, device=cuda)
    assert torch.equal(T.chol_solve_cuda(A, b), T.chol_solve_cuda(A, b))


def test_chol_kernel_reads_only_the_lower_triangle(cuda):
    A, b = hard_systems(6, 40, seed=3, device=cuda)
    junk = torch.triu(torch.full_like(A, float("nan")), diagonal=1)
    xk = T.chol_solve_cuda(torch.tril(A) + torch.nan_to_num(junk, 7.0), b)
    assert rel(xk, T.chol_solve_cuda(A, b)) == 0.0


def test_chol_kernel_padding_solves_to_zero(cuda):
    for R in (8, 27, 200):
        A = (0.01 * torch.eye(R, device=cuda)).expand(4, R, R).contiguous()
        x = T.chol_solve_cuda(A, torch.zeros(4, R, device=cuda))
        assert torch.equal(x, torch.zeros_like(x))


def test_chol_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    A, b = hard_systems(2, 16, seed=0, device=cuda)
    with pytest.raises(TypeError):
        T.chol_solve_cuda(A.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        T.chol_solve_cuda(A.transpose(1, 2), b)
    R = T.chol_max_rank(cuda) + 1
    with pytest.raises(ValueError, match="shared memory"):
        T.chol_solve_cuda(torch.eye(R, device=cuda)[None].contiguous(),
                          torch.zeros(1, R, device=cuda))


@pytest.mark.parametrize("negatives", [False, True])
def test_implicit_train_on_the_card_goes_through_the_chol_kernel(cuda,
                                                                 negatives):
    """Every implicit solve, primal and eig-SMW dual, is a launch of the
    Cholesky kernel; the factors match the same train on the CPU (the
    plain blocked Cholesky) within IMPLICIT_FACTOR_TOL."""
    ui, ii, vv, n_u, n_i = small_ratings()
    if negatives:
        vv = vv.copy()
        vv[::5] *= -1
    coo = RatingsCOO(ui, ii, vv, n_u, n_i)
    kw = dict(rank=16, iterations=3, lam=0.01, work_budget=512, seed=2,
              implicit_prefs=True, alpha=1.0, solver="chol_cuda")
    T.COUNTS.reset()
    tel = {}
    on_card = TA.als_train(coo, TA.ALSConfig(**kw), device=cuda,
                           telemetry=tel)
    assert T.COUNTS.chol_solve == tel["solver_calls"] > 0
    assert T.COUNTS.chol_solve_plain == T.COUNTS.cg_solve == 0
    on_cpu = TA.als_train(coo, TA.ALSConfig(**kw), device="cpu")
    for a, b in ((on_cpu.user_factors, on_card.user_factors),
                 (on_cpu.item_factors, on_card.item_factors)):
        assert np.abs(a - b).max() <= IMPLICIT_FACTOR_TOL * np.abs(a).max()


def factor_spread(m, ref):
    """max |m - ref| over max |ref|, across both factor tables."""
    return max(float(np.abs(a.astype(np.float64) - b).max()
                     / np.abs(b).max())
               for a, b in ((m.user_factors, ref.user_factors),
                            (m.item_factors, ref.item_factors)))


def schulz_tolerance(A, b, iters, cd):
    """max(1e-4, 4x the plain Schulz's f32-vs-f64-sum reading)."""
    x32 = T.schulz_solve(A, b, iters, cd)
    rounding = rel(x32.double(),
                   T.schulz_solve(A.double(), b.double(), iters, cd))
    return x32, max(1e-4, 4 * rounding)


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("R,B,iters", [(200, 9, 18), (176, 5, 184),
                                       (27, 33, 18), (8, 65, 16),
                                       (5, 7, 13), (16, 41, 24),
                                       (32, 19, 40), (56, 11, 64),
                                       (120, 6, 128), (144, 5, 152)])
def test_schulz_kernel_matches_plain(cuda, R, B, iters, cd):
    """At checkpoints 1, 2, 5 and `iters` steps (before convergence a
    wrong step shows directly): the primal R = 200, the path's duals
    K = 8, 16, 32, 56, 120, 144 and 176 with K + 8 steps (the bf16
    kernel's packed, shared-memory-master and workspace-master
    geometries), R = 27 (not a multiple of 8 or 16) and R = 5."""
    A, b = hard_systems(B, R, seed=R + 11, device=cuda)
    for k in sorted({1, 2, 5, iters}):
        xk = T.schulz_solve_cuda(A, b, k, cd)
        torch.cuda.synchronize()
        xp, tol = schulz_tolerance(A, b, k, cd)
        assert torch.isfinite(xk).all()
        assert rel(xk, xp) <= tol


def test_schulz_kernel_padding_and_empty_batch(cuda):
    """Plan padding systems solve to exactly 0 in every geometry: packed
    (R = 8, 16, 27), master X in shared memory (120) and in the
    workspace (200)."""
    for R in (8, 16, 27, 120, 200):
        A = (0.01 * torch.eye(R, device=cuda)).expand(4, R, R).contiguous()
        for cd in ("bfloat16", "float32"):
            x = T.schulz_solve_cuda(A, torch.zeros(4, R, device=cuda), 18,
                                    cd)
            assert torch.equal(x, torch.zeros_like(x))
    x = T.schulz_solve_cuda(torch.zeros(0, 8, 8, device=cuda),
                            torch.zeros(0, 8, device=cuda))
    assert x.shape == (0, 8)


@pytest.mark.parametrize("R,B", [(64, 40), (176, 140), (200, 140)])
def test_schulz_kernel_is_deterministic(cuda, R, B):
    """Bitwise equal over two calls, at R = 176 and 200 (the bf16 master X
    in the L2-resident workspace) with more systems than SMs."""
    A, b = hard_systems(B, R, seed=5, device=cuda)
    for cd in ("bfloat16", "float32"):
        assert torch.equal(T.schulz_solve_cuda(A, b, 20, cd),
                           T.schulz_solve_cuda(A, b, 20, cd))


def test_schulz_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    A, b = hard_systems(2, 16, seed=0, device=cuda)
    with pytest.raises(TypeError):
        T.schulz_solve_cuda(A.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        T.schulz_solve_cuda(A.transpose(1, 2), b)
    with pytest.raises(ValueError, match="compute_dtype"):
        T.schulz_solve_cuda(A, b, 18, "float16")
    assert T.schulz_max_rank(cuda, "bfloat16") >= 200
    for cd in ("bfloat16", "float32"):
        R = T.schulz_max_rank(cuda, cd) + 1
        with pytest.raises(ValueError, match="shared memory"):
            T.schulz_solve_cuda(torch.eye(R, device=cuda)[None].contiguous(),
                                torch.zeros(1, R, device=cuda), 18, cd)


@pytest.mark.parametrize("implicit", [False, True])
def test_bf16_schulz_train_on_the_card_goes_through_the_kernel(cuda,
                                                               implicit):
    """Every solve, primal and dual, is a launch of the Schulz kernel; the
    factors match the same train on the CPU (the plain Schulz) within 4x
    the CPU train's own f32-vs-f64 reading (never below 1e-4)."""
    coo = RatingsCOO(*small_ratings())
    kw = dict(rank=16, iterations=3, lam=0.1 if not implicit else 0.01,
              work_budget=512, seed=2, solver="schulz_cuda",
              compute_dtype="bfloat16", sweep_chunk=4,
              implicit_prefs=implicit)
    T.COUNTS.reset()
    tel = {}
    on_card = TA.als_train(coo, TA.ALSConfig(**kw), device=cuda,
                           telemetry=tel)
    assert T.COUNTS.schulz_solve == tel["solver_calls"] > 0
    assert T.COUNTS.schulz_solve_plain == T.COUNTS.cg_solve == 0
    on_cpu = TA.als_train(coo, TA.ALSConfig(**kw), device="cpu")
    f64 = TA.als_train(coo, TA.ALSConfig(dtype="float64", **kw),
                       device="cpu")
    tol = max(1e-4, 4 * factor_spread(on_cpu, f64))
    assert factor_spread(on_card, on_cpu) <= tol


def test_store_train_and_deploy_on_the_card(cuda, tmp_path, monkeypatch):
    """Events in a SQLite store -> `create_workflow_main` (every solve
    through the CG kernel) -> a persisted instance -> a server that
    restores it onto the card; its answers are the CPU train's."""
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.storage import registry
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.models import recommendation as TR
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                                 create_workflow_main)
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "pio"))
    registry.clear_cache()
    try:
        ui, ii, vv, _, n_items = small_ratings()
        app_id = registry.Storage.get_meta_data_apps().insert(App(0, "a"))
        ev = registry.Storage.get_events()
        ev.insert_columnar(ColumnarBatch(
            len(vv), "rate", "user", [f"u{u}" for u in ui], "item",
            [f"i{i}" for i in ii], [{"rating": float(v)} for v in vv]),
            app_id)
        ev.insert_columnar(ColumnarBatch(
            n_items, "$set", "item", [f"i{i}" for i in range(n_items)],
            properties=[{"categories": [f"c{i % 3}"],
                         "creationYear": 1990 + i % 20}
                        for i in range(n_items)]), app_id)
        algo = dict(rank=16, num_iterations=3, lam=0.1, seed=2)
        path = tmp_path / "engine.json"
        path.write_text(json.dumps({
            "engineFactory": "recommendation",
            "datasource": {"params": {"app_name": "a", "read_items": True}},
            "algorithms": [{"name": "als", "params": algo}]}))
        T.COUNTS.reset()
        tel = {}
        iid = create_workflow_main(WorkflowConfig(engine_variant=str(path)),
                                   telemetry=tel)
        assert T.COUNTS.cg_solve == tel["algorithms"][0]["solver_calls"] > 0
        assert T.COUNTS.cg_solve_plain == 0
        srv = EngineServer(ServerConfig(engine_variant=str(path))).load()
        assert srv.engine_instance.id == iid
        (model,) = srv.models
        assert model.als.tables()[0].device.type == "cuda"
        engine = TR.RecommendationEngineFactory.apply()
        ep = engine.json_to_engine_params({
            "datasource": {"params": {"app_name": "a", "read_items": True}},
            "algorithms": [{"name": "als", "params": dict(
                algo, device="cpu", solver="cg")}]})
        on_cpu = engine.train(ep).models[0]
        for a, b in ((on_cpu.als.user_factors, model.als.user_factors),
                     (on_cpu.als.item_factors, model.als.item_factors)):
            assert np.abs(a - b).max() <= FACTOR_TOL[0.1] * np.abs(a).max()
        for body in ({"user": "u3", "num": 5},
                     {"user": "u3", "num": 5, "categories": ["c1"],
                      "creationYear": 2000}):
            got = srv.handle_query(body)["itemScores"]
            q = TR.Query.from_dict(body)
            scores = model.als.item_factors.astype(np.float64) @ \
                model.als.user_factors[model.user_ix[q.user]]
            mask = model.allowed_mask(q)
            if mask is not None:
                scores[~mask] = -np.inf
            top = np.sort(scores)[::-1][:5]
            # the served items hold the float64 top-5 scores, in order (a
            # swap between items tied within f32 rounding is allowed)
            served = scores[[model.item_ix[s["item"]] for s in got]]
            np.testing.assert_allclose(served, top, rtol=0,
                                       atol=1e-5 * np.abs(top).max())
    finally:
        registry.clear_cache()


@pytest.mark.parametrize("mode", ["on", "exact"])
def test_serve_top_k_and_readback_on_the_card(cuda, mode, monkeypatch):
    """The serve path's batched top-k on the card (a pinned copy and an
    event, no blocking `.cpu()`) against the same call on the CPU.

    - `pack_device` on the card gives the CPU's payload byte for byte on
      the same f32 scores (-inf and values past f16's range included);
    - on each device the served ids are its own f32 top-k's
      (`PIO_SERVE_PACK=off`) and the served scores are those f32 scores
      rounded to the pack's width, exactly;
    - across the devices the ids are equal and the served slots
      byte-equal wherever the two f32 top-k scores are equal; where
      cuBLAS summed in another order, the scores agree within one f16
      step (`on`) or 4 f32 ulps a term of the rank-64 dot (`exact`)."""
    from predictionio_tpu_torch.ops import readback
    from predictionio_tpu_torch.ops import similarity as TSim
    p = {"on": readback.PACK_F16, "exact": readback.PACK_EXACT}[mode]
    rng = np.random.default_rng(3)
    sc = (rng.standard_normal((16, 16)) * 3e4).astype(np.float32)
    sc[0, :3] = -np.inf
    sc[1, :4] = [65504.0, 65519.0, 65520.0, -7e4]
    ids = rng.integers(0, 2000, (16, 16))
    payload = {dev: readback.begin_fetch(readback.pack_device(
        torch.tensor(sc, device=dev), torch.tensor(ids, device=dev), p))()[0]
        for dev in ("cpu", "cuda")}
    assert payload["cuda"].shape == (16, 16, readback.SLOT_BYTES[p])
    np.testing.assert_array_equal(payload["cuda"], payload["cpu"])

    U = rng.standard_normal((300, 64)).astype(np.float32)
    V = rng.standard_normal((2000, 64)).astype(np.float32)
    users = rng.integers(0, 300, 11)
    masks = rng.random((5, 2000)) < 0.5
    out = {}
    for env in ("off", mode):
        monkeypatch.setenv("PIO_SERVE_PACK", env)
        for dev in ("cpu", "cuda"):
            m = TA.ALSModel(U, V, 64, torch.device(dev))
            before = readback.stats_snapshot()
            finish = TA.users_topk_serve_begin(m, users, 10)
            out[env, dev] = finish()
            after = readback.stats_snapshot()
            assert after["windows"] - before["windows"] == 1
            if env == mode:
                assert after["bytes"] - before["bytes"] == \
                    16 * 16 * readback.SLOT_BYTES[p]
            out[env, dev + "_masked"] = TSim.masked_top_k_batch_begin(
                torch.tensor(V, device=dev), U[:5], masks, 7,
                filter_positive=False)()
    width = np.float16 if mode == "on" else np.float32
    for key in ("cpu", "cpu_masked"):
        gkey = key.replace("cpu", "cuda")
        for k in (key, gkey):
            (s, i), (s32, i32) = out[mode, k], out["off", k]
            np.testing.assert_array_equal(i, i32)
            np.testing.assert_array_equal(
                s, s32.astype(width).astype(np.float32))
        (s_c, i_c), (s_g, i_g) = out[mode, key], out[mode, gkey]
        np.testing.assert_array_equal(i_g, i_c)
        same = out["off", key][0].view(np.uint32) == \
            out["off", gkey][0].view(np.uint32)
        assert same.any()
        np.testing.assert_array_equal(s_g.view(np.uint32)[same],
                                      s_c.view(np.uint32)[same])
        rtol = 2.0 ** -10 if mode == "on" else 4 * 2.0 ** -24 * 64
        np.testing.assert_allclose(s_g, s_c, rtol=rtol, atol=1e-6)


def test_a_cache_hit_on_the_card_returns_the_miss_bytes(cuda, monkeypatch):
    """A server at its defaults (the result cache on, f16 packed scores)
    on tables on the card: the repeated query is answered with the bytes
    its miss serialized, without a window; those bytes carry the f16
    rounding of the card's f32 scores."""
    from predictionio_tpu_torch.core import TrainResult
    from predictionio_tpu_torch.models import recommendation as TR
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.weights import from_jax_model
    for k in ("PIO_SERVE_PACK", "PIO_SERVE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    rng = np.random.default_rng(5)
    U = rng.standard_normal((50, 32)).astype(np.float32)
    V = rng.standard_normal((400, 32)).astype(np.float32)
    model = from_jax_model(U, V, [f"u{k}" for k in range(50)],
                           [f"i{k}" for k in range(400)], 32, device="cuda")
    assert model.als.tables()[0].device.type == "cuda"
    srv = EngineServer(
        ServerConfig(port=0, micro_batch=4),
        TR.RecommendationEngineFactory.apply(),
        TR.RecommendationEngineFactory.engine_params(
            TR.RatingsData([], [], [])),
        TrainResult(models=[model], algorithms=[
            TR.ALSAlgorithm(TR.ALSAlgorithmParams(rank=32))]))
    try:
        raw = json.dumps({"user": "u3", "num": 10}).encode()
        miss, _ = srv.queries(raw)
        windows = srv.batcher.n_batches
        hit, _ = srv.queries(raw)
        assert hit == miss
        assert srv.batcher.n_batches == windows
        assert srv.result_cache.hits == 1 and srv.result_cache.misses == 1
        body = json.loads(miss)
        ix = [int(s["item"][1:]) for s in body["itemScores"]]
        scores = np.array([s["score"] for s in body["itemScores"]])
        assert (scores.astype(np.float16).astype(np.float64) == scores).all()
        s64 = V.astype(np.float64) @ U[3].astype(np.float64)
        np.testing.assert_allclose(scores, s64[ix], rtol=2.0 ** -10,
                                   atol=1e-5)
        assert sorted(ix) == sorted(np.argsort(-s64)[:10].tolist())
    finally:
        srv.batcher.stop()


def _ecommerce_store(tmp_path, monkeypatch):
    """small_ratings() as `rate` events, item `$set` categories, views of
    a user the train never sees, and an unavailableItems list."""
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.storage import registry
    from predictionio_tpu_torch.data.storage.base import App
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "pio"))
    registry.clear_cache()
    ui, ii, vv, _, n_items = small_ratings()
    app_id = registry.Storage.get_meta_data_apps().insert(App(0, "a"))
    ev = registry.Storage.get_events()
    ev.insert_columnar(ColumnarBatch(
        len(vv), "rate", "user", [f"u{u}" for u in ui], "item",
        [f"i{i}" for i in ii], [{"rating": float(v)} for v in vv]), app_id)
    ev.insert_columnar(ColumnarBatch(
        n_items, "$set", "item", [f"i{i}" for i in range(n_items)],
        properties=[{"categories": [f"c{i % 3}"]} for i in range(n_items)]),
        app_id)
    ev.insert_columnar(ColumnarBatch(
        3, "view", "user", ["fresh"] * 3, "item", ["i1", "i2", "i3"]),
        app_id)
    ev.insert_columnar(ColumnarBatch(
        1, "$set", "constraint", ["unavailableItems"],
        properties=[{"items": ["i4", "i5"]}]), app_id)
    return registry


def test_ecommerce_store_train_and_deploy_on_the_card(cuda, tmp_path,
                                                      monkeypatch):
    """The e-commerce template from the store on the card: every implicit
    solve, primal and dual, a launch of the CG kernel ('auto'); the
    factors match the same train on the CPU through the plain CG; a
    loaded server's answers equal the CPU copy's `predict` (ids; scores
    within f16 rounding)."""
    from predictionio_tpu_torch.models import ecommerce as TE
    from predictionio_tpu_torch.ops.ratings import dedup_ratings
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.weights import from_jax_ecommerce_model
    from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                                 create_workflow_main)
    registry = _ecommerce_store(tmp_path, monkeypatch)
    try:
        algo = dict(app_name="a", rank=16, num_iterations=3, lam=0.1,
                    alpha=1.0, seed=2)
        path = tmp_path / "engine.json"
        path.write_text(json.dumps({
            "engineFactory": "ecommercerecommendation",
            "datasource": {"params": {"app_name": "a"}},
            "algorithms": [{"name": "ecomm", "params": algo}]}))
        T.COUNTS.reset()
        tel = {}
        create_workflow_main(WorkflowConfig(engine_variant=str(path)),
                             telemetry=tel)
        assert T.COUNTS.cg_solve == tel["algorithms"][0]["solver_calls"] > 0
        assert T.COUNTS.cg_solve_plain == T.COUNTS.chol_solve == 0
        srv = EngineServer(ServerConfig(engine_variant=str(path))).load()
        (model,) = srv.models
        assert model.als().tables()[0].device.type == "cuda"
        td = TE.ECommerceDataSource(TE.DataSourceParams(
            app_name="a")).read_training()
        rd = td.rate_events
        u, i, v = dedup_ratings(model.user_ix.to_indices_array(rd.users),
                                model.item_ix.to_indices_array(rd.items),
                                rd.vals, rd.ts, "latest")
        on_cpu = TA.als_train(
            RatingsCOO(u, i, v, len(model.user_ix), len(model.item_ix)),
            TA.ALSConfig(rank=16, iterations=3, lam=0.1, seed=2,
                         implicit_prefs=True, alpha=1.0,
                         solver="cg_cuda"), device="cpu")
        for a, b in ((on_cpu.user_factors, model.user_factors),
                     (on_cpu.item_factors, model.item_factors)):
            assert np.abs(a - b).max() <= FACTOR_TOL[0.1] * np.abs(a).max()
        host = from_jax_ecommerce_model(
            model.user_factors, model.item_factors,
            model.item_factors_normalized, list(model.user_ix._ids),
            list(model.item_ix._ids), model.items, 16, device="cpu")
        cpu_algo = TE.ECommAlgorithm(TE.ECommAlgorithmParams(
            **algo, device="cpu"))
        for body in ({"user": "u3", "num": 5},
                     {"user": "u3", "num": 5, "categories": ["c1"]},
                     {"user": "fresh", "num": 5}, {"user": "ghost",
                                                   "num": 5}):
            got = srv.handle_query(body)["itemScores"]
            want = cpu_algo.predict(host, TE.Query.from_dict(body))
            assert [s["item"] for s in got] == [
                s.item for s in want.item_scores], body
            assert not {"i4", "i5"} & {s["item"] for s in got}
            ws = np.array([s.score for s in want.item_scores])
            gs = np.array([s["score"] for s in got])
            assert (np.abs(gs - ws) <= 2.0 ** -11 * np.abs(ws) + 1e-6).all()
    finally:
        registry.clear_cache()


def test_recommendeduser_train_on_the_card_goes_through_the_kernel(cuda):
    """The recommended-user train on the card: every solve a CG kernel
    launch; the normalized followed table matches the CPU's plain-CG
    train; `batch_predict` equals `predict` (ids)."""
    from predictionio_tpu_torch.models import recommendeduser as TU
    from predictionio_tpu_torch.models.common import RatingsData
    from predictionio_tpu_torch.ops.similarity import normalize_rows
    ui, ii, _, _, _ = small_ratings()
    td = TU.TrainingData(users={}, follow_events=RatingsData(
        np.array([f"u{u}" for u in ui]), np.array([f"u{i}" for i in ii]),
        np.ones(len(ui), dtype=np.float32)))
    algo = TU.RecommendedUserALSAlgorithm(TU.ALSAlgorithmParams(
        rank=16, num_iterations=3, lam=0.1, seed=2))
    T.COUNTS.reset()
    model = algo.train(TU.PreparedData(td))
    tel = algo.last_train_telemetry
    assert T.COUNTS.cg_solve == tel["solver_calls"] > 0
    assert T.COUNTS.cg_solve_plain == T.COUNTS.chol_solve == 0
    followers, fi = np.unique(td.follow_events.users, return_inverse=True)
    followed, fo = np.unique(td.follow_events.items, return_inverse=True)
    ref = TA.als_train(
        RatingsCOO(fi.astype(np.int32), fo.astype(np.int32),
                   np.ones(len(fi), dtype=np.float32), len(followers),
                   len(followed)),
        TA.ALSConfig(rank=16, iterations=3, lam=0.1, seed=2,
                     implicit_prefs=True, alpha=1.0, solver="cg_cuda"),
        device="cpu")
    a = normalize_rows(ref.item_factors)
    b = model.followed_factors_normalized
    assert np.abs(a - b).max() <= FACTOR_TOL[0.1] * np.abs(a).max()
    queries = [TU.Query(("u1",), 5), TU.Query(("u2", "u7"), 8),
               TU.Query(("nobody",), 3)]
    batched = dict(algo.batch_predict(model, list(enumerate(queries))))
    for ix, q in enumerate(queries):
        assert [s.user for s in batched[ix].similar_user_scores] == [
            s.user for s in algo.predict(model, q).similar_user_scores]


def test_dimsum_gram_on_the_card_matches_the_cpu(cuda):
    """item_cosine_similarities with its Gram on the card equals the CPU's
    (float32 counts are exact with TF32 off; the normalization is the
    same float32 arithmetic)."""
    from predictionio_tpu_torch.ops.similarity import \
        item_cosine_similarities
    rng = np.random.default_rng(3)
    ui = rng.integers(0, 5000, 60_000)
    ii = rng.integers(0, 700, 60_000)
    for threshold in (0.0, 0.05):
        tel = {}
        on_card = item_cosine_similarities(ui, ii, 5000, 700, threshold,
                                           chunk_users=1024, device=cuda,
                                           telemetry=tel)
        on_cpu = item_cosine_similarities(ui, ii, 5000, 700, threshold,
                                          chunk_users=1024, device="cpu")
        assert np.abs(on_card - on_cpu).max() <= 1e-6
        assert tel["gram_device_ms"] > 0 and tel["chunks"] == 5


@pytest.mark.parametrize("implicit,solver,dual_solve", [
    (False, "cg_cuda", "auto"), (True, "chol_cuda", "auto"),
    (True, "cg_cuda", "never")])
def test_fused_train_on_the_card_captures_and_counts(cuda, implicit, solver,
                                                     dual_solve):
    """fuse_iteration on the card: the iteration is captured as CUDA
    graphs and replayed; the tables equal the unfused train's bit for bit
    (the same kernels in the same order); every replayed solve is counted
    as a launch of the solver's kernel, as is the warm-up's."""
    ui, ii, vv, n_u, n_i = small_ratings()
    coo = RatingsCOO(ui, ii, vv, n_u, n_i)
    kw = dict(rank=16, iterations=3, lam=0.1, seed=2, work_budget=512,
              implicit_prefs=implicit, solver=solver, sweep_chunk=2,
              dual_solve=dual_solve)
    kernel = solver.replace("_cuda", "_solve")
    base = TA.als_train(coo, TA.ALSConfig(**kw), device=cuda)
    T.COUNTS.reset()
    tel = {}
    fused = TA.als_train(coo, TA.ALSConfig(fuse_iteration=True, **kw),
                         device=cuda, telemetry=tel)
    assert tel["replays"] == 3 and tel["capture_s"] > 0
    assert tel["captured_launches"] == {kernel: tel["solver_calls"] // 3}
    assert getattr(T.COUNTS, kernel) == \
        tel["solver_calls"] + tel["warmup_calls"]
    assert T.COUNTS.cg_solve_plain == T.COUNTS.chol_solve_plain == 0
    assert np.array_equal(fused.user_factors, base.user_factors)
    assert np.array_equal(fused.item_factors, base.item_factors)


def test_bf16_tables_stay_bf16_on_the_card(cuda, monkeypatch):
    """factor_dtype='bfloat16': the tables the iterations update are bf16
    on the card, the model's tables are float32, and the train lands
    within 4 bf16 ulps of the same train on the CPU."""
    seen = []
    real = TA._iteration

    def spy(U, V, *args):
        seen.append((U.dtype, V.dtype, U.device.type))
        return real(U, V, *args)
    monkeypatch.setattr(TA, "_iteration", spy)
    ui, ii, vv, n_u, n_i = small_ratings()
    coo = RatingsCOO(ui, ii, vv, n_u, n_i)
    cfg = TA.ALSConfig(rank=16, iterations=3, lam=0.1, seed=2,
                       work_budget=512, factor_dtype="bfloat16")
    m = TA.als_train(coo, cfg, device=cuda)
    assert seen == [(torch.bfloat16, torch.bfloat16, "cuda")] * 3
    assert m.user_factors.dtype == np.float32
    assert all(t.dtype == torch.float32 for t in m.tables())
    ref = TA.als_train(coo, cfg, device="cpu")
    for a, b in ((m.user_factors, ref.user_factors),
                 (m.item_factors, ref.item_factors)):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(b).max())) - 7)
        assert np.abs(a - b).max() <= 4 * ulp


def test_nb_counts_and_forest_on_the_card_equal_the_cpu(cuda):
    """The naive Bayes counts and the forest's level histograms on the
    card: integer sums, exact in float32 with TF32 off, so the models
    equal the CPU's (the forest's default draws come from a CPU
    generator, the same on both)."""
    from predictionio_tpu_torch.ops.forest import forest_train
    from predictionio_tpu_torch.ops.naive_bayes import multinomial_nb_train
    rng = np.random.default_rng(4)
    y = rng.integers(0, 4, 20_000)
    X = rng.poisson(2.0 + 3.0 * y[:, None] * np.array([1.0, 0.5, 0.2])
                    ).astype(np.float32)
    a = multinomial_nb_train(X, y, lam=1.0, device=cuda)
    b = multinomial_nb_train(X, y, lam=1.0, device="cpu")
    assert np.array_equal(a.pi, b.pi) and np.array_equal(a.theta, b.theta)
    kw = dict(num_classes=4, num_trees=10, max_depth=5, max_bins=32,
              seed=3)
    fa = forest_train(X, y, device=cuda, **kw)
    fb = forest_train(X, y, device="cpu", **kw)
    for name in ("feature", "threshold", "is_leaf", "leaf_class"):
        assert np.array_equal(getattr(fa, name), getattr(fb, name)), name


def test_staging_copies_from_pinned_buffers_on_a_side_stream(cuda):
    """`device_stage` on the card: pinned sources, tensors on the card
    padded to the bucket, an event behind the copies, and the copy runs
    on the stager's stream, not the caller's; `wait_ready` times the
    event's wait and the values land whole."""
    from predictionio_tpu_torch.ops import staging
    from predictionio_tpu_torch.compile.buckets import bucket_rows
    n = 300_000
    cols = {"t": np.arange(n, dtype=np.int64),
            "v": np.random.default_rng(1).random(n).astype(np.float32)}
    stream = staging.copy_stream(cuda)
    assert stream != torch.cuda.current_stream(cuda)
    out, rows, padded, submit_s, event, hosts = staging.device_stage(
        cols, cuda, stream)
    assert (rows, padded) == (n, bucket_rows(n))
    assert all(h.is_pinned() for h in hosts)
    assert isinstance(event, torch.cuda.Event)
    waited = staging.wait_ready(event)
    assert waited >= 0.0 and event.query()
    for k, a in cols.items():
        t = out[k]
        assert t.device.type == "cuda" and t.shape == (padded,)
        assert np.array_equal(t[:n].cpu().numpy(), a)
        assert not t[n:].any()
    assert submit_s >= 0.0


def test_bulk_load_on_the_card_round_trips(cuda):
    """The executor's stager on the card: every segment a CUDA tensor on
    the bucket ladder, the window drained by `finish`, the staged rows
    byte-equal to the decoded host columns."""
    from predictionio_tpu_torch.dataplane import BulkLoadExecutor
    from predictionio_tpu_torch.compile.buckets import bucket_rows

    class Store:
        def find_columnar_chunked(self, app_name, **kw):
            for lo in range(0, 50_000, 7_000):
                t = np.arange(lo, min(lo + 7_000, 50_000), dtype=np.int64)
                yield {"t": t, "prop": (t % 5).astype(np.float32)}
    result = BulkLoadExecutor(store=Store(), device=cuda).run("app")
    st = result.stats
    assert st.rows == 50_000 and st.chunks == 8
    assert st.steady_compiles == 0 and 0.0 <= st.h2d_overlap_frac <= 1.0
    for seg in result.segments:
        assert seg.padded_rows == bucket_rows(seg.rows)
        assert all(a.device.type == "cuda" for a in seg.arrays.values())
    for k in ("t", "prop"):
        got = np.concatenate([s.arrays[k][:s.rows].cpu().numpy()
                              for s in result.segments])
        want = np.concatenate([c[k] for c in result.decoded])
        assert got.tobytes() == want.tobytes()


def test_e2_on_the_card_matches_the_cpu(cuda):
    """Markov predict (atomic scatter-adds: float32 sums in another
    order) within 1e-6 of the CPU's; the categorical counts exact."""
    from predictionio_tpu_torch.ops.markov import markov_chain_train
    from predictionio_tpu_torch.ops.naive_bayes import (LabeledPoint,
                                                        categorical_nb_train)
    rng = np.random.default_rng(2)
    S = 2_000
    r, c = rng.integers(0, S, 60_000), rng.integers(0, S, 60_000)
    v = rng.integers(1, 9, 60_000)
    a = markov_chain_train(r, c, v, S, 20, device=cuda)
    b = markov_chain_train(r, c, v, S, 20, device="cpu")
    cur = rng.random(S)
    cur /= cur.sum()
    assert np.abs(a.predict(cur) - b.predict(cur)).max() <= 1e-6
    pts = [LabeledPoint(f"l{x % 3}", (f"a{x % 7}", f"b{x % 11}"))
           for x in rng.integers(0, 1000, 5_000)]
    ma = categorical_nb_train(pts, device=cuda)
    mb = categorical_nb_train(pts, device="cpu")
    assert ma.priors == mb.priors and ma.likelihoods == mb.likelihoods


def test_feedback_deploy_on_the_card_posts_every_answer(cuda, tmp_path,
                                                        monkeypatch):
    """Events in through the port's event server, a train on the card,
    a feedback deploy restored onto the card: every answer lands as a
    `predict` event equal to the answer (its prId the query's or the
    instance id), and the result cache takes nothing."""
    import time
    import urllib.request
    from predictionio_tpu_torch.data.api.event_server import (
        EventServer, EventServerConfig)
    from predictionio_tpu_torch.data.storage import registry
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.tools import app_commands as ac
    from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                                 create_workflow_main)

    def post(url, body):
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())

    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "pio"))
    monkeypatch.delenv("PIO_ENGINE_SERVER_PLUGINS", raising=False)
    registry.clear_cache()
    es = srv = None
    try:
        desc = ac.app_new("a")
        key = desc.access_keys[0].key
        es = EventServer(EventServerConfig(ip="127.0.0.1", port=0)).start()
        base = f"http://127.0.0.1:{es.config.port}"
        ui, ii, vv, _, _ = small_ratings()
        rows = [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
                 "targetEntityType": "item", "targetEntityId": f"i{i}",
                 "properties": {"rating": float(v)}}
                for u, i, v in zip(ui, ii, vv)]
        for lo in range(0, len(rows), 50):
            code, body = post(f"{base}/batch/events.json?accessKey={key}",
                              rows[lo:lo + 50])
            assert code == 200 and {r["status"] for r in body} == {201}
        path = tmp_path / "engine.json"
        path.write_text(json.dumps({
            "engineFactory": "recommendation",
            "datasource": {"params": {"app_name": "a"}},
            "algorithms": [{"name": "als", "params": dict(
                rank=16, num_iterations=3, lam=0.1, seed=2)}]}))
        T.COUNTS.reset()
        iid = create_workflow_main(WorkflowConfig(engine_variant=str(path)))
        assert T.COUNTS.cg_solve > 0 and T.COUNTS.cg_solve_plain == 0
        srv = EngineServer(ServerConfig(
            ip="127.0.0.1", port=0, engine_variant=str(path), feedback=True,
            accesskey=key, event_server_ip="127.0.0.1",
            event_server_port=es.config.port)).load().start()
        qs = [{"user": f"u{k}", "num": 4} for k in range(6)]
        qs[1]["prId"] = "mine"
        answers = [post(f"http://127.0.0.1:{srv.config.port}/queries.json",
                        q)[1] for q in qs + qs]
        assert srv.stats()["resultCache"]["entries"] == 0
        ev = registry.Storage.get_events()
        deadline = time.time() + 10
        while True:
            got = list(ev.find(desc.app.id, event_names=["predict"]))
            if len(got) == 2 * len(qs) or time.time() > deadline:
                break
            time.sleep(0.05)
        assert len(got) == 2 * len(qs)
        for q, a in zip(qs, answers):
            assert a["prId"] == q.get("prId", iid)
            assert any(e.properties.fields == {"query": q, "prediction": a}
                       and e.entity_id == a["prId"] for e in got)
    finally:
        for s in (srv, es):
            if s is not None:
                s.stop()
        registry.clear_cache()


def _topk_model(seed, n_users=300, n_items=2000, rank=64, device="cuda"):
    rng = np.random.default_rng(seed)
    return TA.ALSModel(rng.standard_normal((n_users, rank)).astype(np.float32),
                       rng.standard_normal((n_items, rank)).astype(np.float32),
                       rank, torch.device(device))


def test_a_replay_equals_the_eager_dispatch(cuda, monkeypatch):
    """Every bucket of the batch ladder captured as a graph for one model:
    its replay is bit-equal to the eager program on the same batch, and a
    dispatch after the capture is a hit."""
    from predictionio_tpu_torch.compile import buckets as B
    from predictionio_tpu_torch.compile.aot import GraphExecutable, get_aot
    from predictionio_tpu_torch.obs import costmon
    from predictionio_tpu_torch.ops import readback
    from predictionio_tpu_torch.utils.device_cache import cached_put_rows
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    TA.register_aot_specs()
    aot = get_aot()
    m = _topk_model(1)
    rng = np.random.default_rng(2)
    for b in B.batch_ladder(32):
        dims = TA.batch_predict_dims(m, b, 10)
        exe = aot.ensure(costmon.BATCH_PREDICT, dims, (m,))
        assert isinstance(exe, GraphExecutable)
        ixs = torch.tensor(rng.integers(0, m.n_users, dims["b"]),
                           device=cuda)
        U = cached_put_rows(m.user_factors, dims["u"], cuda)
        V = cached_put_rows(m.item_factors, dims["i"], cuda)
        eager = TA._users_topk_b(U, V, ixs, m.n_items, dims["k"], dims["p"])
        torch.testing.assert_close(exe(ixs), eager, rtol=0, atol=0)
    hits = aot.snapshot()["dispatchHits"].get(costmon.BATCH_PREDICT, 0)
    users = rng.integers(0, m.n_users, 5)
    s, i = TA.users_topk_serve(m, users, 10)
    assert aot.snapshot()["dispatchHits"][costmon.BATCH_PREDICT] == hits + 1
    S = m.user_factors[users] @ m.item_factors.T
    np.testing.assert_array_equal(i[:, :10], np.argsort(-S, axis=1)[:, :10])
    assert readback.pack_flag() == readback.PACK_EXACT


def test_a_swap_recaptures_and_never_replays_the_old_tables(cuda):
    """A new model of the same shapes is a new key: its first dispatch
    misses (no replay of the old model's graph), and once captured its
    answers are its own; the old model's graphs go with it."""
    import gc
    from predictionio_tpu_torch.compile.aot import get_aot
    from predictionio_tpu_torch.obs import costmon
    TA.register_aot_specs()
    aot = get_aot()
    old, new = _topk_model(3), _topk_model(4)
    users = np.arange(8)
    dims = TA.batch_predict_dims(old, len(users), 10)
    aot.ensure(costmon.BATCH_PREDICT, dims, (old,))
    before = aot.snapshot()
    TA.users_topk_serve(new, users, 10)
    for t in list(aot._threads):       # the miss's background capture
        t.join(60)
    after = aot.snapshot()
    assert after["dispatchMisses"][costmon.BATCH_PREDICT] == \
        before["dispatchMisses"].get(costmon.BATCH_PREDICT, 0) + 1
    aot.ensure(costmon.BATCH_PREDICT, dims, (new,))
    _, i = TA.users_topk_serve(new, users, 10)
    S = new.user_factors[users] @ new.item_factors.T
    np.testing.assert_array_equal(i[:, :10], np.argsort(-S, axis=1)[:, :10])
    key = aot._key(costmon.BATCH_PREDICT, dims, (old,))
    assert key in aot._compiled
    del old
    gc.collect()
    assert key not in aot._compiled


def test_two_windows_in_flight_read_their_own_outputs(cuda):
    """Two dispatches of one captured bucket enqueued before either is
    read: each window's readback holds its own users' answers."""
    from predictionio_tpu_torch.compile.aot import get_aot
    from predictionio_tpu_torch.obs import costmon
    TA.register_aot_specs()
    m = _topk_model(5)
    a, b = np.arange(0, 16), np.arange(100, 116)
    get_aot().ensure(costmon.BATCH_PREDICT,
                     TA.batch_predict_dims(m, 16, 10), (m,))
    fa = TA.users_topk_serve_begin(m, a, 10)
    fb = TA.users_topk_serve_begin(m, b, 10)
    for users, finish in ((b, fb), (a, fa)):
        _, i = finish()
        S = m.user_factors[users] @ m.item_factors.T
        np.testing.assert_array_equal(i[:, :10],
                                      np.argsort(-S, axis=1)[:, :10])


def test_the_cuda_event_device_time_is_inside_the_sampled_wall(cuda):
    """A sampled dispatch books its CUDA-event time: above 0 and below
    the wall from the call to the end of its work."""
    import time
    from predictionio_tpu_torch.obs import costmon
    # no random draw: a capture in flight in another thread puts the
    # default generator in capture mode
    a = torch.full((4096, 4096), 0.5, device=cuda)
    st = costmon._device_state("cuda_event_probe")
    st.every = 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    costmon.device_timed("cuda_event_probe", torch.matmul, a, a)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    costmon.flush()
    booked = costmon.device_time_by_executable()["cuda_event_probe"]
    assert 0 < booked < wall, (booked, wall)
    samples = costmon.device_samples_by_executable()["cuda_event_probe"]
    assert samples == 1, samples


def _kernel_events(path, pattern):
    import re
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"
            and re.search(pattern, str(e.get("name")))]


def test_the_device_trace_of_a_fold_names_the_cg_kernel(cuda, tmp_path):
    """A fold under the /profile.json device trace: the Chrome trace's
    CG kernel events are the fold's CG launches, one for one."""
    from predictionio_tpu_torch.obs import profiler
    from predictionio_tpu_torch.online import fold_in as TF
    ui, ii, vv, n_u, n_i = small_ratings()
    rng = np.random.default_rng(11)
    U = (np.abs(rng.standard_normal((n_u, 16))) / 4).astype(np.float32)
    V = (np.abs(rng.standard_normal((n_i, 16))) / 4).astype(np.float32)
    coo = RatingsCOO(ui.astype(np.int32), ii.astype(np.int32),
                     vv.astype(np.float32), n_u, n_i)
    tu, ti = np.arange(0, 12), np.arange(0, 6)
    cfg = TF.FoldInConfig(lam=0.1, sweeps=2)
    # built and warm before the trace, so the trace holds the fold alone
    TF.fold_in_coo(TA.ALSModel(U, V, 16, None), coo, tu, ti, cfg,
                   device=cuda)
    torch.cuda.synchronize()
    status, body = profiler.profile_response("start",
                                             {"dir": str(tmp_path)})
    assert status == 200 and body["activities"] == ["CPU", "CUDA"]
    T.COUNTS.reset()
    TF.fold_in_coo(TA.ALSModel(U, V, 16, None), coo, tu, ti, cfg,
                   device=cuda)
    launches = T.COUNTS.cg_solve
    status, body = profiler.profile_response("stop")
    assert status == 200 and not body["tracing"]
    assert launches > 0
    got = _kernel_events(body["traceFile"],
                         r"cg_(warp|reg|stream)_kernel")
    assert len(got) == launches, (len(got), launches)


def test_a_slow_window_waterfall_needs_no_synchronize(cuda, monkeypatch):
    """Every query slow (threshold 0) and every dispatch sampled: the
    waterfalls come back with `device_sync` stages read from the
    windows' CUDA-event stamps, and nothing synchronized the device."""
    import threading
    import urllib.request
    from predictionio_tpu_torch.core import TrainResult
    from predictionio_tpu_torch.models import recommendation as TR
    from predictionio_tpu_torch.obs import costmon
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.weights import from_jax_model
    monkeypatch.setenv("PIO_SLOW_QUERY_MS", "0")
    monkeypatch.setenv("PIO_SERVE_CACHE", "off")
    rng = np.random.default_rng(3)
    U = rng.standard_normal((64, 16)).astype(np.float32)
    V = rng.standard_normal((500, 16)).astype(np.float32)
    model = from_jax_model(U, V, [f"u{k}" for k in range(64)],
                           [f"i{k}" for k in range(500)], 16)
    srv = EngineServer(
        ServerConfig(ip="127.0.0.1", port=0),
        TR.RecommendationEngineFactory.apply(),
        TR.RecommendationEngineFactory.engine_params(
            TR.RatingsData([], [], [])),
        TrainResult(models=[model], algorithms=[TR.ALSAlgorithm(
            TR.ALSAlgorithmParams(rank=16))]))
    srv.start()
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1) or real(*a, **k))
    try:
        costmon._device_state(costmon.BATCH_PREDICT).every = 1
        costmon._device_state(costmon.BATCH_PREDICT_MASKED).every = 1
        url = f"http://127.0.0.1:{srv.config.port}"

        def ask(k):
            req = urllib.request.Request(
                f"{url}/queries.json", method="POST",
                data=json.dumps({"user": f"u{k}", "num": 5}).encode())
            urllib.request.urlopen(req, timeout=60).read()

        for _ in range(3):
            threads = [threading.Thread(target=ask, args=(k,))
                       for k in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        with urllib.request.urlopen(f"{url}/slow.json?n=64",
                                    timeout=60) as r:
            slow = json.loads(r.read())["slow"]
    finally:
        srv.stop()
    assert syncs == []
    assert len(slow) >= 48
    stages = [[s["stage"] for s in e["stages"]] for e in slow]
    assert any("device_sync" in st for st in stages)
    assert all("d2h_wait" in st and "dispatch" in st for st in stages)


def test_simrank_on_the_card_matches_float64(cuda):
    """The friend-recommendation SimRank on the card (TF32 off: true f32
    products) against the same fixed point in float64 on the card:
    entries in [0, 1], within 1e-5 over 2,048 nodes and 5 iterations;
    unit diagonal, symmetric."""
    from predictionio_tpu_torch.examples import friend_recommendation as TF
    rng = np.random.default_rng(6)
    n = 2048
    edges = np.stack([rng.integers(0, n, 20000), rng.integers(0, n, 20000),
                      rng.integers(1, 4, 20000)], axis=1).astype(np.float32)
    S = TF._simrank(TF.adjacency(edges, n, cuda), 5, 0.8)
    S64 = TF._simrank(TF.adjacency(edges, n, cuda, torch.float64), 5, 0.8)
    assert S.dtype == torch.float32 and S.device.type == "cuda"
    assert (S.double() - S64).abs().max().item() <= 1e-5
    assert torch.equal(torch.diagonal(S), torch.ones(n, device=cuda))
    assert (S - S.T).abs().max().item() <= 1e-5


def test_batched_ols_on_the_card_matches_float64(cuda):
    """The stock engine's batched normal equations on the card against
    a float64 solve of the same ridged system, relative to the scale of
    the coefficients."""
    from predictionio_tpu_torch.examples import stock_backtesting as TS
    rng = np.random.default_rng(0)
    N, W, F = 500, 200, 4
    X = rng.normal(size=(N, W, F)).astype(np.float32)
    X[..., -1] = 1.0
    y = (np.einsum("nwf,nf->nw", X, rng.normal(size=(N, F)))
         + 0.01 * rng.normal(size=(N, W))).astype(np.float32)
    got = TS._batched_ols(X, y, device=cuda)
    X64 = torch.as_tensor(X, dtype=torch.float64, device=cuda)
    ref = TS.ols_solve(X64, torch.as_tensor(y, dtype=torch.float64,
                                            device=cuda)).cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_a_nativelog_read_trains_through_the_cg_kernel(cuda, tmp_path):
    """Events in a four-partition nativelog, read back by
    `find_columnar`, train ALS on the card: every solve a CG kernel
    launch, and the tables equal those trained from the same ratings
    held in memory."""
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.storage import nativelog as TNL
    from predictionio_tpu_torch.data.storage.registry import \
        StorageClientConfig
    ui, ii, vv, n_users, n_items = small_ratings()
    client = TNL.StorageClient(StorageClientConfig(
        "NL", "nativelog", {"PATH": str(tmp_path / "log"),
                            "PARTITIONS": "4"}))
    try:
        ev = client.get_data_object("events", "pio_event")
        ev.init(1)
        ev.insert_columnar(ColumnarBatch(
            len(ui), "rate", "user", [str(u) for u in ui], "item",
            [str(i) for i in ii], [{"rating": float(v)} for v in vv],
            [f"2030-01-01T00:00:{k // 1000:02d}.{k % 1000:03d}Z"
             for k in range(len(ui))]), 1)
        cols = ev.find_columnar(1, property_field="rating")
    finally:
        client.close()
    assert cols["entity_id"].tolist() == [str(u) for u in ui]
    coo = RatingsCOO(cols["entity_id"].astype(np.int32),
                     cols["target_entity_id"].astype(np.int32),
                     cols["prop"], n_users, n_items)
    cfg = TA.ALSConfig(rank=16, iterations=3, lam=0.1, seed=2,
                       solver="cg_cuda")
    T.COUNTS.reset()
    tel = {}
    model = TA.als_train(coo, cfg, device=cuda, telemetry=tel)
    assert T.COUNTS.cg_solve == tel["solver_calls"] > 0
    assert T.COUNTS.cg_solve_plain == 0
    ref = TA.als_train(RatingsCOO(ui.astype(np.int32), ii.astype(np.int32),
                                  vv.astype(np.float32), n_users, n_items),
                       cfg, device=cuda)
    assert np.array_equal(model.user_factors, ref.user_factors)
    assert np.array_equal(model.item_factors, ref.item_factors)
