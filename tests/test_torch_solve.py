"""Port parity: predictionio_tpu_torch.ops.solve vs the JAX reference.

The port's plain `cg_solve` (the CPU path of `cg_solve_cuda`, and the
version the CUDA kernel is held against on the card) must match the
reference's Pallas `_cg_kernel` (run through the Pallas interpreter, as
tests/test_solve.py runs it) and the reference's jnp `cg_solve` to 1e-4
relative: the same algorithm and iteration count, with f32 sums taken in
a different order. Against the truth, the port's solvers hold
test_solve.py's rtol=2e-3 / atol=2e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from predictionio_tpu.ops import solve as J
from predictionio_tpu_torch.ops import solve as T

CG_REL_TOL = 1e-4


def make_spd(b, r, cond, seed=0):
    """Batched SPD matrices with a geometric spectrum from 1 to 1/cond
    (the generator of tests/test_solve.py)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((b, r, r)))
    eig = np.geomspace(1.0, 1.0 / cond, r)
    A = np.einsum("brs,s,bts->brt", q, eig, q).astype(np.float32)
    x_true = rng.standard_normal((b, r)).astype(np.float32)
    rhs = np.einsum("brs,bs->br", A, x_true).astype(np.float32)
    return A, rhs, x_true


def als_like(B, K, R, seed):
    """ALS normal matrices: Gram of K rows plus a 0.1*K ridge."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((B, K, R)).astype(np.float32) / np.sqrt(R)
    A = (np.einsum("bkr,bks->brs", V, V)
         + 0.1 * K * np.eye(R, dtype=np.float32)).astype(np.float32)
    rhs = rng.standard_normal((B, R)).astype(np.float32)
    return A, rhs


def rel(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def port_cg(A, b, iters):
    return T.cg_solve(torch.from_numpy(A), torch.from_numpy(b),
                      iters).numpy()


@pytest.mark.parametrize("R", [16, 24, 40, 48, 56, 144])
def test_cg_matches_pallas_kernel_and_jnp_cg(R):
    B, iters = 19, R + 8              # B not a multiple of the 16-tile
    A, b, _ = make_spd(B, R, 60.0, seed=R)
    x_port = port_cg(A, b, iters)
    x_pallas = np.asarray(pl.pallas_call(
        functools.partial(J._cg_kernel, iters=iters),
        out_shape=jax.ShapeDtypeStruct((B, R), jnp.float32),
        interpret=True,
    )(jnp.asarray(A), jnp.asarray(b)))
    x_jnp = np.asarray(J.cg_solve(A, b, iters))
    assert rel(x_port, x_pallas) < CG_REL_TOL
    assert rel(x_port, x_jnp) < CG_REL_TOL


@pytest.mark.parametrize("iters", [1, 2, 4, 12])
def test_cg_iterates_match_pallas_kernel(iters):
    """The early iterates pin the algorithm (preconditioner, step and
    direction updates), which a converged answer alone would not: a
    varying diagonal makes the Jacobi preconditioner change each one."""
    B, R = 19, 40
    A, b, _ = make_spd(B, R, 60.0, seed=7)
    d = np.exp(np.random.default_rng(8).uniform(-1, 1, (B, R)))
    A = (d[:, :, None] * A * d[:, None, :]).astype(np.float32)
    x_pallas = np.asarray(pl.pallas_call(
        functools.partial(J._cg_kernel, iters=iters),
        out_shape=jax.ShapeDtypeStruct((B, R), jnp.float32),
        interpret=True,
    )(jnp.asarray(A), jnp.asarray(b)))
    assert rel(port_cg(A, b, iters), x_pallas) < CG_REL_TOL


@pytest.mark.parametrize("B,K,R", [(13, 40, 16), (21, 24, 24)])
def test_cg_primal_iterations_match_jnp_cg(B, K, R):
    """The primal route's fixed 48 iterations on ALS-shaped systems."""
    A, b = als_like(B, K, R, seed=B)
    x_jnp = np.asarray(J.cg_solve(A, b, 48))
    assert rel(port_cg(A, b, 48), x_jnp) < CG_REL_TOL
    x_wrap = T.cg_solve_cuda(torch.from_numpy(A), torch.from_numpy(b),
                             48).numpy()
    np.testing.assert_array_equal(x_wrap, port_cg(A, b, 48))


@pytest.mark.parametrize("solver", ["cg", "cholesky"])
def test_port_solvers_match_truth(solver):
    A, b = als_like(8, 40, 16, seed=1)
    truth = np.linalg.solve(A.astype(np.float64),
                            b.astype(np.float64)[..., None])[..., 0]
    x = T.spd_solve(torch.from_numpy(A), torch.from_numpy(b),
                    method=solver).numpy()
    np.testing.assert_allclose(x, truth, rtol=2e-3, atol=2e-4)


def test_cholesky_matches_reference_cholesky():
    A, b = als_like(6, 30, 24, seed=4)
    x_ref = np.asarray(J.cholesky_solve(A, b))
    x = T.cholesky_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, x_ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("fn", [T.cg_solve, T.cg_solve_cuda])
def test_padding_system_solves_to_exact_zero(fn):
    """Plan padding rows give A = reg*I, b = 0: r'z = 0 makes
    alpha = 0/1e-30, which must stay 0 (no NaN)."""
    A = (0.01 * torch.eye(16)).expand(5, 16, 16).contiguous()
    x = fn(A, torch.zeros(5, 16), 48)
    assert torch.equal(x, torch.zeros(5, 16))


def test_resolve_solver_by_device():
    assert T.resolve_solver("auto", torch.device("cpu")) == "cholesky"
    assert T.resolve_solver("auto", torch.device("cuda")) == "cg_cuda"
    assert T.resolve_solver("cg", torch.device("cuda")) == "cg"
    # the reference picks cholesky off the TPU, so CPU tests compare like
    # with like
    assert J.resolve_solver("auto") == "cholesky"


def test_spd_solve_rejects_unported_and_unknown_methods():
    """The dispatch: the two Cholesky names and the two Schulz names
    solve, the TPU's Pallas names raise a ValueError naming their CUDA
    counterparts, and an unknown name raises. Nothing is left unported."""
    A, b = als_like(2, 10, 8, seed=0)
    A, b = torch.from_numpy(A), torch.from_numpy(b)
    truth = T.cholesky_solve(A.double(), b.double()).float()
    for method in ("chol_cuda", "chol_blocked", "schulz", "schulz_cuda"):
        torch.testing.assert_close(T.spd_solve(A, b, method=method), truth,
                                   rtol=2e-3, atol=2e-4)
    for method, cuda in (("cg_pallas", "cg_cuda"),
                         ("chol_pallas", "chol_cuda"),
                         ("schulz_pallas", "schulz_cuda")):
        with pytest.raises(ValueError, match=cuda):
            T.spd_solve(A, b, method=method)
    with pytest.raises(ValueError):
        T.spd_solve(A, b, method="qr")


@pytest.mark.parametrize("method", ["schulz", "schulz_cuda"])
def test_spd_solve_resolves_each_solvers_own_step_count(method,
                                                        monkeypatch):
    """`iters=None` reaches a Schulz solver as its own default, 18 steps
    (the reference's `_schulz_iters_default`), never CG's 48; an explicit
    count and the compute dtype pass through unchanged."""
    seen = []
    for name in ("schulz_solve", "schulz_solve_cuda"):
        monkeypatch.setattr(
            T, name, lambda A, b, iters, cd: seen.append((iters, cd)) or b)
    A, b = als_like(2, 10, 8, seed=0)
    A, b = torch.from_numpy(A), torch.from_numpy(b)
    T.spd_solve(A, b, method=method)
    T.spd_solve(A, b, method=method, iters=13, compute_dtype="float32")
    assert seen == [(18, "bfloat16"), (13, "float32")]


def test_cuda_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on CUDA raises; only a CPU
    tensor takes the plain version."""
    A = torch.empty(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        T.cg_solve_cuda(A, torch.empty(2, 8, device="meta"))


def test_launch_counts_track_the_plain_cg():
    before = T.COUNTS.cg_solve_plain
    A, b = als_like(2, 10, 8, seed=0)
    T.cg_solve_cuda(torch.from_numpy(A), torch.from_numpy(b), 4)
    assert T.COUNTS.cg_solve_plain == before + 1
    kernel_launches = T.COUNTS.cg_solve
    T.cg_solve(torch.from_numpy(A), torch.from_numpy(b), 4)
    assert T.COUNTS.cg_solve == kernel_launches
