"""Port parity: the Newton-Schulz solve of predictionio_tpu_torch.ops.solve
vs the JAX reference.

The port's plain `schulz_solve` (the CPU path of `schulz_solve_cuda`, and
the version the CUDA kernel is held against on the card) must match the
reference's jnp `schulz_solve` and its Pallas `_schulz_kernel` (run
through the Pallas interpreter, as tests/test_solve.py runs it), for both
compute dtypes: the same rounding points (A once, X before each product,
A X before the second), f32 sums taken in another order.

Tolerance, per case: 4x what f32 rounding alone moves the port's plain
version on the same systems (its f32-sum run against its f64-sum run with
the same bf16 rounding points), never below 1e-4, relative to the largest
|x|. A probe over ALS-like systems (kappa' = ||A||_inf / lambda_min from
34 to 268) read the port-vs-JAX gap at no more than 1.1x that reading.
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

TOL_FLOOR = 1e-4
ROUNDING_FACTOR = 4


def als_systems(B, R, seed, ridge=0.05):
    """ALS-like SPD systems: the Gram of R + 4 rows, a ridge of
    ridge * (R + 4), and a symmetric e^U(-1/2, 1/2) scaling so the
    diagonal varies; the rhs is random."""
    rng = np.random.default_rng(seed)
    K = R + 4
    V = rng.standard_normal((B, K, R)) / np.sqrt(R)
    A = np.einsum("bkr,bks->brs", V, V) + ridge * K * np.eye(R)
    d = np.exp(rng.uniform(-0.5, 0.5, (B, R)))
    A = d[:, :, None] * A * d[:, None, :]
    b = rng.standard_normal((B, R))
    return A.astype(np.float32), b.astype(np.float32)


def rel(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def port(A, b, iters, cd, fn=T.schulz_solve):
    return fn(torch.from_numpy(A), torch.from_numpy(b), iters, cd).numpy()


def tolerance(A, b, iters, cd):
    """max(TOL_FLOOR, ROUNDING_FACTOR x the plain version's f32-vs-f64
    reading on these systems)."""
    x32 = port(A, b, iters, cd)
    x64 = T.schulz_solve(torch.from_numpy(A).double(),
                         torch.from_numpy(b).double(), iters, cd).numpy()
    return x32, max(TOL_FLOOR, ROUNDING_FACTOR * rel(x32, x64))


def pallas(A, b, iters, cd):
    B, R = b.shape
    return np.asarray(pl.pallas_call(
        functools.partial(J._schulz_kernel, iters=iters, compute_dtype=cd),
        out_shape=jax.ShapeDtypeStruct((B, R), jnp.float32),
        interpret=True,
    )(jnp.asarray(A), jnp.asarray(b)))


CASES = [(R, cd, iters) for R in (8, 16, 27, 64)
         for cd in ("float32", "bfloat16") for iters in (18, R + 8)]
CASES += [(200, cd, 18) for cd in ("float32", "bfloat16")]


@pytest.mark.parametrize("R,cd,iters", CASES)
def test_schulz_matches_jnp_and_pallas_kernel(R, cd, iters):
    """Primal-style 18 steps and dual-style K+8 steps, R not a multiple of
    8 (27), and one R = 200 case (the path's rank) at a small batch."""
    B = 2 if R == 200 else 5
    A, b = als_systems(B, R, seed=R + iters)
    x_port, tol = tolerance(A, b, iters, cd)
    assert rel(x_port, np.asarray(J.schulz_solve(A, b, iters, cd))) <= tol
    assert rel(x_port, pallas(A, b, iters, cd)) <= tol
    # the kernel's wrapper takes the plain version on a CPU tensor
    np.testing.assert_array_equal(
        port(A, b, iters, cd, T.schulz_solve_cuda), x_port)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 2, 5])
def test_schulz_early_iterates_match_pallas_kernel(cd, iters):
    """Before convergence a wrong step (a missed rounding, a wrong
    starting scale) shows directly, which a converged answer would hide."""
    A, b = als_systems(4, 27, seed=3)
    x_port, tol = tolerance(A, b, iters, cd)
    assert rel(x_port, pallas(A, b, iters, cd)) <= tol


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", [T.schulz_solve, T.schulz_solve_cuda])
def test_padding_systems_solve_to_exact_zero(fn, cd):
    """Plan padding rows (A = reg*I, b = 0) in a batch with real systems:
    they solve to exactly 0, and the real ones still match the
    reference."""
    A, b = als_systems(3, 16, seed=11)
    A[1] = 0.01 * np.eye(16, dtype=np.float32)
    b[1] = 0.0
    _, tol = tolerance(A, b, 18, cd)
    x = port(A, b, 18, cd, fn)
    assert (x[1] == 0.0).all()
    assert rel(x, np.asarray(J.schulz_solve(A, b, 18, cd))) <= tol


@pytest.mark.parametrize("fn", [T.schulz_solve, T.schulz_solve_cuda])
def test_empty_batch(fn):
    x = fn(torch.zeros(0, 8, 8), torch.zeros(0, 8), 18, "bfloat16")
    assert x.shape == (0, 8)


@pytest.mark.parametrize("R,seed", [(16, 2), (27, 3), (64, 5)])
def test_bf16_rounding_is_visible_before_convergence(R, seed):
    """The parity check can tell the compute dtypes apart: two steps in,
    the f32 and bf16 answers on the same systems differ by more than
    twice the tolerance (the two refinements hide the bf16 rounding of a
    converged X: at 18 steps they differ by < 1e-2 tolerances)."""
    A, b = als_systems(4, R, seed=seed)
    x_bf, tol = tolerance(A, b, 2, "bfloat16")
    assert rel(port(A, b, 2, "float32"), x_bf) > 2 * tol


def test_plain_schulz_counts_and_rejects_unknown_dtype():
    before = T.COUNTS.schulz_solve_plain
    A, b = als_systems(2, 8, seed=0)
    port(A, b, 3, "float32", T.schulz_solve_cuda)
    assert T.COUNTS.schulz_solve_plain == before + 1
    launches = T.COUNTS.schulz_solve
    port(A, b, 3, "float32")
    assert T.COUNTS.schulz_solve == launches
    with pytest.raises(ValueError, match="compute_dtype"):
        port(A, b, 3, "float16")


def test_wrapper_never_falls_back_off_the_cpu():
    A = torch.empty(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        T.schulz_solve_cuda(A, torch.empty(2, 8, device="meta"))
