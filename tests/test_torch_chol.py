"""Port parity: the plain blocked Cholesky solve `chol_solve` (the CPU path
of `chol_solve_cuda`, and the version the CUDA kernel is held against on
the card) vs the JAX reference's `_blocked_cholesky_solve` and its Pallas
kernel `cholesky_solve_pallas`, run through the Pallas interpreter as
tests/test_solve.py runs it.

Tolerances: against the truth, max(1e-4, cond * 5e-6) relative (a direct
method's error grows as cond * eps_f32), as tests/test_solve.py holds the
reference; against the reference, rtol 2e-3 / atol 2e-4 (the same
factorisation with f32 sums in another order), at conditions up to 2e3
where that elementwise bar is meaningful.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import solve as J
from predictionio_tpu_torch.ops import solve as T


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


def port(A, b):
    return T.chol_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()


def rel_norm(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


# R below one panel, not a multiple of the panel width 8, and a multiple
@pytest.mark.parametrize("R", [5, 10, 27, 48])
@pytest.mark.parametrize("cond", [10.0, 1e3, 1e5])
def test_chol_solve_matches_truth(R, cond):
    A, b, x_true = make_spd(11, R, cond, seed=R)   # B = 11, not a tile
    assert rel_norm(port(A, b), x_true) < max(1e-4, cond * 5e-6)


@pytest.mark.parametrize("R", [5, 10, 27, 48])
@pytest.mark.parametrize("cond", [30.0, 2e3])
def test_chol_solve_matches_reference_blocked_cholesky(R, cond):
    A, b, _ = make_spd(13, R, cond, seed=R + 1)
    x_ref = np.asarray(J._blocked_cholesky_solve(A, b))
    np.testing.assert_allclose(port(A, b), x_ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("R", [5, 10, 27, 48])
def test_chol_solve_matches_pallas_kernel(R):
    """B = 12 pads to two tiles of 8 inside the Pallas wrapper."""
    A, b, _ = make_spd(12, R, 500.0, seed=R + 2)
    x_pallas = np.asarray(J.cholesky_solve_pallas(A, b, tile=8,
                                                  interpret=True))
    np.testing.assert_allclose(port(A, b), x_pallas, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("R", [8, 27, 200])
def test_padding_systems_solve_to_exact_zero(R):
    """Plan padding rows give A = reg*I, b = 0; so do the identity rows
    that pad R to a whole panel."""
    A = (0.01 * torch.eye(R)).expand(3, R, R).contiguous()
    assert torch.equal(T.chol_solve(A, torch.zeros(3, R)),
                       torch.zeros(3, R))


def test_pivot_is_clamped_not_refused():
    """torch.linalg.cholesky refuses a negative pivot; the reference
    takes sqrt(max(d, 1e-30)) and goes on, and so does the port."""
    A, b, _ = make_spd(2, 12, 10.0, seed=4)
    A[:, 3, :] = A[:, :, 3] = 0.0
    A[:, 3, 3] = -1e-3
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.from_numpy(A))
    x_ref = np.asarray(J._blocked_cholesky_solve(A, b))
    x = port(A, b)
    assert np.isfinite(x).all() and np.isfinite(x_ref).all()
    np.testing.assert_allclose(x, x_ref, rtol=2e-3, atol=2e-4)


def test_reads_only_the_lower_triangle():
    A, b, _ = make_spd(4, 20, 50.0, seed=6)
    junk = np.tril(A) + np.triu(np.full_like(A, 7.0), 1)
    np.testing.assert_array_equal(port(junk, b), port(A, b))


@pytest.mark.parametrize("R", [16, 24])
def test_factor_and_substitutions(R):
    """L L^T = A, forward then back substitution solve the system; the
    pieces chip_smoke.py composes its planted faults from."""
    A, b, x_true = make_spd(3, R, 20.0, seed=R)
    At, bt = torch.from_numpy(A).double(), torch.from_numpy(b).double()
    L = T.chol_factor(At)
    assert torch.equal(L, torch.tril(L))
    torch.testing.assert_close(L @ L.transpose(1, 2), At, rtol=0,
                               atol=1e-12)
    x = T.chol_back(L, T.chol_forward(L, bt))
    np.testing.assert_allclose(x.numpy(), x_true, rtol=0, atol=1e-5)


def test_pad_to_panel_adds_an_identity_block():
    A, b, _ = make_spd(2, 10, 5.0)
    Ap, bp = T.pad_to_panel(torch.from_numpy(A), torch.from_numpy(b))
    assert Ap.shape == (2, 16, 16) and bp.shape == (2, 16)
    assert torch.equal(Ap[:, 10:, 10:], torch.eye(6).expand(2, 6, 6))
    assert torch.equal(Ap[:, :10, 10:], torch.zeros(2, 10, 6))
    assert torch.equal(bp[:, 10:], torch.zeros(2, 6))


def test_cuda_wrapper_takes_the_plain_version_on_the_cpu():
    A, b, _ = make_spd(5, 27, 100.0, seed=9)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    plain_before = T.COUNTS.chol_solve_plain
    launches = T.COUNTS.chol_solve
    x = T.chol_solve_cuda(At, bt)
    assert torch.equal(x, T.chol_solve(At, bt))
    assert T.COUNTS.chol_solve_plain == plain_before + 2
    assert T.COUNTS.chol_solve == launches


def test_cuda_wrapper_never_falls_back_off_the_cpu():
    A = torch.empty(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        T.chol_solve_cuda(A, torch.empty(2, 8, device="meta"))


def test_float64_plain_version_reads_rounding():
    """The f64 run is the rounding yardstick the card check's tolerance
    comes from: f32 rounding moves the solve by about cond * eps."""
    A, b, _ = make_spd(6, 40, 1e3, seed=2)
    x32 = port(A, b)
    x64 = T.chol_solve(torch.from_numpy(A).double(),
                       torch.from_numpy(b).double()).numpy()
    assert x64.dtype == np.float64
    assert 0 < np.abs(x32 - x64).max() / np.abs(x64).max() < 1e3 * 1e-6
