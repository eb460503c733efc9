"""The CG and Cholesky kernels' geometry and layout rules in
`predictionio_tpu_torch/ops/solve.py`, on the CPU.

The kernels choose their own geometry (csrc/cg_solve.cu:geometry_for,
csrc/chol_solve.cu:block_threads and pio_chol_solve_max_rank); the Python
mirrors here are what `chip_smoke.py` reports beside every kernel row and
are held to the kernels' own answers at every R by
`tests/test_torch_cuda.py` on the card. These tests pin the rules
themselves: borders, register tiles, shared-memory budgets.
"""

import pytest

from predictionio_tpu_torch.ops import solve as T

# what a block may use on an H100, and on a card with 99 KB a block
H100 = T.H100_SMEM_OPTIN
SMALL = 101_376
# the registers geometry's instantiated column counts (csrc/cg_solve.cu)
REG_COLS = set(range(18, 53, 2))


@pytest.mark.parametrize("R,geometry", [
    (1, "warp"), (8, "warp"), (27, "warp"), (32, "warp"),
    (33, "registers"), (104, "registers"), (105, "registers"),
    (200, "registers"), (208, "registers"), (209, "shared"),
    (240, "shared"), (241, "global"), (256, "global"), (2048, "global")])
def test_cg_geometry_borders_on_an_h100(R, geometry):
    assert T.cg_geometry(R, H100) == geometry
    assert geometry in T.CG_GEOMETRIES


@pytest.mark.parametrize("R,geometry", [(32, "warp"), (104, "registers"),
                                        (144, "registers"),
                                        (158, "registers"),
                                        (159, "global")])
def test_cg_geometry_follows_shared_memory(R, geometry):
    """With less shared memory a block, the registers geometry (which
    stages the next A) gives way earlier, and the stream kernel then
    cannot hold A in shared memory either."""
    assert T.cg_geometry(R, SMALL) == geometry


@pytest.mark.parametrize("R,layout", [(33, (2, 18, 64)),
                                      (56, (2, 28, 64)),
                                      (104, (2, 52, 128)),
                                      (105, (4, 28, 224)),
                                      (144, (4, 36, 288)),
                                      (200, (4, 50, 416)),
                                      (208, (4, 52, 416))])
def test_cg_register_layout(R, layout):
    assert T.cg_register_layout(R) == layout


def test_cg_register_layout_covers_every_rank_it_takes():
    """Every R of the registers geometry: the lanes of a row pair hold all
    R columns, in an instantiated column count, within 13 warps and the
    H100's shared memory (the primal R = 200 takes 162 KB)."""
    for R in range(T.CG_WARP_MAX_RANK + 1, T.CG_REG_MAX_RANK + 1):
        H, CW, threads = T.cg_register_layout(R)
        assert H * CW >= R > H * (CW - 2)
        assert CW in REG_COLS
        assert threads % 32 == 0 and (R + 1) // 2 * H <= threads <= 416
        assert T.cg_register_smem_bytes(R) <= H100
    assert T.cg_register_smem_bytes(200) == 161_760


@pytest.mark.parametrize("R,layout", [
    (5, ("packed", 64, 8, 6_784)), (27, ("packed", 64, 8, 27_904)),
    (32, ("packed", 64, 8, 27_904)), (33, ("block", 64, 1, 4_912)),
    (64, ("block", 64, 1, 10_816)), (65, ("block", 128, 1, 13_328)),
    (128, ("block", 128, 1, 38_528)), (129, ("block", 256, 1, 43_216)),
    (200, ("block", 256, 1, 90_512)), (320, ("block", 256, 1, 226_112))])
def test_chol_layout(R, layout):
    assert T.chol_layout(R) == layout


def test_chol_primal_block_leaves_room_for_two_a_sm():
    """At R = 200 the packed triangle takes 88 KB, so two blocks share an
    SM's 228 KB (the first kernel's square layout took 164 KB)."""
    assert 2 * T.chol_layout(200)[3] <= 228 * 1024


@pytest.mark.parametrize("optin,limit", [(H100, 320), (SMALL, 208),
                                         (48 * 1024, 144)])
def test_chol_rank_limit(optin, limit):
    assert T.chol_rank_limit(optin) == limit
    assert T.chol_layout(limit)[3] <= optin < T.chol_layout(limit + 8)[3]


def test_chol_rank_limit_keeps_every_rank_the_first_kernel_took():
    assert T.chol_rank_limit(H100) >= 232
