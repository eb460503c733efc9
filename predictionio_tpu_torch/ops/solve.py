"""Batched SPD solves for the ALS normal equations.

The port's counterpart of `predictionio_tpu/ops/solve.py`:

- `cholesky_solve`: `torch.linalg.cholesky` + two triangular solves, the
  numerical truth (and the CPU path, as LAPACK is in the reference).
- `cg_solve`: the plain PyTorch batched Jacobi-preconditioned CG, the same
  arithmetic as the reference's `cg_solve`/`_cg_kernel`.
- `cg_solve_cuda`: the wrapper of the hand-written Hopper kernel
  `csrc/cg_solve.cu`, which replaces the TPU's `_cg_kernel`.
- `chol_solve`: the plain PyTorch blocked Cholesky solve, a port of the
  reference's `_blocked_cholesky_solve` (panel width 8, pivots
  `sqrt(max(d, 1e-30))`, identity padding to a whole panel). Unlike
  `torch.linalg.cholesky` it never refuses a pivot: it clamps as the
  reference does.
- `chol_solve_cuda`: the wrapper of the hand-written Hopper kernel
  `csrc/chol_solve.cu`, which replaces the TPU's `_chol_kernel`.
- `schulz_solve`: the plain PyTorch Newton-Schulz inverse iteration, a
  port of the reference's `schulz_solve`/`_schulz_kernel`: products in
  `compute_dtype` (bfloat16 operands, float32 sums) from X0 = I/||A||_inf,
  then x = X b and two float32 refinements.
- `schulz_solve_cuda`: the wrapper of the hand-written Hopper kernel
  `csrc/schulz_solve.cu`, which replaces the TPU's `_schulz_kernel`.

A kernel wrapper given CUDA tensors launches its kernel or raises; it
takes its plain version only for tensors on the CPU.

`spd_solve` dispatches by method name; `resolve_solver('auto', device)` is
`'cg_cuda'` on a CUDA device and `'cholesky'` on the CPU (what the
reference picks off the TPU). `iters=None` means each iterative solver's
own default (CG 48, Schulz 18), as in the reference.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from predictionio_tpu_torch.ops import _build

CG_PRIMAL_ITERS = 48
# the reference's `_schulz_iters_default`: quadratic convergence, the error
# after k steps ~ (1 - 1/kappa)^(2^k); 18 doublings resolve kappa ~ 1e4 to
# f32 eps with margin
SCHULZ_ITERS = 18
COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass
class LaunchCounts:
    """Launches on this process's main path, so a run can show that it
    went through the kernels. `cg_solve`, `chol_solve` and `schulz_solve`
    count CUDA kernel launches (one per wrapper call that launched);
    `*_plain` count calls of the plain PyTorch versions."""
    cg_solve: int = 0
    cg_solve_plain: int = 0
    chol_solve: int = 0
    chol_solve_plain: int = 0
    schulz_solve: int = 0
    schulz_solve_plain: int = 0

    def reset(self) -> None:
        for name in self.__dataclass_fields__:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        return dict(vars(self))

    def since(self, snapshot: dict) -> dict:
        """The counts added after `snapshot` (nonzero ones only)."""
        return {k: v - snapshot[k] for k, v in vars(self).items()
                if v != snapshot[k]}

    def add(self, counts: dict, times: int = 1) -> None:
        """Add `times` x `counts`: a replayed CUDA graph launches the
        kernels its capture recorded without calling their wrappers
        (`ops/als._FusedIteration`)."""
        for k, v in counts.items():
            setattr(self, k, getattr(self, k) + times * v)


COUNTS = LaunchCounts()


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct solve of SPD A [B,R,R] x = b [B,R] — the numerical truth."""
    L = torch.linalg.cholesky(A)
    y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.transpose(-2, -1), y,
                                         upper=True).squeeze(-1)


def cg_solve(A: torch.Tensor, b: torch.Tensor,
             iters: int = CG_PRIMAL_ITERS) -> torch.Tensor:
    """Batched Jacobi-preconditioned CG on SPD A [B,R,R], fixed iteration
    count, zero initial guess — the plain version of the CUDA kernel."""
    COUNTS.cg_solve_plain += 1
    dinv = 1.0 / torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1),
                             min=1e-30)
    x = torch.zeros_like(b)
    r = b
    z = dinv * r
    p = z
    rz = (r * z).sum(dim=1)
    for _ in range(iters):
        Ap = torch.bmm(A, p.unsqueeze(-1)).squeeze(-1)
        alpha = rz / torch.clamp((p * Ap).sum(dim=1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = dinv * r
        rz2 = (r * z).sum(dim=1)
        p = z + (rz2 / torch.clamp(rz, min=1e-30))[:, None] * p
        rz = rz2
    return x


_lib_ready = False


def _cg_lib() -> ctypes.CDLL:
    global _lib_ready
    lib = _build.load("cg_solve")
    if not _lib_ready:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pio_cg_solve_f32.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.pio_cg_solve_f32.restype = ci
        lib.pio_cg_solve_geometry.argtypes = [ci]
        lib.pio_cg_solve_geometry.restype = ci
        lib.pio_cg_solve_smem_optin.argtypes = []
        lib.pio_cg_solve_smem_optin.restype = ci
        lib.pio_cg_solve_max_rank.argtypes = []
        lib.pio_cg_solve_max_rank.restype = ci
        lib.pio_cuda_error_string.argtypes = [ci]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
        _lib_ready = True
    return lib


# Opt-in shared memory of one block on an H100 (227 KB), in bytes.
H100_SMEM_OPTIN = 232_448
# The CG kernel's geometries (csrc/cg_solve.cu), by the code its
# `pio_cg_solve_geometry` returns: a team of lanes per system with A's rows
# in registers (R <= 32); one block per system with A in registers and
# the next system's A staged in shared memory (R <= 208); the stream
# kernel with A in shared memory, or read from global memory.
CG_GEOMETRIES = ("warp", "registers", "shared", "global")
CG_WARP_MAX_RANK = 32
CG_REG_MAX_RANK = 208


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def cg_register_layout(R: int):
    """(lanes sharing a row pair, columns of A per lane, threads per
    block) of the registers geometry: each thread holds two rows over the
    columns of its slice; two lanes a row pair up to R = 104, four above
    it."""
    H = 4 if R > CG_REG_MAX_RANK // 2 else 2
    CW = -(-R // H)
    CW += CW & 1
    return H, CW, ((R + 1) // 2 * H + 31) // 32 * 32


def cg_register_smem_bytes(R: int) -> int:
    """Shared memory of a registers-geometry block: the stage of the next
    A and b, p (slice stride padded so the slices start in different
    banks) and two reduction buffers."""
    H, CW, _ = cg_register_layout(R)
    stride = _round4(CW)
    if (stride // 4) % 4 == 0:
        stride += 4
    return 4 * (_round4(R * R) + _round4(R) + H * stride + 32)


def cg_geometry(R: int, smem_optin: int = H100_SMEM_OPTIN) -> str:
    """The geometry the CG kernel takes for an R x R system on a device
    with `smem_optin` bytes of shared memory a block (mirrors
    csrc/cg_solve.cu:geometry_for)."""
    if R <= CG_WARP_MAX_RANK:
        return "warp"
    if R <= CG_REG_MAX_RANK and cg_register_smem_bytes(R) <= smem_optin:
        return "registers"
    if 4 * (_round4(R) + 64 + R * R) <= smem_optin:
        return "shared"
    return "global"


def cg_device_geometry(R: int) -> str:
    """The geometry the built kernel takes for R on the current CUDA
    device (`cg_geometry` with the device's shared memory)."""
    code = _cg_lib().pio_cg_solve_geometry(int(R))
    if code < 0:
        raise RuntimeError(f"CUDA error {-code} querying shared memory")
    return CG_GEOMETRIES[code]


def cg_smem_optin() -> int:
    """Opt-in shared memory per block of the current CUDA device."""
    n = _cg_lib().pio_cg_solve_smem_optin()
    if n < 0:
        raise RuntimeError(f"CUDA error {-n} querying shared memory")
    return n


def cg_solve_cuda(A: torch.Tensor, b: torch.Tensor,
                  iters: int = CG_PRIMAL_ITERS) -> torch.Tensor:
    """Batched Jacobi-PCG through the Hopper kernel `csrc/cg_solve.cu`.

    A: [B, R, R] f32 contiguous SPD, b: [B, R] f32 contiguous, both on one
    CUDA device. Returns x [B, R]. A CPU tensor takes the plain
    `cg_solve`; any other device raises."""
    if A.device.type == "cpu" and b.device.type == "cpu":
        return cg_solve(A, b, iters)
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"cg_solve_cuda needs A and b on one CUDA device, "
                         f"got {A.device} and {b.device}")
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"cg_solve_cuda takes float32, got {A.dtype} and "
                        f"{b.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or b.shape != A.shape[:2]:
        raise ValueError(f"cg_solve_cuda needs A [B,R,R] and b [B,R], got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("cg_solve_cuda needs contiguous A and b")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    B, R = b.shape
    lib = _cg_lib()
    if R > lib.pio_cg_solve_max_rank():
        raise ValueError(f"cg_solve_cuda takes R <= "
                         f"{lib.pio_cg_solve_max_rank()}, got {R}")
    x = torch.empty_like(b)
    if B == 0:
        return x
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.pio_cg_solve_f32(A.data_ptr(), b.data_ptr(), x.data_ptr(),
                                   B, R, int(iters), stream)
    if err != 0:
        msg = lib.pio_cuda_error_string(err).decode()
        raise RuntimeError(f"cg_solve kernel launch failed at B={B} R={R}: "
                           f"CUDA error {err} ({msg})")
    COUNTS.cg_solve += 1
    return x


CHOL_PANEL = 8


def pad_to_panel(A: torch.Tensor, b: torch.Tensor, panel: int = CHOL_PANEL):
    """Pad R to a multiple of `panel` with an identity block (the padding
    rows decouple and solve to 0), as the reference does."""
    B, R = b.shape
    pad = (-R) % panel
    if not pad:
        return A, b
    Ap = torch.zeros(B, R + pad, R + pad, dtype=A.dtype, device=A.device)
    Ap[:, :R, :R] = A
    Ap[:, R:, R:] = torch.eye(pad, dtype=A.dtype, device=A.device)
    return Ap, torch.cat([b, b.new_zeros(B, pad)], dim=1)


def chol_factor(A: torch.Tensor, panel: int = CHOL_PANEL) -> torch.Tensor:
    """Blocked right-looking Cholesky of SPD A [B,R,R] (R a multiple of
    `panel`): L with L L^T = A, read from A's lower triangle. Per panel:
    the diagonal block by a column loop with pivots sqrt(max(d, 1e-30)),
    the rows below by forward substitution with it, then the trailing
    update A22 -= L21 L21^T."""
    A = A.clone()
    R = A.shape[-1]
    L = torch.zeros_like(A)
    for c0 in range(0, R, panel):
        r0 = c0 + panel
        A11 = A[:, c0:r0, c0:r0]
        L11 = torch.zeros_like(A11)
        for c in range(panel):
            d = torch.sqrt(torch.clamp(A11[:, c, c], min=1e-30))
            col = A11[:, :, c] / d[:, None]
            col[:, :c] = 0.0                        # lower part only
            L11[:, :, c] = col
            A11 = A11 - col[:, :, None] * col[:, None, :]
        L[:, c0:r0, c0:r0] = L11
        if r0 == R:
            break
        A21 = A[:, r0:, c0:r0]
        L21 = torch.zeros_like(A21)
        for c in range(panel):
            acc = A21[:, :, c]
            for k in range(c):
                acc = acc - L21[:, :, k] * L11[:, c, k][:, None]
            L21[:, :, c] = acc / L11[:, c, c][:, None]
        L[:, r0:, c0:r0] = L21
        A[:, r0:, r0:] -= torch.bmm(L21, L21.transpose(1, 2))
    return L


def chol_forward(L: torch.Tensor, b: torch.Tensor,
                 panel: int = CHOL_PANEL) -> torch.Tensor:
    """Blocked forward substitution L y = b."""
    y = torch.zeros_like(b)
    for c0 in range(0, b.shape[1], panel):
        r0 = c0 + panel
        rhs = b[:, c0:r0] - torch.bmm(L[:, c0:r0, :c0],
                                      y[:, :c0, None]).squeeze(-1)
        L11 = L[:, c0:r0, c0:r0]
        for c in range(panel):
            acc = rhs[:, c]
            for k in range(c):
                acc = acc - L11[:, c, k] * y[:, c0 + k]
            y[:, c0 + c] = acc / L11[:, c, c]
    return y


def chol_back(L: torch.Tensor, y: torch.Tensor,
              panel: int = CHOL_PANEL) -> torch.Tensor:
    """Blocked back substitution L^T x = y."""
    x = torch.zeros_like(y)
    for c0 in reversed(range(0, y.shape[1], panel)):
        r0 = c0 + panel
        rhs = y[:, c0:r0] - torch.bmm(L[:, r0:, c0:r0].transpose(1, 2),
                                      x[:, r0:, None]).squeeze(-1)
        L11 = L[:, c0:r0, c0:r0]
        for c in reversed(range(panel)):
            acc = rhs[:, c]
            for k in range(c + 1, panel):
                acc = acc - L11[:, k, c] * x[:, c0 + k]
            x[:, c0 + c] = acc / L11[:, c, c]
    return x


def chol_solve(A: torch.Tensor, b: torch.Tensor,
               panel: int = CHOL_PANEL) -> torch.Tensor:
    """Batched blocked Cholesky solve of SPD A [B,R,R] x = b [B,R] — the
    plain version of the CUDA kernel (the reference's
    `_blocked_cholesky_solve`), in A's dtype."""
    COUNTS.chol_solve_plain += 1
    R = b.shape[1]
    Ap, bp = pad_to_panel(A, b, panel)
    L = chol_factor(Ap, panel)
    return chol_back(L, chol_forward(L, bp, panel), panel)[:, :R]


_chol_ready = False


def _chol_lib() -> ctypes.CDLL:
    global _chol_ready
    lib = _build.load("chol_solve")
    if not _chol_ready:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pio_chol_solve_f32.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.pio_chol_solve_f32.restype = ci
        lib.pio_chol_solve_max_rank.argtypes = []
        lib.pio_chol_solve_max_rank.restype = ci
        lib.pio_chol_solve_threads.argtypes = [ci]
        lib.pio_chol_solve_threads.restype = ci
        lib.pio_chol_error_string.argtypes = [ci]
        lib.pio_chol_error_string.restype = ctypes.c_char_p
        _chol_ready = True
    return lib


# The Cholesky kernel's layout (csrc/chol_solve.cu): the padded lower
# triangle packed as 8x8 tiles, 68 floats apart, then v and x [Rp] each
# and two 64-float slots that carry a panel's L11 to its tile;
# up to Rp = 32 a team of 8 lanes takes a system, 8 systems a 64-thread
# block ("packed"); above it one block a system ("block").
CHOL_TILE_FLOATS = 68
CHOL_PACKED_MAX_RP = 32
CHOL_PACKED_SYSTEMS = 8


def chol_layout(R: int):
    """(geometry, threads per block, systems per block, shared-memory
    bytes per block) of the Cholesky kernel for an R x R system."""
    Rp = -(-R // CHOL_PANEL) * CHOL_PANEL
    nT = Rp // CHOL_PANEL
    floats = nT * (nT + 1) // 2 * CHOL_TILE_FLOATS + 2 * Rp + 128
    if Rp <= CHOL_PACKED_MAX_RP:
        return ("packed", 64, CHOL_PACKED_SYSTEMS,
                4 * floats * CHOL_PACKED_SYSTEMS)
    threads = 64 if Rp <= 64 else 128 if Rp <= 128 else 256
    return "block", threads, 1, 4 * floats


def chol_rank_limit(smem_optin: int = H100_SMEM_OPTIN) -> int:
    """Largest R (a multiple of the panel) whose block fits in
    `smem_optin` bytes of shared memory: 320 on an H100 (mirrors
    csrc/chol_solve.cu:pio_chol_solve_max_rank)."""
    R = 0
    while chol_layout(R + CHOL_PANEL)[3] <= smem_optin:
        R += CHOL_PANEL
    return R


def chol_max_rank(device: torch.device) -> int:
    """Largest R the Cholesky kernel takes on `device` (its packed system
    must fit in one block's shared memory: 320 on an H100)."""
    with torch.cuda.device(device):
        R = _chol_lib().pio_chol_solve_max_rank()
    if R < 0:
        raise RuntimeError(f"CUDA error {-R} querying shared memory")
    return R


def chol_device_threads(R: int) -> int:
    """Threads per block the built Cholesky kernel launches for R (the
    second entry of `chol_layout`)."""
    return _chol_lib().pio_chol_solve_threads(int(R))


def chol_solve_cuda(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched blocked Cholesky solve through the Hopper kernel
    `csrc/chol_solve.cu`.

    A: [B, R, R] f32 contiguous SPD (only its lower triangle is read),
    b: [B, R] f32 contiguous, both on one CUDA device, R up to
    `chol_max_rank`. Returns x [B, R]. A CPU tensor takes the plain
    `chol_solve`; any other device raises."""
    if A.device.type == "cpu" and b.device.type == "cpu":
        return chol_solve(A, b)
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"chol_solve_cuda needs A and b on one CUDA "
                         f"device, got {A.device} and {b.device}")
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"chol_solve_cuda takes float32, got {A.dtype} and "
                        f"{b.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or b.shape != A.shape[:2]:
        raise ValueError(f"chol_solve_cuda needs A [B,R,R] and b [B,R], "
                         f"got {tuple(A.shape)} and {tuple(b.shape)}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("chol_solve_cuda needs contiguous A and b")
    B, R = b.shape
    max_rank = chol_max_rank(A.device)
    if R > max_rank:
        raise ValueError(f"chol_solve_cuda takes R <= {max_rank} (the "
                         f"padded system must fit in shared memory), got "
                         f"{R}")
    x = torch.empty_like(b)
    if B == 0:
        return x
    lib = _chol_lib()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.pio_chol_solve_f32(A.data_ptr(), b.data_ptr(),
                                     x.data_ptr(), B, R, stream)
    if err != 0:
        msg = lib.pio_chol_error_string(err).decode()
        raise RuntimeError(f"chol_solve kernel launch failed at B={B} "
                           f"R={R}: CUDA error {err} ({msg})")
    COUNTS.chol_solve += 1
    return x


def round_operand(t: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """`t` as a product operand in `compute_dtype`, kept in `t`'s dtype:
    rounded to bfloat16 (round to nearest even) and back for 'bfloat16',
    unchanged for 'float32'. A product of two bfloat16 values is exact in
    float32, so rounding the operands and multiplying in float32 is the
    reference's bf16 product with `preferred_element_type=float32`."""
    if compute_dtype == "bfloat16":
        return t.to(torch.bfloat16).to(t.dtype)
    if compute_dtype == "float32":
        return t
    raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got "
                     f"{compute_dtype!r}")


def schulz_solve(A: torch.Tensor, b: torch.Tensor,
                 iters: Optional[int] = None,
                 compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Batched SPD solve by Newton-Schulz iteration — the plain version of
    the CUDA kernel (the reference's `schulz_solve`). X0 = I/||A||_inf;
    each step X <- 2X - X (A X) with both products on `compute_dtype`
    operands (A rounded once, X before each product, A X before the
    second) and sums in A's dtype; then x = X b and two refinements
    x += X (b - A x) with the unrounded A and X. Never uses a bfloat16
    matmul (on the CPU it returns bfloat16): rounds, then multiplies in
    A's dtype."""
    COUNTS.schulz_solve_plain += 1
    R = A.shape[-1]
    iters = iters or SCHULZ_ITERS
    alpha = 1.0 / torch.clamp(A.abs().sum(dim=-1).amax(dim=-1), min=1e-30)
    X = alpha[:, None, None] * torch.eye(R, dtype=A.dtype, device=A.device)
    Ac = round_operand(A, compute_dtype)
    for _ in range(iters):
        Xc = round_operand(X, compute_dtype)
        Y = torch.bmm(Ac, Xc)
        X = 2.0 * X - torch.bmm(Xc, round_operand(Y, compute_dtype))
    x = torch.bmm(X, b.unsqueeze(-1)).squeeze(-1)
    for _ in range(2):
        r = b - torch.bmm(A, x.unsqueeze(-1)).squeeze(-1)
        x = x + torch.bmm(X, r.unsqueeze(-1)).squeeze(-1)
    return x


_schulz_ready = False


def _schulz_lib() -> ctypes.CDLL:
    global _schulz_ready
    lib = _build.load("schulz_solve")
    if not _schulz_ready:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pio_schulz_solve_f32.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp,
                                             vp]
        lib.pio_schulz_solve_f32.restype = ci
        lib.pio_schulz_workspace_floats.argtypes = [ci, ci, ci]
        lib.pio_schulz_workspace_floats.restype = ctypes.c_longlong
        lib.pio_schulz_max_rank.argtypes = [ci]
        lib.pio_schulz_max_rank.restype = ci
        lib.pio_schulz_error_string.argtypes = [ci]
        lib.pio_schulz_error_string.restype = ctypes.c_char_p
        _schulz_ready = True
    return lib


def schulz_max_rank(device: torch.device,
                    compute_dtype: str = "bfloat16") -> int:
    """Largest R the Schulz kernel takes on `device` in `compute_dtype`:
    bfloat16, R padded to 16 at most 208 (rnd(X) and Y in one block's
    shared memory, rnd(A) in registers); float32, its R x R product A X in
    one block's shared memory (224 on an H100)."""
    with torch.cuda.device(device):
        R = _schulz_lib().pio_schulz_max_rank(
            int(compute_dtype == "bfloat16"))
    if R < 0:
        raise RuntimeError(f"CUDA error {-R} querying shared memory")
    return R


def schulz_solve_cuda(A: torch.Tensor, b: torch.Tensor,
                      iters: Optional[int] = None,
                      compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Batched Newton-Schulz solve through the Hopper kernel
    `csrc/schulz_solve.cu`.

    A: [B, R, R] f32 contiguous SPD, b: [B, R] f32 contiguous, both on one
    CUDA device, R up to `schulz_max_rank`; `iters` Schulz steps (None:
    18); products on `compute_dtype` ('bfloat16' or 'float32') operands.
    Returns x [B, R]. A CPU tensor takes the plain `schulz_solve`; any
    other device raises."""
    if A.device.type == "cpu" and b.device.type == "cpu":
        return schulz_solve(A, b, iters, compute_dtype)
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"schulz_solve_cuda needs A and b on one CUDA "
                         f"device, got {A.device} and {b.device}")
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"schulz_solve_cuda takes float32, got {A.dtype} "
                        f"and {b.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or b.shape != A.shape[:2]:
        raise ValueError(f"schulz_solve_cuda needs A [B,R,R] and b [B,R], "
                         f"got {tuple(A.shape)} and {tuple(b.shape)}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("schulz_solve_cuda needs contiguous A and b")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    B, R = b.shape
    iters = iters or SCHULZ_ITERS
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    max_rank = schulz_max_rank(A.device, compute_dtype)
    if R > max_rank:
        raise ValueError(f"schulz_solve_cuda takes R <= {max_rank} in "
                         f"{compute_dtype} (its working set must fit in "
                         f"shared memory), got {R}")
    x = torch.empty_like(b)
    if B == 0:
        return x
    lib = _schulz_lib()
    bf16 = int(compute_dtype == "bfloat16")
    with torch.cuda.device(A.device):
        n = lib.pio_schulz_workspace_floats(B, R, bf16)
        if n < 0:
            raise RuntimeError(f"CUDA error {-n} sizing the Schulz "
                               f"workspace at B={B} R={R}")
        work = torch.empty(n, dtype=torch.float32, device=A.device)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.pio_schulz_solve_f32(A.data_ptr(), b.data_ptr(),
                                       x.data_ptr(), B, R, int(iters), bf16,
                                       work.data_ptr(), stream)
    if err != 0:
        msg = lib.pio_schulz_error_string(err).decode()
        raise RuntimeError(f"schulz_solve kernel launch failed at B={B} "
                           f"R={R}: CUDA error {err} ({msg})")
    COUNTS.schulz_solve += 1
    return x


def resolve_solver(method: str, device: torch.device) -> str:
    """'auto' -> 'cg_cuda' on a CUDA device, 'cholesky' on the CPU."""
    if method != "auto":
        return method
    return "cg_cuda" if torch.device(device).type == "cuda" else "cholesky"


_PALLAS_COUNTERPART = {"cg_pallas": "cg_cuda", "chol_pallas": "chol_cuda",
                       "schulz_pallas": "schulz_cuda"}


def spd_solve(A: torch.Tensor, b: torch.Tensor, method: str = "auto",
              iters: Optional[int] = None,
              compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Batched SPD solve. method: 'auto' | 'cholesky' | 'cg' | 'cg_cuda' |
    'chol_blocked' | 'chol_cuda' | 'schulz' | 'schulz_cuda'. `iters` is the
    iterative solvers' step count, None for each one's own default (CG 48,
    Schulz 18); `compute_dtype` the Schulz products' operand dtype, as in
    the reference (bfloat16 unless the caller says otherwise)."""
    method = resolve_solver(method, A.device)
    if method == "cholesky":
        return cholesky_solve(A, b)
    if method == "cg":
        return cg_solve(A, b, iters or CG_PRIMAL_ITERS)
    if method == "cg_cuda":
        return cg_solve_cuda(A, b, iters or CG_PRIMAL_ITERS)
    if method == "chol_blocked":
        return chol_solve(A, b)
    if method == "chol_cuda":
        return chol_solve_cuda(A, b)
    if method in ("schulz", "schulz_cuda"):
        fn = schulz_solve if method == "schulz" else schulz_solve_cuda
        return fn(A, b, iters or SCHULZ_ITERS, compute_dtype)
    if method in _PALLAS_COUNTERPART:
        raise ValueError(
            f"solver {method!r} is the TPU's Pallas kernel; on the card "
            f"use {_PALLAS_COUNTERPART[method]!r}")
    raise ValueError(f"unknown solver {method!r}")
