#!/usr/bin/env python3
"""Design choices of the bf16 Newton-Schulz kernel, read on one NVIDIA GPU.

    python3 scripts/schulz_variants.py [--seeds 3,4,5,6,7,8]

Builds copies of `predictionio_tpu_torch/csrc/schulz_solve.cu`, each with
one named change (VARIANTS), with the package's nvcc flags into
`predictionio_tpu_torch/_build/variants/` (all nvcc started together),
and launches each through the library's own C interface:

- `as_built`: the source unchanged;
- `master_in_workspace`: the f32 master X in the global (L2) workspace
  at every padded rank, never in shared memory;
- `ieee_sums`: every MMA sums into zeroed accumulators, which are then
  added to the running f32 sums with an ordinary f32 add, so the sums
  across 16-deep k tiles round to nearest as the plain version's do,
  whatever the tensor core does inside one MMA.

Then prints one JSON line per reading:

- `ptxas`: each variant's registers and spill stores by strip count T;
- `time`: each variant's device time (CUDA events, mean of `reps` calls
  after a warm-up) at the Schulz path's shapes, in the order as_built,
  the others, as_built again, and whether the variant's x equals
  as_built's bit for bit;
- `error`: at K = 120 and 144 (the path's dual shapes, K + 8 steps), for
  the systems of `chip_smoke.py`'s Schulz phase (seed "smoke", the same
  generator sequence) and for fresh seeds, at checkpoints 1, 2, 5 and
  the full step count: the kernel of `as_built` and of `ieee_sums` each
  against the plain `schulz_solve` in float32 and in float64 (the same
  bf16 rounding points, f64 sums), the plain float32 against float64,
  and the smoke's tolerance max(1e-4, 4 x that last reading).

The last line is the card's name and power limit from nvidia-smi. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (the smoke's systems and timers)
from predictionio_tpu_torch.ops import _build  # noqa: E402
from predictionio_tpu_torch.ops.solve import schulz_solve  # noqa: E402

SOURCE = _build.CSRC_DIR / "schulz_solve.cu"
OUT_DIR = _build.BUILD_DIR / "variants"

MMA_IEEE = '''__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  c[0] += d0; c[1] += d1; c[2] += d2; c[3] += d3;
}'''

# name -> [(regular expression matching exactly once, replacement)]
VARIANTS = {
    "as_built": [],
    "master_in_workspace": [
        (r"constexpr int kMasterSmemRp = \d+;",
         "constexpr int kMasterSmemRp = 0;")],
    "ieee_sums": [
        (r"__device__ __forceinline__ void mma_bf16\(.*?\n}", MMA_IEEE)],
}

# (K, B, steps): the Schulz path's shapes (chip_smoke.py's Schulz phase)
TIME_SHAPES = ((8, 4375, 16), (56, 9053, 64), (120, 6323, 128),
               (144, 6778, 152), (200, 5242, 18))
ERROR_SHAPES = ((120, 6323, 128), (144, 6778, 152))


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for pattern, repl in VARIANTS[name]:
        src, n = re.subn(pattern, lambda _: repl, src, flags=re.S)
        if n != 1:
            raise RuntimeError(f"variant {name}: {pattern!r} matched {n} "
                               "times in schulz_solve.cu")
    return src


def build_variants(names):
    """One nvcc per variant, all started together; returns {name: (lib,
    ptxas report)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n in names:
        cu = OUT_DIR / f"schulz_{n}.cu"
        cu.write_text(variant_source(n))
        so = cu.with_suffix(".so")
        jobs[n] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for n, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {n}:\n{log}")
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pio_schulz_solve_f32.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp,
                                             vp]
        lib.pio_schulz_solve_f32.restype = ci
        lib.pio_schulz_workspace_floats.argtypes = [ci, ci, ci]
        lib.pio_schulz_workspace_floats.restype = ctypes.c_longlong
        out[n] = (lib, ptxas_mma(log))
    return out


def ptxas_mma(log: str) -> dict:
    """{T: {"registers": n, "spill_stores": bytes}} of the bf16 kernel's
    instantiations, from ptxas's report."""
    rep, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1) if "schulz_solve_mma" in m.group(1) else None
            continue
        if fn and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            rep.setdefault(fn, {})["spill_stores"] = int(spill)
        elif fn and "registers" in line:
            rep.setdefault(fn, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    # name by template argument T: _Z15schulz_solve_mmaILi13ELi2ELi1EEv...
    return {re.search(r"ILi(\d+)E", f).group(1): v for f, v in rep.items()}


def solve(lib, A: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    B, R = b.shape
    x = torch.empty_like(b)
    n = lib.pio_schulz_workspace_floats(B, R, 1)
    if n < 0:
        raise RuntimeError(f"CUDA error {-n} sizing the workspace")
    work = torch.empty(max(n, 1), dtype=torch.float32, device=A.device)
    err = lib.pio_schulz_solve_f32(
        A.data_ptr(), b.data_ptr(), x.data_ptr(), B, R, iters, 1,
        work.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return x


def emit(kind: str, **fields) -> None:
    print(json.dumps({"reading": kind, **fields}), flush=True)


def smoke_systems():
    """The Schulz phase's systems of chip_smoke.py at ERROR_SHAPES: its
    generator (seed 2) run through its shapes in its order."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    B0 = smoke.WORK_BUDGET // smoke.RANK
    order = [(smoke.RANK, B0), (smoke.RANK, B0)] + [
        (K, B) for K, B in smoke.SCHULZ_DUAL_SHAPES]
    want = {(K, B) for K, B, _ in ERROR_SHAPES}
    out = {}
    for R, B in order:
        A, b = smoke.hard_systems(B, R, gen)
        if (R, B) in want:
            out[(R, B)] = (A, b)
        else:
            del A, b
        if len(out) == len(want):
            return out
    raise RuntimeError("chip_smoke.py's Schulz phase no longer holds "
                       "every shape of ERROR_SHAPES")


def time_variants(libs) -> None:
    gen = torch.Generator(device="cuda")
    order = ["as_built"] + [n for n in libs if n != "as_built"] + [
        "as_built"]
    for K, B, steps in TIME_SHAPES:
        gen.manual_seed(2)
        A, b = smoke.hard_systems(B, K, gen)
        ref = solve(libs["as_built"][0], A, b, steps)
        reps = 20 if K <= 64 else 5
        row = {"K": K, "B": B, "steps": steps, "ms": [], "bitwise_equal": {}}
        for n in order:
            lib = libs[n][0]
            row["ms"].append([n, smoke.cuda_ms(
                lambda: solve(lib, A, b, steps), reps)])
            row["bitwise_equal"][n] = bool(torch.equal(
                solve(lib, A, b, steps), ref))
        emit("time", **row)
        del A, b


def error_readings(libs, seeds) -> None:
    systems = smoke_systems()
    for K, B, steps in ERROR_SHAPES:
        for seed in ["smoke"] + list(seeds):
            if seed == "smoke":
                A, b = systems.pop((K, B))
            else:
                gen = torch.Generator(device="cuda")
                gen.manual_seed(seed)
                A, b = smoke.hard_systems(B, K, gen)
            A64, b64 = A.double(), b.double()
            for k in smoke.schulz_checkpoints(steps):
                xp = schulz_solve(A, b, k, "bfloat16")
                x64 = schulz_solve(A64, b64, k, "bfloat16")
                rounding = smoke.rel_err(xp.double(), x64)
                row = {"K": K, "B": B, "seed": seed, "k": k,
                       "plain_f32_vs_f64": rounding,
                       "tolerance": max(smoke.SCHULZ_KERNEL_TOL,
                                        smoke.ROUNDING_FACTOR * rounding)}
                for n in ("as_built", "ieee_sums"):
                    xk = solve(libs[n][0], A, b, k)
                    row[f"{n}_vs_plain"] = smoke.rel_err(xk, xp)
                    row[f"{n}_vs_f64"] = smoke.rel_err(xk.double(), x64)
                    row[f"{n}_share_of_tolerance"] = (
                        row[f"{n}_vs_plain"] / row["tolerance"])
                emit("error", **row)
            del A, b, A64, b64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="3,4,5,6,7,8",
                    help="fresh generator seeds of the error readings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("schulz_variants: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build_variants(list(VARIANTS))
    for n, (_, regs) in libs.items():
        emit("ptxas", variant=n, by_strip_count=regs)
    time_variants(libs)
    error_readings(libs, [int(s) for s in args.seeds.split(",") if s])
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
