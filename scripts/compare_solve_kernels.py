#!/usr/bin/env python3
"""Time the CG and Cholesky kernels of this tree against another tree's.

    python3 scripts/compare_solve_kernels.py --baseline DIR [--reps 5]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with `git archive` into a git-ignored directory).
Builds DIR's `predictionio_tpu_torch/csrc/cg_solve.cu` and
`chol_solve.cu` with this tree's nvcc flags into
`predictionio_tpu_torch/_build/baseline/` (every nvcc started together,
beside this tree's own build), loads both versions with ctypes, and at
every shape of `chip_smoke.py`'s `kernel` and `chol_kernel` phases, on
the same `hard_systems`:

- times the two in turns, baseline, this tree, this tree, baseline (CUDA
  events, `--reps` launches each after a warm-up), and reports each
  version's mean of its two readings and the ratio;
- reads how far apart the two answers are (max |x - x'| / max |x'|), and
  whether two launches of this tree's kernel are bit-equal.

Prints one JSON line per shape, then the card's name and power limit as
nvidia-smi reports them. Needs a CUDA card; both trees' kernels must keep
the C entry points `pio_cg_solve_f32` and `pio_chol_solve_f32`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from predictionio_tpu_torch.ops import _build  # noqa: E402

SOURCES = ("cg_solve", "chol_solve")


def build_baseline(tree: Path) -> dict:
    """nvcc DIR's two sources (and this tree's, if not built yet), all
    started together; returns {name: loaded baseline library}."""
    out_dir = _build.BUILD_DIR / "baseline"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src = tree / "predictionio_tpu_torch" / "csrc" / f"{name}.cu"
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build_all(SOURCES)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the baseline {name}.cu:\n"
                               f"{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


def bind(lib: ctypes.CDLL, name: str):
    """A call x = f(A, b, iters) through `lib`'s C entry point."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "cg_solve":
        fn = lib.pio_cg_solve_f32
        fn.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    else:
        fn = lib.pio_chol_solve_f32
        fn.argtypes = [vp, vp, vp, ci, ci, vp]
    fn.restype = ci

    def call(A, b, iters):
        B, R = b.shape
        x = torch.empty_like(b)
        stream = torch.cuda.current_stream().cuda_stream
        args = (A.data_ptr(), b.data_ptr(), x.data_ptr(), B, R)
        err = (fn(*args, iters, stream) if name == "cg_solve"
               else fn(*args, stream))
        if err != 0:
            raise RuntimeError(f"{name} launch failed at B={B} R={R}: "
                               f"CUDA error {err}")
        return x
    return call


def compare(name: str, base, new, shapes, reps: int, seed: int) -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows = []
    for shape in shapes:
        R, B = shape[0], shape[1]
        iters = shape[2] if len(shape) > 2 else 0
        A, b = smoke.hard_systems(B, R, gen)
        xb, xn = base(A, b, iters), new(A, b, iters)
        repeat = bool(torch.equal(xn, new(A, b, iters)))
        t = [smoke.cuda_ms(lambda f=f: f(A, b, iters), reps)
             for f in (base, new, new, base)]
        if name == "cg_solve":
            nbytes, flops = smoke.cg_cost(B, R, iters)
        else:
            nbytes, flops = smoke.chol_cost(B, R)
        bound_ms, bound_by = smoke.bound(nbytes, flops)
        base_ms, new_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        row = {"kernel": name, "R": R, "B": B, "iters": iters or None,
               "baseline_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
               "baseline_mean_ms": base_ms, "new_mean_ms": new_ms,
               "new_over_baseline": new_ms / base_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "new_tflops": flops / new_ms / 1e9,
               "new_vs_baseline_rel": smoke.rel_err(xn, xb),
               "new_bitwise_repeat": repeat}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del A, b, xb, xn
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_solve_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build_baseline(args.baseline.resolve())
    for name, shapes, seed in (("cg_solve", smoke.CG_KERNEL_SHAPES, 0),
                               ("chol_solve", smoke.CHOL_KERNEL_SHAPES, 1)):
        compare(name, bind(libs[name], name),
                bind(_build.load(name), name), shapes, args.reps, seed)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
