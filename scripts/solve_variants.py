#!/usr/bin/env python3
"""Design choices of the CG and Cholesky kernels, read on one NVIDIA GPU.

    python3 scripts/solve_variants.py [--reps 5] [--only NAME,...]

Builds copies of `predictionio_tpu_torch/csrc/cg_solve.cu` and
`chol_solve.cu`, each with one named change (VARIANTS), with the
package's nvcc flags into `predictionio_tpu_torch/_build/variants/` (all
nvcc started together), and launches each through the library's own C
interface on `chip_smoke.py`'s `hard_systems` at the shapes of the
kernel phases (TIME_SHAPES). Variants named `probe_*` compute a wrong
answer on purpose: they leave one part of the kernel out, so that the
time it saves is that part's cost. The others are alternatives that must
give the same x.

Prints one JSON line per variant and shape: the device time of
`as_built` and of the variant in turns (as_built, variant, variant,
as_built; CUDA events, mean of `--reps` launches after a warm-up), their
ratio, and whether the variant's x equals as_built's bit for bit; then a
line per variant with ptxas's registers and spills of each kernel
function; then the card's name and power limit from nvidia-smi. Imports
nothing of JAX or of the JAX package.
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

import chip_smoke as smoke  # noqa: E402  (the smoke's systems and timers)
from predictionio_tpu_torch.ops import _build  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "variants"

# source -> variant -> [(text that must occur exactly once, replacement)
# or (first text, last text, replacement of the span between them)]
VARIANTS = {
    "cg_solve": {
        # A straight from device memory into registers, no cp.async stage
        "no_stage": [
            ("""  if (s < (size_t)batch) {
    stage_copy(stA, A + s * (size_t)R * R, R * R);
    stage_copy(stB, b + s * (size_t)R, R);
  }""", ""),
            ("""    if (nxt < (size_t)batch) {
      stage_copy(stA, A + nxt * (size_t)R * R, R * R);
      stage_copy(stB, b + nxt * (size_t)R, R);
    }""", ""),
            ("const float* A0 = stA + ", "const float* A0 = As + "),
            ("const float* A1 = stA + ", "const float* A1 = As + "),
            ("1.f / fmaxf(stA[(size_t)row * R + row], 1e-30f)",
             "1.f / fmaxf(As[(size_t)row * R + row], 1e-30f)"),
            ("float r = own ? stB[row] : 0.f;",
             "float r = own ? b[s * R + row] : 0.f;"),
            ("    float a0[CW], a1[CW];\n",
             "    float a0[CW], a1[CW];\n"
             "    const float* As = A + s * (size_t)R * R;\n")],
        # one block an SM where A takes 56-72 registers a thread
        "one_block_mid": [
            ("return (2 * CW >= 56 && 2 * CW <= 72) ? 2 : 1;", "return 1;")],
        # clock64() around each part of a step, block 0, thread 0: the
        # mean cycles of each part land in x[0, :7] (see CLOCK_PARTS)
        "probe_clock": [
            ("    for (int it = 0; it < iters; ++it) {\n      float s0a = 0.f",
             "    tk[6] += clock64() - cpre; tk[7] += 1;\n"
             "    for (int it = 0; it < iters; ++it) {\n"
             "      long long c0 = clock64();\n      float s0a = 0.f"),
            ("      const float pap = block_allsum(own ? pr * ap : 0.f, red0);",
             "      long long c1 = clock64();\n"
             "      const float pap = block_allsum(own ? pr * ap : 0.f, red0);"
             "\n      long long c2 = clock64();"),
            ("      const float rz2 = block_allsum(own ? r * z : 0.f, red1);",
             "      long long c3 = clock64();\n"
             "      const float rz2 = block_allsum(own ? r * z : 0.f, red1);"
             "\n      long long c4 = clock64();"),
            ("      rz = rz2;\n    }",
             "      rz = rz2;\n      long long c5 = clock64();\n"
             "      tk[0] += c1 - c0; tk[1] += c2 - c1; tk[2] += c3 - c2;\n"
             "      tk[3] += c4 - c3; tk[4] += c5 - c4; tk[5] += 1;\n    }"),
            ("  size_t s = blockIdx.x;\n",
             "  long long tk[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
             "  size_t s = blockIdx.x;\n"),
            ("    cp_async_wait_all();\n    __syncthreads();"
             "                            // stage holds system s",
             "    long long cpre = clock64();\n    cp_async_wait_all();\n"
             "    __syncthreads();"),
            ("    if (own) x[s * R + row] = xv;\n  }\n  cp_async_wait_all();",
             "    if (own) x[s * R + row] = xv;\n  }\n  cp_async_wait_all();\n"
             "  if (blockIdx.x == 0 && tid == 0) {\n"
             "    for (int k = 0; k < 5; ++k) x[k] = (float)tk[k] / tk[5];\n"
             "    x[5] = (float)tk[6] / tk[7];\n"
             "    x[6] = (float)tk[5] / tk[7];\n  }")],
        "probe_warp_sums": [
            ("""  __syncthreads();
  const float4* r4 = reinterpret_cast<const float4*>(red);""",
             """  return v;
  const float4* r4 = reinterpret_cast<const float4*>(red);""")],
    },
    "chol_solve": {
        "tile_stride_64": [("constexpr int kTile = 68;",
                            "constexpr int kTile = 64;")],
        "probe_no_trailing": [
            ("  const float* Li = tile(L, J + 1 + ti, J) + rh * 4 * kPanel;",
             "  return;\n"
             "  const float* Li = tile(L, J + 1 + ti, J) + rh * 4 * kPanel;")],
        "probe_no_back_substitution": [
            ("  for (int J = nT - 1; J >= 0; --J) {",
             "  for (int J = nT - 1; J >= nT; --J) {")],
    },
}

# what probe_clock writes to x[0, :7]: mean cycles of each part of a step
# (and of a system's set-up), and the steps a system
CLOCK_PARTS = ("matvec", "sum_pAp", "update_x_r", "sum_rz",
               "publish_p", "system_setup", "steps")

TIME_SHAPES = {
    "cg_solve": ((200, 5242, 48), (144, 7281, 152), (56, 18724, 64),
                 (8, 131072, 16)),
    "chol_solve": ((200, 5242, 0), (144, 7281, 0), (56, 18724, 0),
                   (8, 131072, 0)),
}


def variant_source(source: str, name: str) -> str:
    src = (_build.CSRC_DIR / f"{source}.cu").read_text()
    for change in VARIANTS[source].get(name, []):
        if len(change) == 3:
            first, last, new = change
            start = src.index(first)
            end = src.index(last, start) + len(last)
            src = src[:start] + new + src[end:]
            continue
        old, new = change
        if src.count(old) != 1:
            raise RuntimeError(f"variant {source}/{name}: {old[:60]!r} "
                               f"occurs {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build(source: str, names):
    """One nvcc per variant, all started together; {name: (lib, log)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n in names:
        cu = OUT_DIR / f"{source}_{n}.cu"
        cu.write_text(variant_source(source, n))
        so = cu.with_suffix(".so")
        jobs[n] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for n, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}/{n}:\n{log}")
        out[n] = (ctypes.CDLL(str(so)), log)
    return out


def caller(lib, source: str):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.pio_cg_solve_f32 if source == "cg_solve" \
        else lib.pio_chol_solve_f32
    fn.argtypes = ([vp, vp, vp, ci, ci, ci, vp] if source == "cg_solve"
                   else [vp, vp, vp, ci, ci, vp])
    fn.restype = ci

    def call(A, b, iters):
        B, R = b.shape
        x = torch.empty_like(b)
        args = [A.data_ptr(), b.data_ptr(), x.data_ptr(), B, R]
        if source == "cg_solve":
            args.append(iters)
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{source} launch failed: CUDA error {err}")
        return x
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("solve_variants: needs a CUDA card", file=sys.stderr)
        return 2
    only = set(filter(None, args.only.split(",")))
    built = {}
    for source, variants in VARIANTS.items():
        names = ["as_built"] + [n for n in variants if not only or n in only]
        built[source] = build(source, names)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for source, libs in built.items():
        base = caller(libs["as_built"][0], source)
        for R, B, iters in TIME_SHAPES[source]:
            A, b = smoke.hard_systems(B, R, gen)
            xb = base(A, b, iters)
            for name, (lib, _) in libs.items():
                if name == "as_built":
                    continue
                var = caller(lib, source)
                t = [smoke.cuda_ms(lambda f=f: f(A, b, iters), args.reps)
                     for f in (base, var, var, base)]
                print(json.dumps({
                    "source": source, "variant": name, "R": R, "B": B,
                    "iters": iters or None, "as_built_ms": [t[0], t[3]],
                    "variant_ms": [t[1], t[2]],
                    "variant_over_as_built": (t[1] + t[2]) / (t[0] + t[3]),
                    "bit_equal": bool(torch.equal(var(A, b, iters), xb)),
                    **({"clock_cycles": dict(zip(
                        CLOCK_PARTS, var(A, b, iters)[0, :7].tolist()))}
                       if name == "probe_clock" else {})}),
                    flush=True)
            del A, b, xb
            torch.cuda.empty_cache()
        for name, (_, log) in libs.items():
            print(json.dumps({"source": source, "variant": name,
                              "ptxas": smoke.ptxas_functions(log)}),
                  flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
