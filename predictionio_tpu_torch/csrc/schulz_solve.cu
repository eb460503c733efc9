// Batched Newton-Schulz solve of SPD systems: f32 in and out, products on
// bf16-rounded or f32 operands with f32 sums.
//
// Replaces predictionio_tpu/ops/solve.py:_schulz_kernel (the Pallas kernel
// behind schulz_solve_pallas). It computes what _schulz_kernel computes,
// system by system:
//   - alpha = 1 / max(max_i sum_j |A_ij|, 1e-30) on the f32 A, X0 = alpha I;
//   - `iters` steps of Y = rnd(A) rnd(X), X = 2X - rnd(X) rnd(Y), where rnd
//     rounds to bf16 (round to nearest even) and back in the bf16 mode and
//     is the identity in the f32 mode; X is carried in f32 and 2X - XY is
//     taken in f32;
//   - x = X b, then two refinements x += X (b - A x), all with the f32 A
//     and the f32 X.
// A product of two bf16 values is exact in f32, so f32 FMAs on rounded
// operands are the reference's bf16 products with f32 sums, up to the order
// of the sums. The TPU kernel's 8-system VMEM tile and its identity padding
// of the batch are not carried over: each block solves whole systems.
// Plan padding systems (A = reg*I, b = 0) solve to exactly 0.
//
// What bounds it on an H100: per system 4*iters*R^3 flops (two R x R x R
// products a step) against 4(R^2 + 2R) bytes (A and b read once, x written
// once); at R = 200 and 18 steps that is ~3,500 flops per byte, so the
// arithmetic bounds it by far (the bf16 mode's bound is set by the tensor
// cores' 989 TFLOP/s, the f32 mode's by the CUDA cores' 67 TFLOP/s). This
// first kernel runs both modes on the CUDA cores, in f32 FMAs; the design
// keeps those FMAs fed from registers and shared memory:
//   - one block per system at a time, persistent blocks walking over the
//     batch (grid = blocks resident at once), so the per-block f32 X in a
//     global workspace (160 KB at R = 200, 132 blocks: 21 MB) stays in L2;
//   - the product A X (rounded) lives in dynamic shared memory for the
//     whole step (160 KB at R = 200), so the second product reads it there;
//   - each thread computes 8x8 output tiles, the operands streamed through
//     shared memory in slices of 16 along k (A's slice transposed), two
//     16-byte loads per operand and k for 64 FMAs;
//   - a product is computed a band of whole tile rows at a time (at most
//     384 threads); X = 2X - X Y is written in place band by band, which is
//     safe because a band reads only its own rows of X;
//   - R is padded to a multiple of 8 with zeros (the workspace stride), so
//     any R works and the padding stays 0 through every step;
//   - every sum runs in a fixed order with no atomics: results are
//     deterministic.
// Tensor cores (mma/wgmma on the bf16 operands) and overlapping the slice
// loads with the FMAs are left to a later kernel. A system whose A X does
// not fit in shared memory (R > 224 on an H100) is refused: the wrapper
// raises before launching.
//
// Plain C interface, bound with ctypes (predictionio_tpu_torch/ops/
// solve.py:schulz_solve_cuda). The kernel launches on the caller's stream,
// allocates nothing (the wrapper passes the workspace) and does not
// synchronise; the entry returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;           // a thread's output tile is kTile^2
constexpr int kChunk = 16;         // depth of one staged operand slice
constexpr int kMaxThreads = 384;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int padded_rank(int R) {
  return (R + kTile - 1) / kTile * kTile;
}

// Ys [Rp][Rp], Ps and Qs [kChunk][Rp], b, x and the residual [Rp], and 32
// per-warp maxima.
size_t smem_bytes_for(int R) {
  const size_t Rp = padded_rank(R);
  return (Rp * Rp + 2 * kChunk * Rp + 3 * Rp + 32) * sizeof(float);
}

// Threads and band height (tile rows a pass computes) for one system: a
// band is whole tile rows, so X can be updated in place band by band.
struct Shape {
  int threads;
  int band;
};

Shape shape_for(int R) {
  const int nT = padded_rank(R) / kTile;
  int rows = kMaxThreads / nT;
  if (rows < 1) rows = 1;
  const int passes = (nT + rows - 1) / rows;
  const int band = (nT + passes - 1) / passes;
  return {(band * nT + 31) / 32 * 32, band};
}

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[kTile]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float v[kTile]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// acc[r][c] += sum_{k < kc} pt[k][r] q[k][c]: pt is the thread's 8 rows of
// the P slice (transposed), q its 8 columns of the Q slice, both with row
// stride ld. Sums run in increasing k.
__device__ __forceinline__ void tile_fma(float (&acc)[kTile][kTile],
                                         const float* pt, const float* q,
                                         int ld, int kc) {
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    float a[kTile], b[kTile];
    load8(pt + (size_t)k * ld, a);
    load8(q + (size_t)k * ld, b);
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTile][kTile]) {
#pragma unroll
  for (int r = 0; r < kTile; ++r)
#pragma unroll
    for (int c = 0; c < kTile; ++c) acc[r][c] = 0.f;
}

template <bool kBf16>
__global__ void __launch_bounds__(kMaxThreads)
schulz_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                    float* __restrict__ x, int batch, int R, int iters,
                    int band, float* __restrict__ work) {
  extern __shared__ __align__(16) float smem[];
  const int Rp = padded_rank(R);
  const int nT = Rp / kTile;
  float* Ys = smem;                          // [Rp][Rp] rnd(A X)
  float* Ps = Ys + (size_t)Rp * Rp;          // [kChunk][Rp] P slice^T
  float* Qs = Ps + kChunk * Rp;              // [kChunk][Rp] Q slice
  float* vb = Qs + kChunk * Rp;              // [Rp] b
  float* vx = vb + Rp;                       // [Rp] x
  float* vr = vx + Rp;                       // [Rp] b - A x
  float* red = vr + Rp;                      // [32] per-warp maxima
  float* X = work + (size_t)blockIdx.x * Rp * Rp;   // [Rp][Rp] f32 iterate

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int t_row = tid / nT;        // tile row within a band
  const int tj = tid - t_row * nT;   // tile column

  for (long long s = blockIdx.x; s < batch; s += gridDim.x) {
    const float* As = A + (size_t)s * R * R;

    // alpha = 1 / max(max_i sum_j |A_ij|, 1e-30); X0 = alpha I
    float wmax = 0.f;
    for (int i = warp; i < R; i += n_warps) {
      float sum = 0.f;
      for (int k = lane; k < R; k += 32) sum += fabsf(__ldg(As + (size_t)i * R + k));
      wmax = fmaxf(wmax, warp_sum(sum));
    }
    if (lane == 0) red[warp] = wmax;
    for (int i = tid; i < R; i += nt) vb[i] = __ldg(b + (size_t)s * R + i);
    __syncthreads();
    float amax = 0.f;
    for (int w = 0; w < n_warps; ++w) amax = fmaxf(amax, red[w]);
    const float alpha = 1.f / fmaxf(amax, 1e-30f);
    for (int e = tid; e < Rp * Rp; e += nt) {
      const int i = e / Rp;
      X[e] = (e == i * Rp + i && i < R) ? alpha : 0.f;
    }

    for (int it = 0; it < iters; ++it) {
      // Y = rnd(rnd(A) rnd(X)) into Ys, a band of tile rows at a time
      for (int r0 = 0; r0 < nT; r0 += band) {
        const int rows = min(band, nT - r0) * kTile;
        const int i0 = r0 * kTile;
        const bool active = t_row < band && r0 + t_row < nT;
        float acc[kTile][kTile];
        zero(acc);
        for (int k0 = 0; k0 < Rp; k0 += kChunk) {
          const int kc = min(kChunk, Rp - k0);
          __syncthreads();
          for (int e = tid; e < rows * kc; e += nt) {   // rnd(A) slice^T
            const int ii = e / kc;
            const int kk = e - ii * kc;
            const int i = i0 + ii;
            const int k = k0 + kk;
            Ps[kk * Rp + ii] =
                (i < R && k < R) ? rnd<kBf16>(__ldg(As + (size_t)i * R + k))
                                 : 0.f;
          }
          const int q4 = Rp / 4;
          for (int e = tid; e < kc * q4; e += nt) {     // rnd(X) slice
            const int kk = e / q4;
            const int j = (e - kk * q4) * 4;
            float4 v = *reinterpret_cast<const float4*>(
                X + (size_t)(k0 + kk) * Rp + j);
            v.x = rnd<kBf16>(v.x); v.y = rnd<kBf16>(v.y);
            v.z = rnd<kBf16>(v.z); v.w = rnd<kBf16>(v.w);
            *reinterpret_cast<float4*>(Qs + kk * Rp + j) = v;
          }
          __syncthreads();
          if (active)
            tile_fma(acc, Ps + t_row * kTile, Qs + tj * kTile, Rp, kc);
        }
        if (active) {
          const int i = i0 + t_row * kTile;
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            float v[kTile];
#pragma unroll
            for (int c = 0; c < kTile; ++c) v[c] = rnd<kBf16>(acc[r][c]);
            store8(Ys + (size_t)(i + r) * Rp + tj * kTile, v);
          }
        }
      }
      // X = 2X - rnd(X) Ys in place, a band of tile rows at a time: a band
      // reads only its own rows of X, so later bands still read the old X
      for (int r0 = 0; r0 < nT; r0 += band) {
        const int rows = min(band, nT - r0) * kTile;
        const int i0 = r0 * kTile;
        const bool active = t_row < band && r0 + t_row < nT;
        float acc[kTile][kTile];
        zero(acc);
        for (int k0 = 0; k0 < Rp; k0 += kChunk) {
          const int kc = min(kChunk, Rp - k0);
          const int k4 = kc / 4;
          __syncthreads();
          for (int e = tid; e < rows * k4; e += nt) {   // rnd(X) slice^T
            const int ii = e / k4;
            const int kk = (e - ii * k4) * 4;
            const float4 v = *reinterpret_cast<const float4*>(
                X + (size_t)(i0 + ii) * Rp + k0 + kk);
            Ps[(kk + 0) * Rp + ii] = rnd<kBf16>(v.x);
            Ps[(kk + 1) * Rp + ii] = rnd<kBf16>(v.y);
            Ps[(kk + 2) * Rp + ii] = rnd<kBf16>(v.z);
            Ps[(kk + 3) * Rp + ii] = rnd<kBf16>(v.w);
          }
          __syncthreads();
          if (active)
            tile_fma(acc, Ps + t_row * kTile,
                     Ys + (size_t)k0 * Rp + tj * kTile, Rp, kc);
        }
        if (active) {
          const int i = i0 + t_row * kTile;
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            float* row = X + (size_t)(i + r) * Rp + tj * kTile;
            float v[kTile];
            load8(row, v);
#pragma unroll
            for (int c = 0; c < kTile; ++c) v[c] = 2.f * v[c] - acc[r][c];
            store8(row, v);
          }
        }
      }
    }

    // x = X b, then twice x += X (b - A x), in f32; a warp per row
    __syncthreads();
    for (int i = warp; i < R; i += n_warps) {
      float sum = 0.f;
      for (int k = lane; k < R; k += 32)
        sum = fmaf(X[(size_t)i * Rp + k], vb[k], sum);
      sum = warp_sum(sum);
      if (lane == 0) vx[i] = sum;
    }
    for (int rep = 0; rep < 2; ++rep) {
      __syncthreads();
      for (int i = warp; i < R; i += n_warps) {
        float sum = 0.f;
        for (int k = lane; k < R; k += 32)
          sum = fmaf(__ldg(As + (size_t)i * R + k), vx[k], sum);
        sum = warp_sum(sum);
        if (lane == 0) vr[i] = vb[i] - sum;
      }
      __syncthreads();
      for (int i = warp; i < R; i += n_warps) {
        float sum = 0.f;
        for (int k = lane; k < R; k += 32)
          sum = fmaf(X[(size_t)i * Rp + k], vr[k], sum);
        sum = warp_sum(sum);
        if (lane == 0) vx[i] += sum;
      }
    }
    __syncthreads();
    for (int i = tid; i < R; i += nt) x[(size_t)s * R + i] = vx[i];
    __syncthreads();   // vb, red and X are rewritten for the next system
  }
}

int optin_smem(int* err) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *err = (int)e;
  return optin;
}

// Blocks resident at once on the current device for this R (the grid of
// the persistent kernel), at most `batch`; sets the kernel's dynamic
// shared-memory limit on the way. Returns a cudaError_t.
template <bool kBf16>
int grid_for(int batch, int R, int* grid) {
  const Shape sh = shape_for(R);
  const size_t bytes = smem_bytes_for(R);
  int err = 0;
  const size_t optin = (size_t)optin_smem(&err);
  if (err) return err;
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      schulz_solve_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, schulz_solve_kernel<kBf16>, sh.threads, bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long g = (long long)per_sm * sms;
  *grid = (int)(g < batch ? g : batch);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Largest R whose A X fits in shared memory on the current device;
// negative: a CUDA error while querying it.
int pio_schulz_max_rank() {
  int err = 0;
  const size_t optin = (size_t)optin_smem(&err);
  if (err) return -err;
  int R = 0;
  while (smem_bytes_for(R + kTile) <= optin) R += kTile;
  return R;
}

// Floats of workspace pio_schulz_solve_f32 needs for this batch on the
// current device (one padded R x R iterate per resident block); negative:
// a CUDA error.
long long pio_schulz_workspace_floats(int batch, int R, int bf16) {
  if (batch <= 0) return 0;
  if (R <= 0) return -(long long)cudaErrorInvalidValue;
  int grid = 0;
  const int err = bf16 ? grid_for<true>(batch, R, &grid)
                       : grid_for<false>(batch, R, &grid);
  if (err) return -(long long)err;
  const long long Rp = padded_rank(R);
  return (long long)grid * Rp * Rp;
}

// x[s] = A[s]^-1 b[s] for s < batch by `iters` Newton-Schulz steps, with
// products on bf16-rounded operands when bf16 != 0. A: [batch, R, R], b,
// x: [batch, R], all contiguous f32 on the current device; work: at least
// pio_schulz_workspace_floats(batch, R, bf16) floats there. Returns a
// cudaError_t.
int pio_schulz_solve_f32(const float* A, const float* b, float* x, int batch,
                         int R, int iters, int bf16, float* work,
                         void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (R <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  const Shape sh = shape_for(R);
  const size_t bytes = smem_bytes_for(R);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int grid = 0;
  if (bf16) {
    const int err = grid_for<true>(batch, R, &grid);
    if (err) return err;
    schulz_solve_kernel<true><<<grid, sh.threads, bytes, st>>>(
        A, b, x, batch, R, iters, sh.band, work);
  } else {
    const int err = grid_for<false>(batch, R, &grid);
    if (err) return err;
    schulz_solve_kernel<false><<<grid, sh.threads, bytes, st>>>(
        A, b, x, batch, R, iters, sh.band, work);
  }
  return (int)cudaGetLastError();
}

const char* pio_schulz_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
