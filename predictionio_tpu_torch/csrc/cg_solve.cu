// Batched Jacobi-preconditioned conjugate gradient on SPD systems, f32.
//
// Replaces predictionio_tpu/ops/solve.py:_cg_kernel (the Pallas kernel
// behind cg_solve_pallas, the TPU's production ALS solver). It computes
// exactly what that kernel computes: x0 = 0, Jacobi preconditioner
// 1/max(diag, 1e-30), a fixed number of iterations, and the clamps
// max(p'Ap, 1e-30) and max(r'z, 1e-30), with the reference's recurrences
// (alpha, x, r, z = D r, r'z, beta, p = z + beta p) in that order; no
// pipelined or s-step variant.
//
// What bounds it on an H100: each system reads A once from device memory
// (R*R*4 bytes, 160 KB at R = 200) and does iters * 2R^2 f32 FMA-flops on
// the CUDA cores (a matvec has no reuse for the tensor cores). At 48
// iterations that is ~24 flops per byte of A, just above the card's
// 67 TFLOP/s : 3.35 TB/s = 20 balance point, so the f32 FMAs are the
// bound (0.31 ms for the primal batch of 5,242 systems). The first port
// (one block per system, A in shared memory) read every element of A from
// shared memory once per FMA: shared-memory bandwidth, a quarter of the
// FMA rate, set a floor of ~1.4 ms, and with one 160 KB block an SM the
// seven warps of a block could not hide the latency of three block
// barriers a step. This design keeps A in registers:
//
//   registers geometry (32 < R <= 208), one system per block at a time:
//   - a thread holds two rows of A over CW columns in registers for all
//     steps, H = 2 (R <= 104) or 4 lanes sharing the row pair, CW = R/H
//     rounded up to even (13 warps, 100 registers of A a thread at
//     R = 200). A step reads only p from shared memory, and one 16-byte
//     load of p feeds 8 FMAs (two rows). The H slices of p start in
//     distinct banks;
//   - a step has three block barriers, one for each of its true
//     dependences: p'Ap (then alpha, x, r), r'z (then beta and each owned
//     row of the new p), and the new p, which every lane reads;
//   - blocks are persistent and walk over the batch. While a system
//     iterates, cp.async copies the next system's A and b into the shared
//     memory that the registers freed (the stage), so the SM does not wait
//     for 160 KB of A between systems. Where A takes 56-72 registers a
//     thread, two blocks share an SM;
//   - 13 warps leave at most 128 registers a thread (four warps on one of
//     the SM's four register files): at R = 200 ptxas spills 68 bytes.
//   What bounds it now (scripts/solve_variants.py, probe_clock, clock64()
//   in one thread at R = 200, cycles a step): the matvec ~900, each of
//   the two sums ~370 (warp butterfly, barrier, the warps' partials),
//   the updates and the third barrier ~120 each; a system's set-up (its
//   A from the stage into registers) ~5,900 a system. Measured against
//   alternatives on an H100 (the same script and
//   scripts/compare_solve_kernels.py): each warp keeping its own copy of
//   p and forming all of the new p after the second barrier, in place of
//   the third barrier, cost ~840 cycles a step and was 43 % slower at
//   R = 200; with those copies, one row a thread was 6 % slower than two
//   at R = 200 and 21 % at R = 144, 6 % faster at R = 192; four rows a
//   thread were 28 % slower than two at R = 200 (more spills); A read
//   straight from device memory without the stage was 27 % slower at
//   R = 200; one block an SM where two fit was 52 % slower at R = 144;
//
//   warp geometry (R <= 32): a team of T = 8, 16 or 32 lanes (the power of
//   two >= R) solves one system, lane i holding row i of A in registers
//   (W = R rounded up to 4); 32/T systems share a warp and 128/T a block.
//   Sums are shuffles within the team and p sits in the team's slice of
//   shared memory: no block barrier at all;
//
//   stream geometry (R > 208, up to 2048): the first port's kernel, one
//   block of up to 256 threads per system, A in shared memory while it
//   fits (R <= 240 on an H100, "shared"), else read from global memory
//   and L2 ("global").
//
// Every sum runs in a fixed order with no atomics: the shuffle butterflies
// give every lane the same bits (IEEE addition commutes), and the block
// sums add the warps' partials in a fixed order. Two launches are bit for
// bit equal. Padding systems (A = reg*I, b = 0) solve to exactly 0:
// r'z = 0 makes alpha = 0/1e-30 = 0 and beta = 0.
//
// Plain C interface, bound with ctypes (predictionio_tpu_torch/ops/
// solve.py:cg_solve_cuda). The kernels launch on the caller's stream,
// allocate nothing and do not synchronise; the entry returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Geometry codes, shared with ops/solve.py:CG_GEOMETRIES.
enum Geometry { kGeoWarp = 0, kGeoRegisters = 1, kGeoShared = 2,
                kGeoGlobal = 3 };

constexpr int kWarpMaxR = 32;       // warp geometry: R <= 32
constexpr int kWarpBlock = 128;     // its threads per block
constexpr int kRegMaxR = 208;       // registers geometry: R <= 208
constexpr int kRegThreads = 416;    // 13 warps: 104 row pairs x 4 lanes

constexpr int kMaxThreads = 256;    // stream geometry
constexpr int kMaxPer = 8;          // elements per thread: R <= 2048
constexpr int kRedSlots = 32;       // one partial per warp (<= 32 warps)

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;  // every lane holds the same sum
}

// Sum over a team of T lanes (a power of two <= 32) by an xor butterfly;
// every lane of the team gets the same bits.
template <int T>
__device__ __forceinline__ float team_allsum(float v) {
#pragma unroll
  for (int m = T / 2; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m, T);
  return v;
}

// ---------------------------------------------------------------- warp

template <int W, int T>
__global__ void __launch_bounds__(kWarpBlock)
cg_warp_kernel(const float* __restrict__ A, const float* __restrict__ b,
               float* __restrict__ x, int batch, int R, int iters) {
  __shared__ __align__(16) float ps[kWarpBlock / T * W];
  const int i = threadIdx.x % T;                    // row of this lane
  const int team = threadIdx.x / T;
  const long long s_raw = (long long)blockIdx.x * (kWarpBlock / T) + team;
  const bool live = s_raw < batch;  // teams past the batch run a copy
  const size_t sys = live ? (size_t)s_raw : (size_t)batch - 1;
  float* p = ps + team * W;
  const bool row = i < R;
  const float* Ai = A + sys * (size_t)R * R + (size_t)(row ? i : 0) * R;

  float a[W];
#pragma unroll
  for (int j = 0; j < W; ++j) a[j] = (row && j < R) ? __ldg(Ai + j) : 0.f;
  const float d = row ? 1.f / fmaxf(__ldg(Ai + i), 1e-30f) : 0.f;
  float r = row ? __ldg(b + sys * R + i) : 0.f;
  float xv = 0.f;
  float z = d * r;
  float pr = z;
  if (i < W) p[i] = pr;               // rows R..W-1 write p = 0
  float rz = team_allsum<T>(r * z);
  __syncwarp();

  for (int it = 0; it < iters; ++it) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 pq = *reinterpret_cast<const float4*>(p + 4 * q);
      a0 = fmaf(a[4 * q + 0], pq.x, a0);
      a1 = fmaf(a[4 * q + 1], pq.y, a1);
      a2 = fmaf(a[4 * q + 2], pq.z, a2);
      a3 = fmaf(a[4 * q + 3], pq.w, a3);
    }
    const float ap = (a0 + a1) + (a2 + a3);
    const float pap = team_allsum<T>(pr * ap);
    const float alpha = rz / fmaxf(pap, 1e-30f);
    xv = fmaf(alpha, pr, xv);
    r = fmaf(-alpha, ap, r);
    z = d * r;
    const float rz2 = team_allsum<T>(r * z);
    const float beta = rz2 / fmaxf(rz, 1e-30f);
    pr = fmaf(beta, pr, z);
    __syncwarp();
    if (i < W) p[i] = pr;
    __syncwarp();
    rz = rz2;
  }
  if (live && row) x[sys * R + i] = xv;
}

// ----------------------------------------------------------- registers

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n floats from src to dst by the whole block, 16 bytes a copy where the
// source is 16-byte aligned and n a multiple of 4.
__device__ __forceinline__ void stage_copy(float* dst, const float* src,
                                           int n) {
  if (((reinterpret_cast<uintptr_t>(src) & 15) == 0) && (n & 3) == 0) {
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x)
      cp_async16(dst + 4 * q, src + 4 * q);
  } else {
    for (int q = threadIdx.x; q < n; q += blockDim.x)
      cp_async4(dst + q, src + q);
  }
}

// Fixed-order block sum; every thread returns the same value. `red` holds
// kRegSlots floats, zero past the block's warps, and is rewritten only
// after a later barrier (callers alternate two buffers). The warps'
// partials are added as a fixed tree (four 16-byte loads, depth 4).
constexpr int kRegSlots = 16;      // >= 13 warps
__device__ __forceinline__ float block_allsum(float v, float* red) {
  v = warp_allsum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const float4* r4 = reinterpret_cast<const float4*>(red);
  const float4 q0 = r4[0], q1 = r4[1], q2 = r4[2], q3 = r4[3];
  return (((q0.x + q0.y) + (q0.z + q0.w)) + ((q1.x + q1.y) + (q1.z + q1.w)))
       + (((q2.x + q2.y) + (q2.z + q2.w)) + ((q3.x + q3.y) + (q3.z + q3.w)));
}

// Layout of the registers geometry: a thread holds two rows of A
// (2g, 2g + 1) over CW columns, H = 2 (R <= 104) or 4 (R <= 208) lanes
// sharing a row pair, CW = R/H rounded up to even. One 16-byte load of p
// then feeds 8 FMAs.
__host__ __device__ inline int reg_lanes(int R) {
  return R > kRegMaxR / 2 ? 4 : 2;
}
__host__ __device__ inline int reg_cols(int R) {
  const int H = reg_lanes(R);
  const int c = (R + H - 1) / H;
  return c + (c & 1);
}
// Column stride of p between the H lanes' slices: a multiple of 4 whose
// 16-byte count is not a multiple of 4, so that the slices start in
// different banks.
__host__ __device__ inline int p_stride(int CW) {
  const int s = round4(CW);
  return (s / 4) % 4 == 0 ? s + 4 : s;
}
__host__ __device__ inline int reg_threads(int R) {
  return ((R + 1) / 2 * reg_lanes(R) + 31) / 32 * 32;
}

// Dynamic shared memory of the registers geometry (floats): stage A
// [R*R] | stage b [R] | p [H][stride] | red0 | red1.
size_t reg_smem_bytes(int R) {
  const int H = reg_lanes(R), CW = reg_cols(R);
  const size_t floats = (size_t)round4(R * R) + round4(R) +
                        (size_t)H * p_stride(CW) + 2 * kRegSlots;
  return floats * sizeof(float);
}

// Launch bounds of the instantiation for CW columns: at most 8 CW threads
// (4 lanes a row pair, R up to 4 CW). Where A takes 56-72 registers a
// thread the bounds ask for two blocks an SM, so that one block's
// reductions and barriers overlap the other's matvec; above that A alone
// needs more registers.
__host__ __device__ constexpr int reg_max_threads(int CW) {
  return (8 * CW + 31) / 32 * 32 < kRegThreads ? (8 * CW + 31) / 32 * 32
                                               : kRegThreads;
}
__host__ __device__ constexpr int reg_min_blocks(int CW) {
  return (2 * CW >= 56 && 2 * CW <= 72) ? 2 : 1;
}

template <int CW>
__global__ void __launch_bounds__(reg_max_threads(CW), reg_min_blocks(CW))
cg_reg_kernel(const float* __restrict__ A, const float* __restrict__ b,
              float* __restrict__ x, int batch, int R, int iters) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kQ = CW / 4;                    // 16-byte loads of p
  constexpr bool kTail = (CW & 3) != 0;         // and one of 8 bytes
  const int H = reg_lanes(R);
  const int ps = p_stride(CW);
  float* stA = smem;
  float* stB = stA + round4(R * R);
  float* p = stB + round4(R);                   // [H][ps]
  float* red0 = p + H * ps;
  float* red1 = red0 + kRegSlots;
  const int tid = threadIdx.x;
  const int h = tid % H;                        // column slice
  const int row0 = (tid / H) * 2;               // rows row0, row0 + 1
  const int row = row0 + (h & 1);               // the row this lane owns
  const bool own = h < 2 && row < R;            // writes p and x of row
  const float* pmine = p + h * ps;              // columns h*CW .. +CW-1
  float* prow = p + (row / CW) * ps + row % CW;

  for (int j = tid; j < H * ps; j += blockDim.x) p[j] = 0.f;
  if (tid < 2 * kRegSlots) red0[tid] = 0.f;    // slots past the warps
  size_t s = blockIdx.x;
  if (s < (size_t)batch) {
    stage_copy(stA, A + s * (size_t)R * R, R * R);
    stage_copy(stB, b + s * (size_t)R, R);
  }
  cp_async_commit();

  for (; s < (size_t)batch; s += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();                            // stage holds system s
    float a0[CW], a1[CW];
    const int j0 = h * CW;
    const float* A0 = stA + (size_t)(row0 < R ? row0 : 0) * R + j0;
    const float* A1 = stA + (size_t)(row0 + 1 < R ? row0 + 1 : 0) * R + j0;
    const bool ok0 = row0 < R, ok1 = row0 + 1 < R;
    if ((R & 1) == 0) {                         // 8-byte loads
#pragma unroll
      for (int jj = 0; jj < CW; jj += 2) {
        const bool col = j0 + jj < R;           // R, CW even: both or none
        const float2 v0 = (ok0 && col)
            ? *reinterpret_cast<const float2*>(A0 + jj) : make_float2(0.f, 0.f);
        const float2 v1 = (ok1 && col)
            ? *reinterpret_cast<const float2*>(A1 + jj) : make_float2(0.f, 0.f);
        a0[jj] = v0.x; a0[jj + 1] = v0.y;
        a1[jj] = v1.x; a1[jj + 1] = v1.y;
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) {
        const bool col = j0 + jj < R;
        a0[jj] = (ok0 && col) ? A0[jj] : 0.f;
        a1[jj] = (ok1 && col) ? A1[jj] : 0.f;
      }
    }
    const float d =
        own ? 1.f / fmaxf(stA[(size_t)row * R + row], 1e-30f) : 0.f;
    float r = own ? stB[row] : 0.f;
    __syncthreads();                            // the stage is free
    const size_t nxt = s + gridDim.x;
    if (nxt < (size_t)batch) {
      stage_copy(stA, A + nxt * (size_t)R * R, R * R);
      stage_copy(stB, b + nxt * (size_t)R, R);
    }
    cp_async_commit();

    float xv = 0.f;
    float pr = d * r;                           // p = z
    if (own) *prow = pr;
    // its barrier also publishes p
    float rz = block_allsum(own ? r * pr : 0.f, red1);

    for (int it = 0; it < iters; ++it) {
      float s0a = 0.f, s0b = 0.f, s1a = 0.f, s1b = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 pq = *reinterpret_cast<const float4*>(pmine + 4 * q);
        s0a = fmaf(a0[4 * q + 0], pq.x, s0a);
        s1a = fmaf(a1[4 * q + 0], pq.x, s1a);
        s0b = fmaf(a0[4 * q + 1], pq.y, s0b);
        s1b = fmaf(a1[4 * q + 1], pq.y, s1b);
        s0a = fmaf(a0[4 * q + 2], pq.z, s0a);
        s1a = fmaf(a1[4 * q + 2], pq.z, s1a);
        s0b = fmaf(a0[4 * q + 3], pq.w, s0b);
        s1b = fmaf(a1[4 * q + 3], pq.w, s1b);
      }
      if (kTail) {
        const float2 pt = *reinterpret_cast<const float2*>(pmine + 4 * kQ);
        s0a = fmaf(a0[4 * kQ + 0], pt.x, s0a);
        s1a = fmaf(a1[4 * kQ + 0], pt.x, s1a);
        s0b = fmaf(a0[4 * kQ + 1], pt.y, s0b);
        s1b = fmaf(a1[4 * kQ + 1], pt.y, s1b);
      }
      float ap0 = s0a + s0b, ap1 = s1a + s1b;
      // the row pair's sums over its H lanes: every lane gets the bits
      for (int m = 1; m < H; m <<= 1) {
        ap0 += __shfl_xor_sync(kFull, ap0, m);
        ap1 += __shfl_xor_sync(kFull, ap1, m);
      }
      const float ap = (h & 1) ? ap1 : ap0;
      const float pap = block_allsum(own ? pr * ap : 0.f, red0);
      const float alpha = rz / fmaxf(pap, 1e-30f);
      xv = fmaf(alpha, pr, xv);
      r = fmaf(-alpha, ap, r);
      const float z = d * r;
      const float rz2 = block_allsum(own ? r * z : 0.f, red1);
      const float beta = rz2 / fmaxf(rz, 1e-30f);
      pr = fmaf(beta, pr, z);
      // every warp's matvec read p before the first barrier of the step
      if (own) *prow = pr;
      __syncthreads();                          // publishes the new p
      rz = rz2;
    }
    if (own) x[s * R + row] = xv;
  }
  cp_async_wait_all();
}

// -------------------------------------------------------------- stream

// Ap[i] = sum_j Am[j*R + i] * p[j], four partial sums for ILP.
__device__ __forceinline__ float column_dot(const float* Am, const float* p,
                                            int R, int i) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = 0;
  for (; j + 4 <= R; j += 4) {
    const float4 pj = *reinterpret_cast<const float4*>(p + j);
    a0 = fmaf(Am[(size_t)(j + 0) * R + i], pj.x, a0);
    a1 = fmaf(Am[(size_t)(j + 1) * R + i], pj.y, a1);
    a2 = fmaf(Am[(size_t)(j + 2) * R + i], pj.z, a2);
    a3 = fmaf(Am[(size_t)(j + 3) * R + i], pj.w, a3);
  }
  for (; j < R; ++j) a0 = fmaf(Am[(size_t)j * R + i], p[j], a0);
  return (a0 + a1) + (a2 + a3);
}

// Fixed-order block sum for the stream kernel (lane 0 of each warp holds
// a partial after warp_allsum; every thread returns the same value).
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_allsum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  float s = 0.f;
  for (int w = 0; w < n_warps; ++w) s += red[w];
  return s;
}

// Dynamic shared memory layout (floats): p [R, rounded up to 4] |
// red0 [32] | red1 [32] | A [R*R] (only when kSmemA).
__host__ __device__ inline int vec_floats(int R) {
  return round4(R) + 2 * kRedSlots;
}

template <bool kSmemA>
__global__ void __launch_bounds__(kMaxThreads)
cg_stream_kernel(const float* __restrict__ A, const float* __restrict__ b,
                 float* __restrict__ x, int R, int iters) {
  extern __shared__ __align__(16) float smem[];
  float* p = smem;
  float* red0 = smem + round4(R);
  float* red1 = red0 + kRedSlots;
  const size_t sys = blockIdx.x;
  const float* Ag = A + sys * (size_t)R * R;
  const float* bg = b + sys * (size_t)R;
  float* xg = x + sys * (size_t)R;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const float* Am = Ag;
  if (kSmemA) {
    float* As = smem + vec_floats(R);
    const size_t n = (size_t)R * R;
    size_t q0 = 0;
    if ((reinterpret_cast<size_t>(Ag) & 15) == 0) {   // float4 body
      const float4* src = reinterpret_cast<const float4*>(Ag);
      float4* dst = reinterpret_cast<float4*>(As);
      for (size_t q = tid; q < n / 4; q += nt) dst[q] = __ldg(src + q);
      q0 = (n / 4) * 4;
    }
    for (size_t q = q0 + tid; q < n; q += nt) As[q] = __ldg(Ag + q);
    __syncthreads();
    Am = As;
  }

  float xr[kMaxPer], rr[kMaxPer], dr[kMaxPer], pr[kMaxPer], ar[kMaxPer];
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int i = tid + k * nt;
    xr[k] = rr[k] = dr[k] = pr[k] = ar[k] = 0.f;
    if (i < R) {
      dr[k] = 1.f / fmaxf(Am[(size_t)i * R + i], 1e-30f);
      rr[k] = bg[i];
      const float z = dr[k] * rr[k];
      pr[k] = z;
      p[i] = z;
      part += rr[k] * z;
    }
  }
  float rz = block_sum(part, red1);   // its barrier also publishes p

  for (int it = 0; it < iters; ++it) {
    float pap = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int i = tid + k * nt;
      if (i < R) {
        ar[k] = column_dot(Am, p, R, i);
        pap += pr[k] * ar[k];
      }
    }
    pap = block_sum(pap, red0);
    const float alpha = rz / fmaxf(pap, 1e-30f);
    float rz2 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int i = tid + k * nt;
      if (i < R) {
        xr[k] = fmaf(alpha, pr[k], xr[k]);
        rr[k] = fmaf(-alpha, ar[k], rr[k]);
        rz2 += rr[k] * (dr[k] * rr[k]);
      }
    }
    rz2 = block_sum(rz2, red1);
    const float beta = rz2 / fmaxf(rz, 1e-30f);
    // every thread finished its matvec before the red0 barrier, so p may
    // be rewritten now; the barrier below publishes it for the next one
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int i = tid + k * nt;
      if (i < R) {
        pr[k] = fmaf(beta, pr[k], dr[k] * rr[k]);
        p[i] = pr[k];
      }
    }
    rz = rz2;
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int i = tid + k * nt;
    if (i < R) xg[i] = xr[k];
  }
}

int stream_threads(int R) {
  int t = ((R + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

size_t stream_smem_bytes(int R, bool smem_a) {
  size_t floats = (size_t)vec_floats(R);
  if (smem_a) floats += (size_t)R * R;
  return floats * sizeof(float);
}

// ------------------------------------------------------------ dispatch

int smem_optin(int* err) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *err = (int)e;
  return optin;
}

// The geometry that takes an R x R system, given the device's opt-in
// shared memory per block (mirrored by ops/solve.py:cg_geometry).
int geometry_for(int R, size_t optin) {
  if (R <= kWarpMaxR) return kGeoWarp;
  if (R <= kRegMaxR && reg_smem_bytes(R) <= optin) return kGeoRegisters;
  if (stream_smem_bytes(R, true) <= optin) return kGeoShared;
  return kGeoGlobal;
}

template <int W, int T>
int launch_warp(const float* A, const float* b, float* x, int batch, int R,
                int iters, cudaStream_t s) {
  const int per_block = kWarpBlock / T;
  const int blocks = (batch + per_block - 1) / per_block;
  cg_warp_kernel<W, T><<<blocks, kWarpBlock, 0, s>>>(A, b, x, batch, R,
                                                      iters);
  return (int)cudaGetLastError();
}

template <int CW>
int launch_reg(const float* A, const float* b, float* x, int batch, int R,
               int iters, cudaStream_t s) {
  const size_t bytes = reg_smem_bytes(R);
  const int threads = reg_threads(R);
  cudaError_t e = cudaFuncSetAttribute(
      cg_reg_kernel<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cg_reg_kernel<CW>, threads, bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sms;
  const int grid = (int)(batch < resident ? batch : resident);
  cg_reg_kernel<CW><<<grid, threads, bytes, s>>>(A, b, x, batch, R, iters);
  return (int)cudaGetLastError();
}

int launch_warp_geometry(const float* A, const float* b, float* x,
                         int batch, int R, int iters, cudaStream_t s) {
  switch (round4(R)) {
    case 4: return launch_warp<4, 8>(A, b, x, batch, R, iters, s);
    case 8: return launch_warp<8, 8>(A, b, x, batch, R, iters, s);
    case 12: return launch_warp<12, 16>(A, b, x, batch, R, iters, s);
    case 16: return launch_warp<16, 16>(A, b, x, batch, R, iters, s);
    case 20: return launch_warp<20, 32>(A, b, x, batch, R, iters, s);
    case 24: return launch_warp<24, 32>(A, b, x, batch, R, iters, s);
    case 28: return launch_warp<28, 32>(A, b, x, batch, R, iters, s);
    case 32: return launch_warp<32, 32>(A, b, x, batch, R, iters, s);
  }
  return (int)cudaErrorInvalidValue;
}

#define PIO_CG_REG_CASE(CW) \
  case CW: return launch_reg<CW>(A, b, x, batch, R, iters, s);

int launch_reg_geometry(const float* A, const float* b, float* x, int batch,
                        int R, int iters, cudaStream_t s) {
  switch (reg_cols(R)) {
    PIO_CG_REG_CASE(18) PIO_CG_REG_CASE(20) PIO_CG_REG_CASE(22)
    PIO_CG_REG_CASE(24) PIO_CG_REG_CASE(26) PIO_CG_REG_CASE(28)
    PIO_CG_REG_CASE(30) PIO_CG_REG_CASE(32) PIO_CG_REG_CASE(34)
    PIO_CG_REG_CASE(36) PIO_CG_REG_CASE(38) PIO_CG_REG_CASE(40)
    PIO_CG_REG_CASE(42) PIO_CG_REG_CASE(44) PIO_CG_REG_CASE(46)
    PIO_CG_REG_CASE(48) PIO_CG_REG_CASE(50) PIO_CG_REG_CASE(52)
  }
  return (int)cudaErrorInvalidValue;
}

#undef PIO_CG_REG_CASE

}  // namespace

extern "C" {

// Largest R the kernels take (the stream geometry: kMaxPer elements for
// each of 256 threads).
int pio_cg_solve_max_rank() { return kMaxThreads * kMaxPer; }

// The device's opt-in shared memory per block in bytes; negative: a CUDA
// error while querying it.
int pio_cg_solve_smem_optin() {
  int err = 0;
  const int optin = smem_optin(&err);
  return err ? -err : optin;
}

// The geometry code (0 warp, 1 registers, 2 shared, 3 global) that takes
// an R x R system on the current device; negative: a CUDA error.
int pio_cg_solve_geometry(int R) {
  int err = 0;
  const size_t optin = (size_t)smem_optin(&err);
  return err ? -err : geometry_for(R, optin);
}

// x[s] = CG(A[s], b[s]) for s < batch. A: [batch, R, R], b, x: [batch, R],
// all contiguous f32 on the current device. Returns a cudaError_t.
int pio_cg_solve_f32(const float* A, const float* b, float* x, int batch,
                     int R, int iters, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (R <= 0 || R > kMaxThreads * kMaxPer || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  const size_t optin = (size_t)smem_optin(&err);
  if (err) return err;
  const int geo = geometry_for(R, optin);
  if (geo == kGeoWarp)
    return launch_warp_geometry(A, b, x, batch, R, iters, s);
  if (geo == kGeoRegisters)
    return launch_reg_geometry(A, b, x, batch, R, iters, s);
  const int threads = stream_threads(R);
  const bool smem_a = geo == kGeoShared;
  const size_t bytes = stream_smem_bytes(R, smem_a);
  if (smem_a) {
    cudaError_t e = cudaFuncSetAttribute(
        cg_stream_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    cg_stream_kernel<true><<<batch, threads, bytes, s>>>(A, b, x, R, iters);
  } else {
    cg_stream_kernel<false><<<batch, threads, bytes, s>>>(A, b, x, R, iters);
  }
  return (int)cudaGetLastError();
}

const char* pio_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
