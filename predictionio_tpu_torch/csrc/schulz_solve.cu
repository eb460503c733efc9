// Batched Newton-Schulz solve of SPD systems: f32 in and out, products on
// bf16-rounded operands on the tensor cores (bf16 mode) or on f32 operands
// on the CUDA cores (f32 mode), f32 sums in both.
//
// Replaces predictionio_tpu/ops/solve.py:_schulz_kernel (the Pallas kernel
// behind schulz_solve_pallas). It computes what _schulz_kernel computes,
// system by system:
//   - alpha = 1 / max(max_i sum_j |A_ij|, 1e-30) on the f32 A, X0 = alpha I;
//   - `iters` steps of Y = rnd(rnd(A) rnd(X)), X = 2X - rnd(X) Y, where rnd
//     rounds to bf16 (round to nearest even) in the bf16 mode and is the
//     identity in the f32 mode; X is carried in f32 and 2X - XY is taken
//     in f32;
//   - x = X b, then two refinements x += X (b - A x), all with the f32 A
//     and the f32 X.
// A product of two bf16 values is exact in f32, so an MMA on bf16 operands
// with f32 accumulators is the reference's product up to the order of the
// sums. The TPU kernel's 8-system VMEM tile and its identity padding of
// the batch are not carried over. Plan padding systems (A = reg*I, b = 0)
// solve to exactly 0, and zero padding of R stays exactly 0 in every step.
//
// What bounds it on an H100: per system 4*iters*R^3 flops (two R x R x R
// products a step) against 4(R^2 + 2R) bytes (A and b read once, x written
// once); at R = 200 and 18 steps that is ~3,500 flops per byte, so the
// arithmetic bounds it by far: the tensor cores' 989 TFLOP/s in bf16, the
// CUDA cores' 67 TFLOP/s in f32.
//
// bf16 mode (schulz_solve_mma): both products of a step are
// mma.sync.m16n8k16 bf16 MMAs with f32 accumulators, operands from shared
// memory by ldmatrix. R is padded with zeros to Rp, a multiple of 16; a
// group of Rp/16 warps solves one system, warp w owning the 16-row strip w
// of every product:
//   - rnd(A)'s strip w is the left operand of Y = rnd(A) rnd(X) for warp w
//     alone, so warp w converts it once per system into MMA fragments that
//     stay in its registers for all steps (4*Rp/16 registers: 52 at Rp =
//     208). A is read from device memory once per system for the products
//     and rounded once, never staged in shared memory;
//   - rnd(X) and Y stay in shared memory as bf16 for all steps (two
//     Rp x (Rp + 8) arrays: 180 KB at Rp = 208; the 16-byte row pad keeps
//     ldmatrix and the fragment stores free of bank conflicts);
//   - the f32 master X lives in shared memory (row stride Rp + 8) up to
//     Rp = 160, and above that in a global workspace of one Rp x (Rp + 8)
//     f32 matrix per resident group, which stays in L2 (24 MB at Rp = 208
//     for 132 groups). In shared memory it measured 13-42 % faster than in
//     the workspace on an H100 at Rp = 16-144 (scripts/schulz_variants.py);
//     three bf16-and-f32 matrices no longer fit above Rp = 160. Registers
//     cannot hold it beside rnd(A)'s fragments:
//     it is Rp/2 more registers a thread, 104 at Rp = 208, where 13 warps
//     leave at most 128 a thread (4 warps on one of the SM's four register
//     quarters; ptxas reports 128 used);
//   - a warp computes its strip in chunks of up to 16 x 64 columns (at
//     most 32 f32 accumulators a thread), summing over k in increasing
//     order: results are deterministic, with no atomics. Before a chunk's
//     products of the second kind it loads the chunk's master entries, so
//     their latency overlaps the MMAs;
//   - the kernel is a template on the strip count T (13 instantiations),
//     so every register array is indexed by constants and the loops over
//     k and columns unroll with no branch, which lets the compiler issue
//     the next ldmatrix ahead of the current MMAs;
//   - step: P1 writes rnd(Y) of its strip; barrier; P2 reads rnd(X)'s own
//     strip and all of Y, updates the master X of its strip (2X - acc) and,
//     after its last chunk, rewrites its own strip of rnd(X): in P2 only
//     warp w reads strip w of rnd(X), so no barrier is needed before that
//     rewrite; barrier. Two group barriers a step (named barriers, one per
//     group of a block);
//   - small systems pack: at Rp <= 32 a block holds 8 warps, that is 8
//     systems of Rp = 16 (one warp each) or 4 of Rp = 32;
//   - a system's A is read straight from device memory: a cp.async copy of
//     the next system's A into shared memory while the current one
//     iterates measured no faster on an H100 at Rp = 16, 64 and 128
//     (scripts/schulz_variants.py), since A is read once per system and
//     the SM's other warps hide its latency;
//   - persistent blocks walk over the batch (grid = blocks resident at
//     once).
// The refinements read the f32 A again from device memory (mostly from
// L2) and the f32 master X. The bf16 mode takes Rp <= 208 (R <= 208).
// What holds it at about a quarter of the tensor cores' rate: latency.
// One block of 9-13 warps fills an SM, each warp's MMAs wait on its
// ldmatrix loads, and a step has two barriers. Each warp reads all of
// rnd(X) and Y every step (an ldmatrix.x4 for two MMAs), but shared-memory
// bandwidth is not the limit: warps owning two strips each, which halves
// those reads with half the warps, measured slower on an H100 (21.5
// against 18.8 ms at Rp = 208, 119 against 99 ms at Rp = 176).
// Asynchronous warpgroup MMAs (wgmma) are the next step.
//
// f32 mode (schulz_solve_fma): CUDA-core f32 FMAs, as TF32 would round
// operands that the plain version does not round. One block per system at
// a time, persistent; the f32 X in a global workspace per resident block;
// A X in shared memory (R <= 224); 8x8 register tiles fed from 16-deep
// operand slices; X = 2X - X Y written in place band by band.
//
// Plain C interface, bound with ctypes (predictionio_tpu_torch/ops/
// solve.py:schulz_solve_cuda). The kernel launches on the caller's stream,
// allocates nothing (the wrapper passes the workspace) and does not
// synchronise; the entry returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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

// Blocks of `kernel` resident at once on the current device with this
// block size and shared memory, times SMs, at most `want`; sets the
// kernel's dynamic shared-memory limit on the way. Returns a cudaError_t.
template <typename Kernel>
int resident_grid(Kernel kernel, int threads, size_t bytes, long long want,
                  int* grid) {
  int err = 0;
  const size_t optin = (size_t)optin_smem(&err);
  if (err) return err;
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long g = (long long)per_sm * sms;
  *grid = (int)(g < want ? g : want);
  return (int)cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16 mode: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMma = 16;            // rank padding: one MMA row/k tile
constexpr int kMaxStrips = 13;      // Rp <= 208
constexpr int kPackedRp = 32;       // Rp <= this: several systems a block
constexpr int kPackedWarps = 8;
constexpr int kMasterSmemRp = 160;  // master X in shared memory up to here

// Systems (warp groups of T = Rp / 16 warps) a block holds.
__host__ __device__ constexpr int mma_systems(int T) {
  return kMma * T <= kPackedRp ? kPackedWarps / T : 1;
}

struct MmaPlan {
  int Rp;          // R padded to a multiple of 16
  int strips;      // warps per system, Rp / 16
  int systems;     // systems (warp groups) per block
  int ld;          // row stride of rnd(X) and Y (bf16 elements)
  int ldm;         // row stride of the f32 master X
  bool master_smem;
  size_t group_bytes;   // shared memory of one group
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline MmaPlan mma_plan(int R) {
  MmaPlan p;
  p.Rp = (R + kMma - 1) / kMma * kMma;
  p.strips = p.Rp / kMma;
  p.systems = mma_systems(p.strips);
  p.ld = p.Rp + 8;
  p.ldm = p.Rp + 8;
  p.master_smem = p.Rp <= kMasterSmemRp;
  size_t bytes = 2 * align16((size_t)p.Rp * p.ld * 2);    // rnd(X), Y
  bytes += align16((3 * (size_t)p.Rp + 16) * 4);          // b, x, r, maxima
  if (p.master_smem) bytes += align16((size_t)p.Rp * p.ldm * 4);
  p.group_bytes = bytes;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) is bits 0-15
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 bf16 matrices; lane L gives the row address of matrix L / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for a 16x16 row-major bf16 a, a 16x8 bf16 b, f32 c.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One group of T = Rp/16 warps per system, `systems` groups per block.
// Warp w of a group owns rows [16w, 16w + 16) of every product; in the
// accumulator layout lane (g = lane/4, t = lane%4) holds rows 16w + g and
// 16w + g + 8, columns 16j + 8h + 2t and + 1. T and the chunk width
// kGroups (in 16-column groups) are compile-time, so every register array
// is indexed by constants and every loop over k and columns unrolls with no
// branch.
template <int T, int kGroups, int kMinBlocks>
__global__ void __launch_bounds__(32 * T * mma_systems(T), kMinBlocks)
schulz_solve_mma(const float* __restrict__ A, const float* __restrict__ b,
                 float* __restrict__ x, int batch, int R, int iters,
                 float* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaPlan p = mma_plan(R);   // p.Rp == Rp
  constexpr int Rp = kMma * T, ld = Rp + 8, ldm = Rp + 8;
  constexpr int kSystems = mma_systems(T);
  constexpr bool kMasterSmem = Rp <= kMasterSmemRp;
  // chunks unroll except at T >= 12, where the 128-register cap would make
  // the unrolled chunks spill (on an H100: 36.9 against 18.8 ms at Rp = 208)
  constexpr int kChunkUnroll = T >= 12 ? 1 : (T + kGroups - 1) / kGroups;
  const int lane = threadIdx.x & 31;
  const int grp = (threadIdx.x >> 5) / T;
  const int w = (threadIdx.x >> 5) - grp * T;
  const int gtid = w * 32 + lane;            // thread within the group
  const int gthreads = 32 * T;
  const int bar = 1 + grp;                   // 0 is __syncthreads'

  unsigned char* base = smem + (size_t)grp * p.group_bytes;
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(base);   // rnd(X)
  __nv_bfloat16* Ys = reinterpret_cast<__nv_bfloat16*>(
      base + align16((size_t)Rp * ld * 2));                       // rnd(Y)
  float* vb = reinterpret_cast<float*>(base +
                                       2 * align16((size_t)Rp * ld * 2));
  float* vx = vb + Rp;
  float* vr = vx + Rp;
  float* red = vr + Rp;                                           // [16]
  unsigned char* tail = reinterpret_cast<unsigned char*>(vb) +
                        align16((3 * (size_t)Rp + 16) * 4);
  float* Xm = kMasterSmem
                  ? reinterpret_cast<float*>(tail)
                  : work + ((size_t)blockIdx.x * kSystems + grp) * Rp * ldm;

  const uint32_t xs_s = smem_addr(Xs), ys_s = smem_addr(Ys);
  // ldmatrix row address of this lane within a 16x16 tile
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = kMma * w + g, r1 = r0 + 8;
  float* m0row = Xm + (size_t)r0 * ldm + 2 * t;   // this lane's master rows
  float* m1row = Xm + (size_t)r1 * ldm + 2 * t;
  __nv_bfloat16* x0row = Xs + r0 * ld + 2 * t;    // and its rnd(X) rows
  __nv_bfloat16* x1row = Xs + r1 * ld + 2 * t;
  const long long RR = (long long)R * R;
  const long long stride = (long long)gridDim.x * kSystems;

  for (long long s = (long long)blockIdx.x * kSystems + grp; s < batch;
       s += stride) {
    const float* As = A + s * RR;

    // rnd(A)'s strip as MMA A fragments, once per system; the row sums of
    // |A| on the way (the f32 A)
    uint32_t af[T][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int kt = 0; kt < T; ++kt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (q & 1) ? r1 : r0;
        const int col = kMma * kt + 2 * t + 8 * (q >> 1);
        const bool in = row < R;
        const float v0 = (in && col < R) ? As[(size_t)row * R + col] : 0.f;
        const float v1 =
            (in && col + 1 < R) ? As[(size_t)row * R + col + 1] : 0.f;
        if (q & 1) rs1 += fabsf(v0) + fabsf(v1);
        else rs0 += fabsf(v0) + fabsf(v1);
        af[kt][q] = pack_bf16(v0, v1);
      }
    }
    rs0 += __shfl_xor_sync(kFull, rs0, 1);
    rs0 += __shfl_xor_sync(kFull, rs0, 2);
    rs1 += __shfl_xor_sync(kFull, rs1, 1);
    rs1 += __shfl_xor_sync(kFull, rs1, 2);
    float wmax = fmaxf(rs0, rs1);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      wmax = fmaxf(wmax, __shfl_xor_sync(kFull, wmax, off));
    if (lane == 0) red[w] = wmax;
    for (int i = gtid; i < Rp; i += gthreads)
      vb[i] = i < R ? __ldg(b + s * R + i) : 0.f;
    group_sync(bar, gthreads);
    float amax = 0.f;
    for (int k = 0; k < T; ++k) amax = fmaxf(amax, red[k]);
    const float alpha = 1.f / fmaxf(amax, 1e-30f);

    // X0 = alpha I on this warp's strip: the master X and rnd(X)
#pragma unroll
    for (int j = 0; j < T; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = kMma * j + 8 * h + 2 * t;
        const float2 u = make_float2(r0 == col && r0 < R ? alpha : 0.f,
                                     r0 == col + 1 && r0 < R ? alpha : 0.f);
        const float2 v = make_float2(r1 == col && r1 < R ? alpha : 0.f,
                                     r1 == col + 1 && r1 < R ? alpha : 0.f);
        const int c = kMma * j + 8 * h;
        *reinterpret_cast<float2*>(m0row + c) = u;
        *reinterpret_cast<float2*>(m1row + c) = v;
        *reinterpret_cast<uint32_t*>(x0row + c) = pack_bf16(u.x, u.y);
        *reinterpret_cast<uint32_t*>(x1row + c) = pack_bf16(v.x, v.y);
      }
    }
    group_sync(bar, gthreads);

    for (int it = 0; it < iters; ++it) {
      // P1: Y = rnd(rnd(A) rnd(X)), this warp's strip, into Ys
#pragma unroll kChunkUnroll
      for (int c0 = 0; c0 < T; c0 += kGroups) {
        float acc[kGroups][2][4] = {};
#pragma unroll
        for (int kt = 0; kt < T; ++kt) {
#pragma unroll
          for (int q = 0; q < kGroups; ++q) {
            if (c0 + q < T) {
              uint32_t bb[4];
              ldsm_x4_t(xs_s + ((kMma * kt + lrow) * ld +
                                kMma * (c0 + q) + lcol) * 2, bb);
              mma_bf16(acc[q][0], af[kt], bb[0], bb[1]);
              mma_bf16(acc[q][1], af[kt], bb[2], bb[3]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          if (c0 + q < T) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = kMma * (c0 + q) + 8 * h + 2 * t;
              *reinterpret_cast<uint32_t*>(Ys + r0 * ld + col) =
                  pack_bf16(acc[q][h][0], acc[q][h][1]);
              *reinterpret_cast<uint32_t*>(Ys + r1 * ld + col) =
                  pack_bf16(acc[q][h][2], acc[q][h][3]);
            }
          }
        }
      }
      group_sync(bar, gthreads);

      // P2: X = 2X - rnd(X) Y on this warp's strip, in the master X; the
      // chunk's master entries are loaded before its products, so their
      // latency (L2 where the master is in the workspace) overlaps them
#pragma unroll kChunkUnroll
      for (int c0 = 0; c0 < T; c0 += kGroups) {
        float2 mx[kGroups][2][2];
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          if (c0 + q < T) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = kMma * (c0 + q) + 8 * h;
              mx[q][h][0] = *reinterpret_cast<const float2*>(m0row + c);
              mx[q][h][1] = *reinterpret_cast<const float2*>(m1row + c);
            }
          }
        }
        float acc[kGroups][2][4] = {};
#pragma unroll
        for (int kt = 0; kt < T; ++kt) {
          uint32_t xa[4];
          ldsm_x4(xs_s + ((kMma * w + lrow) * ld + kMma * kt + lcol) * 2, xa);
#pragma unroll
          for (int q = 0; q < kGroups; ++q) {
            if (c0 + q < T) {
              uint32_t bb[4];
              ldsm_x4_t(ys_s + ((kMma * kt + lrow) * ld +
                                kMma * (c0 + q) + lcol) * 2, bb);
              mma_bf16(acc[q][0], xa, bb[0], bb[1]);
              mma_bf16(acc[q][1], xa, bb[2], bb[3]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          if (c0 + q < T) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = kMma * (c0 + q) + 8 * h;
              float2 u = mx[q][h][0], v = mx[q][h][1];
              u.x = 2.f * u.x - acc[q][h][0];
              u.y = 2.f * u.y - acc[q][h][1];
              v.x = 2.f * v.x - acc[q][h][2];
              v.y = 2.f * v.y - acc[q][h][3];
              *reinterpret_cast<float2*>(m0row + c) = u;
              *reinterpret_cast<float2*>(m1row + c) = v;
            }
          }
        }
      }
      // Only this warp reads its strip of rnd(X) in P2, and it is done:
      // rewrite the strip from the master X (entries this thread wrote).
      __syncwarp();
#pragma unroll
      for (int j = 0; j < T; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = kMma * j + 8 * h;
          const float2 u = *reinterpret_cast<const float2*>(m0row + c);
          const float2 v = *reinterpret_cast<const float2*>(m1row + c);
          *reinterpret_cast<uint32_t*>(x0row + c) = pack_bf16(u.x, u.y);
          *reinterpret_cast<uint32_t*>(x1row + c) = pack_bf16(v.x, v.y);
        }
      }
      group_sync(bar, gthreads);
    }

    // x = X b, then twice x += X (b - A x), in f32; a warp per row
    for (int i = w; i < R; i += T) {
      float sum = 0.f;
      for (int k = lane; k < R; k += 32)
        sum = fmaf(Xm[(size_t)i * ldm + k], vb[k], sum);
      sum = warp_sum(sum);
      if (lane == 0) vx[i] = sum;
    }
    for (int rep = 0; rep < 2; ++rep) {
      group_sync(bar, gthreads);
      for (int i = w; i < R; i += T) {
        float sum = 0.f;
        for (int k = lane; k < R; k += 32)
          sum = fmaf(__ldg(As + (size_t)i * R + k), vx[k], sum);
        sum = warp_sum(sum);
        if (lane == 0) vr[i] = vb[i] - sum;
      }
      group_sync(bar, gthreads);
      for (int i = w; i < R; i += T) {
        float sum = 0.f;
        for (int k = lane; k < R; k += 32)
          sum = fmaf(Xm[(size_t)i * ldm + k], vr[k], sum);
        sum = warp_sum(sum);
        if (lane == 0) vx[i] += sum;
      }
    }
    group_sync(bar, gthreads);
    for (int i = gtid; i < R; i += gthreads) x[s * R + i] = vx[i];
    group_sync(bar, gthreads);   // vb, red, Xs and Xm are rewritten next
  }
}

typedef void (*MmaKernel)(const float*, const float*, float*, int, int, int,
                          float*);

// The instantiation for T = Rp / 16 strips. Chunks are 64 columns wide,
// 32 at T >= 12, where 12-13 warps leave at most 128 registers a thread (4
// warps on one of the SM's four register quarters). The second argument of
// the launch bounds lets several small blocks share an SM.
MmaKernel mma_kernel_for(int T) {
  switch (T) {
    case 1: return schulz_solve_mma<1, 1, 3>;
    case 2: return schulz_solve_mma<2, 2, 3>;
    case 3: return schulz_solve_mma<3, 3, 4>;
    case 4: return schulz_solve_mma<4, 4, 4>;
    case 5: return schulz_solve_mma<5, 4, 2>;
    case 6: return schulz_solve_mma<6, 4, 1>;
    case 7: return schulz_solve_mma<7, 4, 1>;
    case 8: return schulz_solve_mma<8, 4, 1>;
    case 9: return schulz_solve_mma<9, 4, 1>;
    case 10: return schulz_solve_mma<10, 4, 1>;
    case 11: return schulz_solve_mma<11, 4, 1>;
    case 12: return schulz_solve_mma<12, 2, 1>;
    default: return schulz_solve_mma<13, 2, 1>;
  }
}

int mma_grid(int batch, int R, int* grid) {
  const MmaPlan p = mma_plan(R);
  if (p.strips > kMaxStrips) return (int)cudaErrorInvalidValue;
  const long long want = ((long long)batch + p.systems - 1) / p.systems;
  return resident_grid(mma_kernel_for(p.strips), 32 * p.strips * p.systems,
                       p.group_bytes * p.systems, want, grid);
}

// ---------------------------------------------------------------------------
// f32 mode: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kTile = 8;           // a thread's output tile is kTile^2
constexpr int kChunk = 16;         // depth of one staged operand slice
constexpr int kMaxFmaThreads = 384;

__host__ __device__ inline int fma_padded_rank(int R) {
  return (R + kTile - 1) / kTile * kTile;
}

// Ys [Rp][Rp], Ps and Qs [kChunk][Rp], b, x and the residual [Rp], and 32
// per-warp maxima.
size_t fma_smem_bytes(int R) {
  const size_t Rp = fma_padded_rank(R);
  return (Rp * Rp + 2 * kChunk * Rp + 3 * Rp + 32) * sizeof(float);
}

// Threads and band height (tile rows a pass computes) for one system: a
// band is whole tile rows, so X can be updated in place band by band.
struct Shape {
  int threads;
  int band;
};

Shape fma_shape(int R) {
  const int nT = fma_padded_rank(R) / kTile;
  int rows = kMaxFmaThreads / nT;
  if (rows < 1) rows = 1;
  const int passes = (nT + rows - 1) / rows;
  const int band = (nT + passes - 1) / passes;
  return {(band * nT + 31) / 32 * 32, band};
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

__global__ void __launch_bounds__(kMaxFmaThreads)
schulz_solve_fma(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, int batch, int R, int iters,
                  int band, float* __restrict__ work) {
  extern __shared__ __align__(16) float fsmem[];
  const int Rp = fma_padded_rank(R);
  const int nT = Rp / kTile;
  float* Ys = fsmem;                         // [Rp][Rp] A X
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
      // Y = A X into Ys, a band of tile rows at a time
      for (int r0 = 0; r0 < nT; r0 += band) {
        const int rows = min(band, nT - r0) * kTile;
        const int i0 = r0 * kTile;
        const bool active = t_row < band && r0 + t_row < nT;
        float acc[kTile][kTile];
        zero(acc);
        for (int k0 = 0; k0 < Rp; k0 += kChunk) {
          const int kc = min(kChunk, Rp - k0);
          __syncthreads();
          for (int e = tid; e < rows * kc; e += nt) {   // A slice^T
            const int ii = e / kc;
            const int kk = e - ii * kc;
            const int i = i0 + ii;
            const int k = k0 + kk;
            Ps[kk * Rp + ii] =
                (i < R && k < R) ? __ldg(As + (size_t)i * R + k) : 0.f;
          }
          const int q4 = Rp / 4;
          for (int e = tid; e < kc * q4; e += nt) {     // X slice
            const int kk = e / q4;
            const int j = (e - kk * q4) * 4;
            *reinterpret_cast<float4*>(Qs + kk * Rp + j) =
                *reinterpret_cast<const float4*>(X + (size_t)(k0 + kk) * Rp + j);
          }
          __syncthreads();
          if (active)
            tile_fma(acc, Ps + t_row * kTile, Qs + tj * kTile, Rp, kc);
        }
        if (active) {
          const int i = i0 + t_row * kTile;
#pragma unroll
          for (int r = 0; r < kTile; ++r)
            store8(Ys + (size_t)(i + r) * Rp + tj * kTile, acc[r]);
        }
      }
      // X = 2X - X Ys in place, a band of tile rows at a time: a band
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
          for (int e = tid; e < rows * k4; e += nt) {   // X slice^T
            const int ii = e / k4;
            const int kk = (e - ii * k4) * 4;
            const float4 v = *reinterpret_cast<const float4*>(
                X + (size_t)(i0 + ii) * Rp + k0 + kk);
            Ps[(kk + 0) * Rp + ii] = v.x;
            Ps[(kk + 1) * Rp + ii] = v.y;
            Ps[(kk + 2) * Rp + ii] = v.z;
            Ps[(kk + 3) * Rp + ii] = v.w;
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

int fma_grid(int batch, int R, int* grid) {
  return resident_grid(schulz_solve_fma, fma_shape(R).threads,
                       fma_smem_bytes(R), batch, grid);
}

}  // namespace

extern "C" {

// Largest R the kernel of this compute mode takes on the current device:
// bf16, Rp <= 208 (rnd(A)'s fragments in registers, rnd(X) and Y in shared
// memory); f32, the A X product in shared memory (224 on an H100).
// Negative: a CUDA error while querying it.
int pio_schulz_max_rank(int bf16) {
  int err = 0;
  const size_t optin = (size_t)optin_smem(&err);
  if (err) return -err;
  int R = 0;
  if (bf16) {
    while (R + kMma <= kMma * kMaxStrips &&
           mma_plan(R + kMma).group_bytes * mma_plan(R + kMma).systems <= optin)
      R += kMma;
  } else {
    while (fma_smem_bytes(R + kTile) <= optin) R += kTile;
  }
  return R;
}

// Floats of workspace pio_schulz_solve_f32 needs for this batch on the
// current device: f32 mode, one padded R x R iterate per resident block;
// bf16 mode, one Rp x (Rp + 8) master X per resident group where it does
// not live in shared memory (Rp > 160), else none. Negative: a CUDA error.
long long pio_schulz_workspace_floats(int batch, int R, int bf16) {
  if (batch <= 0) return 0;
  if (R <= 0) return -(long long)cudaErrorInvalidValue;
  int grid = 0;
  const int err = bf16 ? mma_grid(batch, R, &grid) : fma_grid(batch, R, &grid);
  if (err) return -(long long)err;
  if (bf16) {
    const MmaPlan p = mma_plan(R);
    if (p.master_smem) return 0;
    return (long long)grid * p.systems * p.Rp * p.ldm;
  }
  const long long Rp = fma_padded_rank(R);
  return (long long)grid * Rp * Rp;
}

// x[s] = A[s]^-1 b[s] for s < batch by `iters` Newton-Schulz steps, with
// products on bf16-rounded operands on the tensor cores when bf16 != 0.
// A: [batch, R, R], b, x: [batch, R], all contiguous f32 on the current
// device; work: at least pio_schulz_workspace_floats(batch, R, bf16)
// floats there. Returns a cudaError_t.
int pio_schulz_solve_f32(const float* A, const float* b, float* x, int batch,
                         int R, int iters, int bf16, float* work,
                         void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (R <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int grid = 0;
  if (bf16) {
    const int err = mma_grid(batch, R, &grid);
    if (err) return err;
    const MmaPlan p = mma_plan(R);
    mma_kernel_for(p.strips)<<<grid, 32 * p.strips * p.systems,
                           p.group_bytes * p.systems, st>>>(A, b, x, batch, R,
                                                            iters, work);
  } else {
    const int err = fma_grid(batch, R, &grid);
    if (err) return err;
    const Shape sh = fma_shape(R);
    schulz_solve_fma<<<grid, sh.threads, fma_smem_bytes(R), st>>>(
        A, b, x, batch, R, iters, sh.band, work);
  }
  return (int)cudaGetLastError();
}

const char* pio_schulz_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
