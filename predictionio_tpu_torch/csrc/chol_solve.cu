// Batched blocked Cholesky factorisation and solve of SPD systems, f32.
//
// Replaces predictionio_tpu/ops/solve.py:_chol_kernel (the Pallas kernel
// behind cholesky_solve_pallas, whose body is _blocked_cholesky_solve).
// It computes what _blocked_cholesky_solve computes: R is padded to a
// multiple of the panel width 8 with an identity block (padding rows solve
// to 0), then a right-looking factorisation panel by panel:
//   - the 8x8 diagonal block by a column loop with pivots
//     d = sqrt(max(a_cc, 1e-30)), column = a[:, c] / d on and below the
//     diagonal (so L_cc = a_cc / d, as in the reference);
//   - the rows below the panel by forward substitution with that block,
//     L21[i][c] = (a_ic - sum_{k<c} L21[i][k] L11[c][k]) / L11[c][c];
//   - the trailing update A22 -= L21 L21^T (lower triangle only), each
//     element's 8-term dot product summed in k order and then subtracted;
// then forward substitution L y = b and back substitution L^T x = y, each
// a panel at a time (an 8x8 triangle by division, then one update of the
// rest). Only the lower triangle of A is read. Plan padding systems
// (A = reg*I, b = 0) solve to exactly 0.
//
// What bounds it on an H100: per system ~R^3/3 flops (factorisation) plus
// 2R^2 (substitutions) against 4(R(R+1)/2 + 2R) bytes (A's lower triangle
// and b read once, x written once). At R = 200 that is ~33 flops per byte,
// above the card's 67 TFLOP/s : 3.35 TB/s = 20 balance point, so the f32
// FMAs bound it (from R ~ 120 up; the small dual systems are bound by
// bytes). What held the first port at 31x that bound was not the FMAs but
// the serial chain of each panel: a 164 KB block filled an SM, one warp
// factored the 8x8 block while six waited, three block barriers a panel,
// a trailing update of 8 FMAs per shared-memory round trip, and nothing
// overlapped a block's load of A. This design:
//   - stores the padded lower triangle packed, as 8x8 tiles (tile (I, J),
//     J <= I, row-major, 68 floats apart so that neighbouring tiles start
//     in different banks): 88 KB at R = 200, so two blocks share an SM and
//     one block's load of A and its serial panel steps overlap the other's
//     trailing updates;
//   - one block barrier a panel, and look-ahead. While warps 1-7 do panel
//     J's trailing update on tile columns J + 2 on, warp 0 first brings
//     tile column J + 1 up to date (with the forward update of its rows),
//     then factors panel J + 1's diagonal block (each 8-lane group by
//     width-8 shuffles) and leaves L11 in a slot; a named barrier lets
//     the other warps take it, and then every thread solves rows of panel
//     J + 1 with L11 in registers while the team's last thread solves the
//     panel's 8 entries of y = L^-1 b (the forward substitution is fused
//     into the factorisation). Blocks of 64 and 128 threads (Rp <= 128),
//     which have no warps to spare, take the same steps in two phases with
//     a barrier between them. A trailing unit is a 4x4 quarter of a tile:
//     8 panel values of 4 rows and of 4 columns in registers, 128 FMAs for
//     24 shared-memory accesses of 16 bytes;
//   - the back substitution takes one barrier a panel: every thread solves
//     the panel's 8x8 transposed triangle itself, then updates its rows
//     above;
//   - small systems pack: at Rp <= 32 a team of 8 lanes solves one system
//     (8 systems a 64-thread block, 4 a warp) and synchronises by
//     __syncwarp, with no block barrier;
//   - every sum runs in a fixed order with no atomics, so results are
//     deterministic.
// Measured against alternatives on an H100 (scripts/solve_variants.py,
// scripts/compare_solve_kernels.py): tiles 64 floats apart, without the
// pad, were 12-23 % slower at R = 56-200; each thread factoring the
// diagonal block in its own registers, without shuffles, was slower at
// every shape (by 38 % at Rp = 8); look-ahead gained 4-6 % at R >= 144 and
// lost 12 % at R = 56 (64 threads), where it is off.
// A system whose packed triangle does not fit in one block's shared
// memory (R > 320 on an H100) is refused: the wrapper raises before
// launching.
//
// Plain C interface, bound with ctypes (predictionio_tpu_torch/ops/
// solve.py:chol_solve_cuda). The kernel launches on the caller's stream,
// allocates nothing and does not synchronise; the entry returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPanel = 8;
constexpr int kTile = 68;            // floats between tiles: 8x8 + 4
constexpr int kPackedMaxRp = 32;     // packed geometry: Rp <= 32
constexpr int kPackedTeam = 8;       // lanes a system
constexpr int kPackedBlock = 64;     // 8 systems a block
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int padded_rank(int R) {
  return (R + kPanel - 1) / kPanel * kPanel;
}

// Floats one system takes: the packed tiles, then v [Rp] (b, then y, then
// the back substitution's right-hand sides), xs [Rp] (x) and two slots
// [64] that carry a panel's L11 to its tile.
__host__ __device__ inline int system_floats(int R) {
  const int nT = padded_rank(R) / kPanel;
  return nT * (nT + 1) / 2 * kTile + 2 * padded_rank(R) +
         2 * kPanel * kPanel;
}

int block_threads(int R) {
  const int Rp = padded_rank(R);
  if (Rp <= kPackedMaxRp) return kPackedBlock;
  if (Rp <= 64) return 64;
  if (Rp <= 128) return 128;
  return kMaxThreads;
}

size_t smem_bytes_for(int R) {
  const int per_block = padded_rank(R) <= kPackedMaxRp
                            ? kPackedBlock / kPackedTeam : 1;
  return (size_t)system_floats(R) * per_block * sizeof(float);
}

__device__ __forceinline__ float* tile(float* L, int I, int J) {
  return L + (I * (I + 1) / 2 + J) * kTile;
}
__device__ __forceinline__ const float* tile(const float* L, int I, int J) {
  return L + (I * (I + 1) / 2 + J) * kTile;
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Factor the 8x8 diagonal tile D. Called by whole warps; in each group of
// 8 lanes, lane l owns row l, and gets that row of L11 in `out` (zero
// above the diagonal). Entries of D above the diagonal are never read.
__device__ __forceinline__ void factor_diagonal(const float* D, int l,
                                                float out[kPanel]) {
  float a[kPanel];
  load8(D + l * kPanel, a);
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    const float acc = __shfl_sync(kFull, a[c], c, kPanel);
    const float d = sqrtf(fmaxf(acc, 1e-30f));
    const float col = (l >= c) ? a[c] / d : 0.f;
    out[c] = col;
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      const float colk = __shfl_sync(kFull, col, k, kPanel);
      a[k] -= col * colk;
    }
  }
}

// (row, column) of the lower-triangle tile number t, row-major.
__device__ __forceinline__ void tri_index(int t, int& a, int& b) {
  a = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (a * (a + 1) / 2 > t) --a;
  while ((a + 1) * (a + 2) / 2 <= t) ++a;
  b = t - a * (a + 1) / 2;
}

// A22 -= L21 L21^T for one unit of panel J's trailing update: the 4x4
// quarter (rh, ch) of trailing tile (ti, tj), counted from the panel's
// first trailing tile, tj <= ti. The 8 panel values of its 4 rows and 4
// columns stay in registers: 128 FMAs for 24 accesses of 16 bytes.
__device__ __forceinline__ void trailing_unit(float* L, int J, int ti,
                                              int tj, int rh, int ch) {
  const float* Li = tile(L, J + 1 + ti, J) + rh * 4 * kPanel;
  const float* Lk = tile(L, J + 1 + tj, J) + ch * 4 * kPanel;
  float li[4][kPanel], lk[4][kPanel];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    load8(Li + r * kPanel, li[r]);
    load8(Lk + r * kPanel, lk[r]);
  }
  float* o = tile(L, J + 1 + ti, J + 1 + tj) + rh * 4 * kPanel + ch * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float4 ov = *reinterpret_cast<float4*>(o + r * kPanel);
    float s4[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kPanel; ++k) s = fmaf(li[r][k], lk[c][k], s);
      s4[c] = s;
    }
    ov.x -= s4[0]; ov.y -= s4[1]; ov.z -= s4[2]; ov.w -= s4[3];
    *reinterpret_cast<float4*>(o + r * kPanel) = ov;
  }
}

// Row rr below panel J: L21[rr] = forward substitution with L11.
__device__ __forceinline__ void panel_row(float* L, int J, int rr,
                                          const float l11[kPanel][kPanel]) {
  float* row = tile(L, J + 1 + rr / kPanel, J) + (rr % kPanel) * kPanel;
  float a[kPanel];
  load8(row, a);
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    float acc = a[c];
#pragma unroll
    for (int k = 0; k < c; ++k) acc -= a[k] * l11[c][k];
    a[c] = acc / l11[c][c];
  }
  store8(row, a);
}

// Panel J's 8 entries of y = L^-1 b, in place in v.
__device__ __forceinline__ void panel_y(float* v, int J,
                                        const float l11[kPanel][kPanel]) {
  float y[kPanel];
  load8(v + J * kPanel, y);
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    float acc = y[c];
#pragma unroll
    for (int k = 0; k < c; ++k) acc -= l11[c][k] * y[k];
    y[c] = acc / l11[c][c];
  }
  store8(v + J * kPanel, y);
}

// The forward update of row rr below panel J: v -= L21[rr] . y_J.
__device__ __forceinline__ void forward_row(const float* L, float* v, int J,
                                            int rr) {
  float lr[kPanel], y[kPanel];
  load8(tile(L, J + 1 + rr / kPanel, J) + (rr % kPanel) * kPanel, lr);
  load8(v + J * kPanel, y);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPanel; ++k) s = fmaf(lr[k], y[k], s);
  v[(J + 1) * kPanel + rr] -= s;
}

__device__ __forceinline__ void load_l11(const float* slot,
                                         float l11[kPanel][kPanel]) {
#pragma unroll
  for (int r = 0; r < kPanel; ++r) load8(slot + r * kPanel, l11[r]);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// kPacked: 8-lane teams, 8 systems a block (Rp <= 32). kAhead: look-ahead
// by warp 0 (256-thread blocks, Rp > 128); an instantiation of its own,
// since its registers would cost the smaller blocks occupancy.
template <bool kPacked, bool kAhead>
__global__ void __launch_bounds__(kMaxThreads, 2)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, int batch, int R) {
  extern __shared__ __align__(16) float smem[];
  const int Rp = padded_rank(R);
  const int nT = Rp / kPanel;
  const int T = kPacked ? kPackedTeam : blockDim.x;      // team size
  const int t = kPacked ? (threadIdx.x % kPackedTeam) : threadIdx.x;
  const int team = kPacked ? threadIdx.x / kPackedTeam : 0;
  float* L = smem + (size_t)team * system_floats(R);
  float* v = L + nT * (nT + 1) / 2 * kTile;
  float* xs = v + Rp;
  float* slots = xs + Rp;                  // two 8x8 slots for L11
  const long long s_raw =
      kPacked ? (long long)blockIdx.x * (blockDim.x / kPackedTeam) + team
              : (long long)blockIdx.x;
  const bool live = s_raw < batch;  // teams past the batch run a copy
  const size_t sys = live ? (size_t)s_raw : (size_t)batch - 1;
  const float* Ag = A + sys * (size_t)R * R;
  const float* bg = b + sys * (size_t)R;

  auto sync = [] {
    if (kPacked) __syncwarp(); else __syncthreads();
  };

  // A's lower triangle -> packed tiles (zero above the diagonal of the
  // diagonal tiles), the identity on the padding rows, b -> v.
  const bool vec = (R & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(Ag) & 15) == 0;
  const int q_row = Rp / 4;
  for (int q = t; q < Rp * q_row; q += T) {
    const int i = q / q_row;
    const int j = (q - i * q_row) * 4;
    if (j > i) continue;
    float e[4];
    if (vec && i < R && j < R) {
      const float4 g =
          __ldg(reinterpret_cast<const float4*>(Ag + (size_t)i * R + j));
      e[0] = g.x; e[1] = g.y; e[2] = g.z; e[3] = g.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        e[k] = (i < R && j + k < R) ? __ldg(Ag + (size_t)i * R + j + k)
                                    : (i == j + k ? 1.f : 0.f);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (j + k > i) e[k] = 0.f;
    *reinterpret_cast<float4*>(tile(L, i / kPanel, j / kPanel) +
                               (i % kPanel) * kPanel + j % kPanel) =
        make_float4(e[0], e[1], e[2], e[3]);
  }
  for (int i = t; i < Rp; i += T) v[i] = i < R ? __ldg(bg + i) : 0.f;
  sync();

  // Panel 0's first phase: L11 (every 8-lane group), the rows below, y's
  // panel; L11 waits in slot 0 for its tile.
  {
    float out[kPanel];
    factor_diagonal(tile(L, 0, 0), threadIdx.x & 7, out);
    float l11[kPanel][kPanel];
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
#pragma unroll
      for (int k = 0; k <= c; ++k)
        l11[c][k] = __shfl_sync(kFull, out[k], c, kPanel);
    for (int rr = t; rr < kPanel * (nT - 1); rr += T)
      panel_row(L, 0, rr, l11);
    if (t < kPanel) store8(slots + t * kPanel, out);
    if (t == T - 1) panel_y(v, 0, l11);
  }
  sync();

  for (int J = 0; J < nT; ++J) {
    const int m = nT - 1 - J;               // tiles below the panel
    float* slot = slots + (J & 1) * kPanel * kPanel;
    float* next = slots + ((J + 1) & 1) * kPanel * kPanel;
    // Panel J's L11 into its tile; nothing below reads tile (J, J).
    for (int q = t; q < 2 * kPanel; q += T)
      *reinterpret_cast<float4*>(tile(L, J, J) + 4 * q) =
          *reinterpret_cast<const float4*>(slot + 4 * q);
    if (m == 0) break;
    // Panel J's trailing update and forward update, and panel J + 1's
    // diagonal block, whose L11 goes to the other slot.
    float l11[kPanel][kPanel];
    if (!kAhead) {
      const int n_units = 4 * (m * (m + 1) / 2);
      for (int u = t; u < n_units; u += T) {
        int ti, tj;
        tri_index(u >> 2, ti, tj);
        const int rh = (u >> 1) & 1, ch = u & 1;
        if (ti == tj && ch > rh) continue;  // above the diagonal
        trailing_unit(L, J, ti, tj, rh, ch);
      }
      for (int rr = t; rr < kPanel * m; rr += T) forward_row(L, v, J, rr);
      sync();
      float out[kPanel];
      factor_diagonal(tile(L, J + 1, J + 1), threadIdx.x & 7, out);
#pragma unroll
      for (int c = 0; c < kPanel; ++c)
#pragma unroll
        for (int k = 0; k <= c; ++k)
          l11[c][k] = __shfl_sync(kFull, out[k], c, kPanel);
      if (t < kPanel) store8(next + t * kPanel, out);
    } else if (threadIdx.x < 32) {
      // Look-ahead: warp 0 first brings tile column J + 1 up to date,
      // with the forward update of its 8 rows, then factors its diagonal
      // block while the other warps finish the rest of the update.
      const int lane = threadIdx.x;
      for (int u = lane; u < 4 * m; u += 32) {
        const int ti = u >> 2, rh = (u >> 1) & 1, ch = u & 1;
        if (ti == 0 && ch > rh) continue;   // above the diagonal
        trailing_unit(L, J, ti, 0, rh, ch);
      }
      if (lane < kPanel) forward_row(L, v, J, lane);
      __syncwarp();
      float out[kPanel];
      factor_diagonal(tile(L, J + 1, J + 1), lane & 7, out);
      if (lane < kPanel) store8(next + lane * kPanel, out);
      __syncwarp();
      named_arrive(1, blockDim.x);
    } else {
      const int u0 = threadIdx.x - 32, ut = blockDim.x - 32;
      const int n_units = 4 * (m * (m - 1) / 2);  // tile columns >= J + 2
      for (int u = u0; u < n_units; u += ut) {
        int ti, tj;
        tri_index(u >> 2, ti, tj);
        const int rh = (u >> 1) & 1, ch = u & 1;
        if (ti == tj && ch > rh) continue;  // above the diagonal
        trailing_unit(L, J, ti + 1, tj + 1, rh, ch);
      }
      for (int rr = kPanel + u0; rr < kPanel * m; rr += ut)
        forward_row(L, v, J, rr);
      named_sync(1, blockDim.x);
    }
    // Panel J + 1's rows below and its entries of y, with L11 in
    // registers (its column is up to date, and no other thread writes it).
    if (kAhead) load_l11(next, l11);
    for (int rr = t; rr < kPanel * (m - 1); rr += T)
      panel_row(L, J + 1, rr, l11);
    if (t == T - 1) panel_y(v, J + 1, l11);
    sync();
  }
  sync();

  // Back substitution L^T x = y, last panel first; xs holds x.
  for (int J = nT - 1; J >= 0; --J) {
    const int c0 = J * kPanel;
    const float* D = tile(L, J, J);
    float d[kPanel][kPanel], rhs[kPanel], xv[kPanel];
#pragma unroll
    for (int k = 0; k < kPanel; ++k) load8(D + k * kPanel, d[k]);
    load8(v + c0, rhs);
#pragma unroll
    for (int c = kPanel - 1; c >= 0; --c) {
      float acc = rhs[c];
#pragma unroll
      for (int k = c + 1; k < kPanel; ++k) acc -= d[k][c] * xv[k];
      xv[c] = acc / d[c][c];
    }
    if (t == 0) store8(xs + c0, xv);
    for (int i = t; i < c0; i += T) {
      const float* col = tile(L, J, i / kPanel) + i % kPanel;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kPanel; ++k) s = fmaf(col[k * kPanel], xv[k], s);
      v[i] -= s;
    }
    sync();
  }
  if (live)
    for (int i = t; i < R; i += T) x[sys * R + i] = xs[i];
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

}  // namespace

extern "C" {

// Largest R whose packed system fits in one block's shared memory on the
// current device; negative: a CUDA error while querying it.
int pio_chol_solve_max_rank() {
  int err = 0;
  const size_t optin = (size_t)optin_smem(&err);
  if (err) return -err;
  int R = 0;
  while (smem_bytes_for(R + kPanel) <= optin) R += kPanel;
  return R;
}

// Threads per block for an R x R system (64 in the packed geometry, which
// holds 8 systems a block; one system a block above it).
int pio_chol_solve_threads(int R) { return R > 0 ? block_threads(R) : 0; }

// x[s] = A[s]^-1 b[s] for s < batch. A: [batch, R, R], b, x: [batch, R],
// all contiguous f32 on the current device. Returns a cudaError_t.
int pio_chol_solve_f32(const float* A, const float* b, float* x, int batch,
                       int R, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (R <= 0) return (int)cudaErrorInvalidValue;
  int err = 0;
  const size_t optin = (size_t)optin_smem(&err);
  if (err) return err;
  const size_t bytes = smem_bytes_for(R);
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(R);
  const bool packed = padded_rank(R) <= kPackedMaxRp;
  const bool ahead = threads == kMaxThreads;
  auto kernel = packed ? chol_solve_kernel<true, false>
                : ahead ? chol_solve_kernel<false, true>
                        : chol_solve_kernel<false, false>;
  const int per_block = packed ? kPackedBlock / kPackedTeam : 1;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(batch + per_block - 1) / per_block, threads, bytes, s>>>(
      A, b, x, batch, R);
  return (int)cudaGetLastError();
}

const char* pio_chol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
