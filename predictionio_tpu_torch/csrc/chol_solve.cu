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
//   - the trailing update A22 -= L21 L21^T (lower triangle only);
// then forward substitution L y = b and back substitution L^T x = y, each
// a panel at a time (8x8 triangle, then one update of the rest).
// Only the lower triangle of A is read. Plan padding systems (A = reg*I,
// b = 0) solve to exactly 0.
//
// What bounds it on an H100: per system ~R^3/3 flops (factorisation) plus
// 2R^2 (substitutions) against 4(R(R+1)/2 + 2R) bytes (A's lower triangle
// and b read once, x written once). At R = 200 that is ~33 flops per byte,
// above the card's 67 TFLOP/s : 3.35 TB/s = 20 balance point, so the f32
// FMAs bound it (from R ~ 120 up; the small dual systems are bound by
// bytes). The design reads A once and feeds every FMA from shared memory
// and registers:
//   - one CTA per system, no batch padding;
//   - A copied once into dynamic shared memory (164 KB at R = 200, after
//     cudaFuncSetAttribute) and factored there in place;
//   - the row stride is the padded R plus 4 floats, so the 16-byte row
//     segments that neighbouring threads read (an L21 row of a panel)
//     fall in distinct banks;
//   - the trailing update walks the lower triangle in 32x32 tiles, one
//     warp per tile: each lane keeps its column's 8 panel values in
//     registers, so an element costs one shared-memory load and one
//     store for 8 FMAs;
//   - every reduction runs in a fixed order with no atomics, so results
//     are deterministic.
// The pivots and the 8x8 triangles are sequential (one warp, shuffles);
// this first kernel does not overlap them with the trailing update, and
// the card is left idle while a CTA loads its A (one 164 KB CTA fits an
// SM). A system whose padded A does not fit in shared memory (R > 232 on
// an H100) is refused: the wrapper raises before launching.
//
// Plain C interface, bound with ctypes (predictionio_tpu_torch/ops/
// solve.py:chol_solve_cuda). The kernel launches on the caller's stream,
// allocates nothing and does not synchronise; the entry returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kPanel = 8;
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int padded_rank(int R) {
  return (R + kPanel - 1) / kPanel * kPanel;
}
// Row stride in floats: a multiple of 4 (16-byte rows) that is 4 mod 8,
// so 8 consecutive rows' 16-byte segments cover all 32 banks once.
__host__ __device__ inline int row_stride(int Rp) { return Rp + 4; }

size_t smem_bytes_for(int R) {
  const int Rp = padded_rank(R);
  return ((size_t)Rp * row_stride(Rp) + Rp) * sizeof(float);
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

// Factor the 8x8 diagonal block at (c0, c0) in place. Called by one whole
// warp; lane l < 8 owns row c0 + l.
__device__ void factor_diagonal(float* L, int ld, int c0, int lane) {
  const int l = lane & (kPanel - 1);
  float* row = L + (size_t)(c0 + l) * ld + c0;
  float a[kPanel], out[kPanel];
  load8(row, a);
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    const float acc = __shfl_sync(kFull, a[c], c);
    const float d = sqrtf(fmaxf(acc, 1e-30f));
    const float col = (l >= c) ? a[c] / d : 0.f;
    out[c] = col;
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      const float colk = __shfl_sync(kFull, col, k);
      a[k] -= col * colk;
    }
  }
  if (lane < kPanel) store8(row, out);
}

// L21 row i of the panel at c0: forward substitution with L11.
__device__ __forceinline__ void panel_row(float* L, int ld, int c0, int i) {
  float* row = L + (size_t)i * ld + c0;
  const float* L11 = L + (size_t)c0 * ld + c0;
  float a[kPanel];
  load8(row, a);
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    float acc = a[c];
#pragma unroll
    for (int k = 0; k < c; ++k) acc -= a[k] * L11[(size_t)c * ld + k];
    a[c] = acc / L11[(size_t)c * ld + c];
  }
  store8(row, a);
}

// A22 -= L21 L21^T on the lower triangle of rows/cols r0..Rp-1, where L21
// sits in columns c0..c0+7. Tiles of 32x32 in the lower triangle go to
// warps round-robin; lane = column within the tile.
__device__ void trailing_update(float* L, int ld, int c0, int r0, int Rp,
                                int warp, int n_warps, int lane) {
  const int n_tiles_1d = (Rp - r0 + 31) / 32;
  const int n_tiles = n_tiles_1d * (n_tiles_1d + 1) / 2;
  for (int t = warp; t < n_tiles; t += n_warps) {
    int ti = 0, rem = t;               // t -> (ti, tj), tj <= ti
    while (rem > ti) { rem -= ti + 1; ++ti; }
    const int tj = rem;
    const int j = r0 + 32 * tj + lane;
    float lj[kPanel];
    if (j < Rp) load8(L + (size_t)j * ld + c0, lj);
    const int i_lo = r0 + 32 * ti;
    const int i_hi = min(i_lo + 32, Rp);
    for (int i = i_lo; i < i_hi; ++i) {
      float li[kPanel];
      load8(L + (size_t)i * ld + c0, li);   // same address in every lane
      if (j <= i) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kPanel; ++k) s = fmaf(li[k], lj[k], s);
        L[(size_t)i * ld + j] -= s;
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, int R) {
  extern __shared__ __align__(16) float smem[];
  const int Rp = padded_rank(R);
  const int ld = row_stride(Rp);
  float* L = smem;                       // [Rp][ld]; L in place of A
  float* v = smem + (size_t)Rp * ld;     // [Rp]: b, then y, then x
  const size_t sys = blockIdx.x;
  const float* Ag = A + sys * (size_t)R * R;
  const float* bg = b + sys * (size_t)R;
  float* xg = x + sys * (size_t)R;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;

  // A -> shared memory (lower triangle and diagonal are all that is read),
  // identity block on the padding rows, b -> v.
  if ((R & 3) == 0 && (reinterpret_cast<size_t>(Ag) & 15) == 0) {
    const int q_row = R >> 2;
    const float4* src = reinterpret_cast<const float4*>(Ag);
    for (int q = tid; q < R * q_row; q += nt) {
      const int i = q / q_row;
      const int j = (q - i * q_row) << 2;
      if (j <= i)
        *reinterpret_cast<float4*>(L + (size_t)i * ld + j) = __ldg(src + q);
    }
  } else {
    for (int q = tid; q < R * R; q += nt) {
      const int i = q / R;
      const int j = q - i * R;
      if (j <= i) L[(size_t)i * ld + j] = __ldg(Ag + q);
    }
  }
  for (int q = tid; q < (Rp - R) * Rp; q += nt) {
    const int i = R + q / Rp;
    const int j = q % Rp;
    L[(size_t)i * ld + j] = (i == j) ? 1.f : 0.f;
  }
  for (int i = tid; i < Rp; i += nt) v[i] = i < R ? __ldg(bg + i) : 0.f;
  __syncthreads();

  const int n_panels = Rp / kPanel;
  for (int p = 0; p < n_panels; ++p) {
    const int c0 = p * kPanel;
    const int r0 = c0 + kPanel;
    if (warp == 0) factor_diagonal(L, ld, c0, lane);
    __syncthreads();
    if (r0 == Rp) break;
    for (int i = r0 + tid; i < Rp; i += nt) panel_row(L, ld, c0, i);
    __syncthreads();
    trailing_update(L, ld, c0, r0, Rp, warp, n_warps, lane);
    __syncthreads();
  }

  // Forward substitution L y = b, a panel at a time.
  for (int p = 0; p < n_panels; ++p) {
    const int c0 = p * kPanel;
    const int r0 = c0 + kPanel;
    if (warp == 0) {
      const int l = lane & (kPanel - 1);
      float lrow[kPanel];
      load8(L + (size_t)(c0 + l) * ld + c0, lrow);
      float rhs = v[c0 + l], y = 0.f;
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        const float yc = __shfl_sync(kFull, rhs, c) /
                         __shfl_sync(kFull, lrow[c], c);
        if (l > c) rhs -= lrow[c] * yc;
        if (l == c) y = yc;
      }
      if (lane < kPanel) v[c0 + l] = y;
    }
    __syncthreads();
    for (int i = r0 + tid; i < Rp; i += nt) {
      float li[kPanel];
      load8(L + (size_t)i * ld + c0, li);
      float s = v[i];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) s -= li[k] * v[c0 + k];
      v[i] = s;
    }
    __syncthreads();
  }

  // Back substitution L^T x = y, last panel first.
  for (int p = n_panels - 1; p >= 0; --p) {
    const int c0 = p * kPanel;
    if (warp == 0) {
      const int l = lane & (kPanel - 1);
      float rhs = v[c0 + l], xl = 0.f;
#pragma unroll
      for (int c = kPanel - 1; c >= 0; --c) {
        const float* Lc = L + (size_t)(c0 + c) * ld + c0;  // row c of L11
        const float xc = __shfl_sync(kFull, rhs, c) / Lc[c];
        if (l < c) rhs -= Lc[l] * xc;
        if (l == c) xl = xc;
      }
      if (lane < kPanel) v[c0 + l] = xl;
    }
    __syncthreads();
    for (int i = tid; i < c0; i += nt) {
      float s = v[i];
#pragma unroll
      for (int k = 0; k < kPanel; ++k)
        s -= L[(size_t)(c0 + k) * ld + i] * v[c0 + k];
      v[i] = s;
    }
    __syncthreads();
  }
  for (int i = tid; i < R; i += nt) xg[i] = v[i];
}

int threads_for(int R) {
  const int Rp = padded_rank(R);
  const int t = (Rp + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
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

// Largest R whose padded system fits in shared memory on the current
// device; negative: a CUDA error while querying it.
int pio_chol_solve_max_rank() {
  int err = 0;
  const size_t optin = (size_t)optin_smem(&err);
  if (err) return -err;
  int R = 0;
  while (smem_bytes_for(R + kPanel) <= optin) R += kPanel;
  return R;
}

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
  cudaError_t e = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  chol_solve_kernel<<<batch, threads_for(R), bytes,
                      static_cast<cudaStream_t>(stream)>>>(A, b, x, R);
  return (int)cudaGetLastError();
}

const char* pio_chol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
