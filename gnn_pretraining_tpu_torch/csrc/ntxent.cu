// K2: the fused NT-Xent on Hopper, forward and the two halves of its backward.
//
//   ntxent_fwd_kernel       per row r: loss_r = log(den_r) + mx_r - S[r, pos(r)]
//                           with the online max mx_r and denominator den_r of
//                           the masked row S[r, :]                 (ntxent_fwd)
//   ntxent_bwd_rows_kernel  dZa = G @ Zhat                    (ntxent_bwd_rows)
//   ntxent_bwd_cols_kernel  dZb = G^T @ Zhat                  (ntxent_bwd_cols)
//
// Replaces gnn_pretraining_tpu/ops/ntxent_pallas.py: _fwd_kernel (the
// pl.pallas_call in _fwd_call), _bwd_rows_kernel and _bwd_cols_kernel (the
// two pl.pallas_calls in _bwd_call). S = Zhat Zhat^T / tau over the stacked,
// row-normalized projections Zhat = [z1; z2] (R = 2n rows, d <= 128 columns),
// with the diagonal and the invalid columns set to -1e30 as there; the
// positive of row r is column r + n (r < n) or r - n. The backward recomputes
// S tile by tile from the saved mx and den:
//   G[r, c] = (exp(S[r, c] - mx_r) / den_r - [c == pos(r)]) * g_r / tau,
// and dZhat = dZa + dZb. Nothing of size R x R is ever written to memory.
//
// Operands: Zhat [R, d] f32 row-major, valid [R] f32 (0/1), tau a 1-element
// f32 tensor on the device (read here, so no launch waits on the host); the
// backward also takes mx, den and g [R] f32. Everything is f32: the TPU
// kernel's bf16 operands were a TPU choice, and this kernel is held against
// the f32 formula.
//
// What bounds it on the H100: each kernel does 2 R^2 d operations for S (the
// backward kernels 2 R^2 d more for G @ Zhat) and moves O(R d) bytes, so at
// every row count of the main path (16 to ~1k) it is bound by operations, and
// by launch latency below a few hundred rows. This design does the products
// as f32 FMAs on the CUDA cores, so at its best it reaches the 67 TFLOP/s f32
// rate, not the tensor cores'.
//
// Design (simple and right first): one block of 256 threads per 32-row tile
// (bwd-cols: per 32-column tile) stages its tile of Zhat in shared memory
// once and loops over the other axis in 32-wide tiles inside the block, the
// TPU grid's sequential axis. The 32 x 32 tile of S goes through shared
// memory: the forward's 8 warps own 4 rows each and keep the online max,
// denominator and positive logit of their rows in registers (warp
// shuffles reduce a tile row); the backward kernels turn the tile into G
// and accumulate G @ Zhat (or G^T @ Zhat) into 16 f32 registers per thread.
// Ragged rows and columns are masked, nothing is padded: a column past R is
// -inf (no share of any row's max or sum), a row past R is not written.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int D_MAX = 128;                      // widest projection taken
constexpr int T = 32;                           // rows and columns per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;             // 8
constexpr int ROWS_PER_WARP = T / WARPS;        // 4 (forward), 4 (accumulators)
constexpr int FEATS_PER_THREAD = D_MAX / 32;    // 4
constexpr float kMasked = -1e30f;               // the TPU kernel's mask value

// rows [r0, r0 + T) of z [rows, d] into s, zero past rows and past d.
__device__ __forceinline__ void stage(float (*s)[D_MAX + 1],
                                      const float* __restrict__ z, int r0,
                                      int rows, int d) {
  for (int idx = threadIdx.x; idx < T * D_MAX; idx += THREADS) {
    const int r = idx / D_MAX, k = idx % D_MAX;
    const int gr = r0 + r;
    s[r][k] = (gr < rows && k < d) ? z[static_cast<size_t>(gr) * d + k] : 0.f;
  }
}

// The thread's four entries of the tile product A B^T: row i = tid / 8,
// columns j = tid % 8 + 8 q. Rows of 129 floats put the 8 columns a warp
// reads at one k in 8 banks.
__device__ __forceinline__ void tile_dots(float (*a)[D_MAX + 1],
                                          float (*b)[D_MAX + 1],
                                          float dots[4]) {
  const int i = threadIdx.x / 8, j0 = threadIdx.x % 8;
#pragma unroll
  for (int q = 0; q < 4; ++q) dots[q] = 0.f;
#pragma unroll 8
  for (int k = 0; k < D_MAX; ++k) {
    const float av = a[i][k];
#pragma unroll
    for (int q = 0; q < 4; ++q) dots[q] = fmaf(av, b[j0 + 8 * q][k], dots[q]);
  }
}

// S[gr, gc] from a dot product: -inf past the last column, the mask value on
// the diagonal and at invalid columns.
__device__ __forceinline__ float masked_logit(float dot, int gr, int gc,
                                              int rows,
                                              const float* __restrict__ valid,
                                              float tau) {
  if (gc >= rows) return -CUDART_INF_F;
  if (gr == gc || !(valid[gc] > 0.f)) return kMasked;
  return dot / tau;
}

__device__ __forceinline__ int positive_of(int r, int rows) {
  const int half = rows / 2;
  return r < half ? r + half : r - half;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
ntxent_fwd_kernel(const float* __restrict__ z, const float* __restrict__ valid,
                  const float* __restrict__ temp, float* __restrict__ loss,
                  float* __restrict__ mx_out, float* __restrict__ den_out,
                  int rows, int d) {
  __shared__ float zr[T][D_MAX + 1];
  __shared__ float zc[T][D_MAX + 1];
  __shared__ float s[T][T + 1];
  const int r0 = blockIdx.x * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float tau = temp[0];
  stage(zr, z, r0, rows, d);

  float mx[ROWS_PER_WARP], den[ROWS_PER_WARP], pos[ROWS_PER_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    mx[q] = kMasked;
    den[q] = 0.f;
    pos[q] = 0.f;
  }

  for (int c0 = 0; c0 < rows; c0 += T) {
    __syncthreads();                    // the last tile's zc and s are read
    stage(zc, z, c0, rows, d);
    __syncthreads();
    float dots[4];
    tile_dots(zr, zc, dots);
    const int i = threadIdx.x / 8, j0 = threadIdx.x % 8;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 8 * q;
      s[i][j] = masked_logit(dots[q], r0 + i, c0 + j, rows, valid, tau);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      const int row = warp * ROWS_PER_WARP + q;
      const int gr = r0 + row;
      const float v = s[row][lane];
      const float m_new = fmaxf(mx[q], warp_max(v));
      const float tile_sum = warp_sum(expf(v - m_new));
      den[q] = den[q] * expf(mx[q] - m_new) + tile_sum;
      mx[q] = m_new;
      pos[q] += warp_sum(c0 + lane == positive_of(gr, rows) ? v : 0.f);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      const int gr = r0 + warp * ROWS_PER_WARP + q;
      if (gr < rows) {
        loss[gr] = logf(den[q]) + mx[q] - pos[q];
        mx_out[gr] = mx[q];
        den_out[gr] = den[q];
      }
    }
  }
}

// Row statistics of the tile's rows [r0, r0 + T); rows past the end get
// mx = 0, den = 1, g = 0 (so their G is 0), as the TPU kernel pads them.
__device__ __forceinline__ void stage_stats(float* mx_s, float* den_s,
                                            float* g_s,
                                            const float* __restrict__ mx,
                                            const float* __restrict__ den,
                                            const float* __restrict__ g,
                                            int r0, int rows) {
  if (threadIdx.x < T) {
    const int gr = r0 + threadIdx.x;
    const bool in = gr < rows;
    mx_s[threadIdx.x] = in ? mx[gr] : 0.f;
    den_s[threadIdx.x] = in ? den[gr] : 1.f;
    g_s[threadIdx.x] = in ? g[gr] : 0.f;
  }
}

// G over the tile of rows r0.. (zr, stats) and columns c0.. (zc), into gs.
__device__ __forceinline__ void grad_tile(float (*zr)[D_MAX + 1],
                                          float (*zc)[D_MAX + 1],
                                          const float* mx_s, const float* den_s,
                                          const float* g_s, float (*gs)[T + 1],
                                          int r0, int c0, int rows,
                                          const float* __restrict__ valid,
                                          float tau) {
  float dots[4];
  tile_dots(zr, zc, dots);
  const int i = threadIdx.x / 8, j0 = threadIdx.x % 8;
  const int gr = r0 + i;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + 8 * q, gc = c0 + j;
    const float sv = masked_logit(dots[q], gr, gc, rows, valid, tau);
    const float p = expf(sv - mx_s[i]) / den_s[i];
    const float onehot = (gr < rows && gc == positive_of(gr, rows)) ? 1.f : 0.f;
    gs[i][j] = (p - onehot) * g_s[i] / tau;
  }
}

// Writes the block's 32 x d tile of acc (rows o0 + ty*4 + i, features
// tx + 32 f) into out, masking the ragged rows and d.
__device__ __forceinline__ void store_tile(float acc[ROWS_PER_WARP][FEATS_PER_THREAD],
                                           float* __restrict__ out, int o0,
                                           int rows, int d) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = o0 + ty * ROWS_PER_WARP + i;
    if (r >= rows) continue;
#pragma unroll
    for (int f = 0; f < FEATS_PER_THREAD; ++f) {
      const int k = tx + 32 * f;
      if (k < d) out[static_cast<size_t>(r) * d + k] = acc[i][f];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ntxent_bwd_rows_kernel(const float* __restrict__ z,
                       const float* __restrict__ valid,
                       const float* __restrict__ temp,
                       const float* __restrict__ mx,
                       const float* __restrict__ den,
                       const float* __restrict__ g, float* __restrict__ dz,
                       int rows, int d) {
  __shared__ float zr[T][D_MAX + 1];
  __shared__ float zc[T][D_MAX + 1];
  __shared__ float gs[T][T + 1];
  __shared__ float mx_s[T], den_s[T], g_s[T];
  const int r0 = blockIdx.x * T;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float tau = temp[0];
  stage(zr, z, r0, rows, d);
  stage_stats(mx_s, den_s, g_s, mx, den, g, r0, rows);

  float acc[ROWS_PER_WARP][FEATS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
    for (int f = 0; f < FEATS_PER_THREAD; ++f) acc[i][f] = 0.f;

  for (int c0 = 0; c0 < rows; c0 += T) {
    __syncthreads();
    stage(zc, z, c0, rows, d);
    __syncthreads();
    grad_tile(zr, zc, mx_s, den_s, g_s, gs, r0, c0, rows, valid, tau);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float gv[ROWS_PER_WARP];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) gv[i] = gs[ty * ROWS_PER_WARP + i][c];
#pragma unroll
      for (int f = 0; f < FEATS_PER_THREAD; ++f) {
        const float zv = zc[c][tx + 32 * f];
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) acc[i][f] = fmaf(gv[i], zv, acc[i][f]);
      }
    }
  }
  store_tile(acc, dz, r0, rows, d);
}

__global__ void __launch_bounds__(THREADS)
ntxent_bwd_cols_kernel(const float* __restrict__ z,
                       const float* __restrict__ valid,
                       const float* __restrict__ temp,
                       const float* __restrict__ mx,
                       const float* __restrict__ den,
                       const float* __restrict__ g, float* __restrict__ dz,
                       int rows, int d) {
  __shared__ float zr[T][D_MAX + 1];
  __shared__ float zc[T][D_MAX + 1];
  __shared__ float gs[T][T + 1];
  __shared__ float mx_s[T], den_s[T], g_s[T];
  const int c0 = blockIdx.x * T;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float tau = temp[0];
  stage(zc, z, c0, rows, d);

  float acc[ROWS_PER_WARP][FEATS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
    for (int f = 0; f < FEATS_PER_THREAD; ++f) acc[i][f] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += T) {
    __syncthreads();
    stage(zr, z, r0, rows, d);
    stage_stats(mx_s, den_s, g_s, mx, den, g, r0, rows);
    __syncthreads();
    grad_tile(zr, zc, mx_s, den_s, g_s, gs, r0, c0, rows, valid, tau);
    __syncthreads();
    // acc holds columns c0 + ty*4 + i of the output: sum over the tile's rows.
#pragma unroll 4
    for (int r = 0; r < T; ++r) {
      float gv[ROWS_PER_WARP];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) gv[i] = gs[r][ty * ROWS_PER_WARP + i];
#pragma unroll
      for (int f = 0; f < FEATS_PER_THREAD; ++f) {
        const float zv = zr[r][tx + 32 * f];
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) acc[i][f] = fmaf(gv[i], zv, acc[i][f]);
      }
    }
  }
  store_tile(acc, dz, c0, rows, d);
}

int check_shape(int rows, int d) {
  return (rows <= 0 || d <= 0 || d > D_MAX)
             ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 = launched). rows = R = 2n, d <= 128.
extern "C" int ntxent_fwd(const float* z, const float* valid, const float* temp,
                          float* loss, float* mx, float* den, int rows, int d,
                          int device, void* stream) {
  if (int bad = check_shape(rows, d)) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntxent_fwd_kernel<<<(rows + T - 1) / T, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      z, valid, temp, loss, mx, den, rows, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ntxent_bwd_rows(const float* z, const float* valid,
                               const float* temp, const float* mx,
                               const float* den, const float* g, float* dz,
                               int rows, int d, int device, void* stream) {
  if (int bad = check_shape(rows, d)) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntxent_bwd_rows_kernel<<<(rows + T - 1) / T, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      z, valid, temp, mx, den, g, dz, rows, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ntxent_bwd_cols(const float* z, const float* valid,
                               const float* temp, const float* mx,
                               const float* den, const float* g, float* dz,
                               int rows, int d, int device, void* stream) {
  if (int bad = check_shape(rows, d)) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntxent_bwd_cols_kernel<<<(rows + T - 1) / T, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      z, valid, temp, mx, den, g, dz, rows, d);
  return static_cast<int>(cudaGetLastError());
}
