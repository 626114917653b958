// K3: the block-CSR GIN aggregation on Hopper, one kernel for both directions.
//
//   out = T @ H + (1 + eps) * H      over the nonzero 128 x 128 tiles T of A
//
// The forward (csr_spmm_fwd in ops/spmm_csr.py) runs it over the tiles of A
// and H; the backward (csr_spmm_bwd) over the prebuilt tiles of A^T and the
// upstream gradient G, giving dH = A^T @ G + (1 + eps) * G.
//
// Replaces gnn_pretraining_tpu/ops/spmm_csr.py:_csr_kernel, which
// _csr_matvec drives through pl.pallas_call over the grid (F / bn, nnzb):
// the sequential tile axis t walks the tiles in row order, accumulates
// T_t @ H[col_t] in a VMEM scratch carried from one grid step to the next,
// and flushes acc + (1 + eps) * H[row_t] when the tile row changes. Blocks
// of a CUDA grid run in no order and carry nothing, so here one block owns
// one (tile row, 64-feature slice) and walks that row's tiles in a loop
// (tile range from row_ptr, built on the host; the TPU prefetched the
// coordinates as scalars). The accumulator stays in registers and the
// epilogue writes each output element once: blocks share nothing, no atomics.
//
// Operands: tiles [nnzb,128,128] f32 sorted by tile row (a zero tile for an
// empty row; pad tiles repeat the last row with zero values and add zeros),
// row_ptr [n_rows+1] i32, cols [nnzb] i32, H [N,F] f32 with N <= 128 n_rows
// (rows past N and features past F are masked, nothing is padded), eps one
// f32 on the device (read here: no host sync), out [N,F] f32. Modes follow
// the TPU kernel: HIGHEST f32 products; SPLIT rounds H to hi = bf16(h) and
// lo = bf16(h - hi) as it is staged and sums t*hi + t*lo; BF16 takes
// t*bf16(h); in SPLIT and BF16 a tile is rounded to bf16, which is exact for
// edge multiplicities.
//
// What bounds it on the H100: the tiles. At Cora x6 after RCM (16248 nodes,
// 7620 tiles, F = 256) they are 499 MB of f32, against ~33 MB of H and out:
// moved once at 3.35 TB/s that is ~0.16 ms, while the products (two bf16
// passes in SPLIT, 128 GFLOP) take ~0.13 ms at the 989 TFLOP/s tensor-core
// peak. So the function is bound by bytes. This first design does the
// products as f32 FMAs on the CUDA cores, so it is bound by FMA throughput
// instead, far above either bound (like K1); what it does about the bytes:
// the four feature slices of a tile row are neighbouring blocks, launched
// together, so a tile comes from device memory about once and from L2 for
// the other three, and tiles are read with 16-byte loads. Tensor cores
// (wgmma with TMA), skipping the all-zero parts of a tile (~8 edges per
// 16384 entries at Cora x6) and bf16 or sparser tile storage are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 128;                       // bm = bk of the tiles
constexpr int BN = 64;                          // output features per block
constexpr int BK = 32;                          // contraction slice per step
constexpr int TM = 8;                           // rows per thread
constexpr int TN = 4;                           // features per thread
constexpr int COLS = BN / TN;                   // 16 threads across features
constexpr int THREADS = (TILE / TM) * COLS;     // 256
constexpr int MAX_TILE_ROWS = 65535;            // gridDim.y

enum Mode { kHighest = 0, kSplit = 1, kBf16 = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
csr_spmm_kernel(const float* __restrict__ vals, const int* __restrict__ row_ptr,
                const int* __restrict__ cols, const float* __restrict__ h,
                const float* __restrict__ eps, float* __restrict__ out, int n,
                int f) {
  __shared__ float a_s[TILE][BK + 1];             // +1: no bank conflicts
  __shared__ float hi_s[BK][BN];
  __shared__ float lo_s[MODE == kSplit ? BK : 1][BN];

  const int tid = threadIdx.x;
  const int tx = tid % COLS;                      // features tx + COLS*j
  const int ty = tid / COLS;                      // rows ty*TM + i
  const int col0 = blockIdx.x * BN;
  const int tile_row = blockIdx.y;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int t_end = row_ptr[tile_row + 1];
  for (int t = row_ptr[tile_row]; t < t_end; ++t) {
    const float* tile = vals + static_cast<size_t>(t) * TILE * TILE;
    const int k_base = cols[t] * TILE;            // first row of H it meets
    for (int k0 = 0; k0 < TILE; k0 += BK) {
      // A slice [128 x 32]: 16-byte loads, eight per tile row slice.
      for (int idx = tid; idx < TILE * BK / 4; idx += THREADS) {
        const int r = idx / (BK / 4), c = 4 * (idx % (BK / 4));
        float4 v = *reinterpret_cast<const float4*>(
            tile + static_cast<size_t>(r) * TILE + k0 + c);
        if constexpr (MODE != kHighest) {
          v.x = round_bf16(v.x);
          v.y = round_bf16(v.y);
          v.z = round_bf16(v.z);
          v.w = round_bf16(v.w);
        }
        a_s[r][c] = v.x;
        a_s[r][c + 1] = v.y;
        a_s[r][c + 2] = v.z;
        a_s[r][c + 3] = v.w;
      }
      for (int idx = tid; idx < BK * BN; idx += THREADS) {
        const int r = idx / BN, c = idx % BN;
        const int gr = k_base + k0 + r, gc = col0 + c;
        const float v =
            (gr < n && gc < f) ? h[static_cast<size_t>(gr) * f + gc] : 0.f;
        if constexpr (MODE == kSplit) {
          const float hi = round_bf16(v);
          hi_s[r][c] = hi;
          lo_s[r][c] = round_bf16(v - hi);
        } else if constexpr (MODE == kBf16) {
          hi_s[r][c] = round_bf16(v);
        } else {
          hi_s[r][c] = v;
        }
      }
      __syncthreads();

#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = a_s[ty * TM + i][k];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float hv = hi_s[k][tx + COLS * j];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i], hv, acc[i][j]);
          if constexpr (MODE == kSplit) {
            const float lv = lo_s[k][tx + COLS * j];
#pragma unroll
            for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i], lv, acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

  const float scale = 1.f + eps[0];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tile_row * TILE + ty * TM + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + COLS * j;
      if (c < f) {
        const size_t o = static_cast<size_t>(r) * f + c;
        out[o] = acc[i][j] + scale * h[o];
      }
    }
  }
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 = launched).
// One block per (64-feature slice, tile row): grid (ceil(f/64), n_rows).
// mode: 0 highest, 1 split, 2 bf16. The forward passes the tiles of A and H,
// the backward the tiles of A^T and the upstream gradient.
extern "C" int csr_spmm(const float* vals, const int* row_ptr, const int* cols,
                        const float* h, const float* eps, float* out,
                        int n_rows, int n, int f, int mode, int device,
                        void* stream) {
  if (mode < kHighest || mode > kBf16 || n <= 0 || f <= 0 || n_rows <= 0 ||
      n_rows > MAX_TILE_ROWS || n > n_rows * TILE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((f + BN - 1) / BN, n_rows);
  switch (mode) {
    case kHighest:
      csr_spmm_kernel<kHighest><<<grid, THREADS, 0, s>>>(vals, row_ptr, cols,
                                                         h, eps, out, n, f);
      break;
    case kSplit:
      csr_spmm_kernel<kSplit><<<grid, THREADS, 0, s>>>(vals, row_ptr, cols, h,
                                                       eps, out, n, f);
      break;
    default:
      csr_spmm_kernel<kBf16><<<grid, THREADS, 0, s>>>(vals, row_ptr, cols, h,
                                                      eps, out, n, f);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
