// K1: the GIN aggregation on Hopper, forward and backward.
//
//   K1-fwd  out = A  @ H + (1 + eps) * H     (gin_spmm_fwd)
//   K1-bwd  dH  = A^T @ G + (1 + eps) * G    (gin_spmm_bwd)
//
// Replaces gnn_pretraining_tpu/ops/spmm.py:_spmm_kernel, which
// _spmm_fwd_impl drives through pl.pallas_call: with transpose_a=False for
// the forward, and with transpose_a=True (the A block spec (bk, bm), (k, i)
// and the dot_general contraction over A's rows) for the backward that
// _spmm_bwd asks for. Both directions share one tile routine here; the
// backward reads A's tile through transposed indices and never makes a
// transposed copy of A.
//
// Operands: A [N,N] row-major, bf16 (as the serving and fine-tune paths
// build it; exact, its entries are small edge multiplicities) or f32;
// H [N,F] f32; eps a 1-element f32 tensor on the device (read here, so the
// launch never waits on the host); out [N,F] f32. Precision modes follow the
// TPU kernel: HIGHEST takes f32 products; SPLIT rounds H to hi = bf16(h) and
// lo = bf16(h - hi) and sums a*hi + a*lo in f32; BF16 takes a*bf16(h). In
// SPLIT and BF16 an f32 A is rounded to bf16 first, as there.
//
// What bounds it on the H100: the function is a dense [N,N]x[N,F] product.
// At the main path's shapes (N = 1056 and 2712, F = 256) the tensor cores
// would bound it at 2*N*N*F operations per bf16 pass (two passes in SPLIT):
// about 7.6 us for N = 2712 at 989 TFLOP/s, against about 6.1 us to move A,
// H and out once at 3.35 TB/s. This kernel does the same multiply-adds as
// f32 FMAs on the CUDA cores (67 TFLOP/s), so it is bound by FMA issue and
// shared-memory reads, not by device memory: A is read once per 64-feature
// column of blocks (4 times at F = 256) and stays in the 50 MB L2.
//
// Design (simple and right first): a tiled SIMT kernel. One block of 128
// threads computes a 32-row x 64-feature output tile; a loop inside the
// block walks the contraction in 32-wide slices of A and H staged in shared
// memory. H is rounded (BF16) or split into hi/lo (SPLIT) once as it is
// staged, so the inner loop is only FMAs into 16 f32 accumulators per thread
// held in registers. The ragged edge is masked in the loads and the store,
// so nothing is padded, and the (1 + eps) * H epilogue is fused into the
// store. At N = 1056 the grid is 33 x 4 = 132 blocks, one per SM. Tensor
// cores (wgmma with TMA, SPLIT as two bf16 products as on the TPU) and
// skipping all-zero tiles of A are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int BM = 32;                          // output rows per block
constexpr int BN = 64;                          // output features per block
constexpr int BK = 32;                          // contraction slice per step
constexpr int TM = 4;                           // rows per thread
constexpr int TN = 4;                           // features per thread
constexpr int COLS = BN / TN;                   // 16 threads across features
constexpr int THREADS = (BM / TM) * COLS;       // 128

enum Mode { kHighest = 0, kSplit = 1, kBf16 = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }

// One block's work, shared by the two kernels below: TRANS = false is the
// forward, TRANS = true the backward (h is then the upstream gradient).
template <typename TA, int MODE, bool TRANS>
__device__ __forceinline__ void
gin_spmm_tile(const TA* __restrict__ adj, const float* __restrict__ h,
              const float* __restrict__ eps, float* __restrict__ out,
              int n, int f) {
  __shared__ float a_s[BM][BK + 1];               // +1: no bank conflicts
  __shared__ float hi_s[BK][BN];
  __shared__ float lo_s[MODE == kSplit ? BK : 1][BN];

  const int tid = threadIdx.x;
  const int tx = tid % COLS;                      // features tx + COLS*j
  const int ty = tid / COLS;                      // rows ty*TM + i
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      // r: output row in the tile, c: position in the contraction slice.
      // The thread index runs along whichever of the two is A's column.
      const int r = TRANS ? idx % BM : idx / BK;
      const int c = TRANS ? idx / BM : idx % BK;
      const int gr = row0 + r, gc = k0 + c;
      float v = 0.f;
      if (gr < n && gc < n) {
        v = to_float(TRANS ? adj[static_cast<size_t>(gc) * n + gr]
                           : adj[static_cast<size_t>(gr) * n + gc]);
        if constexpr (MODE != kHighest && std::is_same<TA, float>::value) {
          v = round_bf16(v);
        }
      }
      a_s[r][c] = v;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int gr = k0 + r, gc = col0 + c;
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

#pragma unroll
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

  const float scale = 1.f + eps[0];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
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

template <typename TA, int MODE>
__global__ void __launch_bounds__(THREADS)
gin_spmm_fwd_kernel(const TA* __restrict__ adj, const float* __restrict__ h,
                    const float* __restrict__ eps, float* __restrict__ out,
                    int n, int f) {
  gin_spmm_tile<TA, MODE, false>(adj, h, eps, out, n, f);
}

template <typename TA, int MODE>
__global__ void __launch_bounds__(THREADS)
gin_spmm_bwd_kernel(const TA* __restrict__ adj, const float* __restrict__ g,
                    const float* __restrict__ eps, float* __restrict__ dh,
                    int n, int f) {
  gin_spmm_tile<TA, MODE, true>(adj, g, eps, dh, n, f);
}

template <typename TA, int MODE, bool TRANS>
void launch_mode(const TA* adj, const float* h, const float* eps, float* out,
                 int n, int f, cudaStream_t stream) {
  const dim3 grid((f + BN - 1) / BN, (n + BM - 1) / BM);
  if constexpr (TRANS) {
    gin_spmm_bwd_kernel<TA, MODE><<<grid, THREADS, 0, stream>>>(
        adj, h, eps, out, n, f);
  } else {
    gin_spmm_fwd_kernel<TA, MODE><<<grid, THREADS, 0, stream>>>(
        adj, h, eps, out, n, f);
  }
}

template <typename TA, bool TRANS>
void launch(const void* adj, const float* h, const float* eps, float* out,
            int n, int f, int mode, cudaStream_t stream) {
  const TA* a = static_cast<const TA*>(adj);
  switch (mode) {
    case kHighest:
      launch_mode<TA, kHighest, TRANS>(a, h, eps, out, n, f, stream);
      break;
    case kSplit:
      launch_mode<TA, kSplit, TRANS>(a, h, eps, out, n, f, stream);
      break;
    default:
      launch_mode<TA, kBf16, TRANS>(a, h, eps, out, n, f, stream);
      break;
  }
}

template <bool TRANS>
int run(const void* adj, int adj_is_bf16, const float* h, const float* eps,
        float* out, int n, int f, int mode, int device, void* stream) {
  if (mode < kHighest || mode > kBf16 || n <= 0 || f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adj_is_bf16) {
    launch<__nv_bfloat16, TRANS>(adj, h, eps, out, n, f, mode, s);
  } else {
    launch<float, TRANS>(adj, h, eps, out, n, f, mode, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1-fwd on `stream` and returns cudaGetLastError() (0 = launched).
// mode: 0 highest, 1 split, 2 bf16. adj_is_bf16: 1 for a bf16 A, 0 for f32.
extern "C" int gin_spmm_fwd(const void* adj, int adj_is_bf16, const float* h,
                            const float* eps, float* out, int n, int f,
                            int mode, int device, void* stream) {
  return run<false>(adj, adj_is_bf16, h, eps, out, n, f, mode, device, stream);
}

// Launches K1-bwd: dh = A^T @ g + (1 + eps) * g, same arguments with the
// upstream gradient g [N,F] in h's place; A is read in place.
extern "C" int gin_spmm_bwd(const void* adj, int adj_is_bf16, const float* g,
                            const float* eps, float* dh, int n, int f,
                            int mode, int device, void* stream) {
  return run<true>(adj, adj_is_bf16, g, eps, dh, n, f, mode, device, stream);
}

extern "C" const char* gin_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
