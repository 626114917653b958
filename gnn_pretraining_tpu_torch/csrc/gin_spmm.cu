// K1-fwd: the GIN aggregation  out = A @ H + (1 + eps) * H  on Hopper.
//
// Replaces gnn_pretraining_tpu/ops/spmm.py:_spmm_kernel (the forward,
// transpose_a=False), which _spmm_fwd_impl drives through pl.pallas_call.
// The transposed variant (the backward) is not here yet.
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

template <typename TA, int MODE>
__global__ void __launch_bounds__(THREADS)
gin_spmm_fwd_kernel(const TA* __restrict__ adj, const float* __restrict__ h,
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
      const int r = idx / BK, c = idx % BK;
      const int gr = row0 + r, gc = k0 + c;
      float v = 0.f;
      if (gr < n && gc < n) {
        v = to_float(adj[static_cast<size_t>(gr) * n + gc]);
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

template <typename TA>
void launch(const void* adj, const float* h, const float* eps, float* out,
            int n, int f, int mode, cudaStream_t stream) {
  const dim3 grid((f + BN - 1) / BN, (n + BM - 1) / BM);
  const TA* a = static_cast<const TA*>(adj);
  switch (mode) {
    case kHighest:
      gin_spmm_fwd_kernel<TA, kHighest><<<grid, THREADS, 0, stream>>>(
          a, h, eps, out, n, f);
      break;
    case kSplit:
      gin_spmm_fwd_kernel<TA, kSplit><<<grid, THREADS, 0, stream>>>(
          a, h, eps, out, n, f);
      break;
    default:
      gin_spmm_fwd_kernel<TA, kBf16><<<grid, THREADS, 0, stream>>>(
          a, h, eps, out, n, f);
      break;
  }
}

}  // namespace

// Launches K1-fwd on `stream` and returns cudaGetLastError() (0 = launched).
// mode: 0 highest, 1 split, 2 bf16. adj_is_bf16: 1 for a bf16 A, 0 for f32.
extern "C" int gin_spmm_fwd(const void* adj, int adj_is_bf16, const float* h,
                            const float* eps, float* out, int n, int f,
                            int mode, int device, void* stream) {
  if (mode < kHighest || mode > kBf16 || n <= 0 || f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adj_is_bf16) {
    launch<__nv_bfloat16>(adj, h, eps, out, n, f, mode, s);
  } else {
    launch<float>(adj, h, eps, out, n, f, mode, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gin_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
