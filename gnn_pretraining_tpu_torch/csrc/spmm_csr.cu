// K3: the sparse GIN aggregation on Hopper, a row-gather kernel over an edge
// CSR, one kernel for both directions.
//
//   out[r] = sum_{e in row r} a_e * H[col_e] + (1 + eps) * H[r]
//
// The forward (csr_spmm_fwd in ops/spmm_csr.py) runs it over the CSR of A by
// destination row and H; the backward (csr_spmm_bwd) over the prebuilt CSR
// of A^T by source row and the upstream gradient G, giving
// dH = A^T @ G + (1 + eps) * G. Both directions own their output rows, so
// neither needs atomics and both are deterministic (the TPU prebuilt the
// tiles of A^T for the same reason).
//
// Replaces gnn_pretraining_tpu/ops/spmm_csr.py:_csr_kernel, which
// _csr_matvec drives through pl.pallas_call over the grid (F / bn, nnzb):
// the sequential tile axis walks the nonzero 128 x 128 tiles of A in row
// order, runs each tile against its slice of H on the matrix unit and
// flushes acc + (1 + eps) * H[row] when the tile row changes. The tiles
// suit a 128 x 128 matrix unit; on this card they carry ~8 edges per 16384
// entries at Cora x6, so the tile format costs ~2000x the needed
// multiply-adds and ~15x the needed bytes. Here the kernel reads only the
// nonzeros.
//
// What bounds it on the H100: bytes, counted by nonzeros. For N rows, F
// features and nnz nonzeros it must read H once and write out once
// (8 N F bytes), read each nonzero's index and value (8 nnz) and indptr
// (4 (N + 1)); at Cora_NC x6 (N = 16248, F = 256, nnz = 63336) that is
// 33.8 MB, 0.0101 ms at 3.35 TB/s, against 65 MFLOP (4 nnz F in SPLIT),
// which are negligible. So the design is about bytes and occupancy, and
// tensor cores are deliberately not used:
//   * one warp per row, 8 rows per 256-thread block (2031 blocks at
//     Cora x6, ~15 per SM);
//   * the warp reads up to 32 (index, value) pairs with one coalesced load
//     and hands them round with __shfl_sync; it gathers 2 neighbours' rows
//     (4 float4 per lane) before adding any, so a row with many edges (a
//     hub, or the clipped ends of the banded graph, up to 92) keeps 4 loads
//     in flight per lane, not 2 (4 neighbours made ptxas spill);
//   * each lane holds 8 features of a 256-feature chunk (two float4 at
//     F = 256), so a neighbour's H row is gathered with 16-byte loads, 512
//     contiguous bytes per warp and load; wider F loops over chunks; a width
//     that is not a multiple of 4 (or an unaligned H) takes a masked scalar
//     path, 8 strided features per lane;
//   * the gathered rows of H (16.6 MB at Cora x6) stay in the 50 MB L2;
//   * the mode's rounding is applied in registers, as the TPU kernel and
//     csr_matvec_reference do: HIGHEST f32 products; SPLIT
//     acc += a * bf16(h) + a * bf16(h - bf16(h)); BF16 acc += a * bf16(h);
//     in SPLIT and BF16 a is rounded to bf16 (exact for multiplicities);
//   * the epilogue acc + (1 + eps) * H[row] writes each output once, with
//     eps read from device memory (no host sync); a row with no nonzero
//     writes only the epilogue.
//
// Operands: indptr [N+1] i32, indices [nnz] i32, data [nnz] f32, H [N,F]
// f32, eps one f32, out [N,F] f32, all on the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARPS = 8;                        // rows per block
constexpr int THREADS = 32 * WARPS;             // 256
constexpr int CHUNK = 256;                      // features per warp pass
constexpr int PER_LANE = CHUNK / 32;            // 8
constexpr int UNROLL = 2;                       // neighbours gathered at once
// Blocks per SM that ptxas must allow: 4 x 256 threads, 64 registers each,
// the SM's whole thread count. Left free, ptxas gave the split kernel 48
// registers and spilled.
constexpr int MIN_BLOCKS = 4;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { kHighest = 0, kSplit = 1, kBf16 = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc += a * v with the mode's rounding of v.
template <int MODE>
__device__ __forceinline__ float add_scaled(float acc, float a, float v) {
  if constexpr (MODE == kHighest) {
    return fmaf(a, v, acc);
  } else {
    const float hi = round_bf16(v);
    acc = fmaf(a, hi, acc);
    if constexpr (MODE == kSplit) acc = fmaf(a, round_bf16(v - hi), acc);
    return acc;
  }
}

// acc += a * v per element, with the mode's rounding of v.
template <int MODE>
__device__ __forceinline__ void add_scaled4(float4& acc, float a, float4 v) {
  acc.x = add_scaled<MODE>(acc.x, a, v.x);
  acc.y = add_scaled<MODE>(acc.y, a, v.y);
  acc.z = add_scaled<MODE>(acc.z, a, v.z);
  acc.w = add_scaled<MODE>(acc.w, a, v.w);
}

// VEC: F % 4 == 0 and H, out 16-byte aligned. Then a lane holds two float4
// of each 256-feature chunk, at 4 lane and 128 + 4 lane; otherwise 8
// features strided by 32, each loaded and stored alone. Features past F are
// masked either way.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
csr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const float* __restrict__ data, const float* __restrict__ h,
                const float* __restrict__ eps, float* __restrict__ out, int n,
                int f) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n) return;                         // whole warps leave together
  const int start = indptr[row], end = indptr[row + 1];
  const float scale = 1.f + eps[0];
  const float* h_row = h + static_cast<size_t>(row) * f;
  float* out_row = out + static_cast<size_t>(row) * f;

  for (int c0 = 0; c0 < f; c0 += CHUNK) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc0 = zero, acc1 = zero;                               // VEC
    float acc[PER_LANE];                                           // scalar
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) acc[q] = 0.f;
    const int ca = c0 + 4 * lane, cb = ca + 128;

    for (int e0 = start; e0 < end; e0 += 32) {
      int my_src = 0;
      float my_a = 0.f;
      if (e0 + lane < end) {                    // one coalesced load per 32
        my_src = indices[e0 + lane];
        my_a = data[e0 + lane];
        if constexpr (MODE != kHighest) my_a = round_bf16(my_a);
      }
      const int count = min(32, end - e0);
      if constexpr (VEC) {
        // UNROLL neighbours' rows are loaded before any is added.
        for (int k0 = 0; k0 < count; k0 += UNROLL) {
          float a[UNROLL];
          float4 va[UNROLL], vb[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int src = __shfl_sync(FULL, my_src, (k0 + u) % 32);
            a[u] = __shfl_sync(FULL, my_a, (k0 + u) % 32);
            const float4* v = reinterpret_cast<const float4*>(
                h + static_cast<size_t>(src) * f);
            const bool edge = k0 + u < count;
            va[u] = edge && ca < f ? __ldg(v + ca / 4) : zero;
            vb[u] = edge && cb < f ? __ldg(v + cb / 4) : zero;
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (k0 + u < count) {
              add_scaled4<MODE>(acc0, a[u], va[u]);
              add_scaled4<MODE>(acc1, a[u], vb[u]);
            }
          }
        }
      } else {
#pragma unroll 1                                // unrolled, ptxas spills here
        for (int k = 0; k < count; ++k) {
          const int src = __shfl_sync(FULL, my_src, k);
          const float a = __shfl_sync(FULL, my_a, k);
          const float* h_src = h + static_cast<size_t>(src) * f;
#pragma unroll
          for (int q = 0; q < PER_LANE; ++q) {
            const int c = c0 + lane + 32 * q;
            if (c < f) acc[q] = add_scaled<MODE>(acc[q], a, __ldg(h_src + c));
          }
        }
      }
    }

    if constexpr (VEC) {
      // The epilogue acc + (1 + eps) * H[row], 16 bytes at a time.
      if (ca < f) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(h_row + ca));
        *reinterpret_cast<float4*>(out_row + ca) =
            make_float4(fmaf(scale, v.x, acc0.x), fmaf(scale, v.y, acc0.y),
                        fmaf(scale, v.z, acc0.z), fmaf(scale, v.w, acc0.w));
      }
      if (cb < f) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(h_row + cb));
        *reinterpret_cast<float4*>(out_row + cb) =
            make_float4(fmaf(scale, v.x, acc1.x), fmaf(scale, v.y, acc1.y),
                        fmaf(scale, v.z, acc1.z), fmaf(scale, v.w, acc1.w));
      }
    } else {
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) {
        const int c = c0 + lane + 32 * q;
        if (c < f) out_row[c] = fmaf(scale, h_row[c], acc[q]);
      }
    }
  }
}

template <int MODE>
void launch(const int* indptr, const int* indices, const float* data,
            const float* h, const float* eps, float* out, int n, int f,
            bool vec, cudaStream_t s) {
  const dim3 grid((n + WARPS - 1) / WARPS);
  if (vec) {
    csr_spmm_kernel<MODE, true><<<grid, THREADS, 0, s>>>(indptr, indices, data,
                                                         h, eps, out, n, f);
  } else {
    csr_spmm_kernel<MODE, false><<<grid, THREADS, 0, s>>>(indptr, indices, data,
                                                          h, eps, out, n, f);
  }
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 = launched).
// One warp per row, grid ceil(n / 8) blocks of 256 threads. mode: 0 highest,
// 1 split, 2 bf16. The forward passes the CSR of A and H, the backward the
// CSR of A^T and the upstream gradient.
extern "C" int csr_spmm(const int* indptr, const int* indices,
                        const float* data, const float* h, const float* eps,
                        float* out, int n, int f, int mode, int device,
                        void* stream) {
  if (mode < kHighest || mode > kBf16 || n <= 0 || f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  switch (mode) {
    case kHighest:
      launch<kHighest>(indptr, indices, data, h, eps, out, n, f, vec, s);
      break;
    case kSplit:
      launch<kSplit>(indptr, indices, data, h, eps, out, n, f, vec, s);
      break;
    default:
      launch<kBf16>(indptr, indices, data, h, eps, out, n, f, vec, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
