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
// backward reads A's tile through transposed loads and never makes a
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
// At the main path's shapes (N = 416 to 2712, F = 256) the tensor cores
// bound it at 2*N*N*F operations per bf16 pass (two passes in SPLIT):
// about 7.6 us for N = 2712 at 989 TFLOP/s, against about 6.1 us to move A,
// H and out once at 3.35 TB/s; below N ~ 1300 the bytes bound it.
//
// Design of SPLIT and BF16, the main path's modes (spmm defaults to SPLIT):
// the TPU ran them as bf16 passes on its matrix unit, and so does this
// kernel, with mma.sync.m16n8k16 (bf16 in, f32 accumulate) on the tensor
// cores.
//   * A block of 4 warps (2 x 2) owns a BM x BN output tile and walks its
//     share of the contraction in BK = 32 slices (the TPU's sequential k
//     grid axis).
//   * A 3-stage cp.async ring stages A's slice (bf16, as stored) and H's
//     slice (f32) in shared memory, two slices ahead of the one in use. An
//     f32 A (a check path) is rounded to bf16 as it is staged, through
//     registers; so is a ragged A or H that 16-byte copies cannot reach
//     (N % 8 or F % 4 not 0): those copies are masked per element.
//   * H's slice is split once per block into hi/lo bf16 tiles (SPLIT) or
//     rounded into hi (BF16) as it leaves the ring.
//   * Operands reach registers with ldmatrix: A's tile with ldmatrix (its
//     rows are output rows) in the forward and with ldmatrix.trans (its rows
//     are the contraction) in the backward, hi/lo with ldmatrix.trans.
//     Shared rows are padded to an odd number of 16-byte chunks, so the 8
//     row addresses of an ldmatrix hit distinct banks.
//   * In SPLIT each A fragment feeds two MMAs (a*hi and a*lo, the TPU's own
//     arithmetic, exact in A) into one f32 accumulator; in BF16 one.
//   * The f32 accumulators stay in registers. Rows past N and features past
//     F are masked (zero-filled when staged, skipped when stored); nothing is
//     padded.
//   * Filling the card: at these shapes the output has only 104 to 172
//     tiles of a size that keeps the tensor cores fed, for 132 SMs, and each
//     block's walk down the contraction is a chain of dependent slices. So
//     the contraction is also split into up to 4 ranges, one block each.
//     Unsplit, the (1 + eps) * H epilogue is fused into the store; split,
//     each block stores its partial sum to scratch and a second kernel
//     (gin_spmm_*_sum_kernel) adds the partials in split order and the
//     epilogue, so the result does not depend on the order blocks finish.
//   * Tile and splits (plan()): the largest of 64 x 64, 32 x 64 and 32 x 32
//     whose tile count reaches the SM count (else 32 x 32), then
//     min(4, 4 * SMs / tiles) splits, which puts about 4 blocks on each SM.
//     On 132 SMs at F = 256: N = 2712 -> 64 x 64, 3 splits, grid 4 x 43 x 3
//     = 516 blocks; N = 1128 -> 32 x 64, 3 splits, 4 x 36 x 3 = 432;
//     N = 1056 -> 32 x 64, 4 splits, 4 x 33 x 4 = 528; N = 416 -> 32 x 32,
//     4 splits, 8 x 13 x 4 = 416; (136, 40) -> 32 x 32, 3 splits,
//     2 x 5 x 3 = 30. The rule was picked by timing these tiles and larger
//     ones (to 128 x 128) at 1 to 4 splits at N = 416, 1056, 1128 and 2712
//     on the H100; chip_smoke.py times the plan it picks.
// wgmma with TMA, and skipping all-zero slices of A (block-diagonal
// molecule batches), are later work.
//
// HIGHEST (no path uses it; the autograd checks do) is a tiled SIMT
// kernel: a 32 x 64 output tile per 128-thread block, A and H staged 32
// deep in shared memory, f32 FMAs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BK = 32;                          // contraction slice per step

enum Mode { kHighest = 0, kSplit = 1, kBf16 = 2 };

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }

// ---------------------------------------------------------------------------
// Tensor-core design (SPLIT, BF16)

constexpr int STAGES = 3;                       // cp.async ring depth
constexpr int PAD = 8;                          // bf16 per shared row: 16 B

// A block tile of BM x BN outputs over WARPS_M x WARPS_N warps.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // warp tile
  static constexpr int MF = WM / 16, NF = WN / 8;   // m16 and n8 fragments
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile of m16 x n16 steps");
};

// Dynamic shared memory of one block, in bytes from its start: A's ring as
// bf16 (forward [BM][BK], rows are output rows; backward [BK][BM], rows are
// the contraction; each row padded by PAD), H's ring as loaded (f32), then
// the hi and lo tiles of the slice in use.
template <class T, int MODE, bool TRANS>
struct Layout {
  static constexpr int A_ROWS = TRANS ? BK : T::BM;
  static constexpr int A_COLS = (TRANS ? T::BM : BK) + PAD;
  static constexpr int HI_COLS = T::BN + PAD;
  static constexpr int A_BYTES = STAGES * A_ROWS * A_COLS * 2;
  static constexpr int H_BYTES = STAGES * BK * T::BN * 4;
  static constexpr int HI_BYTES = BK * HI_COLS * 2;
  static constexpr int BYTES =
      A_BYTES + H_BYTES + HI_BYTES * (MODE == kSplit ? 2 : 1);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// acc (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage slice k0 of A (rows row0.. of the output tile) into `a`.
// a_vec: A is bf16, N % 8 == 0 and A is 16-byte aligned, so whole 16-byte
// rows of 8 entries are either inside N or outside it.
template <int THREADS, int ROWS, int COLS, bool TRANS, typename TA, int A_COLS>
__device__ __forceinline__ void stage_a(__nv_bfloat16 (*a)[A_COLS],
                                        const TA* __restrict__ adj, int n,
                                        int row0, int k0, bool a_vec) {
  // Shared row r, column c <- A[gr][gc]: forward gr = row0 + r (an output
  // row), gc = k0 + c; backward gr = k0 + r (a contraction row),
  // gc = row0 + c, so A's rows are read along their length either way.
  const int gr0 = TRANS ? k0 : row0, gc0 = TRANS ? row0 : k0;
  if constexpr (std::is_same<TA, __nv_bfloat16>::value) {
    if (a_vec) {
      for (int idx = threadIdx.x; idx < ROWS * COLS / 8; idx += THREADS) {
        const int r = idx / (COLS / 8), c = 8 * (idx % (COLS / 8));
        const int gr = gr0 + r, gc = gc0 + c;
        const bool in = gr < n && gc < n;
        cp_async16(&a[r][c], in ? adj + static_cast<size_t>(gr) * n + gc : adj,
                   in ? 16 : 0);
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += THREADS) {
    const int r = idx / COLS, c = idx % COLS;
    const int gr = gr0 + r, gc = gc0 + c;
    const float v =
        gr < n && gc < n ? to_float(adj[static_cast<size_t>(gr) * n + gc]) : 0.f;
    a[r][c] = __float2bfloat16_rn(v);           // exact for a bf16 A
  }
}

// Stage rows k0.. and features col0.. of H into `hs`. h_vec: F % 4 == 0 and
// H is 16-byte aligned.
template <int THREADS, int BN>
__device__ __forceinline__ void stage_h(float (*hs)[BN],
                                        const float* __restrict__ h, int n,
                                        int f, int k0, int col0, bool h_vec) {
  if (h_vec) {
    for (int idx = threadIdx.x; idx < BK * BN / 4; idx += THREADS) {
      const int r = idx / (BN / 4), c = 4 * (idx % (BN / 4));
      const int gr = k0 + r, gc = col0 + c;
      const bool in = gr < n && gc < f;
      cp_async16(&hs[r][c], in ? h + static_cast<size_t>(gr) * f + gc : h,
                 in ? 16 : 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gr = k0 + r, gc = col0 + c;
    hs[r][c] = gr < n && gc < f ? h[static_cast<size_t>(gr) * f + gc] : 0.f;
  }
}

// One block: the output tile (blockIdx.y, blockIdx.x) over the contraction
// range [blockIdx.z * k_split, + k_split). With one split (gridDim.z == 1)
// it writes out = acc + (1 + eps) * H; otherwise it writes its partial sum
// to ws[blockIdx.z] and gin_spmm_*_sum_kernel finishes the sum.
template <class T, typename TA, int MODE, bool TRANS>
__device__ __forceinline__ void
tc_tile(const TA* __restrict__ adj, const float* __restrict__ h,
        const float* __restrict__ eps, float* __restrict__ out,
        float* __restrict__ ws, int n, int f, int k_split, bool a_vec,
        bool h_vec) {
  using L = Layout<T, MODE, TRANS>;
  constexpr int MF = T::MF, NF = T::NF, BN = T::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  auto a_s = reinterpret_cast<__nv_bfloat16 (*)[L::A_ROWS][L::A_COLS]>(smem);
  auto h_s = reinterpret_cast<float (*)[BK][BN]>(smem + L::A_BYTES);
  auto hi_s = reinterpret_cast<__nv_bfloat16 (*)[L::HI_COLS]>(
      smem + L::A_BYTES + L::H_BYTES);
  auto lo_s = reinterpret_cast<__nv_bfloat16 (*)[L::HI_COLS]>(
      smem + L::A_BYTES + L::H_BYTES + L::HI_BYTES);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / T::WARPS_N) * T::WM, wn = (warp % T::WARPS_N) * T::WN;
  const int row0 = blockIdx.y * T::BM, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_split;
  const int nk = (min(n - k_begin, k_split) + BK - 1) / BK;

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto stage = [&](int kt) {
    const int s = kt % STAGES, k0 = k_begin + kt * BK;
    stage_a<T::THREADS, L::A_ROWS, L::A_COLS - PAD, TRANS>(a_s[s], adj, n,
                                                           row0, k0, a_vec);
    stage_h<T::THREADS, BN>(h_s[s], h, n, f, k0, col0, h_vec);
  };

#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < nk) stage(kt);
    cp_async_commit();                          // one group per slice
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    cp_async_wait<STAGES - 2>();                // slice kt has landed
    // Slice kt is visible to every thread, and every warp has finished
    // slice kt - 1: its ring slot and hi/lo may be overwritten.
    __syncthreads();
    if (kt + STAGES - 1 < nk) stage(kt + STAGES - 1);
    cp_async_commit();

    // Split (or round) H's slice once for the whole block.
    for (int idx = tid; idx < BK * BN / 4; idx += T::THREADS) {
      const int r = idx / (BN / 4), c = 4 * (idx % (BN / 4));
      const float4 v = *reinterpret_cast<const float4*>(&h_s[s][r][c]);
      const __nv_bfloat162 hi01 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi23 = __floats2bfloat162_rn(v.z, v.w);
      __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(&hi_s[r][c]);
      hi[0] = hi01;
      hi[1] = hi23;
      if constexpr (MODE == kSplit) {
        __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(&lo_s[r][c]);
        lo[0] = __floats2bfloat162_rn(v.x - __low2float(hi01),
                                      v.y - __high2float(hi01));
        lo[1] = __floats2bfloat162_rn(v.z - __low2float(hi23),
                                      v.w - __high2float(hi23));
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int m0 = wm + 16 * i;
        if constexpr (TRANS) {
          // Shared rows are the contraction: matrix q of the four is
          // (k + 8 * (q / 2), m + 8 * (q % 2)), read transposed.
          ldmatrix_x4_trans(af[i], &a_s[s][kk + lane % 8 + 8 * (lane / 16)]
                                       [m0 + 8 * ((lane / 8) % 2)]);
        } else {
          ldmatrix_x4(af[i], &a_s[s][m0 + lane % 16][kk + 8 * (lane / 16)]);
        }
      }
#pragma unroll
      for (int j = 0; j < NF; j += 2) {
        // Four 8 x 8 matrices: (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8)
        // -> the two b registers of fragments j and j + 1.
        const int kr = kk + lane % 8 + 8 * ((lane / 8) % 2);
        const int nc = wn + 8 * j + 8 * (lane / 16);
        uint32_t bh[4];
        ldmatrix_x4_trans(bh, &hi_s[kr][nc]);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          mma_bf16(acc[i][j], af[i], bh[0], bh[1]);
          mma_bf16(acc[i][j + 1], af[i], bh[2], bh[3]);
        }
        if constexpr (MODE == kSplit) {
          uint32_t bl[4];
          ldmatrix_x4_trans(bl, &lo_s[kr][nc]);
#pragma unroll
          for (int i = 0; i < MF; ++i) {
            mma_bf16(acc[i][j], af[i], bl[0], bl[1]);
            mma_bf16(acc[i][j + 1], af[i], bl[2], bl[3]);
          }
        }
      }
    }
  }

  // Fragment element e of (i, j): row g + 8 * (e / 2), column 2 t + e % 2.
  const bool whole = gridDim.z == 1;
  const float scale = 1.f + eps[0];
  float* dst = whole ? out : ws + static_cast<size_t>(blockIdx.z) * n * f;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + wm + 16 * i + g + 8 * (e / 2);
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int c = col0 + wn + 8 * j + 2 * t + e % 2;
        if (c < f) {
          const size_t o = static_cast<size_t>(r) * f + c;
          dst[o] = whole ? fmaf(scale, h[o], acc[i][j][e]) : acc[i][j][e];
        }
      }
    }
  }
}

// out = sum over the splits of ws + (1 + eps) * H, in split order.
__device__ __forceinline__ void sum_splits(const float* __restrict__ ws,
                                           int splits,
                                           const float* __restrict__ h,
                                           const float* __restrict__ eps,
                                           float* __restrict__ out,
                                           size_t total) {
  const float scale = 1.f + eps[0];
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = ws[i];
    for (int s = 1; s < splits; ++s) acc += ws[s * total + i];
    out[i] = fmaf(scale, h[i], acc);
  }
}

// ---------------------------------------------------------------------------
// SIMT design (HIGHEST)

constexpr int S_BM = 32;                        // output rows per block
constexpr int S_BN = 64;                        // output features per block
constexpr int S_TM = 4;                         // rows per thread
constexpr int S_TN = 4;                         // features per thread
constexpr int S_COLS = S_BN / S_TN;             // 16 threads across features
constexpr int S_THREADS = (S_BM / S_TM) * S_COLS;  // 128

template <typename TA, bool TRANS>
__device__ __forceinline__ void
simt_tile(const TA* __restrict__ adj, const float* __restrict__ h,
          const float* __restrict__ eps, float* __restrict__ out, int n,
          int f) {
  __shared__ float a_s[S_BM][BK + 1];           // +1: no bank conflicts
  __shared__ float h_s[BK][S_BN];

  const int tid = threadIdx.x;
  const int tx = tid % S_COLS;                  // features tx + S_COLS*j
  const int ty = tid / S_COLS;                  // rows ty*S_TM + i
  const int row0 = blockIdx.y * S_BM;
  const int col0 = blockIdx.x * S_BN;

  float acc[S_TM][S_TN];
#pragma unroll
  for (int i = 0; i < S_TM; ++i)
#pragma unroll
    for (int j = 0; j < S_TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    for (int idx = tid; idx < S_BM * BK; idx += S_THREADS) {
      // r: output row in the tile, c: position in the contraction slice.
      // The thread index runs along whichever of the two is A's column.
      const int r = TRANS ? idx % S_BM : idx / BK;
      const int c = TRANS ? idx / S_BM : idx % BK;
      const int gr = row0 + r, gc = k0 + c;
      a_s[r][c] = gr < n && gc < n
                      ? to_float(TRANS ? adj[static_cast<size_t>(gc) * n + gr]
                                       : adj[static_cast<size_t>(gr) * n + gc])
                      : 0.f;
    }
    for (int idx = tid; idx < BK * S_BN; idx += S_THREADS) {
      const int r = idx / S_BN, c = idx % S_BN;
      const int gr = k0 + r, gc = col0 + c;
      h_s[r][c] = gr < n && gc < f ? h[static_cast<size_t>(gr) * f + gc] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[S_TM];
#pragma unroll
      for (int i = 0; i < S_TM; ++i) a[i] = a_s[ty * S_TM + i][k];
#pragma unroll
      for (int j = 0; j < S_TN; ++j) {
        const float hv = h_s[k][tx + S_COLS * j];
#pragma unroll
        for (int i = 0; i < S_TM; ++i) acc[i][j] = fmaf(a[i], hv, acc[i][j]);
      }
    }
    __syncthreads();
  }

  const float scale = 1.f + eps[0];
#pragma unroll
  for (int i = 0; i < S_TM; ++i) {
    const int r = row0 + ty * S_TM + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < S_TN; ++j) {
      const int c = col0 + tx + S_COLS * j;
      if (c < f) {
        const size_t o = static_cast<size_t>(r) * f + c;
        out[o] = acc[i][j] + scale * h[o];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels and launch

// The tensor-core block tiles, largest first (the note at the top says how
// one is chosen), and the SIMT tile of HIGHEST.
using Tile64x64 = Tile<64, 64, 2, 2>;
using Tile32x64 = Tile<32, 64, 2, 2>;
using Tile32x32 = Tile<32, 32, 2, 2>;
constexpr int TILES[][2] = {{64, 64}, {32, 64}, {32, 32}};
constexpr int MAX_SPLITS = 4;
using SimtTile = Tile<S_BM, S_BN, 2, 2>;        // 128 threads

template <class T, typename TA, int MODE>
__global__ void __launch_bounds__(T::THREADS)
gin_spmm_fwd_kernel(const TA* __restrict__ adj, const float* __restrict__ h,
                    const float* __restrict__ eps, float* __restrict__ out,
                    float* __restrict__ ws, int n, int f, int k_split,
                    bool a_vec, bool h_vec) {
  if constexpr (MODE == kHighest) {
    simt_tile<TA, false>(adj, h, eps, out, n, f);
  } else {
    tc_tile<T, TA, MODE, false>(adj, h, eps, out, ws, n, f, k_split, a_vec,
                                h_vec);
  }
}

template <class T, typename TA, int MODE>
__global__ void __launch_bounds__(T::THREADS)
gin_spmm_bwd_kernel(const TA* __restrict__ adj, const float* __restrict__ g,
                    const float* __restrict__ eps, float* __restrict__ dh,
                    float* __restrict__ ws, int n, int f, int k_split,
                    bool a_vec, bool h_vec) {
  if constexpr (MODE == kHighest) {
    simt_tile<TA, true>(adj, g, eps, dh, n, f);
  } else {
    tc_tile<T, TA, MODE, true>(adj, g, eps, dh, ws, n, f, k_split, a_vec,
                               h_vec);
  }
}

__global__ void __launch_bounds__(256)
gin_spmm_fwd_sum_kernel(const float* __restrict__ ws, int splits,
                        const float* __restrict__ h,
                        const float* __restrict__ eps, float* __restrict__ out,
                        size_t total) {
  sum_splits(ws, splits, h, eps, out, total);
}

__global__ void __launch_bounds__(256)
gin_spmm_bwd_sum_kernel(const float* __restrict__ ws, int splits,
                        const float* __restrict__ g,
                        const float* __restrict__ eps, float* __restrict__ dh,
                        size_t total) {
  sum_splits(ws, splits, g, eps, dh, total);
}

struct Args {
  const void* adj;
  const float* h;
  const float* eps;
  float* out;
  float* ws;
  int n, f;
  bool a_vec, h_vec;
  cudaStream_t stream;
};

// Tile and contraction splits for (n, f) on `sms` SMs.
struct Plan {
  int tile;      // index into TILES
  int splits;    // contraction splits; > 1 sums partials in a second kernel
};

int k_split_of(int n, int splits) {
  const int slices = (n + BK - 1) / BK;
  return (slices + splits - 1) / splits * BK;
}

Plan plan(int n, int f, int sms) {
  Plan p{0, 1};
  long long tiles = 0;
  for (p.tile = 0; p.tile < 3; ++p.tile) {
    tiles = static_cast<long long>((n + TILES[p.tile][0] - 1) / TILES[p.tile][0]) *
            ((f + TILES[p.tile][1] - 1) / TILES[p.tile][1]);
    if (tiles >= sms || p.tile == 2) break;
  }
  p.splits = static_cast<int>(
      std::max(1LL, std::min<long long>(MAX_SPLITS, 4LL * sms / tiles)));
  const int k_split = k_split_of(n, p.splits);
  p.splits = (n + k_split - 1) / k_split;       // no empty split
  return p;
}

template <class T, typename TA, int MODE, bool TRANS>
void launch_tile(const Args& x, int splits) {
  constexpr int smem = MODE == kHighest ? 0 : Layout<T, MODE, TRANS>::BYTES;
  static_assert(smem <= 48 * 1024, "more dynamic shared memory than a "
                "launch may ask for without cudaFuncSetAttribute");
  const dim3 grid((x.f + T::BN - 1) / T::BN, (x.n + T::BM - 1) / T::BM,
                  splits);
  auto kernel = TRANS ? gin_spmm_bwd_kernel<T, TA, MODE>
                      : gin_spmm_fwd_kernel<T, TA, MODE>;
  kernel<<<grid, T::THREADS, smem, x.stream>>>(
      static_cast<const TA*>(x.adj), x.h, x.eps, x.out, x.ws, x.n, x.f,
      k_split_of(x.n, splits), x.a_vec, x.h_vec);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(x.n) * x.f;
    const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256,
                                                         65535));
    auto sum = TRANS ? gin_spmm_bwd_sum_kernel : gin_spmm_fwd_sum_kernel;
    sum<<<blocks, 256, 0, x.stream>>>(x.ws, splits, x.h, x.eps, x.out, total);
  }
}

template <typename TA, int MODE, bool TRANS>
void launch_tc(const Args& x, const Plan& p) {
  switch (p.tile) {
    case 0: launch_tile<Tile64x64, TA, MODE, TRANS>(x, p.splits); break;
    case 1: launch_tile<Tile32x64, TA, MODE, TRANS>(x, p.splits); break;
    default: launch_tile<Tile32x32, TA, MODE, TRANS>(x, p.splits); break;
  }
}

template <typename TA, bool TRANS>
void launch(const Args& x, int mode, const Plan& p) {
  switch (mode) {
    case kHighest: launch_tile<SimtTile, TA, kHighest, TRANS>(x, 1); break;
    case kSplit: launch_tc<TA, kSplit, TRANS>(x, p); break;
    default: launch_tc<TA, kBf16, TRANS>(x, p); break;
  }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        v <= 0) {
      return 132;
    }
    cached[device] = v;
  }
  return cached[device];
}

template <bool TRANS>
int run(const void* adj, int adj_is_bf16, const float* h, const float* eps,
        float* out, float* ws, int n, int f, int mode, int device,
        void* stream) {
  if (mode < kHighest || mode > kBf16 || n <= 0 || f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args x{adj,
               h,
               eps,
               out,
               ws,
               n,
               f,
               adj_is_bf16 && n % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(adj) % 16 == 0,
               f % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0,
               static_cast<cudaStream_t>(stream)};
  const Plan p = plan(n, f, sm_count(device));
  if (mode != kHighest && p.splits > 1 && ws == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (adj_is_bf16) {
    launch<__nv_bfloat16, TRANS>(x, mode, p);
  } else {
    launch<float, TRANS>(x, mode, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that K1 needs for (n, f, mode) on `device`: the partial
// sums of its contraction splits, 0 when it runs unsplit. The caller passes
// that much as `ws` to gin_spmm_fwd / gin_spmm_bwd.
extern "C" long long gin_spmm_workspace(int n, int f, int mode, int device) {
  if (mode == kHighest || n <= 0 || f <= 0) return 0;
  const Plan p = plan(n, f, sm_count(device));
  return p.splits > 1 ? static_cast<long long>(p.splits) * n * f : 0;
}

// Launches K1-fwd on `stream` and returns cudaGetLastError() (0 = launched).
// mode: 0 highest, 1 split, 2 bf16. adj_is_bf16: 1 for a bf16 A, 0 for f32.
// ws: gin_spmm_workspace(n, f, mode, device) floats of scratch (or null
// when that is 0).
extern "C" int gin_spmm_fwd(const void* adj, int adj_is_bf16, const float* h,
                            const float* eps, float* out, float* ws, int n,
                            int f, int mode, int device, void* stream) {
  return run<false>(adj, adj_is_bf16, h, eps, out, ws, n, f, mode, device,
                    stream);
}

// Launches K1-bwd: dh = A^T @ g + (1 + eps) * g, same arguments with the
// upstream gradient g [N,F] in h's place; A is read in place.
extern "C" int gin_spmm_bwd(const void* adj, int adj_is_bf16, const float* g,
                            const float* eps, float* dh, float* ws, int n,
                            int f, int mode, int device, void* stream) {
  return run<true>(adj, adj_is_bf16, g, eps, dh, ws, n, f, mode, device,
                   stream);
}

extern "C" const char* gin_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
