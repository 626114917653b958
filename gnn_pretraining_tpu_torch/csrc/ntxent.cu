// K2: the fused NT-Xent on Hopper tensor cores, forward and backward.
//
//   ntxent_fwd  per row r: loss_r = log(den_r) + mx_r - S[r, pos(r)], with
//               the max mx_r and denominator den_r of the masked row S[r, :]
//   ntxent_bwd  dZhat = G @ Zhat + G^T @ Zhat, in one pass over S
//
// Replaces gnn_pretraining_tpu/ops/ntxent_pallas.py: _fwd_kernel (the
// pl.pallas_call in _fwd_call), and _bwd_rows_kernel and _bwd_cols_kernel
// (the two pl.pallas_calls in _bwd_call), which ntxent_bwd computes
// together. S = Zhat Zhat^T / tau over the stacked, row-normalized
// projections Zhat = [z1; z2] (R = 2n rows, d <= 128 columns), with the
// diagonal and the invalid columns set to -1e30 as there; the positive of
// row r is column r + n (r < n) or r - n. The backward recomputes S tile by
// tile from the saved mx and den:
//   G[r, c] = (exp(S[r, c] - mx_r) / den_r - [c == pos(r)]) * g_r / tau.
// Nothing of size R x R is ever written to memory.
//
// Operands: Zhat [R, d] f32 row-major, valid [R] f32 (0/1), tau a 1-element
// f32 tensor on the device (read here, so no launch waits on the host); the
// backward also takes mx, den and g [R] f32. Results are f32.
//
// What bounds it on the H100: the forward does 2 R^2 d operations (S) and
// the backward 4 R^2 d (S, then one product with Zhat), on O(R d) bytes, so
// it is bound by operations; at the main path's rows (16 to 2640) the
// operations take 0.1 to 4 us at the tensor-core rate, and launch latency
// and the walk down a block's columns set the time.
//
// Design.
//   * Precision: S must hold the f32 formula to 1e-5 (|S| reaches 1/tau, so
//     one bf16 pass, as the TPU ran it, is 1e-2 off). The products run as
//     3xTF32 on mma.sync.m16n8k8 (tf32 in, f32 accumulate):
//     a_hi b_hi + a_hi b_lo + a_lo b_hi with hi = tf32(x), lo = tf32(x - hi),
//     about 22 bits of each operand. ntxent_split_kernel splits Zhat once
//     per call into a zero-padded [2][R][128] hi/lo array (and writes each
//     row's coefficients), so no block splits what it stages.
//   * Filling the card: a block owns a 32-row tile and a chunk of the
//     32-column tiles, which it walks through a 2-stage cp.async ring; the
//     host's plan (ops/ntxent.py: plan) picks the chunks so that about one
//     wave of 2 blocks per SM runs (R = 400: 13 x 13 blocks, 832: 26 x 9,
//     4104: 129 x 3). A block has 8 warps, each on 16 rows x 8 columns of
//     every tile: at 2 blocks per SM (their shared memory allows no more)
//     that is 16 warps to hide the latency of the fragment loads and MMAs,
//     which at 2 or 4 warps per SM set the time (measured on the H100).
//   * Forward: each thread keeps an online max and denominator (and the
//     positive logit) for its two rows over its columns; the four threads of
//     a row merge theirs by shuffles, then the column warps theirs through
//     shared memory in warp order. With one chunk the block writes the
//     result; otherwise it writes its chunk's partial, and the last block of
//     the row tile to finish (an integer counter, zeroed by the split kernel)
//     merges the partials in chunk order. The result is the same from run to
//     run: no float atomics, and a fixed merge order whichever block merges.
//   * Backward in one pass: the dot z_r . z_c gives both S[r, c] and S[c, r]
//     (their masks differ), so a block forms H = G[r, c] + G[c, r] for its
//     rows r and chunk's columns c and accumulates H @ Zhat_c into its rows'
//     dZhat: dZhat_r = sum_c (G[r, c] + G[c, r]) Zhat_c, the row term and the
//     column term of the TPU's two kernels. H goes from the accumulator
//     fragment straight into the A fragment of the second product, with the
//     contraction's column order permuted to match (k slot t <-> column 2t,
//     t + 4 <-> 2t + 1), and is split into hi/lo in registers. The column
//     warps' shares of dZhat are summed in warp order through shared memory,
//     the chunks' partials [chunks][R][d] in chunk order by the last block.
//   * Ragged rows and columns are zero-filled as staged and masked; columns
//     past R are -inf in the forward and 0 in H.
//   * NaN goes where the plain version puts it: the hi/lo split keeps a NaN
//     (tf32_round), and every running max is max.NaN, so a NaN in a valid,
//     unmasked entry of S makes its row's max, denominator and loss NaN,
//     and a NaN in H or Zhat reaches dZhat through the products. A masked
//     entry is -1e30 and a column past R -inf whatever Zhat holds there.
// Each warp reloads its rows' A fragments for every tile (4 warps share
// them): the shared-memory loads, 12 per 3 MMAs, bound the tile loop now.
// Wider loads (a permuted k order), fewer reloads, or wgmma with TMA would
// be the next steps.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int D_MAX = 128;                      // widest projection taken
constexpr int BM = 32;                          // rows per block
constexpr int BN = 32;                          // columns per tile
constexpr int WARPS_M = BM / 16;                // warps down the rows (16 each)
constexpr int WARPS_N = BN / 8;                 // warps across a tile (8 columns each)
constexpr int THREADS = 32 * WARPS_M * WARPS_N; // 256
constexpr int BLOCKS_PER_SM = 2;
constexpr int LD = D_MAX + 4;                   // shared row stride, floats
constexpr int OF = D_MAX / 8;                   // n8 fragments of a dZ row
constexpr int KSTEPS = D_MAX / 8;               // k8 steps over the features
constexpr int SPLIT_THREADS = 256;
constexpr int MAX_CHUNKS = 32;                  // column chunks a launch may take
constexpr float kMasked = -1e30f;               // the TPU kernel's mask value

// A row's coefficients, one float4 (made by the split kernel): the saved
// max, g / (tau den), g / tau (backward; 0 in the forward) and validity.
// Rows past R stage as zeros, so their G is 0. At the end of the backward
// the column ring holds the warps' dZ partials (red) instead.
struct Smem {
  float zi[2][BM][LD];                          // hi, lo of the block's rows
  union {
    float zj[2][2][BN][LD];                     // ring: hi, lo of a column tile
    float red[WARPS_N][BM][LD];                 // backward: each column warp's dZ
  };
  float4 aux[2][BN];                            // ring: its columns' coefficients
  float stats[3][WARPS_N][BM];                  // forward: each column warp's row stats
};
constexpr int SMEM_BYTES = sizeof(Smem);        // 103936: 2 blocks per SM

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero as cvt.rna does: the low 13 bits of the result are 0. A NaN or an
// infinity is returned as it is: the card's NaN is 0x7fffffff, which the
// rounding would carry into the sign bit and mask to -0, so that a NaN in
// Zhat or in H vanished from S and from dZhat.
__device__ __forceinline__ float tf32_round(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x7f800000u) == 0x7f800000u ? x
                                          : __uint_as_float((u + 0x1000u) & 0xffffe000u);
}

// max(a, b), NaN if either is (PTX max.NaN, sm_80 and later), as
// torch.max and jnp.maximum give it; fmaxf returns the other operand.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

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

// acc (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col). Not
// volatile: independent products may be scheduled between dependent ones.
__device__ __forceinline__ void mma_tf32(float (&acc)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int positive_of(int r, int rows) {
  const int half = rows / 2;
  return r < half ? r + half : r - half;
}

// Rows [r0, r0 + BM) of the hi/lo array zs [2][rows][D_MAX] into s.
__device__ __forceinline__ void stage_rows(float (*s)[BM][LD],
                                           const float* __restrict__ zs,
                                           int r0, int rows) {
  constexpr int CHUNKS = D_MAX / 4;             // 16-byte pieces of a row
  const size_t plane = static_cast<size_t>(rows) * D_MAX;
  for (int idx = threadIdx.x; idx < 2 * BM * CHUNKS; idx += THREADS) {
    const int p = idx / (BM * CHUNKS), r = (idx / CHUNKS) % BM;
    const int c = 4 * (idx % CHUNKS);
    const int gr = r0 + r;
    const bool in = gr < rows;
    cp_async16(&s[p][r][c], in ? zs + p * plane + static_cast<size_t>(gr) * D_MAX + c
                               : zs, in ? 16 : 0);
  }
}

// Column tile c0 (its hi/lo rows and coefficients) into ring slot `slot`.
__device__ __forceinline__ void stage_cols(Smem& sm, int slot,
                                           const float* __restrict__ zs,
                                           const float4* __restrict__ aux,
                                           int c0, int rows) {
  stage_rows(sm.zj[slot], zs, c0, rows);
  if (threadIdx.x < BN) {
    const int gc = c0 + threadIdx.x;
    const bool in = gc < rows;
    cp_async16(&sm.aux[slot][threadIdx.x], in ? aux + gc : aux, in ? 16 : 0);
  }
}

// The warp's 16 x 8 block of Zi Zj^T: rows wr.. of zi against rows wc.. of
// zj; element e is row g + 8 (e / 2), column 2t + e % 2 (g = lane / 4,
// t = lane % 4). Rows of LD = 132 floats put the 32 lanes of every fragment
// load in 32 banks. In 3xTF32, hi*hi and the small hi*lo + lo*hi go to
// separate accumulators, the even and odd k steps to separate ones too,
// summed at the end.
__device__ __forceinline__ void tile_dots(float (*zi)[BM][LD],
                                          float (*zj)[BN][LD], int wr, int wc,
                                          float (&acc)[4]) {
  constexpr int KG = 2;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float big[KG][4], small[KG][4];
#pragma unroll
  for (int q = 0; q < KG; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) big[q][e] = small[q][e] = 0.f;
#pragma unroll
  for (int ks0 = 0; ks0 < KSTEPS; ks0 += KG) {
#pragma unroll
    for (int q = 0; q < KG; ++q) {
      const int k = 8 * (ks0 + q) + t;
      const uint32_t ah[4] = {bits(zi[0][wr + g][k]), bits(zi[0][wr + g + 8][k]),
                              bits(zi[0][wr + g][k + 4]), bits(zi[0][wr + g + 8][k + 4])};
      const uint32_t al[4] = {bits(zi[1][wr + g][k]), bits(zi[1][wr + g + 8][k]),
                              bits(zi[1][wr + g][k + 4]), bits(zi[1][wr + g + 8][k + 4])};
      const uint32_t bh0 = bits(zj[0][wc + g][k]), bh1 = bits(zj[0][wc + g][k + 4]);
      mma_tf32(small[q], al, bh0, bh1);
      mma_tf32(big[q], ah, bh0, bh1);
      mma_tf32(small[q], ah, bits(zj[1][wc + g][k]), bits(zj[1][wc + g][k + 4]));
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float b = big[0][e], sm = small[0][e];
#pragma unroll
    for (int q = 1; q < KG; ++q) {
      b += big[q][e];
      sm += small[q][e];
    }
    acc[e] = b + sm;
  }
}

// After every thread wrote its block's partial: true in the last block of
// row tile blockIdx.x to get here (count[] zeroed by the split kernel).
__device__ __forceinline__ bool last_of_row_tile(int* __restrict__ count) {
  __shared__ bool last;
  __threadfence();                              // partials visible first
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&count[blockIdx.x], 1) == static_cast<int>(gridDim.y) - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__global__ void __launch_bounds__(SPLIT_THREADS)
ntxent_split_kernel(const float* __restrict__ z, const float* __restrict__ valid,
                    const float* __restrict__ temp, const float* __restrict__ mx,
                    const float* __restrict__ den, const float* __restrict__ g,
                    float* __restrict__ zs, float4* __restrict__ aux,
                    int* __restrict__ count, int rows, int d, int row_tiles) {
  const float tau = temp[0];
  const size_t total = static_cast<size_t>(rows) * D_MAX;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / D_MAX), k = static_cast<int>(i % D_MAX);
    const float x = k < d ? z[static_cast<size_t>(r) * d + k] : 0.f;
    const float hi = tf32_round(x);
    zs[i] = hi;
    zs[total + i] = tf32_round(x - hi);
    if (k == 0) {
      aux[r] = mx == nullptr
                   ? make_float4(0.f, 0.f, 0.f, valid[r])
                   : make_float4(mx[r], g[r] / (tau * den[r]), g[r] / tau, valid[r]);
    }
    if (i < static_cast<size_t>(row_tiles)) count[i] = 0;
  }
}

// Block layout shared by the product kernels: warp (wm, wn) owns rows
// wr = 16 wm.. of the row tile and columns wc = 8 wn.. of each column tile.
struct Place {
  int lane, g, t, wn, wr, wc, r0, j0, j1;
  int gr[2], pos_col[2];                        // the thread's rows g, g + 8
  __device__ Place(int rows, int tiles_per_chunk) {
    lane = threadIdx.x % 32;
    g = lane / 4;
    t = lane % 4;
    const int warp = threadIdx.x / 32;
    wn = warp % WARPS_N;
    wr = 16 * (warp / WARPS_N);
    wc = 8 * wn;
    r0 = blockIdx.x * BM;
    j0 = blockIdx.y * tiles_per_chunk;
    j1 = min(j0 + tiles_per_chunk, (rows + BN - 1) / BN);
    gr[0] = r0 + wr + g;
    gr[1] = gr[0] + 8;
    pos_col[0] = positive_of(gr[0], rows);
    pos_col[1] = positive_of(gr[1], rows);
  }
};

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
ntxent_fwd_kernel(const float* __restrict__ zs, const float4* __restrict__ aux,
                  const float* __restrict__ temp, float* __restrict__ loss,
                  float* __restrict__ mx_out, float* __restrict__ den_out,
                  float* __restrict__ part, int* __restrict__ count, int rows,
                  int tiles_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  const Place at(rows, tiles_per_chunk);
  const int t = at.t;
  const float tau = temp[0];

  float mx[2] = {kMasked, kMasked}, den[2] = {0.f, 0.f}, pos[2] = {0.f, 0.f};

  stage_rows(sm.zi, zs, at.r0, rows);
  stage_cols(sm, 0, zs, aux, at.j0 * BN, rows);
  cp_async_commit();
  for (int j = at.j0; j < at.j1; ++j) {
    const int slot = (j - at.j0) & 1;
    if (j + 1 < at.j1) stage_cols(sm, slot ^ 1, zs, aux, (j + 1) * BN, rows);
    cp_async_commit();
    cp_async_wait<1>();                         // tile j has landed
    __syncthreads();
    float acc[4];
    tile_dots(sm.zi, sm.zj[slot], at.wr, at.wc, acc);
    const int c0 = j * BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {               // rows g, g + 8
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int cl = at.wc + 2 * t + q, gc = c0 + cl;
        v[q] = gc >= rows ? -CUDART_INF_F
               : (at.gr[h] == gc || !(sm.aux[slot][cl].w > 0.f)) ? kMasked
                                                                : acc[2 * h + q] / tau;
        if (gc == at.pos_col[h]) pos[h] += v[q];
      }
      const float m_new = max_nan(mx[h], max_nan(v[0], v[1]));
      den[h] = den[h] * expf(mx[h] - m_new) + (expf(v[0] - m_new) + expf(v[1] - m_new));
      mx[h] = m_new;
    }
    __syncthreads();                            // slot is free for tile j + 2
  }

  // The four threads of a row merge their columns, then the column warps
  // theirs, in warp order.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, mx[h], o);
      const float d_o = __shfl_xor_sync(0xffffffffu, den[h], o);
      const float m = max_nan(mx[h], m_o);
      den[h] = den[h] * expf(mx[h] - m) + d_o * expf(m_o - m);
      mx[h] = m;
      pos[h] += __shfl_xor_sync(0xffffffffu, pos[h], o);
    }
    if (t == 0) {
      const int row = at.wr + at.g + 8 * h;
      sm.stats[0][at.wn][row] = mx[h];
      sm.stats[1][at.wn][row] = den[h];
      sm.stats[2][at.wn][row] = pos[h];
    }
  }
  __syncthreads();
  const int chunks = gridDim.y;
  const int r = at.r0 + threadIdx.x;
  if (threadIdx.x < BM && r < rows) {
    float m = sm.stats[0][0][threadIdx.x], d = sm.stats[1][0][threadIdx.x];
    float p = sm.stats[2][0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w) {
      const float m_w = sm.stats[0][w][threadIdx.x];
      const float m_new = max_nan(m, m_w);
      d = d * expf(m - m_new) + sm.stats[1][w][threadIdx.x] * expf(m_w - m_new);
      m = m_new;
      p += sm.stats[2][w][threadIdx.x];
    }
    if (chunks == 1) {
      loss[r] = logf(d) + m - p;
      mx_out[r] = m;
      den_out[r] = d;
    } else {
      const size_t o = static_cast<size_t>(blockIdx.y) * rows + r;
      part[o] = m;
      part[static_cast<size_t>(chunks) * rows + o] = d;
      part[2 * static_cast<size_t>(chunks) * rows + o] = p;
    }
  }
  if (chunks == 1 || !last_of_row_tile(count)) return;

  // The row tile's chunks, merged in chunk order, a thread per row, with
  // the loads of 8 chunks in flight at once.
  if (threadIdx.x >= BM || r >= rows) return;
  const size_t plane = static_cast<size_t>(chunks) * rows;
  float m = kMasked, sum = 0.f, p = 0.f;
  for (int k0 = 0; k0 < chunks; k0 += 8) {
    float m_k[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      m_k[q] = k0 + q < chunks ? __ldcg(part + static_cast<size_t>(k0 + q) * rows + r)
                               : kMasked;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) m = max_nan(m, m_k[q]);
  }
  for (int k0 = 0; k0 < chunks; k0 += 8) {
    float m_k[8], d_k[8], p_k[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const size_t o = static_cast<size_t>(k0 + q) * rows + r;
      const bool in = k0 + q < chunks;
      m_k[q] = in ? __ldcg(part + o) : 0.f;
      d_k[q] = in ? __ldcg(part + plane + o) : 0.f;
      p_k[q] = in ? __ldcg(part + 2 * plane + o) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (k0 + q < chunks) {
        sum += d_k[q] * expf(m_k[q] - m);
        p += p_k[q];
      }
    }
  }
  loss[r] = logf(sum) + m - p;
  mx_out[r] = m;
  den_out[r] = sum;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
ntxent_bwd_kernel(const float* __restrict__ zs, const float4* __restrict__ aux,
                  const float* __restrict__ temp, float* __restrict__ dz,
                  float* __restrict__ part, int* __restrict__ count, int rows,
                  int d, int tiles_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  const Place at(rows, tiles_per_chunk);
  const int g = at.g, t = at.t;
  const float tau = temp[0];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 ar[2] = {at.gr[0] < rows ? aux[at.gr[0]] : zero,
                        at.gr[1] < rows ? aux[at.gr[1]] : zero};

  // This warp's share of dZ of rows g, g + 8 (its columns only): fragment o
  // holds features 8o + 2t + e % 2.
  float out[OF][4];
#pragma unroll
  for (int o = 0; o < OF; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[o][e] = 0.f;

  stage_rows(sm.zi, zs, at.r0, rows);
  stage_cols(sm, 0, zs, aux, at.j0 * BN, rows);
  cp_async_commit();
  for (int j = at.j0; j < at.j1; ++j) {
    const int slot = (j - at.j0) & 1;
    if (j + 1 < at.j1) stage_cols(sm, slot ^ 1, zs, aux, (j + 1) * BN, rows);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float acc[4];
    tile_dots(sm.zi, sm.zj[slot], at.wr, at.wc, acc);
    const int c0 = j * BN;
    // acc -> H = G[r, c] + G[c, r], in place.
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e / 2, cl = at.wc + 2 * t + e % 2;
      const int r = at.gr[h], c = c0 + cl;
      float hv = 0.f;
      if (c < rows) {
        const float4 ac = sm.aux[slot][cl];
        const float s_rc = (r == c || !(ac.w > 0.f)) ? kMasked : acc[e] / tau;
        const float s_cr = (r == c || !(ar[h].w > 0.f)) ? kMasked : acc[e] / tau;
        hv = expf(s_rc - ar[h].x) * ar[h].y - (c == at.pos_col[h] ? ar[h].z : 0.f);
        hv += expf(s_cr - ac.x) * ac.y - (r == positive_of(c, rows) ? ac.z : 0.f);
      }
      acc[e] = hv;
    }
    // out += H (16 x 8) @ Zhat_j's rows wc.. (8 x 128). H's fragment is the A
    // fragment of one contraction step with k slot t <-> column 2t and slot
    // t + 4 <-> column 2t + 1, so B takes Zhat_j's rows wc + 2t and + 1. In
    // 3xTF32 pass by pass over the 16 output fragments.
    const float a[4] = {acc[0], acc[2], acc[1], acc[3]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hi = tf32_round(a[e]);
      ah[e] = bits(hi);
      al[e] = bits(tf32_round(a[e] - hi));
    }
    float (*zj)[BN][LD] = sm.zj[slot];
    const int kr = at.wc + 2 * t;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int half = p == 1 ? 1 : 0;          // Zhat_j's lo in pass 1
      const uint32_t (&x)[4] = p == 0 ? al : ah;
#pragma unroll
      for (int o = 0; o < OF; ++o) {
        mma_tf32(out[o], x, bits(zj[half][kr][8 * o + g]),
                 bits(zj[half][kr + 1][8 * o + g]));
      }
    }
    __syncthreads();
  }

  // The column warps' shares, summed in warp order through the ring.
#pragma unroll
  for (int o = 0; o < OF; ++o) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sm.red[at.wn][at.wr + g + 8 * (e / 2)][8 * o + 2 * t + e % 2] = out[o][e];
    }
  }
  __syncthreads();
  const int chunks = gridDim.y;
  float* dst = chunks == 1 ? dz : part + static_cast<size_t>(blockIdx.y) * rows * d;
  for (int i = threadIdx.x; i < BM * D_MAX; i += THREADS) {
    const int row = i / D_MAX, k = i % D_MAX, r = at.r0 + row;
    if (r >= rows || k >= d) continue;
    float sum = sm.red[0][row][k];
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w) sum += sm.red[w][row][k];
    dst[static_cast<size_t>(r) * d + k] = sum;
  }
  if (chunks == 1 || !last_of_row_tile(count)) return;

  // The row tile's rows are one contiguous range of dZ: sum the chunks'
  // partials of it in chunk order, with a chunk's loads (4 float4 a
  // thread) all in flight at once.
  const size_t begin = static_cast<size_t>(at.r0) * d;
  const size_t plane = static_cast<size_t>(rows) * d;
  const int n = (min(at.r0 + BM, rows) - at.r0) * d;
  if (d % 4 != 0) {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      float sum = 0.f;
      for (int k = 0; k < chunks; ++k) sum += __ldcg(part + k * plane + begin + i);
      dz[begin + i] = sum;
    }
    return;
  }
  constexpr int PER = BM * D_MAX / 4 / THREADS;
  float4 acc4[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) acc4[q] = zero;
  for (int k = 0; k < chunks; ++k) {
    const float4* src = reinterpret_cast<const float4*>(part + k * plane + begin);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + THREADS * q;
      if (4 * e < n) {
        const float4 v = __ldcg(src + e);
        acc4[q].x += v.x;
        acc4[q].y += v.y;
        acc4[q].z += v.z;
        acc4[q].w += v.w;
      }
    }
  }
  float4* dz4 = reinterpret_cast<float4*>(dz + begin);
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + THREADS * q;
    if (4 * e < n) dz4[e] = acc4[q];
  }
}

__global__ void ntxent_empty_kernel() {}

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

template <class Kernel>
cudaError_t allow_smem(Kernel* kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Checks the plan (every column tile in exactly one chunk, no chunk empty,
// scratch for a split plan), sets the device and the product kernels'
// shared memory, and launches the split kernel.
int prepare(const float* z, const float* valid, const float* temp,
            const float* mx, const float* den, const float* g, float* zs,
            void* aux, const float* part, int* count, int rows, int d,
            int chunks, int tiles_per_chunk, int device, cudaStream_t stream) {
  const int tiles = (rows + BN - 1) / BN;
  if (rows <= 0 || d <= 0 || d > D_MAX || chunks <= 0 || tiles_per_chunk <= 0 ||
      static_cast<long long>(chunks) * tiles_per_chunk < tiles ||
      static_cast<long long>(chunks - 1) * tiles_per_chunk >= tiles ||
      chunks > MAX_CHUNKS || zs == nullptr || aux == nullptr ||
      reinterpret_cast<uintptr_t>(zs) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(aux) % 16 != 0 ||
      (chunks > 1 && (part == nullptr || count == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool ready[64] = {false};
  if (!ready[device]) {     // more than 48 KB, and the SM's shared memory for 2
    err = allow_smem(ntxent_fwd_kernel);
    if (err == cudaSuccess) err = allow_smem(ntxent_bwd_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const long long total = static_cast<long long>(rows) * D_MAX;
  const int blocks = static_cast<int>(std::min<long long>(
      (total + SPLIT_THREADS - 1) / SPLIT_THREADS, 8LL * sm_count(device)));
  ntxent_split_kernel<<<blocks, SPLIT_THREADS, 0, stream>>>(
      z, valid, temp, mx, den, g, zs, static_cast<float4*>(aux),
      chunks > 1 ? count : nullptr, rows, d, chunks > 1 ? tiles : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches the split kernel and one product kernel on `stream`
// and returns cudaGetLastError() (0 = launched). rows = R = 2n, d <= 128.
// Scratch from the caller: zs 2 * rows * 128 floats and aux rows float4
// (both 16-byte aligned); with chunks > 1 also part (forward 3 * chunks *
// rows floats, backward chunks * rows * d) and count (row tiles ints). The
// grid is (ceil(rows / 32), chunks), chunk c taking column tiles
// [c * tiles_per_chunk, (c + 1) * tiles_per_chunk).
extern "C" int ntxent_fwd(const float* z, const float* valid, const float* temp,
                          float* loss, float* mx, float* den, float* zs,
                          void* aux, float* part, int* count, int rows, int d,
                          int chunks, int tiles_per_chunk, int device,
                          void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (int bad = prepare(z, valid, temp, nullptr, nullptr, nullptr, zs, aux, part,
                        count, rows, d, chunks, tiles_per_chunk, device, st)) {
    return bad;
  }
  const dim3 grid((rows + BM - 1) / BM, chunks);
  ntxent_fwd_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      zs, static_cast<const float4*>(aux), temp, loss, mx, den, part, count, rows,
      tiles_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

// dz = G @ Zhat + G^T @ Zhat [rows, d], from the saved mx, den and the
// per-row upstream gradient g [rows]; scratch as for ntxent_fwd.
extern "C" int ntxent_bwd(const float* z, const float* valid, const float* temp,
                          const float* mx, const float* den, const float* g,
                          float* dz, float* zs, void* aux, float* part,
                          int* count, int rows, int d, int chunks,
                          int tiles_per_chunk, int device, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (mx == nullptr || den == nullptr || g == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (int bad = prepare(z, valid, temp, mx, den, g, zs, aux, part, count, rows, d,
                        chunks, tiles_per_chunk, device, st)) {
    return bad;
  }
  const dim3 grid((rows + BM - 1) / BM, chunks);
  ntxent_bwd_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      zs, static_cast<const float4*>(aux), temp, dz, part, count, rows, d,
      tiles_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the forward (backward = 0) or backward product kernel that one
// SM holds at once (the occupancy calculator, after the launch attributes
// are set), or a negative CUDA error.
extern "C" int ntxent_blocks_per_sm(int backward, int device) {
  if (device < 0 || device >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = backward ? allow_smem(ntxent_bwd_kernel) : allow_smem(ntxent_fwd_kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = backward ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ntxent_bwd_kernel,
                                                                   THREADS, SMEM_BYTES)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ntxent_fwd_kernel,
                                                                   THREADS, SMEM_BYTES);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// One launch of an empty kernel: the device time of a launch, the floor
// under every K2 call (which is two launches). A timing aid; no path runs it.
extern "C" int ntxent_launch_floor(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntxent_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
