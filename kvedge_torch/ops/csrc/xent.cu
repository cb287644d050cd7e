// Fused softmax cross-entropy of the tied readout for Hopper (sm_90a),
// CUDA C++: the forward and its two backward passes.
//
// Replaces the three TPU kernels of kvedge_tpu/ops/xent.py that the
// reference wires together with a custom_vjp (`fused_xent`):
//   kvedge_xent_fwd    <- `_fwd_kernel` (:72, via `_xent_fwd_raw`)
//   kvedge_xent_bwd_dx <- `_dx_kernel`  (:115, via `_fused_xent_bwd`)
//   kvedge_xent_bwd_de <- `_de_kernel`  (:148, via `_fused_xent_bwd`)
// on x [N, D] and the embedding E [V, D] (row-major, contiguous, both in
// the compute dtype: bf16 or fp32), targets [N] int32 already wrapped and
// clipped into [0, V) by the wrapper, D in {64, 128, 256, 512}, any
// N, V >= 1 (partial tiles are masked). No [N, V] tensor is written.
//
// Rounding points, each the reference's:
//   forward: s = x . E^T accumulated in fp32 and never rounded; an fp32
//            running max m and sum l over the vocab, lse = m + log(l);
//            the target logit is s at the target column, exactly.
//   dx:      p = exp(s - lse) in fp32 (the bf16 kernels take it as
//            2^((s - lse) log2 e) on the hardware's ex2, within a few
//            fp32 ulps), ds = (p - onehot) * g in fp32,
//            dx += (ds -> dtype) . E in fp32, dx -> x's dtype.
//   dE:      the same ds, dE += (ds -> dtype)^T . x in fp32, kept fp32.
// Products of bf16 values are exact in fp32, so an fp32-accumulated
// product of dtype-rounded operands is the reference's bf16-operand,
// fp32-accumulate dot; only the order of the fp32 sums differs.
//
// Work and bound. Each pass computes every s (2 N V D operations); dx and
// dE add one product each (2 N V D more). At the flagship training shape
// (N 32768, V 32000, D 512, bf16) that is 1.07 TFLOP for the forward and
// 2.15 TFLOP for each backward pass: 1.09 / 2.17 / 2.17 ms at the 989
// TFLOP/s bf16 tensor-core peak, against 66.6 / 66.9 / 99.6 MB read once
// and written once (0.02-0.03 ms at 3.35 TB/s). All three are bound by
// the operations.
//
// Design. The TPU kernels carry their state across a sequential grid axis
// in VMEM; here one CTA owns a tile of resident rows and loops over every
// tile of the other operand inside itself, so nothing is carried between
// CTAs and there are no atomics: the backward run twice is bit-identical.
//   forward: a CTA owns 32 rows of x and streams E in 64-row tiles,
//            keeping the running max, sum and target logit of its rows.
//   dx:      a CTA owns rows of x and streams E; per tile it forms ds
//            [rows x 64] and accumulates dx [rows x D] += ds . E_tile.
//   dE:      a CTA owns rows of E and streams x in 64-row tiles; per
//            tile it forms ds^T [rows x 64] and accumulates
//            dE [rows x D] += ds^T . x_tile.
// The bf16 backward (B6, B7) is built for Hopper: 64 resident rows, the
// streamed tiles by TMA into an mbarrier ring, both products on wgmma
// (section "bf16, B6 and B7" below). The
// bf16 forward (B5) runs on the tensor cores with mma.sync m16n8k16 (bf16
// operands, fp32 accumulation): 8 warps, 32 resident rows; for the score
// tile warp w owns rows 16 (w & 1) .. +15 and columns 16 (w >> 1) .. +15,
// so a row's online softmax spans 4 warps and its max and sum are
// combined through shared memory; its tiles are loaded synchronously.
// fp32 has no tensor-core path of full fp32 precision (TF32 would round
// the operands), so it runs on the CUDA cores with fp32 FMA: 32 resident
// rows, thread (ty, tx) of 16 x 16 owns score rows ty + 16 i (i < 2) and
// columns tx + 16 j (j < 4), so a row's max and sum reduce over a
// half-warp, and output columns tx + 16 c.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 32;      // resident rows of a CTA
constexpr int kCols = 64;      // rows of a streamed tile (score columns)
constexpr int kThreads = 256;  // 8 warps; 16 x 16 on the fp32 path
constexpr int kLdsF32 = kCols + 1;   // row stride of the fp32 ds tile

__device__ __forceinline__ float half_warp_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
}

__device__ __forceinline__ float half_warp_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// ds = (exp(s - lse) - onehot) * g for one score, 0 where `valid` is false.
__device__ __forceinline__ float cotangent(float s, float lse, int target,
                                           float g, int vocab, bool valid) {
  if (!valid) return 0.f;
  return (expf(s - lse) - (vocab == target ? 1.f : 0.f)) * g;
}

// The row parameters of a backward pass, staged in shared memory: for dx
// those of the CTA's resident x rows, for dE those of the streamed tile.
// Rows at or past `n` read lse 0, target -1 and g 0, so their ds is 0.
__device__ __forceinline__ void load_params(float* lse_s, int* tgt_s,
                                            float* g_s, const float* lse,
                                            const int* tgt, const float* g,
                                            int row0, int count, int n) {
  if (threadIdx.x < count) {
    const int row = row0 + threadIdx.x;
    const bool in = row < n;
    lse_s[threadIdx.x] = in ? lse[row] : 0.f;
    tgt_s[threadIdx.x] = in ? tgt[row] : -1;
    g_s[threadIdx.x] = in ? g[row] : 0.f;
  }
}

// ---- fp32: CUDA-core FMA -------------------------------------------------

// dst[r * (D + 1) + c] = src[(row0 + r) * D + c] for r < ROWS; rows at or
// past `nrows` read as zero. The odd stride puts the 16 rows a half-warp
// reads along D on 16 banks.
template <int D, int ROWS>
__device__ __forceinline__ void load_f32(float* dst,
                                         const float* __restrict__ src,
                                         int row0, int nrows) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < nrows ? src[static_cast<size_t>(row) * D + c] : 0.f;
  }
}

// s[i][j] = A[ty + 16 i, :] . B[tx + 16 j, :] (i < 2, j < 4).
template <int D>
__device__ __forceinline__ void score_f32(float (&s)[2][4], const float* A,
                                          const float* B, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[2], b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// ---- fp32, B5: forward -----------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
xent_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    const int* __restrict__ tgt, float* __restrict__ lse,
                    float* __restrict__ tlogit, int n, int v) {
  extern __shared__ float smem[];
  float* Xs = smem;                  // [kRows][D + 1]
  float* Es = Xs + kRows * (D + 1);  // [kCols][D + 1]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kRows;
  load_f32<D, kRows>(Xs, x, row0, n);

  int tg[2];
  float m[2], l[2], tl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ty + 16 * i;
    tg[i] = row < n ? tgt[row] : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
    tl[i] = 0.f;
  }

  for (int c0 = 0; c0 < v; c0 += kCols) {
    __syncthreads();  // the previous tile is no longer read
    load_f32<D, kCols>(Es, e, c0, v);
    __syncthreads();
    float s[2][4];
    score_f32<D>(s, Xs, Es, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col >= v) {
          s[i][j] = -INFINITY;
        } else if (col == tg[i]) {
          tl[i] += s[i][j];  // the one target column: exact
        }
        mx = fmaxf(mx, s[i][j]);
      }
      // Column c0 of every tile is in range, so m_new is finite.
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float t = half_warp_sum(tl[i]);
    const int row = row0 + ty + 16 * i;
    if (tx == 0 && row < n) {
      lse[row] = m[i] + logf(l[i]);
      tlogit[row] = t;
    }
  }
}

// ---- fp32, B6 (kDx) and B7 (!kDx): backward --------------------------------
// B6: A = x rows (resident), B = E rows (streamed), out = dx [N, D].
// B7: A = E rows (resident), B = x rows (streamed), out = dE [V, D].
template <int D, bool kDx>
__global__ void __launch_bounds__(kThreads)
xent_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    const int* __restrict__ tgt, const float* __restrict__ lse,
                    const float* __restrict__ g, float* __restrict__ out,
                    int n, int v) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* As = smem;              // [kRows][LD]
  float* Bs = As + kRows * LD;   // [kCols][LD]
  float* Ds = Bs + kCols * LD;   // [kRows][kLdsF32]
  __shared__ float lse_s[kCols], g_s[kCols];
  __shared__ int tgt_s[kCols];

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* a_src = kDx ? x : e;
  const float* b_src = kDx ? e : x;
  const int a_rows = kDx ? n : v;
  const int b_rows = kDx ? v : n;
  const int a0 = blockIdx.x * kRows;

  load_f32<D, kRows>(As, a_src, a0, a_rows);
  if (kDx) load_params(lse_s, tgt_s, g_s, lse, tgt, g, a0, kRows, n);
  float acc[2][DC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int b0 = 0; b0 < b_rows; b0 += kCols) {
    __syncthreads();  // the previous tile and its ds are no longer read
    load_f32<D, kCols>(Bs, b_src, b0, b_rows);
    if (!kDx) load_params(lse_s, tgt_s, g_s, lse, tgt, g, b0, kCols, n);
    __syncthreads();
    float s[2][4];
    score_f32<D>(s, As, Bs, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;  // resident row
        const int c = tx + 16 * j;  // streamed row
        const int p = kDx ? r : c;  // the x row whose parameters apply
        Ds[r * kLdsF32 + c] = cotangent(s[i][j], lse_s[p], tgt_s[p], g_s[p],
                                        kDx ? b0 + c : a0 + r,
                                        b0 + c < b_rows);
      }
    __syncthreads();  // ds complete
#pragma unroll 4
    for (int k = 0; k < kCols; ++k) {
      const float d0 = Ds[ty * kLdsF32 + k];
      const float d1 = Ds[(ty + 16) * kLdsF32 + k];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float b = Bs[k * LD + tx + 16 * c];
        acc[0][c] = fmaf(d0, b, acc[0][c]);
        acc[1][c] = fmaf(d1, b, acc[1][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = a0 + ty + 16 * i;
    if (row >= a_rows) continue;
    float* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c];
  }
}

// ---- bf16: tensor-core tiles (mma.sync m16n8k16, fp32 accumulation) -----
//
// Shared-memory rows are padded by 8 elements so that the fragment loads
// of a warp fall on 32 different banks. Accumulator element e of n tile
// nt sits at tile row g + 8 (e / 2) and tile column 8 nt + 2 t + e % 2,
// with (g, t) = (lane / 4, lane % 4).

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ROWS rows of a [.., D] bf16 array into shared memory, row stride D + 8,
// in 16-byte vectors; rows at or past `nrows` read as zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_bf16(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int row0, int nrows) {
  constexpr int LD = D + 8;
  constexpr int V = D / 8;
  for (int i = threadIdx.x; i < ROWS * V; i += kThreads) {
    const int r = i / V;
    const int c = (i % V) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// s[nt] = A[16 rg + 0..15, :] . B[16 cg + 8 nt + 0..7, :]^T (nt < 2): the
// warp's 16 x 16 block of the [32 x 64] score tile, A and B row-major.
template <int D>
__device__ __forceinline__ void score_bf16(float (&s)[2][4], const bf16* A,
                                           const bf16* B, int rg, int cg,
                                           int g, int t) {
  constexpr int LD = D + 8;
  zero(s);
  const bf16* a = A + (16 * rg + g) * LD + 2 * t;
  const bf16* b = B + (16 * cg + g) * LD + 2 * t;
#pragma unroll 8
  for (int kc = 0; kc < D / 16; ++kc) {
    const int kk = kc * 16;
    const uint32_t a0 = ld32(a + kk);
    const uint32_t a1 = ld32(a + 8 * LD + kk);
    const uint32_t a2 = ld32(a + kk + 8);
    const uint32_t a3 = ld32(a + 8 * LD + kk + 8);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const bf16* y = b + 8 * nt * LD + kk;
      mma16816(s[nt], a0, a1, a2, a3, ld32(y), ld32(y + 8));
    }
  }
}

// ---- bf16, B5: forward -----------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
xent_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ e,
                     const int* __restrict__ tgt, float* __restrict__ lse,
                     float* __restrict__ tlogit, int n, int v) {
  constexpr int LD = D + 8;
  extern __shared__ uint4 smem_vec[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_vec);  // [kRows][LD]
  bf16* Es = Xs + kRows * LD;                    // [kCols][LD]
  // Per-row partials of the 4 column groups: the tile max, then the sum.
  __shared__ float part_max[4][kRows], part_sum[4][kRows];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = warp & 1;
  const int cg = warp >> 1;
  const int row0 = blockIdx.x * kRows;
  load_bf16<D, kRows>(Xs, x, row0, n);

  int tg[2];
  float m[2], l[2], tl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * rg + g + 8 * h;
    tg[h] = row < n ? tgt[row] : -1;
    m[h] = -INFINITY;
    l[h] = 0.f;
    tl[h] = 0.f;
  }

  for (int c0 = 0; c0 < v; c0 += kCols) {
    __syncthreads();  // the previous tile and partials are no longer read
    load_bf16<D, kCols>(Es, e, c0, v);
    __syncthreads();
    float s[2][4];
    score_bf16<D>(s, Xs, Es, rg, cg, g, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q >> 1;
        const int col = c0 + 16 * cg + 8 * nt + 2 * t + (q & 1);
        if (col >= v) {
          s[nt][q] = -INFINITY;
        } else if (col == tg[h]) {
          tl[h] += s[nt][q];  // the one target column: exact
        }
        mx[h] = fmaxf(mx[h], s[nt][q]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      if (t == 0) part_max[cg][16 * rg + g + 8 * h] = mx[h];
    }
    __syncthreads();
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * rg + g + 8 * h;
      // Column c0 of every tile is in range, so m_new is finite.
      m_new[h] = fmaxf(m[h], fmaxf(fmaxf(part_max[0][r], part_max[1][r]),
                                   fmaxf(part_max[2][r], part_max[3][r])));
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[q >> 1] += expf(s[nt][q] - m_new[q >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = quad_sum(sum[h]);
      if (t == 0) part_sum[cg][16 * rg + g + 8 * h] = sum[h];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * rg + g + 8 * h;
      l[h] = l[h] * expf(m[h] - m_new[h]) +
             ((part_sum[0][r] + part_sum[1][r]) +
              (part_sum[2][r] + part_sum[3][r]));
      m[h] = m_new[h];
    }
  }

  // The target logit: one column group holds it, the others add zeros.
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tl[h] = quad_sum(tl[h]);
    if (t == 0) part_sum[cg][16 * rg + g + 8 * h] = tl[h];
  }
  __syncthreads();
  if (cg == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * rg + g + 8 * h;
      const int row = row0 + r;
      if (row >= n) continue;
      lse[row] = m[h] + logf(l[h]);
      tlogit[row] = (part_sum[0][r] + part_sum[1][r]) +
                    (part_sum[2][r] + part_sum[3][r]);
    }
  }
}

// ---- bf16, B6 (kDx) and B7 (!kDx): the backward on wgmma over TMA rings ---
//
// One design for both passes (the pieces are B2-B4's, hopper.cuh). A CTA
// owns 64 resident rows (B6: of x, B7: of E), which one TMA load brings at
// the start, and streams every 64-row tile of the other operand (B6: E;
// B7: x, with the tile's lse, g and targets by 1-D TMA boxes) through a
// ring of kBwdStages stages guarded by mbarriers. Tiles live in shared
// memory as TMA writes them, in 64-column panels of 128-byte swizzled
// rows: K-major for the score product, MN-major for the gradient product.
// (Clusters of 2 or 4 CTAs sharing each tile by TMA multicast measured
// slower: PERF.md.) One lane of a producer warpgroup issues the loads; the
// consumer
// warpgroups (two where D >= 256, one below) each own D / W of the D
// columns (W warpgroups) and run, per streamed tile t:
//   S_w = A[:, w] . B_t[:, w]^T   wgmma m64n64, both operands K-major in
//                            shared memory, over the warpgroup's columns;
//   S = S_0 + S_1            the fp32 partials summed through shared
//                            memory (W = 2), in the same order in both;
//   ds = (exp(s - lse) - onehot) g in fp32, 0 past N or V, rounded to
//                            bf16 as it is packed into wgmma's register A
//                            fragments (as B2 packs P);
//   acc_w += ds . B_t[:, w]  wgmma, ds from registers, B_t MN-major (as
//                            B2 reads V), into the warpgroup's columns.
// The gradient product of tile t - 1 is issued before the wait for tile t
// and S of tile t, and the stage of t - 1 is released as soon as that
// product is done, so its refill with tile t + 1 has an iteration to land.
// The [64, D / W] fp32 accumulator is 128 registers a thread at D 512,
// which is why D is split. A CTA of three warpgroups may use 168
// registers a thread, too few for that accumulator with the scores and
// ds in flight (ptxas then serializes the wgmmas), so with two consumer
// warpgroups the producer's drops to 40 (setmaxnreg) and theirs rise to
// 232, as CUTLASS's warp-specialized kernels do. At D 512 the resident
// rows, two stages and the partials take 226.5 KB, one CTA an SM. Every
// output row is written by one CTA in a fixed order, from registers as
// whole 32-byte sectors: no atomics, and two runs are bit-identical. dx
// leaves in bf16, dE in fp32.

constexpr int kBwdRows = 64;   // resident rows of a CTA; rows of a streamed tile
constexpr int kBwdStages = 2;  // streamed tiles in flight

template <int D>
struct BwdShape {
  static constexpr int kGroups = D >= 256 ? 2 : 1;  // consumer warpgroups
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + 128;  // and the producer's
  static constexpr int kPanels = D / 64;            // 64-column panels
  static constexpr int kPanelBytes = kBwdRows * 128;
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kCols = D / kGroups;  // the D columns of a warpgroup
  // The fp32 score partials, [64 x 64] a warpgroup, when D is split.
  static constexpr int kPartialBytes = kGroups == 2 ? 2 * 64 * 64 * 4 : 0;
  static constexpr int kParamBytes = 3 * kBwdRows * 4;  // B7: lse, g, targets
  // 1024 bytes of slack align the tiles for the 128-byte swizzle.
  static constexpr int kSmem = 1024 + (1 + kBwdStages) * kTileBytes +
                               kPartialBytes + kBwdStages * kParamBytes;
};

// S_w = A . B^T over warpgroup w's D columns: A the resident tile at sa,
// B a stage at sb (both in 64-column panels).
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t sa,
                                             uint32_t sb, int w) {
  using L = BwdShape<D>;
#pragma unroll
  for (int kk = 0; kk < L::kCols / 16; ++kk) {
    const int c0 = w * L::kCols + kk * 16;
    const uint32_t off = (c0 / 64) * L::kPanelBytes + (c0 % 64) * 2;
    wgmma_ss_n64(s, smem_desc(sa + off, 16, 1024, 1),
                smem_desc(sb + off, 16, 1024, 1), kk > 0);
  }
}

// acc += ds . B: ds the A fragments a (k steps of 16 tile rows), B the
// warpgroup's output panels of a stage at sb (MN-major).
template <int D>
__device__ __forceinline__ void issue_grad(
    float (&acc)[BwdShape<D>::kCols / 2], const uint32_t (&a)[4][4],
    uint32_t sb) {
  using L = BwdShape<D>;
#pragma unroll
  for (int kc = 0; kc < kBwdRows / 16; ++kc)
    wgmma_rs(acc, a[kc],
             smem_desc(sb + kc * 16 * 128, L::kPanelBytes, 1024, 1));
}

// This warp has read stage s for the last time: it arrives on the stage's
// "empty" barrier.
__device__ __forceinline__ void release_bwd_stage(uint32_t empty, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8u * s);
}

template <int D, bool kDx>
__global__ void __launch_bounds__(BwdShape<D>::kThreads, 1)
xent_bwd_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_lse,
                     const __grid_constant__ CUtensorMap map_g,
                     const __grid_constant__ CUtensorMap map_tgt,
                     const int* __restrict__ tgt,
                     const float* __restrict__ lse,
                     const float* __restrict__ g_in, void* __restrict__ out,
                     int n, int v) {
  using L = BwdShape<D>;
  constexpr int S = kBwdStages;
  extern __shared__ uint8_t bwd_smem[];
  // bars: [0] the resident tile, then S "full" and S "empty" barriers.
  __shared__ __align__(8) uint64_t bars[1 + 2 * S];
  const uint32_t base = smem_u32(bwd_smem);
  const uint32_t sa = (base + 1023u) & ~1023u;  // the resident rows
  const uint32_t sb = sa + L::kTileBytes;       // the ring
  const uint32_t spart = sb + S * L::kTileBytes;  // the score partials
  const uint32_t sprm = spart + L::kPartialBytes;  // B7: each stage's rows
  float* part = reinterpret_cast<float*>(bwd_smem + (spart - base));
  const float* prm = reinterpret_cast<const float*>(bwd_smem + (sprm - base));
  const uint32_t bar_a = smem_u32(bars);
  const uint32_t full = bar_a + 8u;
  const uint32_t empty = full + 8u * S;

  const int tid = threadIdx.x;
  // The warpgroup, through a shuffle so that the compiler knows it is
  // uniform across the warp: a wgmma on a path it takes for divergent
  // would be serialized (ptxas C7520).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int a_rows = kDx ? n : v;
  const int b_rows = kDx ? v : n;
  const int a0 = blockIdx.x * kBwdRows;
  const int n_tiles = (b_rows + kBwdRows - 1) / kBwdRows;

  if (tid == 0) {
    mbar_init(bar_a, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8u * s, 1);
      mbar_init(empty + 8u * s, L::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist before any thread uses them

  if (wg == L::kGroups) {
    // The producer warpgroup: one lane issues every load. Stage s takes
    // tile t once every consumer warp has released tile t - S. It hands
    // its registers to the consumers first.
    if constexpr (L::kGroups == 2) setmaxnreg_dec<40>();
    if (tid == L::kConsumers) {
      mbar_expect_tx(bar_a, L::kTileBytes);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load_2d(sa + p * L::kPanelBytes, &map_a, bar_a, 64 * p, a0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + 8u * s, (t / S - 1) & 1);
        const uint32_t bar = full + 8u * s;
        mbar_expect_tx(bar, L::kTileBytes + (kDx ? 0 : L::kParamBytes));
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_2d(sb + s * L::kTileBytes + p * L::kPanelBytes, &map_b,
                      bar, 64 * p, t * kBwdRows);
        if constexpr (!kDx) {
          const uint32_t ps = sprm + s * L::kParamBytes;
          tma_load_row(ps, &map_lse, bar, t * kBwdRows);
          tma_load_row(ps + 256, &map_g, bar, t * kBwdRows);
          tma_load_row(ps + 512, &map_tgt, bar, t * kBwdRows);
        }
      }
    }
    __syncwarp();
  } else {
    if constexpr (L::kGroups == 2) setmaxnreg_inc<232>();
    const int w = wg;  // the consumer warpgroup
    const int lt = tid & 127;
    const int lane = tid & 31;
    const int r0 = 16 * (lt >> 5) + (lane >> 2);  // rows r0, r0 + 8
    const int t4 = lane & 3;
    // B6: the resident x rows' lse, g and target. A row at or past N
    // reads as zeros and takes lse 0 and g 0, so its ds is 0.
    float row_lse[2] = {0.f, 0.f}, row_g[2] = {0.f, 0.f};
    int row_tgt[2] = {-1, -1};
    if constexpr (kDx) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = a0 + r0 + 8 * h;
        if (row < n) {
          row_lse[h] = lse[row];
          row_g[h] = g_in[row];
          row_tgt[h] = tgt[row];
        }
      }
    }
    float sc[32], acc[L::kCols / 2];
    uint32_t a[4][4];  // ds of the last tile, as A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < L::kCols / 2; ++i) acc[i] = 0.f;
    const uint32_t sbn = sb + w * (L::kCols / 64) * L::kPanelBytes;

    mbar_wait(bar_a, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S;
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(a);
      wgmma_fence();
      if (t > 0) {  // the gradient product of tile t - 1 first
        issue_grad<D>(acc, a, sbn + ((t - 1) % S) * L::kTileBytes);
        wgmma_commit();
      }
      mbar_wait(full + 8u * s, (t / S) & 1);  // it runs while tile t lands
      issue_scores<D>(sc, sa, sb + s * L::kTileBytes, w);
      wgmma_commit();
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(a);
      if (t > 0) {
        // Tile t - 1 is read no more while S_t runs on: its stage is
        // refilled with tile t + 1, an iteration ahead of its use.
        wgmma_wait<1>();
        fence_regs(acc);
        fence_regs(a);
        release_bwd_stage(empty, (t - 1) % S);
      }
      wgmma_wait<0>();
      fence_regs(sc);
      if constexpr (L::kGroups == 2) {
        // Thread lt of either warpgroup holds the same 32 entries of S,
        // so the partials are exchanged entry by entry, conflict-free.
        // The second barrier keeps the next tile's partial from landing
        // before the other warpgroup has read this one.
#pragma unroll
        for (int i = 0; i < 32; ++i) part[(w * 32 + i) * 128 + lt] = sc[i];
        named_sync(1, L::kConsumers);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] += part[((1 - w) * 32 + i) * 128 + lt];
        named_sync(1, L::kConsumers);
      }

      // ds of tile t into the A fragments. Element i of a wgmma
      // accumulator sits at tile row r0 + 8 ((i / 2) % 2) and column
      // 8 (i / 4) + 2 t4 + i % 2, and the accumulators of columns
      // 16 kc .. 16 kc + 15 are exactly the A fragment of k step kc.
      const int b0 = t * kBwdRows;
      const float* ps = prm + s * (L::kParamBytes / 4);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + 2 * t4;
        // B7's column parameters as 8-byte vectors: one shared-memory
        // wavefront for the pair.
        float2 lp, gp;
        int2 tp;
        if constexpr (!kDx) {
          lp = *reinterpret_cast<const float2*>(ps + c);
          gp = *reinterpret_cast<const float2*>(ps + kBwdRows + c);
          tp = *reinterpret_cast<const int2*>(ps + 2 * kBwdRows + c);
        }
        float ds[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float l, gg;
          int tg, vocab;
          bool valid;
          if constexpr (kDx) {
            l = row_lse[h];
            gg = row_g[h];
            tg = row_tgt[h];
            vocab = b0 + c + k;
            valid = vocab < v;
          } else {
            l = k ? lp.y : lp.x;
            gg = k ? gp.y : gp.x;
            tg = k ? tp.y : tp.x;
            vocab = a0 + r0 + 8 * h;
            valid = b0 + c + k < n;
          }
          ds[k] = valid ? (ex2((sc[i + k] - l) * kLog2e) -
                           (vocab == tg ? 1.f : 0.f)) * gg
                        : 0.f;
        }
        // ds rounded to bf16 here, as the reference's ds.astype(dtype).
        const int nt = i >> 2;
        a[nt >> 1][2 * (nt & 1) + h] = pack_bf16(ds[0], ds[1]);
      }
    }
    // The last tile's gradient product.
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
    issue_grad<D>(acc, a, sbn + ((n_tiles - 1) % S) * L::kTileBytes);
    wgmma_commit();
    fence_regs(acc);
    fence_regs(a);
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int i = 0; i < L::kCols / 2; i += 2) {
      const int row = a0 + r0 + 8 * ((i >> 1) & 1);
      if (row >= a_rows) continue;
      const size_t off = static_cast<size_t>(row) * D + w * L::kCols +
                         8 * (i >> 2) + 2 * t4;
      if constexpr (kDx) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + off) =
            pack_bf16(acc[i], acc[i + 1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
            make_float2(acc[i], acc[i + 1]);
      }
    }
  }
}

// ---- launchers ---------------------------------------------------------------

constexpr int f32_bytes(int d, bool ds) {
  return ((kRows + kCols) * (d + 1) + (ds ? kRows * kLdsF32 : 0)) *
         static_cast<int>(sizeof(float));
}

constexpr int bf16_bytes(int d) {
  return (kRows + kCols) * (d + 8) * static_cast<int>(sizeof(bf16));
}

int blocks(int rows) { return (rows + kRows - 1) / kRows; }

template <int D>
int fwd(int dtype_code, const void* x, const void* e, const int* tgt,
        float* lse, float* tlogit, int n, int v, cudaStream_t stream) {
  if (dtype_code == 0) {
    const int smem = f32_bytes(D, false);
    if (int rc = launch_setup(xent_fwd_f32_kernel<D>, smem)) return rc;
    xent_fwd_f32_kernel<D><<<blocks(n), kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(e), tgt, lse,
        tlogit, n, v);
  } else {
    const int smem = bf16_bytes(D);
    if (int rc = launch_setup(xent_fwd_bf16_kernel<D>, smem)) return rc;
    xent_fwd_bf16_kernel<D><<<blocks(n), kThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(e), tgt, lse,
        tlogit, n, v);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tensor map of a bf16 [rows, D] array in boxes of `box_rows` rows by
// one 64-column panel, 128-byte swizzled; rows past `rows` read as zeros.
template <int D>
int encode_rows_map(CUtensorMap* map, const void* ptr, int rows,
                    int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {D * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return static_cast<int>(
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// The tensor map of an [N] array of 4-byte entries (lse, g: fp32;
// targets: int32) in boxes of 64; entries past N read as zeros.
int encode_vec_map(CUtensorMap* map, const void* ptr, int n,
                   CUtensorMapDataType type) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {0};  // a rank-1 map has none
  const cuuint32_t box[1] = {kBwdRows};
  const cuuint32_t elem[1] = {1};
  return static_cast<int>(
      fn(map, type, 1, const_cast<void*>(ptr), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// The bf16 backward: one CTA a 64-row resident block.
template <int D, bool kDx>
int bwd_bf16(const bf16* x, const bf16* e, const int* tgt, const float* lse,
             const float* g, void* out, int n, int v, cudaStream_t stream) {
  using L = BwdShape<D>;
  const int a_rows = kDx ? n : v;
  CUtensorMap map_a, map_b, map_lse = {}, map_g = {}, map_tgt = {};
  if (int rc = encode_rows_map<D>(&map_a, kDx ? x : e, a_rows, kBwdRows))
    return rc;
  if (int rc = encode_rows_map<D>(&map_b, kDx ? e : x, kDx ? v : n,
                                  kBwdRows))
    return rc;
  if (!kDx) {
    if (int rc = encode_vec_map(&map_lse, lse, n,
                                CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return rc;
    if (int rc = encode_vec_map(&map_g, g, n, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return rc;
    if (int rc = encode_vec_map(&map_tgt, tgt, n,
                                CU_TENSOR_MAP_DATA_TYPE_INT32))
      return rc;
  }
  const auto kernel = xent_bwd_bf16_kernel<D, kDx>;
  if (int rc = launch_setup(kernel, L::kSmem)) return rc;
  kernel<<<(a_rows + kBwdRows - 1) / kBwdRows, L::kThreads, L::kSmem,
           stream>>>(map_a, map_b, map_lse, map_g, map_tgt, tgt, lse, g, out,
                     n, v);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDx>
int bwd(int dtype_code, const void* x, const void* e, const int* tgt,
        const float* lse, const float* g, void* out, int n, int v,
        cudaStream_t stream) {
  if (dtype_code == 1)
    return bwd_bf16<D, kDx>(static_cast<const bf16*>(x),
                            static_cast<const bf16*>(e), tgt, lse, g, out, n,
                            v, stream);
  const int smem = f32_bytes(D, true);
  if (int rc = launch_setup(xent_bwd_f32_kernel<D, kDx>, smem)) return rc;
  xent_bwd_f32_kernel<D, kDx><<<blocks(kDx ? n : v), kThreads, smem,
                                stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(e), tgt, lse,
      g, static_cast<float*>(out), n, v);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int dtype_code, int n, int v, int d) {
  return (dtype_code == 0 || dtype_code == 1) && n > 0 && v > 0 &&
         (d == 64 || d == 128 || d == 256 || d == 512);
}

}  // namespace

// C entry points bound with ctypes (kvedge_torch/ops/_build.py,
// kvedge_torch/ops/xent.py). dtype_code: 0 = float32, 1 = bfloat16 (bf16
// x and E, and the backward's lse, g and targets, 16-byte aligned). Each returns cudaGetLastError() after its
// launch (0 = launched), or -1 for a shape it does not take (D not in
// {64, 128, 256, 512}, N or V < 1); the wrapper checks those before
// calling.

#define KVEDGE_DISPATCH(FN, ...)                \
  do {                                          \
    if (d == 64) return FN<64>(__VA_ARGS__);    \
    if (d == 128) return FN<128>(__VA_ARGS__);  \
    if (d == 256) return FN<256>(__VA_ARGS__);  \
    return FN<512>(__VA_ARGS__);                \
  } while (0)

#define KVEDGE_DISPATCH_BWD(KDX, ...)                    \
  do {                                                   \
    if (d == 64) return bwd<64, KDX>(__VA_ARGS__);       \
    if (d == 128) return bwd<128, KDX>(__VA_ARGS__);     \
    if (d == 256) return bwd<256, KDX>(__VA_ARGS__);     \
    return bwd<512, KDX>(__VA_ARGS__);                   \
  } while (0)

extern "C" int kvedge_xent_fwd(int dtype_code, const void* x, const void* e,
                               const int* targets, float* lse, float* tlogit,
                               int n, int v, int d, void* stream) {
  if (!shape_ok(dtype_code, n, v, d)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  KVEDGE_DISPATCH(fwd, dtype_code, x, e, targets, lse, tlogit, n, v, st);
}

extern "C" int kvedge_xent_bwd_dx(int dtype_code, const void* x,
                                  const void* e, const int* targets,
                                  const float* lse, const float* g, void* dx,
                                  int n, int v, int d, void* stream) {
  if (!shape_ok(dtype_code, n, v, d)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  KVEDGE_DISPATCH_BWD(true, dtype_code, x, e, targets, lse, g, dx, n, v, st);
}

extern "C" int kvedge_xent_bwd_de(int dtype_code, const void* x,
                                  const void* e, const int* targets,
                                  const float* lse, const float* g, float* de,
                                  int n, int v, int d, void* stream) {
  if (!shape_ok(dtype_code, n, v, d)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  KVEDGE_DISPATCH_BWD(false, dtype_code, x, e, targets, lse, g, de, n, v, st);
}
