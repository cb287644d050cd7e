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
//   dx:      p = exp(s - lse) in fp32, ds = (p - onehot) * g in fp32,
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
// Design (simple first). The TPU kernels carry their state across a
// sequential grid axis in VMEM; here one CTA owns a tile of resident rows
// and loops over every tile of the other operand inside itself, so
// nothing is carried between CTAs and there are no atomics: the backward
// run twice is bit-identical.
//   forward: a CTA owns 32 rows of x and streams E in 64-row tiles,
//            keeping the running max, sum and target logit of its rows.
//   dx:      a CTA owns 32 rows of x and streams E; per tile it forms ds
//            [32 x 64] and accumulates dx [32 x D] += ds . E_tile.
//   dE:      a CTA owns 32 rows of E and streams x in 64-row tiles; per
//            tile it forms ds^T [32 x 64] and accumulates
//            dE [32 x D] += ds^T . x_tile.
// 32 resident rows, not the TPU's hundreds: the [rows, D] fp32
// accumulator of dx and dE lives in registers, and at D = 512 a 32-row
// tile over 256 threads is 64 registers a thread (64 rows would be 128).
// E (32.8 MB in bf16 at the flagship) is re-read from the 50 MB L2 by
// every row tile rather than from device memory.
// bf16 runs on the tensor cores with mma.sync m16n8k16 (bf16 operands,
// fp32 accumulation): 8 warps; for the score tile warp w owns rows
// 16 (w & 1) .. +15 and columns 16 (w >> 1) .. +15, so a row of the
// forward's online softmax spans 4 warps and its max and sum are combined
// through shared memory. ds is rounded to bf16 as it is written to shared
// memory, where it is the A operand of the second product; there warp w
// owns rows 16 (w & 1) .. +15 and D / 4 output columns. fp32 has no
// tensor-core path of full fp32 precision (TF32 would round the
// operands), so it runs on the CUDA cores with fp32 FMA: thread (ty, tx)
// of 16 x 16 owns score rows ty + 16 i (i < 2) and columns tx + 16 j
// (j < 4), so a row's max and sum reduce over a half-warp, and output
// columns tx + 16 c. Tiles are loaded synchronously; ldmatrix, cp.async or
// TMA pipelining and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 32;      // resident rows of a CTA
constexpr int kCols = 64;      // rows of a streamed tile (score columns)
constexpr int kThreads = 256;  // 8 warps; 16 x 16 on the fp32 path
constexpr int kLdsBf16 = kCols + 8;  // row stride of the bf16 ds tile
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

// Two fp32 values rounded to bf16 (round to nearest even), low half first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
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

// ---- bf16, B6 (kDx) and B7 (!kDx): backward --------------------------------
// As on the fp32 path: A resident, B streamed. The output [32 x D] is
// split over the warps as 2 row groups x 4 column groups of D / 4.
template <int D, bool kDx>
__global__ void __launch_bounds__(kThreads)
xent_bwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ e,
                     const int* __restrict__ tgt, const float* __restrict__ lse,
                     const float* __restrict__ g_in, void* __restrict__ out,
                     int n, int v) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 32;  // output n tiles of a warp
  extern __shared__ uint4 smem_vec[];
  bf16* As = reinterpret_cast<bf16*>(smem_vec);  // [kRows][LD]
  bf16* Bs = As + kRows * LD;                    // [kCols][LD]
  bf16* Ds = Bs + kCols * LD;                    // [kRows][kLdsBf16]
  __shared__ float lse_s[kCols], g_s[kCols];
  __shared__ int tgt_s[kCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = warp & 1;
  const int cg = warp >> 1;
  const bf16* a_src = kDx ? x : e;
  const bf16* b_src = kDx ? e : x;
  const int a_rows = kDx ? n : v;
  const int b_rows = kDx ? v : n;
  const int a0 = blockIdx.x * kRows;

  load_bf16<D, kRows>(As, a_src, a0, a_rows);
  if (kDx) load_params(lse_s, tgt_s, g_s, lse, tgt, g_in, a0, kRows, n);
  float acc[NT][4];
  zero(acc);

  for (int b0 = 0; b0 < b_rows; b0 += kCols) {
    __syncthreads();  // the previous tile and its ds are no longer read
    load_bf16<D, kCols>(Bs, b_src, b0, b_rows);
    if (!kDx) load_params(lse_s, tgt_s, g_s, lse, tgt, g_in, b0, kCols, n);
    __syncthreads();
    float s[2][4];
    score_bf16<D>(s, As, Bs, rg, cg, g, t);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * rg + g + 8 * h;     // resident row
        const int c = 16 * cg + 8 * nt + 2 * t;  // streamed rows c, c + 1
        float ds[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int p = kDx ? r : c + k;
          ds[k] = cotangent(s[nt][2 * h + k], lse_s[p], tgt_s[p], g_s[p],
                            kDx ? b0 + c + k : a0 + r, b0 + c + k < b_rows);
        }
        // ds rounded to bf16 here, as the reference's ds.astype(dtype).
        *reinterpret_cast<uint32_t*>(Ds + r * kLdsBf16 + c) =
            pack_bf16(ds[0], ds[1]);
      }
    __syncthreads();  // ds complete

    // acc += Ds[16 rg + 0..15, :] . Bs[:, cg D/4 + 0 .. D/4 - 1]
#pragma unroll
    for (int kc = 0; kc < kCols / 16; ++kc) {
      const bf16* a = Ds + (16 * rg + g) * kLdsBf16 + kc * 16 + 2 * t;
      const uint32_t a0f = ld32(a);
      const uint32_t a1f = ld32(a + 8 * kLdsBf16);
      const uint32_t a2f = ld32(a + 8);
      const uint32_t a3f = ld32(a + 8 * kLdsBf16 + 8);
      const bf16* z = Bs + (kc * 16 + 2 * t) * LD + cg * (D / 4) + g;
#pragma unroll
      for (int nd = 0; nd < NT; ++nd) {
        const bf16* zc = z + 8 * nd;
        mma16816(acc[nd], a0f, a1f, a2f, a3f, pack_bf16(zc[0], zc[LD]),
                 pack_bf16(zc[8 * LD], zc[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = a0 + 16 * rg + g + 8 * h;
    if (row >= a_rows) continue;
    const size_t off = static_cast<size_t>(row) * D + cg * (D / 4) + 2 * t;
#pragma unroll
    for (int nd = 0; nd < NT; ++nd) {
      if constexpr (kDx) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + off + 8 * nd) =
            pack_bf16(acc[nd][2 * h], acc[nd][2 * h + 1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off + 8 * nd) =
            make_float2(acc[nd][2 * h], acc[nd][2 * h + 1]);
      }
    }
  }
}

// ---- launchers ---------------------------------------------------------------

// Dynamic shared memory above 48 KB needs the kernel's opt-in first.
template <typename K>
int launch_setup(K kernel, int smem_bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

constexpr int f32_bytes(int d, bool ds) {
  return ((kRows + kCols) * (d + 1) + (ds ? kRows * kLdsF32 : 0)) *
         static_cast<int>(sizeof(float));
}

constexpr int bf16_bytes(int d, bool ds) {
  return ((kRows + kCols) * (d + 8) + (ds ? kRows * kLdsBf16 : 0)) *
         static_cast<int>(sizeof(bf16));
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
    const int smem = bf16_bytes(D, false);
    if (int rc = launch_setup(xent_fwd_bf16_kernel<D>, smem)) return rc;
    xent_fwd_bf16_kernel<D><<<blocks(n), kThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(e), tgt, lse,
        tlogit, n, v);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDx>
int bwd(int dtype_code, const void* x, const void* e, const int* tgt,
        const float* lse, const float* g, void* out, int n, int v,
        cudaStream_t stream) {
  const int grid = blocks(kDx ? n : v);
  if (dtype_code == 0) {
    const int smem = f32_bytes(D, true);
    if (int rc = launch_setup(xent_bwd_f32_kernel<D, kDx>, smem)) return rc;
    xent_bwd_f32_kernel<D, kDx><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(e), tgt, lse,
        g, static_cast<float*>(out), n, v);
  } else {
    const int smem = bf16_bytes(D, true);
    if (int rc = launch_setup(xent_bwd_bf16_kernel<D, kDx>, smem)) return rc;
    xent_bwd_bf16_kernel<D, kDx><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(e), tgt, lse, g,
        out, n, v);
  }
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int dtype_code, int n, int v, int d) {
  return (dtype_code == 0 || dtype_code == 1) && n > 0 && v > 0 &&
         (d == 64 || d == 128 || d == 256 || d == 512);
}

}  // namespace

// C entry points bound with ctypes (kvedge_torch/ops/_build.py,
// kvedge_torch/ops/xent.py). dtype_code: 0 = float32, 1 = bfloat16 (bf16
// pointers 16-byte aligned). Each returns cudaGetLastError() after its
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
