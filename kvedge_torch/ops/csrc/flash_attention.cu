// Causal flash attention for Hopper (sm_90a), CUDA C++: the forward and
// its two backward passes.
//
// Replaces the three TPU kernels of kvedge_tpu/ops/attention.py that the
// reference wires together with a custom_vjp (`flash_attention`):
//   kvedge_flash_fwd     <- `_fwd_kernel`      (:98, via `_flash_fwd_raw`)
//   kvedge_flash_bwd_dq  <- `_bwd_dq_kernel`   (:234, via `_flash_bwd_vjp`)
//   kvedge_flash_bwd_dkv <- `_bwd_dkv_kernel`  (:273, via `_flash_bwd_vjp`)
// on q, k, v of shape [BH, T, Dh] (row-major, contiguous), bf16 or fp32,
// Dh in {32, 64, 128}, any T >= 1 (a partial last tile is masked).
//
// Rounding points, each the reference's:
//   forward: s = (q . k in fp32) * scale in fp32, never rounded to the
//            dtype; -inf above the diagonal; an fp32 running max m and
//            sum l; p = exp(s - m_new) enters l unrounded and is rounded
//            to the dtype BEFORE the fp32-accumulated p . V (:145-149);
//            O = (acc / l) -> dtype, lse = m + log(l) in fp32.
//   dq:      p = exp(s - lse), dp = dO . V^T in fp32,
//            ds = p * (dp - delta), acc += (ds -> dtype) . K,
//            dq = (acc * scale) -> dtype.
//   dk/dv:   dv += (p -> dtype)^T . dO, dk += (ds -> dtype)^T . Q,
//            dk = (acc * scale) -> dtype, dv = acc -> dtype.
// `delta = rowsum(dO * O)` (fp32) comes from the caller, as the
// reference computes it outside its kernels (:331-334). `scale` is
// float32(Dh ** -0.5), the reference's Python scalar in fp32. Products
// of bf16 values are exact in fp32, so an fp32-accumulated product of
// dtype-rounded operands is the reference's bf16-operand, fp32-accumulate
// dot; only the order of the fp32 sums differs.
//
// Work and bound. With n = T (T + 1) / 2 causal (q, k) pairs per head,
// each matmul of the pass does 2 * BH * n * Dh operations: the forward
// does 2 of them (q.k, p.V), dq 3 (q.k, dO.V, ds.K), dk/dv 4 (q.k, dO.V,
// p.dO, ds.Q). At the flagship training shape (BH 512, T 512, Dh 64,
// bf16) that is 17.2, 25.8 and 34.4 GFLOP per launch, 0.017 / 0.026 /
// 0.035 ms at the 989 TFLOP/s bf16 tensor-core peak, against 135 / 170 /
// 203 MB of input read once and output written once, 0.040 / 0.051 /
// 0.061 ms at 3.35 TB/s: at this short T the bound is the bytes, and at
// T >= ~1200 it becomes the operations.
//
// Design (simple first). Every CTA owns one (bh, 64-row tile):
//   forward / dq: one CTA per (bh, q tile); a loop over the k tiles up to
//     and including the diagonal (tiles above it are never loaded).
//   dk/dv:        one CTA per (bh, k tile); a loop over the q tiles from
//     the diagonal down. Each CTA owns its dk/dv rows, so there are no
//     atomics and the backward is deterministic, as the TPU grid is.
// bf16 runs on the tensor cores: 4 warps, each owning 16 rows of the
// tile, with mma.sync m16n8k16 (bf16 operands, fp32 accumulation) on
// tiles staged in shared memory, and the online softmax on the score
// accumulators in registers (section "bf16" below). wgmma, TMA and warp
// specialisation are later work. fp32 has no tensor-core path of full
// fp32 precision (TF32 would round the operands), so it runs on the CUDA
// cores with fp32 FMA: 256 threads (16 x 16), thread (ty, tx) owning tile
// rows ty + 16 i and tile columns tx + 16 j (i, j < 4) of every 64 x 64
// score tile, so a row's max and sum reduce over the 16 lanes of a
// half-warp and the running max, sum and accumulator of a row stay in one
// thread; fp32 tiles in shared memory, those read along their rows by
// the 16 lanes with a (Dh + 1) stride so the lanes fall on separate
// banks. Its bound at the fp32 peak (67 TFLOP/s) is 0.26 / 0.39 / 0.51 ms
// at the shape above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // rows of a q tile and of a k tile
constexpr int kThreads = 256;        // 16 x 16
constexpr int kPer = kTile / 16;     // tile rows (and score columns) a thread owns
constexpr int kPad = kTile + 1;      // stride of the score tiles in shared memory

__device__ __forceinline__ float half_warp_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// dst[r * ld + d] = src[(row0 + r) * DH + d] as fp32 for the tile's 64
// rows; rows at or past `seq` read as zero.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int row0, int seq) {
  for (int i = threadIdx.x; i < kTile * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i % DH;
    const int row = row0 + r;
    dst[r * ld + d] = row < seq ? src[static_cast<size_t>(row) * DH + d] : 0.f;
  }
}

constexpr int fwd_smem_floats(int dh) {
  return kTile * dh + kTile * (dh + 1) + kTile * dh + kTile * kPad;
}
constexpr int dq_smem_floats(int dh) {
  return 2 * kTile * dh + 2 * kTile * (dh + 1) + kTile * kPad;
}
constexpr int dkv_smem_floats(int dh) {
  return 2 * kTile * dh + 2 * kTile * (dh + 1) + 2 * kTile * kPad + 2 * kTile;
}

// ---- fp32, B2: forward --------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int seq, float scale) {
  constexpr int DC = DH / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kTile][DH]
  float* Ks = Qs + kTile * DH;       // [kTile][DH + 1]
  float* Vs = Ks + kTile * (DH + 1); // [kTile][DH]
  float* Ps = Vs + kTile * DH;       // [kTile][kPad]

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = static_cast<size_t>(bh) * seq * DH;
  const int q0 = qt * kTile;

  load_tile<DH>(Qs, DH, q + base, q0, seq);

  float m[kPer], l[kPer], acc[kPer][DC];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<DH>(Ks, DH + 1, k + base, k0, seq);
    load_tile<DH>(Vs, DH, v + base, k0, seq);
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[kPer], kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) qv[i] = Qs[(ty + 16 * i) * DH + d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) kv[j] = Ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x = s[i][j] * scale;
        s[i][j] = (col <= row && col < seq) ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // Column 0 of tile 0 is visible to every row, so m_new is finite.
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * kPad + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = Ps[(ty + 16 * i) * kPad + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    float* orow = out + base + static_cast<size_t>(row) * DH;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] / l[i];
    if (tx == 0) lse[static_cast<size_t>(bh) * seq + row] = m[i] + logf(l[i]);
  }
}

// ---- fp32, B3: dq ---------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int seq, float scale) {
  constexpr int DC = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kTile][DH]
  float* Os = Qs + kTile * DH;        // dO [kTile][DH]
  float* Ks = Os + kTile * DH;        // [kTile][DH + 1]
  float* Vs = Ks + kTile * (DH + 1);  // [kTile][DH + 1]
  float* Ds = Vs + kTile * (DH + 1);  // [kTile][kPad]

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = static_cast<size_t>(bh) * seq * DH;
  const size_t rbase = static_cast<size_t>(bh) * seq;
  const int q0 = qt * kTile;

  load_tile<DH>(Qs, DH, q + base, q0, seq);
  load_tile<DH>(Os, DH, dout + base, q0, seq);
  float lse_r[kPer], delta_r[kPer], acc[kPer][DC];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < seq ? lse[rbase + row] : 0.f;
    delta_r[i] = row < seq ? delta[rbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<DH>(Ks, DH + 1, k + base, k0, seq);
    load_tile<DH>(Vs, DH + 1, v + base, k0, seq);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[kPer], ov[kPer], kv[kPer], vv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DH + d];
        ov[i] = Os[(ty + 16 * i) * DH + d];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        kv[j] = Ks[(tx + 16 * j) * (DH + 1) + d];
        vv[j] = Vs[(tx + 16 * j) * (DH + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = (col <= row && col < seq)
                            ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        Ds[(ty + 16 * i) * kPad + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();  // ds complete

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * (DH + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float ds = Ds[(ty + 16 * i) * kPad + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    float* drow = dq + base + static_cast<size_t>(row) * DH;
#pragma unroll
    for (int c = 0; c < DC; ++c) drow[tx + 16 * c] = acc[i][c] * scale;
  }
}

// ---- fp32, B4: dk and dv --------------------------------------------------------
// Scores here are held transposed: tile rows are keys (ty + 16 i), tile
// columns are queries (tx + 16 j).
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int seq, float scale) {
  constexpr int DC = DH / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                   // [kTile][DH]
  float* Vs = Ks + kTile * DH;        // [kTile][DH]
  float* Qs = Vs + kTile * DH;        // [kTile][DH + 1]
  float* Os = Qs + kTile * (DH + 1);  // dO [kTile][DH + 1]
  float* Pt = Os + kTile * (DH + 1);  // [kTile][kPad], p^T
  float* Dt = Pt + kTile * kPad;      // [kTile][kPad], ds^T
  float* lse_s = Dt + kTile * kPad;   // [kTile]
  float* delta_s = lse_s + kTile;     // [kTile]

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = static_cast<size_t>(bh) * seq * DH;
  const size_t rbase = static_cast<size_t>(bh) * seq;
  const int k0 = kt * kTile;
  const int nq = (seq + kTile - 1) / kTile;

  load_tile<DH>(Ks, DH, k + base, k0, seq);
  load_tile<DH>(Vs, DH, v + base, k0, seq);
  float dk_acc[kPer][DC], dv_acc[kPer][DC];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qt = kt; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<DH>(Qs, DH + 1, q + base, q0, seq);
    load_tile<DH>(Os, DH + 1, dout + base, q0, seq);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < seq ? lse[rbase + row] : 0.f;
      delta_s[threadIdx.x] = row < seq ? delta[rbase + row] : 0.f;
    }
    __syncthreads();

    float st[kPer][kPer], dpt[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float kv[kPer], vv[kPer], qv[kPer], ov[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        kv[i] = Ks[(ty + 16 * i) * DH + d];
        vv[i] = Vs[(ty + 16 * i) * DH + d];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        qv[j] = Qs[(tx + 16 * j) * (DH + 1) + d];
        ov[j] = Os[(tx + 16 * j) * (DH + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(ov[j], vv[i], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int krow = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qc = tx + 16 * j;
        const int qrow = q0 + qc;
        const float p = (krow <= qrow && qrow < seq)
                            ? expf(st[i][j] * scale - lse_s[qc]) : 0.f;
        Pt[(ty + 16 * i) * kPad + qc] = p;
        Dt[(ty + 16 * i) * kPad + qc] =
            p * (dpt[i][j] - delta_s[qc]);
      }
    }
    __syncthreads();  // p^T and ds^T complete

#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float ov[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        ov[c] = Os[qq * (DH + 1) + tx + 16 * c];
        qv[c] = Qs[qq * (DH + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = Pt[(ty + 16 * i) * kPad + qq];
        const float ds = Dt[(ty + 16 * i) * kPad + qq];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(p, ov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= seq) continue;
    float* krow = dk + base + static_cast<size_t>(row) * DH;
    float* vrow = dv + base + static_cast<size_t>(row) * DH;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[tx + 16 * c] = dk_acc[i][c] * scale;
      vrow[tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// ---- bf16: tensor-core tiles (mma.sync m16n8k16, fp32 accumulation) -----
//
// The same algorithm and rounding points on bf16 tiles in shared memory.
// A CTA of 4 warps owns one 64-row tile; warp w owns its rows 16w..16w+15
// of every 64 x 64 score tile, held in registers as eight 16 x 8 mma
// accumulators. A row lives in the 4 lanes of a quad, so its max and sum
// reduce with two shuffles. p and ds are rounded to bf16 as they are
// packed into the A operand of the next product, straight from the score
// accumulators. Shared-memory rows are padded by 8 elements so that the
// fragment loads of a warp fall on 32 different banks.

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;

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

// A 64-row tile of a [.., DH] bf16 array into shared memory, row stride
// DH + 8, in 16-byte vectors; rows at or past `seq` read as zero.
template <int DH>
__device__ __forceinline__ void load_tile_bf16(bf16* dst,
                                               const bf16* __restrict__ src,
                                               int row0, int seq) {
  constexpr int LD = DH + 8;
  constexpr int V = DH / 8;
  for (int i = threadIdx.x; i < kTile * V; i += kMmaThreads) {
    const int r = i / V;
    const int c = (i % V) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < seq)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// acc[nt] += X[r0 + 0..15, :] . Y[8 nt + 0..7, :]^T over the DH columns,
// for the 64 rows of Y (nt < 8): X and Y row-major in shared memory.
// Lane (g, t) = (lane / 4, lane % 4) holds the fragments of rows g, g + 8.
template <int DH>
__device__ __forceinline__ void mma_xyt(float (&acc)[8][4], const bf16* X,
                                        int r0, const bf16* Y, int g,
                                        int t) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    const int kk = kc * 16 + 2 * t;
    const uint32_t a0 = ld32(X + (r0 + g) * LD + kk);
    const uint32_t a1 = ld32(X + (r0 + g + 8) * LD + kk);
    const uint32_t a2 = ld32(X + (r0 + g) * LD + kk + 8);
    const uint32_t a3 = ld32(X + (r0 + g + 8) * LD + kk + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* y = Y + (8 * nt + g) * LD + kk;
      mma16816(acc[nt], a0, a1, a2, a3, ld32(y), ld32(y + 8));
    }
  }
}

// acc[nd] += (P -> bf16) . Z for the warp's 16 x 64 tile P, held as the
// score accumulators p[8][4], and Z row-major [64][DH] in shared memory
// (nd < DH / 8). The accumulators of score columns 16 kc .. 16 kc + 15
// are exactly the A fragment of k step kc.
template <int DH>
__device__ __forceinline__ void mma_pz(float (&acc)[DH / 8][4],
                                       const float (&p)[8][4], const bf16* Z,
                                       int g, int t) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t a0 = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    const uint32_t a1 = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    const uint32_t a2 = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    const uint32_t a3 = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
    const bf16* z = Z + (kc * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const bf16* zc = z + 8 * nd;
      mma16816(acc[nd], a0, a1, a2, a3, pack_bf16(zc[0], zc[LD]),
               pack_bf16(zc[8 * LD], zc[9 * LD]));
    }
  }
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

// Accumulator element e of n tile nt sits at tile row g + 8 (e / 2) and
// tile column 8 nt + 2 t + e % 2.

// ---- bf16, B2: forward -----------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int seq, float scale) {
  constexpr int LD = DH + 8;
  extern __shared__ uint4 smem_vec[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_vec);
  bf16* Ks = Qs + kTile * LD;
  bf16* Vs = Ks + kTile * LD;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const size_t base = static_cast<size_t>(bh) * seq * DH;
  const int q0 = qt * kTile;

  load_tile_bf16<DH>(Qs, q + base, q0, seq);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[DH / 8][4];
  zero(o);

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile_bf16<DH>(Ks, k + base, k0, seq);
    load_tile_bf16<DH>(Vs, v + base, k0, seq);
    __syncthreads();

    float s[8][4];
    zero(s);
    mma_xyt<DH>(s, Qs, r0, Ks, g, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + g + 8 * (e >> 1);
        const int col = k0 + 8 * nt + 2 * t + (e & 1);
        const float x = s[nt][e] * scale;
        s[nt][e] = (col <= row && col < seq) ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // Column 0 of tile 0 is visible to every row, so m_new is finite.
      m_new[h] = fmaxf(m[h], quad_max(mx[h]));
      corr[h] = expf(m[h] - m_new[h]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m_new[e >> 1]);
        s[nt][e] = p;  // unrounded into l; rounded as mma_pz packs it
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * corr[h] + quad_sum(sum[h]);
      m[h] = m_new[h];
    }
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= corr[e >> 1];
    mma_pz<DH>(o, s, Vs, g, t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= seq) continue;
    bf16* orow = out + base + static_cast<size_t>(row) * DH + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      *reinterpret_cast<uint32_t*>(orow + 8 * nd) =
          pack_bf16(o[nd][2 * h] / l[h], o[nd][2 * h + 1] / l[h]);
    if (t == 0) lse[static_cast<size_t>(bh) * seq + row] = m[h] + logf(l[h]);
  }
}

// ---- bf16, B3: dq ----------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int seq, float scale) {
  constexpr int LD = DH + 8;
  extern __shared__ uint4 smem_vec[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_vec);
  bf16* Os = Qs + kTile * LD;  // dO
  bf16* Ks = Os + kTile * LD;
  bf16* Vs = Ks + kTile * LD;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const size_t base = static_cast<size_t>(bh) * seq * DH;
  const size_t rbase = static_cast<size_t>(bh) * seq;
  const int q0 = qt * kTile;

  load_tile_bf16<DH>(Qs, q + base, q0, seq);
  load_tile_bf16<DH>(Os, dout + base, q0, seq);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    lse_r[h] = row < seq ? lse[rbase + row] : 0.f;
    delta_r[h] = row < seq ? delta[rbase + row] : 0.f;
  }
  float acc[DH / 8][4];
  zero(acc);

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_bf16<DH>(Ks, k + base, k0, seq);
    load_tile_bf16<DH>(Vs, v + base, k0, seq);
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_xyt<DH>(s, Qs, r0, Ks, g, t);
    mma_xyt<DH>(dp, Os, r0, Vs, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int row = q0 + r0 + g + 8 * h;
        const int col = k0 + 8 * nt + 2 * t + (e & 1);
        const float p = (col <= row && col < seq)
                            ? expf(s[nt][e] * scale - lse_r[h]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[h]);  // ds
      }
    mma_pz<DH>(acc, s, Ks, g, t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= seq) continue;
    bf16* drow = dq + base + static_cast<size_t>(row) * DH + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      *reinterpret_cast<uint32_t*>(drow + 8 * nd) =
          pack_bf16(acc[nd][2 * h] * scale, acc[nd][2 * h + 1] * scale);
  }
}

// ---- bf16, B4: dk and dv ---------------------------------------------------
// Scores are held transposed: tile rows are keys, tile columns queries.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int seq, float scale) {
  constexpr int LD = DH + 8;
  extern __shared__ uint4 smem_vec[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_vec);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;
  bf16* Os = Qs + kTile * LD;  // dO
  float* lse_s = reinterpret_cast<float*>(Os + kTile * LD);
  float* delta_s = lse_s + kTile;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const size_t base = static_cast<size_t>(bh) * seq * DH;
  const size_t rbase = static_cast<size_t>(bh) * seq;
  const int k0 = kt * kTile;
  const int nq = (seq + kTile - 1) / kTile;

  load_tile_bf16<DH>(Ks, k + base, k0, seq);
  load_tile_bf16<DH>(Vs, v + base, k0, seq);
  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int qt = kt; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile_bf16<DH>(Qs, q + base, q0, seq);
    load_tile_bf16<DH>(Os, dout + base, q0, seq);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < seq ? lse[rbase + row] : 0.f;
      delta_s[threadIdx.x] = row < seq ? delta[rbase + row] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];
    zero(st);
    zero(dpt);
    mma_xyt<DH>(st, Ks, r0, Qs, g, t);
    mma_xyt<DH>(dpt, Vs, r0, Os, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int krow = k0 + r0 + g + 8 * (e >> 1);
        const int qc = 8 * nt + 2 * t + (e & 1);
        const int qrow = q0 + qc;
        const float p = (krow <= qrow && qrow < seq)
                            ? expf(st[nt][e] * scale - lse_s[qc]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[qc]);  // ds^T
      }
    mma_pz<DH>(dv_acc, st, Os, g, t);
    mma_pz<DH>(dk_acc, dpt, Qs, g, t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + r0 + g + 8 * h;
    if (row >= seq) continue;
    const size_t off = base + static_cast<size_t>(row) * DH + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * nd) = pack_bf16(
          dk_acc[nd][2 * h] * scale, dk_acc[nd][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * nd) =
          pack_bf16(dv_acc[nd][2 * h], dv_acc[nd][2 * h + 1]);
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

constexpr int bf16_tile_bytes(int dh) {
  return kTile * (dh + 8) * static_cast<int>(sizeof(bf16));
}

template <int DH>
int fwd(int dtype_code, const void* q, const void* k, const void* v,
        void* out, float* lse, int BH, int seq, float scale,
        cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, BH);
  if (dtype_code == 0) {
    const int smem = fwd_smem_floats(DH) * static_cast<int>(sizeof(float));
    if (int rc = launch_setup(flash_fwd_kernel<DH>, smem)) return rc;
    flash_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, seq,
        scale);
  } else {
    const int smem = 3 * bf16_tile_bytes(DH);
    if (int rc = launch_setup(flash_fwd_bf16_kernel<DH>, smem)) return rc;
    flash_fwd_bf16_kernel<DH><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, seq,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int bwd_dq(int dtype_code, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta, void* dq,
           int BH, int seq, float scale, cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, BH);
  if (dtype_code == 0) {
    const int smem = dq_smem_floats(DH) * static_cast<int>(sizeof(float));
    if (int rc = launch_setup(flash_bwd_dq_kernel<DH>, smem)) return rc;
    flash_bwd_dq_kernel<DH><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), seq, scale);
  } else {
    const int smem = 4 * bf16_tile_bytes(DH);
    if (int rc = launch_setup(flash_bwd_dq_bf16_kernel<DH>, smem)) return rc;
    flash_bwd_dq_bf16_kernel<DH><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), seq, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int bwd_dkv(int dtype_code, const void* q, const void* k, const void* v,
            const void* dout, const float* lse, const float* delta, void* dk,
            void* dv, int BH, int seq, float scale, cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, BH);
  if (dtype_code == 0) {
    const int smem = dkv_smem_floats(DH) * static_cast<int>(sizeof(float));
    if (int rc = launch_setup(flash_bwd_dkv_kernel<DH>, smem)) return rc;
    flash_bwd_dkv_kernel<DH><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), seq, scale);
  } else {
    const int smem =
        4 * bf16_tile_bytes(DH) + 2 * kTile * static_cast<int>(sizeof(float));
    if (int rc = launch_setup(flash_bwd_dkv_bf16_kernel<DH>, smem)) return rc;
    flash_bwd_dkv_bf16_kernel<DH><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int dtype_code, int BH, int seq, int Dh) {
  return (dtype_code == 0 || dtype_code == 1) && BH > 0 && BH <= 65535 &&
         seq > 0 && (Dh == 32 || Dh == 64 || Dh == 128);
}

}  // namespace

// C entry points bound with ctypes (kvedge_torch/ops/_build.py,
// kvedge_torch/ops/attention.py). dtype_code: 0 = float32, 1 = bfloat16
// (bf16 pointers 16-byte aligned). Each returns cudaGetLastError() after
// its launch (0 = launched), or -1 for a shape it does not take (Dh not
// in {32, 64, 128}, BH or T < 1, BH > 65535); the wrapper checks those
// before calling.

#define KVEDGE_DISPATCH(FN, ...)                      \
  do {                                                \
    if (Dh == 32) return FN<32>(__VA_ARGS__);         \
    if (Dh == 64) return FN<64>(__VA_ARGS__);         \
    return FN<128>(__VA_ARGS__);                      \
  } while (0)

extern "C" int kvedge_flash_fwd(int dtype_code, const void* q, const void* k,
                                const void* v, void* out, float* lse, int BH,
                                int seq, int Dh, float scale, void* stream) {
  if (!shape_ok(dtype_code, BH, seq, Dh)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  KVEDGE_DISPATCH(fwd, dtype_code, q, k, v, out, lse, BH, seq, scale, st);
}

extern "C" int kvedge_flash_bwd_dq(int dtype_code, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq, int BH,
                                   int seq, int Dh, float scale,
                                   void* stream) {
  if (!shape_ok(dtype_code, BH, seq, Dh)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  KVEDGE_DISPATCH(bwd_dq, dtype_code, q, k, v, dout, lse, delta, dq, BH, seq,
                  scale, st);
}

extern "C" int kvedge_flash_bwd_dkv(int dtype_code, const void* q,
                                    const void* k, const void* v,
                                    const void* dout, const float* lse,
                                    const float* delta, void* dk, void* dv,
                                    int BH, int seq, int Dh, float scale,
                                    void* stream) {
  if (!shape_ok(dtype_code, BH, seq, Dh)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  KVEDGE_DISPATCH(bwd_dkv, dtype_code, q, k, v, dout, lse, delta, dk, dv, BH,
                  seq, scale, st);
}
