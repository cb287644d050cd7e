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
// Design. Every CTA owns q or k rows of one head, in 64-row tiles:
//   forward / dq: a loop over the k tiles up to and including the
//     diagonal (tiles above it are never loaded).
//   dk/dv:        a loop over the q tiles from the diagonal down. Each
//     CTA owns its dk/dv rows, so there are no atomics and the backward
//     is deterministic, as the TPU grid is.
// The bf16 forward (B2) is built for Hopper (section "bf16, B2" below):
// a CTA is one warpgroup that owns two 64-row q tiles of a head in turn,
// n_q - 1 - p and then p, so the CTAs are of one size; TMA brings both Q
// tiles and then the K/V tiles of the two as one stream into 2-stage
// rings of 128-byte (Dh 32: 64-byte) swizzled shared memory guarded by
// mbarriers, K's stage refilled as soon as its Q K^T is done and V's
// when its P V is, so each load is issued an iteration or more before
// its use; S = Q K^T and O += P V run on wgmma (A = P from registers, V
// read MN-major), the next tile's S overlapping this tile's softmax and
// P V; the causal mask runs on the diagonal tile only; O leaves through
// shared memory as one TMA store per q tile. At the flagship shape it
// holds 4 CTAs an SM, and their warps still wait on the loads ~18% of
// the time; the tensor cores and the exponentials are each busy about a
// quarter of it. Less L2 traffic (two warpgroups sharing each K/V tile),
// a persistent grid, a third ring stage, an L2 prefetch of later heads,
// Q read from registers and L2 eviction policies all measured slower or
// no faster (PERF.md, `kvedge_torch/tools/flash_fwd_variants.py`).
// The bf16 backward (B3, B4) is built the same way (section "bf16, B3
// and B4"): pairs of tiles a CTA, the tiles it owns resident, the others
// streamed through TMA rings, S and dP on wgmma with both operands in
// shared memory, and the gradient products with p or ds rounded to bf16
// as they are packed into wgmma's register A operand. B3 (dq) keeps Q and
// dO and streams K and V, and runs dQ's product beside the next tile's S
// and dP; B4 (dk, dv) keeps K and V, streams Q and dO with their lse and
// delta entries, and computes S^T and dP^T, whose key rows make p^T and
// ds^T the A operand of dV and dK without a transpose. fp32 has no
// tensor-core path of full
// fp32 precision (TF32 would round the operands), so it runs on the CUDA
// cores with fp32 FMA: 256 threads (16 x 16), thread (ty, tx) owning tile
// rows ty + 16 i and tile columns tx + 16 j (i, j < 4) of every 64 x 64
// score tile, so a row's max and sum reduce over the 16 lanes of a
// half-warp and the running max, sum and accumulator of a row stay in one
// thread; fp32 tiles in shared memory, those read along their rows by
// the 16 lanes with a (Dh + 1) stride so the lanes fall on separate
// banks. Its bound at the fp32 peak (67 TFLOP/s) is 0.26 / 0.39 / 0.51 ms
// at the shape above.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---- bf16, B2: forward on wgmma, with TMA into an mbarrier ring ----------
//
// A CTA is one warpgroup (128 threads) of one head. It owns two 64-row q
// tiles in turn, n_q - 1 - p and then p (pair p of the causal triangle's
// rows; an odd n_q leaves its middle tile alone in the last pair), so
// every CTA but that one reads n_q + 1 k tiles: the CTAs are of one size,
// and the second q tile's first K/V tiles stream in while the first is
// still being computed. Thread 0 issues every TMA load: both Q tiles at
// the start, then the two q tiles' k tiles as one stream, tile g of it
// into stage g % kStages of the K ring and of the V ring, each
// completing on its own "full" mbarrier. A stage of either ring is
// reloaded once every warp has arrived on its "empty" mbarrier, which a
// warp does when its wgmmas on the tile are complete: K's after Q K^T,
// V's after P V, an iteration later. Tiles live in shared memory as TMA
// writes them with 128-byte swizzle (64-byte for Dh 32), in panels of 64
// rows by kCols columns (Dh 128: two panels), which is the canonical
// layout the wgmma descriptors name: K-major for Q and K, MN-major for V.
// O is rounded into its q tile's Q buffer in the same layout and leaves
// by TMA store.
// Per k tile kt the tensor cores run S_kt = Q K_kt^T together with
// O += P_{kt-1} V_{kt-1}, and the softmax of S_kt overlaps the second.
// The softmax runs in base 2 on the raw scores, p = 2^(s c - m c) with
// c = scale * log2(e), which is exp(s * scale - m * scale) up to the
// last bits of fp32.

constexpr int kStages = 2;  // K/V tiles in flight

// CTAs an SM should hold: 4 caps a thread at 128 registers, which the
// Dh 32 and 64 kernels fit; Dh 128's output accumulator needs more.
constexpr int fwd_min_blocks(int dh) { return dh > 64 ? 3 : 4; }

template <int DH>
struct FwdTile {
  static constexpr int kCols = DH < 64 ? DH : 64;      // columns of a panel
  static constexpr int kPanels = DH / kCols;
  static constexpr int kRowBytes = 2 * kCols;          // the swizzle span
  static constexpr int kPanelBytes = kTile * kRowBytes;
  static constexpr int kBytes = kPanels * kPanelBytes;  // one 64-row tile
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // B128 / B64
};


// Row tile `tile` of head bh of a [BH, T, DH] map into the tile at dst,
// completing on bar, whose expected bytes the caller has raised.
template <int DH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int tile, int bh) {
  using L = FwdTile<DH>;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
    tma_load(dst + p * L::kPanelBytes, map, bar, p * L::kCols, tile * kTile,
             bh);
}

// The tile at src to row tile `tile` of head bh of a [BH, T, DH] map.
template <int DH>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map,
                                               uint32_t src, int tile,
                                               int bh) {
  using L = FwdTile<DH>;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
    tma_store(map, src + p * L::kPanelBytes, p * L::kCols, tile * kTile, bh);
}

// Row tile `tile` of head bh, the g-th of a stream, into stage g % S of
// the ring at base, completing on the stage's "full" barrier.
template <int DH, int S>
__device__ __forceinline__ void ring_load(const CUtensorMap* map,
                                          uint32_t base, uint32_t full, int g,
                                          int tile, int bh) {
  using L = FwdTile<DH>;
  const int s = g % S;
  mbar_expect_tx(full + 8u * s, L::kBytes);
  tma_tile<DH>(base + s * L::kBytes, map, full + 8u * s, tile, bh);
}

// This warp has read the stream's tile g of a ring of S stages for the
// last time: it arrives on the stage's "empty" barrier. Returns true in
// thread 0 when the stage is to be refilled with tile g + S, once every
// warp has arrived; the caller refills it, then calls __syncwarp().
template <int S>
__device__ __forceinline__ bool ring_release(uint32_t empty, int g,
                                             int n_loads) {
  const int s = g % S;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8u * s);
  if (threadIdx.x == 0 && g + S < n_loads) {
    mbar_wait(empty + 8u * s, (g / S) & 1);
    return true;
  }
  return false;
}

// The k tile of the stream's tile g: the first q tile's k tiles 0..first,
// then the second's.
__device__ __forceinline__ int stream_tile(int g, int first) {
  return g <= first ? g : g - first - 1;
}

// This warp has read stream tile g of a ring of S stages for the last
// time; thread 0, once every warp has, refills the stage with the
// stream's tile g + S, if there is one.
template <int DH, int S>
__device__ __forceinline__ void release_stage(const CUtensorMap* map,
                                              uint32_t base, uint32_t full,
                                              uint32_t empty, int g,
                                              int n_loads, int first,
                                              int bh) {
  if (ring_release<S>(empty, g, n_loads))
    ring_load<DH, S>(map, base, full, g + S, stream_tile(g + S, first), bh);
  __syncwarp();
}

// The tile in shared memory at so (as stage_o lays it out) leaves by TMA
// store: every warp's stores are made visible to the async proxy, then
// thread 0 issues the store, which runs on while the CTA goes on.
template <int DH>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           uint32_t so, int tile, int bh) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_store_tile<DH>(map, so, tile, bh);
    bulk_commit();
  }
}

// The online softmax of one 64 x 64 tile of raw scores held as wgmma
// accumulators: s[4 nt + e] sits at tile row r0 + 8 (e / 2) and tile
// column 8 nt + 2 t + e % 2. Masks the diagonal tile, updates the running
// max m (of the raw scores) and sum l, leaves p = 2^(s c - m c) in s
// (it enters l unrounded), and returns in corr the factor the output
// accumulator must take.
__device__ __forceinline__ void online_softmax(float (&s)[32], bool diag,
                                               int r0, int t, float c,
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (diag && 8 * nt + 2 * t + (e & 1) > r0 + 8 * (e >> 1))
        s[4 * nt + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * nt + e]);
    }
  float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // Column 0 of tile 0 is visible to every row, so m_new is finite.
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    corr[h] = ex2((m[h] - m_new) * c);
    m[h] = m_new;
    mc[h] = m_new * c;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(sum[h]);
}

// p rounded to bf16 as the A fragments of P V: the accumulators of score
// columns 16 kc .. 16 kc + 15 are exactly the A fragment of k step kc.
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    a[nt >> 1][2 * (nt & 1)] = pack_bf16(s[4 * nt], s[4 * nt + 1]);
    a[nt >> 1][2 * (nt & 1) + 1] = pack_bf16(s[4 * nt + 2], s[4 * nt + 3]);
  }
}

// O = acc / l rounded to bf16 into the tile at so, laid out as tma_load
// lays out a tile (swizzled panels), for tma_store to write: each 16-byte
// chunk c of tile row r sits at chunk c ^ (r mod 8) of its 128-byte row
// (64-byte rows: c ^ (r / 2 mod 4)), so a warp's stores hit 32 banks.
template <int DH>
__device__ __forceinline__ void stage_o(uint32_t so, const float (&o)[DH / 2],
                                        const float (&l)[2], int r0, int t) {
  using L = FwdTile<DH>;
  constexpr uint32_t kMask = L::kRowBytes == 128 ? 7 : 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int col = 8 * nd + 2 * t;
      const uint32_t off = (r0 + 8 * h) * L::kRowBytes + (col % L::kCols) * 2;
      const uint32_t addr = so + (col / L::kCols) * L::kPanelBytes +
                            (off ^ (((off >> 7) & kMask) << 4));
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr),
                   "r"(pack_bf16(o[4 * nd + 2 * h] / l[h],
                                 o[4 * nd + 2 * h + 1] / l[h]))
                   : "memory");
    }
}

// S = Q . K^T for the warpgroup's Q tile at sq and the K tile at sk.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t sq,
                                         uint32_t sk) {
  using L = FwdTile<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off =
        (kk * 16 / L::kCols) * L::kPanelBytes + (kk * 16 % L::kCols) * 2;
    wgmma_ss_n64(s, smem_desc(sq + off, 16, 8 * L::kRowBytes, L::kLayout),
                 smem_desc(sk + off, 16, 8 * L::kRowBytes, L::kLayout),
                 kk > 0);
  }
}

// O += P . V for the P fragments a and the V tile at sv (MN-major).
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t sv) {
  using L = FwdTile<DH>;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wgmma_rs(o, a[kc],
             smem_desc(sv + kc * 16 * L::kRowBytes, L::kPanelBytes,
                       8 * L::kRowBytes, L::kLayout));
}

template <int DH>
__global__ void __launch_bounds__(128, fwd_min_blocks(DH))
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_o,
                      float* __restrict__ lse, int seq, float scale) {
  using L = FwdTile<DH>;
  extern __shared__ uint8_t fwd_smem[];
  // bars: [0, 1] the Q tiles, [2 + s] K full, [2 + kStages + s] V full,
  // [2 + 2 kStages + s] K empty, [2 + 3 kStages + s] V empty.
  __shared__ __align__(8) uint64_t bars[2 + 4 * kStages];
  const uint32_t sq = (smem_u32(fwd_smem) + 1023u) & ~1023u;  // 2 Q tiles
  const uint32_t sk = sq + 2 * L::kBytes;                       // ring of K
  const uint32_t sv = sk + kStages * L::kBytes;                 // ring of V
  const uint32_t bar_q = smem_u32(bars);
  const uint32_t full_k = bar_q + 16u;
  const uint32_t full_v = full_k + 8u * kStages;
  const uint32_t empty_k = full_v + 8u * kStages;
  const uint32_t empty_v = empty_k + 8u * kStages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // tile rows r0, r0 + 8
  const int t = lane & 3;
  const int n_q = (seq + kTile - 1) / kTile;
  const int pair = blockIdx.x;
  const int bh = blockIdx.y;
  // The CTA's q tiles, the heavier first; tile qt reads k tiles 0..qt.
  const int first = n_q - 1 - pair;
  const int n_items = pair < first ? 2 : 1;
  const int n_loads = first + 1 + (n_items == 2 ? pair + 1 : 0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8u, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8u * s, 1);
      mbar_init(full_v + 8u * s, 1);
      mbar_init(empty_k + 8u * s, 4);  // one arrival per warp
      mbar_init(empty_v + 8u * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int it = 0; it < n_items; ++it) {
      mbar_expect_tx(bar_q + 8u * it, L::kBytes);
      tma_tile<DH>(sq + it * L::kBytes, &map_q, bar_q + 8u * it,
                   it == 0 ? first : pair, bh);
    }
    for (int g = 0; g < kStages && g < n_loads; ++g) {
      ring_load<DH, kStages>(&map_k, sk, full_k, g, stream_tile(g, first),
                             bh);
      ring_load<DH, kStages>(&map_v, sv, full_v, g, stream_tile(g, first),
                             bh);
    }
  }

  const float c = scale * kLog2e;
  int g0 = 0;  // the stream index of this q tile's k tile 0
  for (int it = 0; it < n_items; ++it) {
    const int qt = it == 0 ? first : pair;
    const int nk = qt + 1;  // k tiles 0..qt; qt is the diagonal
    const uint32_t sqt = sq + it * L::kBytes;
    float s[32], o[DH / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float corr[2];
    uint32_t a[4][4];

    // Tile 0's scores and probabilities.
    mbar_wait(bar_q + 8u * it, 0);
    mbar_wait(full_k + 8u * (g0 % kStages), (g0 / kStages) & 1);
    fence_regs(s);
    wgmma_fence();
    issue_qk<DH>(s, sqt, sk + (g0 % kStages) * L::kBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release_stage<DH, kStages>(&map_k, sk, full_k, empty_k, g0, n_loads,
                               first, bh);
    online_softmax(s, nk == 1, r0, t, c, m, l, corr);
    pack_p(s, a);

    // Then, for each later tile kt, S_kt = Q K_kt^T runs on the tensor
    // cores while they also run O += P_{kt-1} V_{kt-1}; the softmax of
    // S_kt overlaps the second product, and O takes its correction, and
    // P_kt its place in the A fragments, once that product is done. Each
    // consumed stage is released, and thread 0 refills it with the
    // stream's tile kStages further on, which may be the next q tile's.
    for (int kt = 1; kt <= nk; ++kt) {
      const int g = g0 + kt;  // stream index of tile kt
      const int sp = (g - 1) % kStages;
      mbar_wait(full_v + 8u * sp, ((g - 1) / kStages) & 1);
      fence_regs(o);
      fence_regs(a);
      if (kt < nk) {
        const int st = g % kStages;
        mbar_wait(full_k + 8u * st, (g / kStages) & 1);
        fence_regs(s);
        wgmma_fence();
        issue_qk<DH>(s, sqt, sk + st * L::kBytes);
        wgmma_commit();
        issue_pv<DH>(o, a, sv + sp * L::kBytes);
        wgmma_commit();
        fence_regs(s);
        fence_regs(o);
        fence_regs(a);
        wgmma_wait<1>();  // S_kt is ready; P V may still run
        fence_regs(s);
        release_stage<DH, kStages>(&map_k, sk, full_k, empty_k, g, n_loads,
                                   first, bh);
        online_softmax(s, kt == nk - 1, r0, t, c, m, l, corr);
      } else {  // the last tile's P V alone
        wgmma_fence();
        issue_pv<DH>(o, a, sv + sp * L::kBytes);
        wgmma_commit();
        fence_regs(o);
        fence_regs(a);
      }
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(a);
      release_stage<DH, kStages>(&map_v, sv, full_v, empty_v, g - 1, n_loads,
                                 first, bh);
      if (kt < nk) {
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        pack_p(s, a);
      }
    }
    g0 += nk;

    // The epilogue: O through this q tile's Q buffer (its last Q K^T is
    // done) and one TMA store, which runs on while the next q tile
    // computes; the LSE straight to memory.
    stage_o<DH>(sqt, o, l, r0, t);
    store_tile<DH>(&map_o, sqt, qt, bh);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qt * kTile + r0 + 8 * h;
      if (t == 0 && row < seq)
        lse[static_cast<size_t>(bh) * seq + row] = m[h] * scale + logf(l[h]);
    }
  }
  if (tid == 0) bulk_wait_read();  // shared memory outlives the stores
}

// ---- bf16, B3 and B4: the backward on wgmma, with TMA into mbarrier rings --
//
// Both passes are built from B2's pieces. A CTA is one warpgroup of one
// head that owns two 64-row tiles in turn, the tiles of pair p (n - 1 - p
// and p; an odd n leaves the middle tile alone in the last pair), so that
// the CTAs are of one size. TMA loads every tile in B2's swizzled panels;
// the first two products of a tile run on wgmma with both operands
// K-major in shared memory, the others with A, p or ds rounded to bf16,
// straight from the registers that hold the scores and B read MN-major.
// The gradient is rounded into the shared memory of a tile the CTA reads
// no more and leaves by TMA store. Every output row is written by one CTA
// in a fixed order: no atomics, and the backward is bitwise deterministic.
//
// B3 (dq): the CTA's two q tiles and their dO tiles stay resident; the k
// tiles of both stream through a K ring and a V ring as in B2. Per k tile
// S = Q K^T and dP = dO V^T run together; V's stage is released when dP
// is done; p = 2^(s c - lse log2 e) (the mask on the diagonal tile only)
// and ds = p (dp - delta); dQ += (ds -> bf16) K then runs on the tensor
// cores together with the next tile's S and dP. K is read by both
// products, so its stage is released after dQ's, and its ring has a third
// stage to keep its load an iteration ahead.
//
// B4 (dk, dv): the CTA's two k tiles (the heavier first) keep K and V
// resident; the q tiles from each diagonal down stream through a Q ring
// and a dO ring, each stage with its 64 lse or delta entries, which a 1-D
// TMA box brings on the same mbarrier. Per q tile S^T = K Q^T and dP^T =
// V dO^T: the accumulators have key rows, so p^T and ds^T are exactly the
// A fragments of dV += (p^T -> bf16) dO and dK += (ds^T -> bf16) Q, with
// dO and Q read MN-major as B2 reads V. Four sets of accumulators (S^T,
// dP^T, dK, dV) leave no registers for the next tile's products to be in
// flight, so a CTA runs its tile's four in turn and the SM overlaps its
// CTAs (3 an SM at Dh 64). Query columns past T (TMA reads them as zeros,
// and their lse as the next head's) are masked like the causal ones.
//
// Dh 128: B4's accumulators alone take 192 registers a thread, and either
// pass's tiles 130-150 KB, so both run one CTA an SM at up to 255
// registers; Dh 32 and 64 fit 4 and 3.

constexpr int kStagesDqK = 3;  // B3's K ring: K is read by two products
constexpr int kStagesDqV = 2;  // B3's V ring
constexpr int kStagesDkv = 2;  // B4's Q and dO rings
constexpr int kRowBytes64 = kTile * 4;  // 64 fp32 entries of lse or delta

__host__ __device__ constexpr int bwd_min_blocks(int dh) {
  return dh > 64 ? 1 : dh > 32 ? 3 : 4;
}

// acc * mul rounded to bf16 into the tile at so, in the layout stage_o
// writes (the swizzled panels tma_store reads).
template <int DH>
__device__ __forceinline__ void stage_scaled(uint32_t so,
                                             const float (&acc)[DH / 2],
                                             float mul, int r0, int t) {
  using L = FwdTile<DH>;
  constexpr uint32_t kMask = L::kRowBytes == 128 ? 7 : 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int col = 8 * nd + 2 * t;
      const uint32_t off = (r0 + 8 * h) * L::kRowBytes + (col % L::kCols) * 2;
      const uint32_t addr = so + (col / L::kCols) * L::kPanelBytes +
                            (off ^ (((off >> 7) & kMask) << 4));
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr),
                   "r"(pack_bf16(acc[4 * nd + 2 * h] * mul,
                                 acc[4 * nd + 2 * h + 1] * mul))
                   : "memory");
    }
}

// B3: the score tile's p = 2^(s c - lse log2 e) and ds = p (dp - delta),
// left in s. Element i of a wgmma accumulator sits at tile row
// r0 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 t + i % 2; lc and dl hold
// lse log2 e and delta of rows r0 and r0 + 8. On the diagonal tile keys
// past the query are masked.
__device__ __forceinline__ void dq_ds(float (&s)[32], const float (&dp)[32],
                                      bool diag, int r0, int t, float c,
                                      const float (&lc)[2],
                                      const float (&dl)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * t + (i & 1);
    const float p =
        diag && col > r0 + 8 * h ? 0.f : ex2(fmaf(s[i], c, -lc[h]));
    s[i] = p * (dp[i] - dl[h]);
  }
}

template <int DH>
__global__ void __launch_bounds__(128, bwd_min_blocks(DH))
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_dq,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, int seq,
                         float scale) {
  using L = FwdTile<DH>;
  constexpr int SK = kStagesDqK;
  constexpr int SV = kStagesDqV;
  extern __shared__ uint8_t bwd_smem[];
  // bars: [0, 1] each q tile's Q and dO, then K full and K empty (SK
  // each), then V full and V empty (SV each).
  __shared__ __align__(8) uint64_t bars[2 + 2 * SK + 2 * SV];
  const uint32_t sq = (smem_u32(bwd_smem) + 1023u) & ~1023u;  // 2 Q tiles
  const uint32_t sdo = sq + 2 * L::kBytes;                     // 2 dO tiles
  const uint32_t sk = sdo + 2 * L::kBytes;                     // ring of K
  const uint32_t sv = sk + SK * L::kBytes;                     // ring of V
  const uint32_t bar_q = smem_u32(bars);
  const uint32_t full_k = bar_q + 16u;
  const uint32_t empty_k = full_k + 8u * SK;
  const uint32_t full_v = empty_k + 8u * SK;
  const uint32_t empty_v = full_v + 8u * SV;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // tile rows r0, r0 + 8
  const int t = lane & 3;
  const int n_q = (seq + kTile - 1) / kTile;
  const int pair = blockIdx.x;
  const int bh = blockIdx.y;
  // The CTA's q tiles, the heavier first; tile qt reads k tiles 0..qt.
  const int first = n_q - 1 - pair;
  const int n_items = pair < first ? 2 : 1;
  const int n_loads = first + 1 + (n_items == 2 ? pair + 1 : 0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8u, 1);
    for (int s = 0; s < SK; ++s) {
      mbar_init(full_k + 8u * s, 1);
      mbar_init(empty_k + 8u * s, 4);  // one arrival per warp
    }
    for (int s = 0; s < SV; ++s) {
      mbar_init(full_v + 8u * s, 1);
      mbar_init(empty_v + 8u * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int it = 0; it < n_items; ++it) {
      const int qt = it == 0 ? first : pair;
      mbar_expect_tx(bar_q + 8u * it, 2 * L::kBytes);
      tma_tile<DH>(sq + it * L::kBytes, &map_q, bar_q + 8u * it, qt, bh);
      tma_tile<DH>(sdo + it * L::kBytes, &map_do, bar_q + 8u * it, qt, bh);
    }
    for (int g = 0; g < SK && g < n_loads; ++g)
      ring_load<DH, SK>(&map_k, sk, full_k, g, stream_tile(g, first), bh);
    for (int g = 0; g < SV && g < n_loads; ++g)
      ring_load<DH, SV>(&map_v, sv, full_v, g, stream_tile(g, first), bh);
  }

  const float c = scale * kLog2e;
  float s[32], dp[32], dq[DH / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  uint32_t a[4][4];
  int g0 = 0;  // the stream index of this q tile's k tile 0
  for (int it = 0; it < n_items; ++it) {
    const int qt = it == 0 ? first : pair;
    const int nk = qt + 1;  // k tiles 0..qt; qt is the diagonal
    const uint32_t sqt = sq + it * L::kBytes;
    const uint32_t sdot = sdo + it * L::kBytes;
    float lc[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qt * kTile + r0 + 8 * h;
      const size_t at = static_cast<size_t>(bh) * seq + row;
      lc[h] = row < seq ? lse[at] * kLog2e : 0.f;
      dl[h] = row < seq ? delta[at] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
    mbar_wait(bar_q + 8u * it, 0);

    // Tile 0's S and dP, then its ds as dQ's A fragments.
    mbar_wait(full_k + 8u * (g0 % SK), (g0 / SK) & 1);
    mbar_wait(full_v + 8u * (g0 % SV), (g0 / SV) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_qk<DH>(s, sqt, sk + (g0 % SK) * L::kBytes);
    issue_qk<DH>(dp, sdot, sv + (g0 % SV) * L::kBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    release_stage<DH, SV>(&map_v, sv, full_v, empty_v, g0, n_loads, first,
                          bh);
    dq_ds(s, dp, nk == 1, r0, t, c, lc, dl);
    pack_p(s, a);

    // Then, for each later tile kt, S_kt and dP_kt run on the tensor cores
    // with dQ += ds_{kt-1} K_{kt-1}; ds_kt is computed while the latter
    // runs, and takes its place in the A fragments once it is done.
    for (int kt = 1; kt <= nk; ++kt) {
      const int g = g0 + kt;  // stream index of tile kt
      const uint32_t skp = sk + ((g - 1) % SK) * L::kBytes;
      fence_regs(dq);
      fence_regs(a);
      if (kt < nk) {
        mbar_wait(full_k + 8u * (g % SK), (g / SK) & 1);
        mbar_wait(full_v + 8u * (g % SV), (g / SV) & 1);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_qk<DH>(s, sqt, sk + (g % SK) * L::kBytes);
        issue_qk<DH>(dp, sdot, sv + (g % SV) * L::kBytes);
        wgmma_commit();
        issue_pv<DH>(dq, a, skp);
        wgmma_commit();
        fence_regs(s);
        fence_regs(dp);
        fence_regs(dq);
        fence_regs(a);
        wgmma_wait<1>();  // S_kt and dP_kt are ready; dQ may still run
        fence_regs(s);
        fence_regs(dp);
        release_stage<DH, SV>(&map_v, sv, full_v, empty_v, g, n_loads,
                              first, bh);
        dq_ds(s, dp, kt == nk - 1, r0, t, c, lc, dl);
      } else {  // the last tile's dQ product alone
        wgmma_fence();
        issue_pv<DH>(dq, a, skp);
        wgmma_commit();
        fence_regs(dq);
        fence_regs(a);
      }
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(a);
      release_stage<DH, SK>(&map_k, sk, full_k, empty_k, g - 1, n_loads,
                            first, bh);
      if (kt < nk) pack_p(s, a);
    }
    g0 += nk;

    // dq = (acc * scale) -> bf16 through this q tile's Q buffer, which no
    // product reads any more.
    __syncthreads();
    stage_scaled<DH>(sqt, dq, scale, r0, t);
    store_tile<DH>(&map_dq, sqt, qt, bh);
  }
  if (tid == 0) bulk_wait_read();  // shared memory outlives the stores
}

// B4: p^T of a transposed score tile (key rows, query columns), left in s:
// p = 2^(s c - lse log2 e), 0 for a query column past T (at or past
// qmax) and, on the diagonal tile, for a query before the key. lrow holds
// the stage's 64 lse entries.
__device__ __forceinline__ void dkv_p(float (&s)[32], const float* lrow,
                                      bool diag, int qmax, int r0, int t,
                                      float c) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 l = *reinterpret_cast<const float2*>(lrow + 8 * nt + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * nt + 2 * t + (e & 1);
      const bool keep = col < qmax && !(diag && col < r0 + 8 * (e >> 1));
      const float lv = (e & 1) ? l.y : l.x;
      s[4 * nt + e] = keep ? ex2(fmaf(s[4 * nt + e], c, -lv * kLog2e)) : 0.f;
    }
  }
}

// B4: ds^T = p^T (dp^T - delta), left in dp; drow holds the stage's 64
// delta entries.
__device__ __forceinline__ void dkv_ds(float (&dp)[32], const float (&s)[32],
                                       const float* drow, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 d = *reinterpret_cast<const float2*>(drow + 8 * nt + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * nt + e] = s[4 * nt + e] * (dp[4 * nt + e] - ((e & 1) ? d.y : d.x));
  }
}

// B4's Q tile qt with its lse entries, and its dO tile with its delta
// entries, the stream's tile g, into stage g % kStagesDkv of the two
// rings; each completes on its own "full" barrier.
template <int DH>
__device__ __forceinline__ void dkv_load(
    const CUtensorMap* map_q, const CUtensorMap* map_do,
    const CUtensorMap* map_lse, const CUtensorMap* map_delta, uint32_t sq,
    uint32_t sdo, uint32_t srow, uint32_t full_q, uint32_t full_do, int g,
    int qt, int bh, int seq) {
  using L = FwdTile<DH>;
  const int s = g % kStagesDkv;
  const int entry = bh * seq + qt * kTile;
  mbar_expect_tx(full_q + 8u * s, L::kBytes + kRowBytes64);
  tma_tile<DH>(sq + s * L::kBytes, map_q, full_q + 8u * s, qt, bh);
  tma_load_row(srow + s * kRowBytes64, map_lse, full_q + 8u * s, entry);
  mbar_expect_tx(full_do + 8u * s, L::kBytes + kRowBytes64);
  tma_tile<DH>(sdo + s * L::kBytes, map_do, full_do + 8u * s, qt, bh);
  tma_load_row(srow + (kStagesDkv + s) * kRowBytes64, map_delta,
               full_do + 8u * s, entry);
}

template <int DH>
__global__ void __launch_bounds__(128, bwd_min_blocks(DH))
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_dk,
                          const __grid_constant__ CUtensorMap map_dv,
                          const __grid_constant__ CUtensorMap map_lse,
                          const __grid_constant__ CUtensorMap map_delta,
                          int seq, float scale) {
  using L = FwdTile<DH>;
  constexpr int S = kStagesDkv;
  extern __shared__ uint8_t bwd_smem[];
  // bars: [0, 1] each k tile's K and V, then Q full, dO full and the
  // stages' empty barriers (S each; a stage of both rings is freed at once).
  __shared__ __align__(8) uint64_t bars[2 + 3 * S];
  const uint32_t base = smem_u32(bwd_smem);
  const uint32_t sk = (base + 1023u) & ~1023u;  // 2 K tiles
  const uint32_t sv = sk + 2 * L::kBytes;       // 2 V tiles
  const uint32_t sq = sv + 2 * L::kBytes;       // ring of Q
  const uint32_t sdo = sq + S * L::kBytes;      // ring of dO
  const uint32_t srow = sdo + S * L::kBytes;    // lse rows, then delta rows
  const float* rows = reinterpret_cast<const float*>(bwd_smem + (srow - base));
  const uint32_t bar_kv = smem_u32(bars);
  const uint32_t full_q = bar_kv + 16u;
  const uint32_t full_do = full_q + 8u * S;
  const uint32_t empty = full_do + 8u * S;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // tile rows r0, r0 + 8
  const int t = lane & 3;
  const int n = (seq + kTile - 1) / kTile;
  const int pair = blockIdx.x;
  const int bh = blockIdx.y;
  // The CTA's k tiles, the heavier first; k tile kt reads q tiles kt..n-1.
  const int kt0 = pair;
  const int kt1 = n - 1 - pair;
  const int n_items = kt0 < kt1 ? 2 : 1;
  const int n_first = n - kt0;
  const int n_loads = n_first + (n_items == 2 ? n - kt1 : 0);
  // The q tile of the stream's tile g.
  auto stream_q = [=](int g) { return g < n_first ? kt0 + g : kt1 + g - n_first; };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8u, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_q + 8u * s, 1);
      mbar_init(full_do + 8u * s, 1);
      mbar_init(empty + 8u * s, 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int it = 0; it < n_items; ++it) {
      const int kt = it == 0 ? kt0 : kt1;
      mbar_expect_tx(bar_kv + 8u * it, 2 * L::kBytes);
      tma_tile<DH>(sk + it * L::kBytes, &map_k, bar_kv + 8u * it, kt, bh);
      tma_tile<DH>(sv + it * L::kBytes, &map_v, bar_kv + 8u * it, kt, bh);
    }
    for (int g = 0; g < S && g < n_loads; ++g)
      dkv_load<DH>(&map_q, &map_do, &map_lse, &map_delta, sq, sdo, srow,
                   full_q, full_do, g, stream_q(g), bh, seq);
  }

  const float c = scale * kLog2e;
  float s[32], dp[32], dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  uint32_t ap[4][4], ads[4][4];
  int g = 0;  // the stream index of the current q tile
  for (int it = 0; it < n_items; ++it) {
    const int kt = it == 0 ? kt0 : kt1;
    const uint32_t skt = sk + it * L::kBytes;
    const uint32_t svt = sv + it * L::kBytes;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(bar_kv + 8u * it, 0);
    for (int qt = kt; qt < n; ++qt, ++g) {
      const int st = g % S;
      const int ph = (g / S) & 1;
      const uint32_t sqs = sq + st * L::kBytes;
      const uint32_t sdos = sdo + st * L::kBytes;
      mbar_wait(full_q + 8u * st, ph);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_qk<DH>(s, skt, sqs);  // S^T = K Q^T
      wgmma_commit();
      mbar_wait(full_do + 8u * st, ph);
      issue_qk<DH>(dp, svt, sdos);  // dP^T = V dO^T
      wgmma_commit();
      fence_regs(s);
      fence_regs(dp);
      wgmma_wait<1>();  // S^T is ready; dP^T may still run
      fence_regs(s);
      dkv_p(s, rows + st * kTile, qt == kt, seq - qt * kTile, r0, t, c);
      wgmma_wait<0>();
      fence_regs(dp);
      dkv_ds(dp, s, rows + (S + st) * kTile, t);
      pack_p(s, ap);
      pack_p(dp, ads);
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(ap);
      fence_regs(ads);
      wgmma_fence();
      issue_pv<DH>(dv, ap, sdos);  // dV += (p^T -> bf16) dO
      issue_pv<DH>(dk, ads, sqs);  // dK += (ds^T -> bf16) Q
      wgmma_commit();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(ap);
      fence_regs(ads);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (ring_release<S>(empty, g, n_loads))
        dkv_load<DH>(&map_q, &map_do, &map_lse, &map_delta, sq, sdo, srow,
                     full_q, full_do, g + S, stream_q(g + S), bh, seq);
      __syncwarp();
    }

    // dk = (acc * scale) -> bf16 and dv = acc -> bf16 through this k
    // tile's K and V buffers, which no product reads any more.
    __syncthreads();
    stage_scaled<DH>(skt, dk, scale, r0, t);
    stage_scaled<DH>(svt, dv, 1.f, r0, t);
    store_tile<DH>(&map_dk, skt, kt, bh);
    if (tid == 0) {
      tma_store_tile<DH>(&map_dv, svt, kt, bh);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read();  // shared memory outlives the stores
}

// ---- launchers ---------------------------------------------------------------

// The tensor map of a bf16 [BH, T, DH] array in boxes of 64 rows by one
// swizzle panel; rows past T read as zeros and no box crosses a head.
template <int DH>
int encode_tile_map(CUtensorMap* map, const void* ptr, int BH, int seq) {
  using L = FwdTile<DH>;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {DH * sizeof(bf16),
                                 static_cast<cuuint64_t>(seq) * DH *
                                     sizeof(bf16)};
  const cuuint32_t box[3] = {L::kCols, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return static_cast<int>(
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// The tensor map of an fp32 [BH, T] array (lse, delta) as one row of
// BH * T entries, in boxes of 64: a box that starts in a head's last,
// partial tile reads on into the next head's entries (zeros past the
// end), which the kernel masks.
int encode_row_map(CUtensorMap* map, const float* ptr, int BH, int seq) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(BH) * seq};
  const cuuint64_t strides[1] = {0};  // a rank-1 map has none
  const cuuint32_t box[1] = {kTile};
  const cuuint32_t elem[1] = {1};
  return static_cast<int>(
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int DH>
int fwd(int dtype_code, const void* q, const void* k, const void* v,
        void* out, float* lse, int BH, int seq, float scale,
        cudaStream_t stream) {
  if (dtype_code == 0) {
    const dim3 grid((seq + kTile - 1) / kTile, BH);
    const int smem = fwd_smem_floats(DH) * static_cast<int>(sizeof(float));
    if (int rc = launch_setup(flash_fwd_kernel<DH>, smem)) return rc;
    flash_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, seq,
        scale);
  } else {
    CUtensorMap map_q, map_k, map_v, map_o;
    if (int rc = encode_tile_map<DH>(&map_q, q, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_k, k, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_v, v, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_o, out, BH, seq)) return rc;
    // 1024 bytes of slack to align the tiles for the 128-byte swizzle.
    const int smem = 1024 + (2 + 2 * kStages) * FwdTile<DH>::kBytes;
    if (int rc = launch_setup(flash_fwd_bf16_kernel<DH>, smem)) return rc;
    const int n_q = (seq + kTile - 1) / kTile;
    const dim3 grid((n_q + 1) / 2, BH);  // one CTA a pair of q tiles
    flash_fwd_bf16_kernel<DH><<<grid, 128, smem, stream>>>(
        map_q, map_k, map_v, map_o, lse, seq, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int bwd_dq(int dtype_code, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta, void* dq,
           int BH, int seq, float scale, cudaStream_t stream) {
  const int n_q = (seq + kTile - 1) / kTile;
  if (dtype_code == 0) {
    const int smem = dq_smem_floats(DH) * static_cast<int>(sizeof(float));
    if (int rc = launch_setup(flash_bwd_dq_kernel<DH>, smem)) return rc;
    flash_bwd_dq_kernel<DH><<<dim3(n_q, BH), kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), seq, scale);
  } else {
    CUtensorMap map_q, map_k, map_v, map_do, map_dq;
    if (int rc = encode_tile_map<DH>(&map_q, q, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_k, k, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_v, v, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_do, dout, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_dq, dq, BH, seq)) return rc;
    // 1024 bytes of slack to align the tiles for the 128-byte swizzle.
    const int smem =
        1024 + (4 + kStagesDqK + kStagesDqV) * FwdTile<DH>::kBytes;
    if (int rc = launch_setup(flash_bwd_dq_bf16_kernel<DH>, smem)) return rc;
    // One CTA a pair of q tiles.
    flash_bwd_dq_bf16_kernel<DH><<<dim3((n_q + 1) / 2, BH), 128, smem,
                                   stream>>>(map_q, map_k, map_v, map_do,
                                             map_dq, lse, delta, seq, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int bwd_dkv(int dtype_code, const void* q, const void* k, const void* v,
            const void* dout, const float* lse, const float* delta, void* dk,
            void* dv, int BH, int seq, float scale, cudaStream_t stream) {
  const int n_k = (seq + kTile - 1) / kTile;
  if (dtype_code == 0) {
    const int smem = dkv_smem_floats(DH) * static_cast<int>(sizeof(float));
    if (int rc = launch_setup(flash_bwd_dkv_kernel<DH>, smem)) return rc;
    flash_bwd_dkv_kernel<DH><<<dim3(n_k, BH), kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), seq, scale);
  } else {
    CUtensorMap map_q, map_k, map_v, map_do, map_dk, map_dv, map_lse,
        map_delta;
    if (int rc = encode_tile_map<DH>(&map_q, q, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_k, k, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_v, v, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_do, dout, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_dk, dk, BH, seq)) return rc;
    if (int rc = encode_tile_map<DH>(&map_dv, dv, BH, seq)) return rc;
    if (int rc = encode_row_map(&map_lse, lse, BH, seq)) return rc;
    if (int rc = encode_row_map(&map_delta, delta, BH, seq)) return rc;
    const int smem = 1024 + (4 + 2 * kStagesDkv) * FwdTile<DH>::kBytes +
                     2 * kStagesDkv * kRowBytes64;
    if (int rc = launch_setup(flash_bwd_dkv_bf16_kernel<DH>, smem)) return rc;
    // One CTA a pair of k tiles.
    flash_bwd_dkv_bf16_kernel<DH><<<dim3((n_k + 1) / 2, BH), 128, smem,
                                    stream>>>(map_q, map_k, map_v, map_do,
                                              map_dk, map_dv, map_lse,
                                              map_delta, seq, scale);
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
// (bf16 tensors, and the fp32 lse and delta beside them, 16-byte
// aligned). Each returns cudaGetLastError() after its launch (0 =
// launched), or -1 for a shape it does not take (Dh not in {32, 64, 128},
// BH or T < 1, BH > 65535); the wrapper checks those before calling.

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
