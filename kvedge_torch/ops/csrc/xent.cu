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
//            the target logit is s at the target column, exactly. The
//            bf16 kernel keeps m in log2 units (max(s) log2 e, rounded
//            once), takes exp(s - max) as 2^(s log2 e - m) on the
//            hardware's ex2 (within a few fp32 ulps) and lse as
//            m ln 2 + log(l); each thread keeps its own m and l over its
//            columns until the end, where the four lanes of a row
//            combine theirs.
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
// the operations. The forward also takes N V exponentials (1.05e9 at
// that shape, ~0.3 ms of the SM's ex2 units), which it overlaps with
// its products.
//
// Design. The TPU kernels carry their state across a sequential grid axis
// in VMEM; here one CTA owns a tile of resident rows and loops over every
// tile of the other operand inside itself, so nothing is carried between
// CTAs and there are no atomics: every pass run twice is bit-identical.
//   forward: a CTA owns rows of x and streams E, keeping the running
//            max, sum and target logit of its rows.
//   dx:      a CTA owns rows of x and streams E; per tile it forms ds
//            [rows x 64] and accumulates dx [rows x D] += ds . E_tile.
//   dE:      a CTA owns rows of E and streams x in 64-row tiles; per
//            tile it forms ds^T [rows x 64] and accumulates
//            dE [rows x D] += ds^T . x_tile.
// bf16 is built for Hopper: resident rows and streamed tiles by TMA, the
// streamed ones through a ring of stages guarded by mbarriers, products
// on wgmma, a producer warpgroup and two consumer warpgroups whose
// registers setmaxnreg moves (sections "bf16, B5" and "bf16, B6 and B7"
// below). fp32 has no tensor-core path of full fp32 precision (TF32
// would round the operands), so it runs on the CUDA cores with fp32 FMA:
// 32 resident rows, thread (ty, tx) of 16 x 16 owns score rows ty + 16 i
// (i < 2) and columns tx + 16 j (j < 4), so a row's max and sum reduce
// over a half-warp, and output columns tx + 16 c.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// The fp32 kernels' tiles.
constexpr int kRows = 32;      // resident rows of a CTA
constexpr int kCols = 64;      // rows of a streamed tile (score columns)
constexpr int kThreads = 256;  // 16 x 16
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

// ---- bf16, B5: the forward on wgmma over a TMA ring -----------------------
//
// A CTA of three warpgroups owns 128 resident rows of x, which one TMA
// load per 64-column panel brings at the start: N / 128 CTAs (256 at the
// flagship shape), so E crosses from L2 into shared memory N / 128 times
// (8.4 GB a launch there). Each of the two consumer warpgroups owns 64 of
// the rows; the producer warpgroup, its registers dropped to 40 by
// setmaxnreg so that the consumers may hold 232, streams E through a ring
// of kFwdStages stages guarded by mbarriers. A stage is a K-chunk of a
// score tile: 128 rows of E (the tile's score columns) by 64 columns of D
// (16 KB, one 128-byte swizzled panel), so a tile takes D / 64 stages.
// Both consumers read every stage, and it is refilled once all eight of
// their warps have released it.
//
// Shared memory at D 512: the resident rows 128 x 512 x 2 = 128 KB, the
// ring 6 x 16 KB = 96 KB and 1 KB of slack to align the tiles for the
// swizzle: 225 KB of the 227 KB a block may use, one CTA an SM. (A whole
// [64 x 512] tile a stage would leave room for one stage only.)
//
// A consumer computes its [64 x 128] fp32 score tile S = x . E_tile^T with
// wgmma m64n128k16, both operands K-major in shared memory, four per
// K-chunk, one commit group per K-chunk. It keeps two score tiles in
// registers (2 x 64 a thread) and a copy of the older one (64 more):
// after it issues K-chunk k of tile j it waits until only the last kLag
// groups run and releases the stage of chunk k - kLag, and after chunk
// kLag - 1 it folds tile j - 1 into its rows' running state while the
// tensor cores run tile j. The fold reads the copy, taken before tile j's
// first product issues, and a tile ends with no product running (its
// last kLag stages are released then): a fold on the accumulator itself,
// or products running where the code's paths join, make ptxas serialize
// every wgmma (C7515). kLag is 1: 2 and 3 measured no faster and hold
// more stages. FlashAttention-3's ping-pong, the two consumers taking
// turns, would make the lagging one hold a whole tile of stages (D / 64
// = 8 at D 512), more than the ring has.
//
// Folding a tile: columns at or past V (TMA fills E's rows past V with
// zeros, a score of 0) become -inf; the target logit is added where the
// tile holds it; then each thread updates its own running max and sum
// over the 32 columns of each of its two rows (no shuffle and no barrier
// inside the loop), the max kept as m = max(s) log2 e, rounded once, and
// each score's term taken as 2^(s log2 e - m) by one fma and one ex2. At
// the end the four lanes of a row combine theirs: m = max m_t, l = sum
// l_t 2^(m_t - m), and lse = m ln 2 + log(l). Rows past N compute on
// zeros and write nothing.

constexpr int kFwdRows = 128;   // resident rows of a CTA (64 a consumer)
constexpr int kFwdCols = 128;   // score columns of a tile (rows of E)
constexpr int kFwdStages = 6;   // K-chunks of E in flight
constexpr int kFwdLag = 1;      // K-chunk products left running at a fold
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdShape {
  static constexpr int kChunks = D / 64;             // K-chunks of a tile
  static constexpr int kPanelBytes = kFwdRows * 128;  // x: 128 rows x 64
  static constexpr int kChunkBytes = kFwdCols * 128;  // E: 128 rows x 64
  static constexpr int kLag = kFwdLag < kChunks ? kFwdLag : kChunks;
  static constexpr int kConsumers = 256;
  static constexpr int kConsumerWarps = kConsumers / 32;  // release a stage
  static constexpr int kThreads = kConsumers + 128;  // and the producer's
  static constexpr int kSmem = 1024 + kChunks * kPanelBytes +
                               kFwdStages * kChunkBytes;
};

template <int D>
__global__ void __launch_bounds__(FwdShape<D>::kThreads, 1)
xent_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_e,
                     const int* __restrict__ tgt, float* __restrict__ lse,
                     float* __restrict__ tlogit, int n, int v) {
  using L = FwdShape<D>;
  constexpr int S = kFwdStages;
  extern __shared__ uint8_t fwd_smem[];
  // bars: [0] the resident rows, then S "full" and S "empty" barriers.
  __shared__ __align__(8) uint64_t bars[1 + 2 * S];
  const uint32_t sa = (smem_u32(fwd_smem) + 1023u) & ~1023u;  // x panels
  const uint32_t sb = sa + L::kChunks * L::kPanelBytes;         // the ring
  const uint32_t bar_x = smem_u32(bars);
  const uint32_t full = bar_x + 8u;
  const uint32_t empty = full + 8u * S;

  const int tid = threadIdx.x;
  // Uniform across the warp by a shuffle, or ptxas serializes the wgmmas
  // (C7520).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int row0 = blockIdx.x * kFwdRows;
  const int n_tiles = (v + kFwdCols - 1) / kFwdCols;

  if (tid == 0) {
    mbar_init(bar_x, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8u * s, 1);
      mbar_init(empty + 8u * s, L::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialized before any use

  if (wg == 2) {
    // The producer warpgroup: one lane issues every load. Stage s takes
    // chunk q once every consumer warp has released chunk q - S.
    setmaxnreg_dec<40>();
    if (tid == L::kConsumers) {
      mbar_expect_tx(bar_x, L::kChunks * L::kPanelBytes);
      for (int p = 0; p < L::kChunks; ++p)
        tma_load_2d(sa + p * L::kPanelBytes, &map_x, bar_x, 64 * p, row0);
      int s = 0, phase = 0;
      for (int j = 0; j < n_tiles; ++j)
        for (int k = 0; k < L::kChunks; ++k) {
          if (j * L::kChunks + k >= S) mbar_wait(empty + 8u * s, phase ^ 1);
          mbar_expect_tx(full + 8u * s, L::kChunkBytes);
          tma_load_2d(sb + s * L::kChunkBytes, &map_e, full + 8u * s, 64 * k,
                      j * kFwdCols);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
    }
    __syncwarp();
  } else {
    setmaxnreg_inc<232>();
    const int lt = tid & 127;
    const int lane = tid & 31;
    const int r0 = 16 * (lt >> 5) + (lane >> 2);  // rows r0, r0 + 8
    const int t4 = lane & 3;
    const int rows = row0 + 64 * wg;  // the warpgroup's first row
    int tg[2];
    float m[2], l[2], tl[2];  // the thread's max (x log2 e), sum, target logit
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rows + r0 + 8 * h;
      tg[h] = row < n ? tgt[row] : -1;
      m[h] = -INFINITY;
      l[h] = 0.f;
      tl[h] = 0.f;
    }
    // Element i of a wgmma accumulator sits at tile row r0 + 8 ((i / 2) %
    // 2) and column 8 (i / 4) + 2 t4 + i % 2.
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    // Its rows of every panel of x, as a wgmma descriptor.
    const uint64_t da = smem_desc(sa + 64 * wg * 128, 16, 1024, 1);

    // Tile j's scores, in sc, into the running state of the thread's
    // columns of its two rows.
    auto fold = [&](float (&sc)[64], int j) {
      const int c0 = j * kFwdCols + 2 * t4;
      if ((j + 1) * kFwdCols > v) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (c0 + 8 * (i >> 2) + (i & 1) >= v) sc[i] = -INFINITY;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tc = tg[h] - c0;  // the target's column in this tile
        if (tc >= 0 && tc < kFwdCols) {
#pragma unroll
          for (int c = 0; c < 16; ++c)
#pragma unroll
            for (int k = 0; k < 2; ++k)
              if (8 * c + k == tc) tl[h] += sc[4 * c + 2 * h + k];  // exact
        }
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * h], sc[4 * c + 2 * h + 1]));
        // m is kept as max * log2 e, rounded once, so that a tile that
        // leaves it unchanged rescales l by exactly 1. It is -inf only
        // while every column the thread has seen is past V.
        const float m_new = fmaxf(m[h], mx * kLog2e);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 16; ++c)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            sum[k] += ex2(fmaf(sc[4 * c + 2 * h + k], kLog2e, -base));
        l[h] = l[h] * ex2(m[h] - base) + (sum[0] + sum[1]);
        m[h] = m_new;
      }
    };

    int s = 0, phase = 0, rs = 0;  // the next chunk's stage; the release's
    auto release = [&] {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8u * rs);
      if (++rs == S) rs = 0;
    };
    // Tile j into cur, K-chunk by K-chunk, while tile j - 1 is folded
    // from a copy of prev taken before tile j's first product issues.
    // ptxas serializes the wgmmas (C7515) if the fold touches prev's
    // registers while tile j's products run, or if products still run
    // where the loop's paths join; so a step ends with none running.
    auto step = [&](float (&cur)[64], const float (&prev)[64], int j) {
      float held[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) held[i] = prev[i];
#pragma unroll
      for (int k = 0; k < L::kChunks; ++k) {
        mbar_wait(full + 8u * s, phase);
        fence_regs(cur);
        wgmma_fence();
        const uint64_t db = smem_desc(sb + s * L::kChunkBytes, 16, 1024, 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // a descriptor counts 16 bytes
          wgmma_ss_n128(cur, da + (k * L::kPanelBytes + kk * 32) / 16,
                        db + 2 * kk, k > 0 || kk > 0);
        wgmma_commit();
        fence_regs(cur);
        wgmma_wait<L::kLag>();
        if (k >= L::kLag) release();  // chunk k - kLag is read
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
        if (k == L::kLag - 1 && j > 0) fold(held, j - 1);
      }
      wgmma_wait<0>();
      fence_regs(cur);
      for (int k = 0; k < L::kLag; ++k) release();
    };

    mbar_wait(bar_x, 0);
    for (int j = 0; j < n_tiles; j += 2) {
      step(acc0, acc1, j);
      if (j + 1 < n_tiles) step(acc1, acc0, j + 1);
    }
    if (n_tiles & 1) {
      fold(acc0, n_tiles - 1);
    } else {
      fold(acc1, n_tiles - 1);
    }

    // The four lanes of a row combine their states; column 0 is the
    // first lane's, so m is finite. lse = m ln 2 + log(l), m in log2 units.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mr = quad_max(m[h]);
      const float sum = quad_sum(l[h] * ex2(m[h] - mr));
      const float t = quad_sum(tl[h]);
      const int row = rows + r0 + 8 * h;
      if (t4 == 0 && row < n) {
        lse[row] = mr * kLn2 + logf(sum);
        tlogit[row] = t;
      }
    }
  }
}

// ---- launchers ---------------------------------------------------------------

constexpr int f32_bytes(int d, bool ds) {
  return ((kRows + kCols) * (d + 1) + (ds ? kRows * kLdsF32 : 0)) *
         static_cast<int>(sizeof(float));
}

int blocks(int rows) { return (rows + kRows - 1) / kRows; }

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

// The bf16 forward: one CTA a 128-row resident block.
template <int D>
int fwd_bf16(const bf16* x, const bf16* e, const int* tgt, float* lse,
             float* tlogit, int n, int v, cudaStream_t stream) {
  using L = FwdShape<D>;
  CUtensorMap map_x, map_e;
  if (int rc = encode_rows_map<D>(&map_x, x, n, kFwdRows)) return rc;
  if (int rc = encode_rows_map<D>(&map_e, e, v, kFwdCols)) return rc;
  const auto kernel = xent_fwd_bf16_kernel<D>;
  if (int rc = launch_setup(kernel, L::kSmem)) return rc;
  kernel<<<(n + kFwdRows - 1) / kFwdRows, L::kThreads, L::kSmem, stream>>>(
      map_x, map_e, tgt, lse, tlogit, n, v);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd(int dtype_code, const void* x, const void* e, const int* tgt,
        float* lse, float* tlogit, int n, int v, cudaStream_t stream) {
  if (dtype_code == 1)
    return fwd_bf16<D>(static_cast<const bf16*>(x),
                       static_cast<const bf16*>(e), tgt, lse, tlogit, n, v,
                       stream);
  const int smem = f32_bytes(D, false);
  if (int rc = launch_setup(xent_fwd_f32_kernel<D>, smem)) return rc;
  xent_fwd_f32_kernel<D><<<blocks(n), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(e), tgt, lse,
      tlogit, n, v);
  return static_cast<int>(cudaGetLastError());
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
