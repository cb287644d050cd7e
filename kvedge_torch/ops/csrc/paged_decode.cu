// Single-query paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_decode_flat_kernel` in
// kvedge_tpu/ops/paged_attention.py (wrapper `paged_decode_attention`):
// one query token per sequence attends to key positions 0..q_pos[b],
// whose K/V rows sit in pool pages tables[b, 0..q_pos[b] / page].
//
// Numerics follow the reference's gather path (kvcache.py
// `_paged_attend_layer`), rounding point for rounding point:
//   1. score = fp32-accumulated q.k, rounded to the compute dtype;
//   2. divided by sqrt(Dh) in the dtype (the wrapper passes the divisor
//      already rounded to the dtype; for Dh = 64 it is 8, exact);
//   3. softmax over the row in fp32: max, exp(s - max), sum, and the
//      weights e / sum rounded to the dtype;
//   4. out = fp32-accumulated sum of w * v, rounded to the dtype.
// int8 pools dequantize each element as float(int8) * scale[row, kv]
// rounded to the dtype BEFORE any math (`_kv_dequantize`).
// Positions past q_pos are never read: in the gather they carry the
// mask value finfo(dtype).min, whose exp underflows to exactly 0, so
// they add exact zeros to the sum and to the output. The fp32 sums run
// in another order than the plain version's matmuls, which is what the
// tolerances of the tests and of chip_smoke.py allow for.
//
// Bound: the bytes it reads. Per call that is
//   sum_b live_b * K * Dh * 2 * itemsize   (K and V rows, live only)
// plus 2 * 4 bytes of scale per live row and kv head for int8 pools,
// plus q, the tables and the output. The flops (4 * live * H * Dh) are
// far below the bytes' time on this card. At decode lengths the bytes
// are a few hundred KB, so what bounds a call in practice is latency:
// how many dependent waves of loads from device memory it waits on, and
// how many SMs it keeps busy.
//
// Design. Each (sequence, kv head) is split across a thread-block
// cluster of `split` CTAs (split <= 8, the portable cluster size; the
// wrapper picks it from the pool's shape, never from the live lengths),
// covering that kv head's G = H / K query heads, so each K/V row is read
// once for all G heads. Cluster rank r takes the r-th contiguous slice
// of positions 0..q_pos[b], computed on the device. A CTA:
//   1. issues cp.async copies of its slice's K rows and, behind them,
//      its V rows into shared memory (a ring of ring_rows rows each; a
//      longer slice loops), so pass 2 finds V resident: one wave of
//      loads at serving lengths;
//   2. pass 1: 8 lanes per row reduce each query head's dot with 3
//      shuffles; the rounded scores stay in this CTA's shared memory;
//   3. the row max and then the fp32 sum of exp(s - max) cross the
//      cluster through distributed shared memory: each CTA reads every
//      rank's part in rank order, so all agree bit for bit; the weights
//      e / sum are rounded to the dtype in place;
//   4. pass 2: each CTA accumulates its slice's w * v in fp32; rank 0
//      adds the split partial outputs in rank order and rounds once.
// Every CTA reaches every cluster barrier (an empty slice included), and
// none exits while rank 0 still reads its shared memory. No online
// softmax: folding the score pass into a running max moves the rounding
// points (the retired TPU online-softmax kernel reached only 0.92 token
// agreement at live 512).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDh = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 8;                  // lanes sharing one row
constexpr int kElems = kDh / kLanesPerRow;       // elements a lane holds
constexpr int kRowsPerPass = kThreads / kLanesPerRow;
constexpr int kMaxSplit = 8;                     // portable cluster size

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_float(float x) { return x; }
  // Round an fp32 value to the compute dtype and back (exact for fp32).
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Eight consecutive pool elements as floats, in one or two vector loads
// (the wrapper checks the pools' 16-byte alignment; a lane's offset is a
// multiple of 8 elements, so every load is aligned).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}

// An int8 row dequantized to the compute dtype: float(int8) * scale,
// rounded (`_kv_dequantize`). Other pools are already in the dtype.
template <typename T, typename P>
__device__ __forceinline__ void dequant(float (&x)[8], float scale) {
  if constexpr (sizeof(P) == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = Num<T>::round(x[i] * scale);
  }
}

__device__ __forceinline__ float group_sum(float x) {  // over 8 lanes
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The floats of a CTA's shared memory after its two row rings (the
// wrapper's `decode_split` sizes the same layout).
template <int G>
struct Floats {
  float* sc;       // [G][slice_rows]: rounded scores, then weights
  float* sk;       // [ring_rows] int8 K scales (int8 pools only)
  float* sv;       // [ring_rows] int8 V scales
  float* red_max;  // [kWarps][G]
  float* red_sum;  // [kWarps][G]
  float* local;    // [2][G]: this CTA's max and sum, read by the cluster
  float* global;   // [2][G]: the cluster's max and sum
  float* warp_acc; // [kWarps][G][kDh]
  float* part;     // [G][kDh]: this CTA's output, read by rank 0
  float* end;

  __device__ Floats(float* p, int slice_rows, int ring_rows, bool quant) {
    sc = p;
    sk = sc + G * slice_rows;
    sv = sk + (quant ? ring_rows : 0);
    red_max = sv + (quant ? ring_rows : 0);
    red_sum = red_max + kWarps * G;
    local = red_sum + kWarps * G;
    global = local + 2 * G;
    warp_acc = global + 2 * G;
    part = warp_acc + kWarps * G * kDh;
    end = part + G * kDh;
  }
};

// cp.async copies of the K (or V) rows of positions s0 .. s0 + cnt - 1 of
// kv head kvh into `rows` (and, for int8 pools, their scales into
// `scales`), as one commit group.
template <typename P>
__device__ __forceinline__ void stage_rows(P* rows, float* scales,
                                           const P* __restrict__ pool,
                                           const float* __restrict__ scale,
                                           const int* __restrict__ table,
                                           int s0, int cnt, int page, int K,
                                           int kvh) {
  constexpr int kPieces = kDh * static_cast<int>(sizeof(P)) / 16;
  constexpr int kPer = 16 / static_cast<int>(sizeof(P));  // elements a piece
  for (int i = threadIdx.x; i < cnt * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int c = i % kPieces;
    const int s = s0 + r;
    const size_t row =
        (static_cast<size_t>(table[s / page]) * page + s % page) * K + kvh;
    cp_async16(rows + r * kDh + c * kPer, pool + row * kDh + c * kPer);
  }
  if constexpr (sizeof(P) == 1) {
    for (int r = threadIdx.x; r < cnt; r += kThreads) {
      const int s = s0 + r;
      const size_t row =
          (static_cast<size_t>(table[s / page]) * page + s % page) * K + kvh;
      cp_async4(scales + r, scale + row);
    }
  }
  cp_async_commit();
}

template <typename T, typename P, int G>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ pool_k,
                    const P* __restrict__ pool_v,
                    const float* __restrict__ scale_k,
                    const float* __restrict__ scale_v,
                    const int* __restrict__ tables,
                    const int* __restrict__ q_pos, T* __restrict__ out, int H,
                    int K, int page, int max_pages, int slice_rows,
                    int ring_rows, float divisor) {
  constexpr bool kQuant = sizeof(P) == 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());

  extern __shared__ uint4 smem_vec[];
  P* kbuf = reinterpret_cast<P*>(smem_vec);
  P* vbuf = kbuf + ring_rows * kDh;
  Floats<G> f(reinterpret_cast<float*>(vbuf + ring_rows * kDh), slice_rows,
              ring_rows, kQuant);

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % kLanesPerRow;  // column chunk of a row
  const int slot = tid / kLanesPerRow;  // row within a pass
  const int h0 = kvh * G;
  const int* table = tables + static_cast<size_t>(b) * max_pages;

  // This CTA's slice [lo, lo + n) of the live positions 0..len - 1; a row
  // at live 0 (not reachable from the serving path) leaves every slice
  // empty and writes zeros.
  const int len = min(q_pos[b] + 1, max_pages * page);
  const int chunk = len > 0 ? (len + split - 1) / split : 0;
  const int lo = min(len > 0 ? len : 0, rank * chunk);
  const int n = max(0, min(len, lo + chunk) - lo);

  // K and then V of the first ring's worth of rows: one wave of loads.
  const int first = min(n, ring_rows);
  stage_rows<P>(kbuf, f.sk, pool_k, scale_k, table, lo, first, page, K, kvh);
  stage_rows<P>(vbuf, f.sv, pool_v, scale_v, table, lo, first, page, K, kvh);

  float qr[G][kElems];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      qr[g][e] = Num<T>::to_float(
          q[(static_cast<size_t>(b) * H + h0 + g) * kDh + sub * kElems + e]);

  // ---- pass 1: rounded scores of the slice, per query head --------------
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = __int_as_float(0xff800000);  // -inf
  for (int c0 = 0; c0 < n; c0 += ring_rows) {
    const int cnt = min(ring_rows, n - c0);
    if (c0 == 0) {
      cp_async_wait<1>();  // K arrived; V may still be in flight
    } else {
      stage_rows<P>(kbuf, f.sk, pool_k, scale_k, table, lo + c0, cnt, page,
                    K, kvh);
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int base = 0; base < cnt; base += kRowsPerPass) {  // uniform trips
      const int r = base + slot;
      float kr[kElems];
      if (r < cnt) {
        load8(kbuf + r * kDh + sub * kElems, kr);
        dequant<T, P>(kr, kQuant ? f.sk[r] : 1.f);
      } else {
#pragma unroll
        for (int e = 0; e < kElems; ++e) kr[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kElems; ++e) dot = fmaf(qr[g][e], kr[e], dot);
        dot = group_sum(dot);  // identical in the group's 8 lanes
        if (r < cnt) {
          const float sc = Num<T>::round(Num<T>::round(dot) / divisor);
          if (sub == g % kLanesPerRow) f.sc[g * slice_rows + c0 + r] = sc;
          mx[g] = fmaxf(mx[g], sc);
        }
      }
    }
    __syncthreads();  // kbuf is free for the next ring
  }

  // ---- the row max across the cluster (order-free, so exact) ------------
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m = warp_max(mx[g]);
    if (lane == 0) f.red_max[warp * G + g] = m;
  }
  __syncthreads();
  if (tid < G) {
    float m = f.red_max[tid];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, f.red_max[w * G + tid]);
    f.local[tid] = m;
  }
  cluster.sync();  // every CTA's max visible
  if (tid < G) {
    float m = *cluster.map_shared_rank(f.local + tid, 0);
    for (int r = 1; r < split; ++r)
      m = fmaxf(m, *cluster.map_shared_rank(f.local + tid, r));
    f.global[tid] = m;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = f.global[g];

  // ---- the fp32 sum of exp(s - max), added in rank order ------------------
  float sum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) sum[g] = 0.f;
  for (int i = tid; i < n; i += kThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      sum[g] += expf(f.sc[g * slice_rows + i] - mx[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float w = warp_sum(sum[g]);
    if (lane == 0) f.red_sum[warp * G + g] = w;
  }
  __syncthreads();
  if (tid < G) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += f.red_sum[w * G + tid];
    f.local[G + tid] = t;
  }
  cluster.sync();  // every CTA's sum visible
  if (tid < G) {
    float t = 0.f;
    for (int r = 0; r < split; ++r)
      t += *cluster.map_shared_rank(f.local + G + tid, r);
    f.global[G + tid] = t;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* p = f.sc + g * slice_rows + i;
      *p = Num<T>::round(expf(*p - mx[g]) / f.global[G + g]);
    }
  }

  // ---- pass 2: this slice's sum of w[g, s] * v[s], fp32 ------------------
  float acc[G][kElems];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[g][e] = 0.f;
  for (int c0 = 0; c0 < n; c0 += ring_rows) {
    const int cnt = min(ring_rows, n - c0);
    if (c0 == 0) {
      cp_async_wait<0>();
    } else {
      __syncthreads();  // every thread is done with the previous ring
      stage_rows<P>(vbuf, f.sv, pool_v, scale_v, table, lo + c0, cnt, page,
                    K, kvh);
      cp_async_wait<0>();
    }
    __syncthreads();  // V rows and weights visible
    for (int r = slot; r < cnt; r += kRowsPerPass) {
      float vr[kElems];
      load8(vbuf + r * kDh + sub * kElems, vr);
      dequant<T, P>(vr, kQuant ? f.sv[r] : 1.f);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float w = f.sc[g * slice_rows + c0 + r];
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[g][e] = fmaf(w, vr[e], acc[g][e]);
      }
    }
  }
  // The 4 row slots of a warp hold partial sums of the same columns.
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      float x = acc[g][e];
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      acc[g][e] = x;
    }
  if (lane < kLanesPerRow) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        f.warp_acc[(warp * G + g) * kDh + sub * kElems + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * kDh; i += kThreads) {
    float t = f.warp_acc[i];
    for (int w = 1; w < kWarps; ++w) t += f.warp_acc[w * G * kDh + i];
    f.part[i] = t;
  }
  cluster.sync();  // every CTA's partial output visible
  if (rank == 0) {
    T* orow = out + (static_cast<size_t>(b) * H + h0) * kDh;
    for (int i = tid; i < G * kDh; i += kThreads) {
      float t = 0.f;
      for (int r = 0; r < split; ++r) t += *cluster.map_shared_rank(f.part + i, r);
      orow[i] = Num<T>::from(t);
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
}

// Bytes of dynamic shared memory the kernel's layout takes.
template <int G>
size_t smem_bytes(int slice_rows, int ring_rows, int itemsize) {
  const size_t floats = static_cast<size_t>(G) * slice_rows +
                        (itemsize == 1 ? 2 * ring_rows : 0) +
                        2 * kWarps * G + 4 * G + kWarps * G * kDh + G * kDh;
  return 2 * static_cast<size_t>(ring_rows) * kDh * itemsize + 4 * floats;
}

template <typename T, typename P, int G>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const float* scale_k, const float* scale_v, const int* tables,
           const int* q_pos, void* out, int B, int H, int K, int page,
           int max_pages, int split, int slice_rows, int ring_rows,
           int smem, float divisor, cudaStream_t stream) {
  if (split < 1 || split > kMaxSplit || ring_rows < 1 ||
      static_cast<size_t>(split) * slice_rows <
          static_cast<size_t>(max_pages) * page ||
      smem_bytes<G>(slice_rows, ring_rows, sizeof(P)) >
          static_cast<size_t>(smem))
    return -1;
  auto kernel = paged_decode_kernel<T, P, G>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, K, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                          static_cast<const P*>(pool_k),
                          static_cast<const P*>(pool_v), scale_k, scale_v,
                          tables, q_pos, static_cast<T*>(out), H, K, page,
                          max_pages, slice_rows, ring_rows, divisor);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_group(int G, const void* q, const void* pool_k, const void* pool_v,
                 const float* scale_k, const float* scale_v,
                 const int* tables, const int* q_pos, void* out, int B, int H,
                 int K, int page, int max_pages, int split, int slice_rows,
                 int ring_rows, int smem, float divisor,
                 cudaStream_t stream) {
#define KVEDGE_LAUNCH(g)                                                    \
  return launch<T, P, g>(q, pool_k, pool_v, scale_k, scale_v, tables, q_pos, \
                         out, B, H, K, page, max_pages, split, slice_rows,   \
                         ring_rows, smem, divisor, stream)
  switch (G) {
    case 1: KVEDGE_LAUNCH(1);
    case 2: KVEDGE_LAUNCH(2);
    case 4: KVEDGE_LAUNCH(4);
    case 8: KVEDGE_LAUNCH(8);
    default: return -1;
  }
#undef KVEDGE_LAUNCH
}

}  // namespace

// C entry point bound with ctypes (kvedge_torch/ops/_build.py).
// dtype_code: 0 = float32, 1 = bfloat16. quantized: the pools are int8
// and scale_k/scale_v are [P, page, K] fp32. split, slice_rows,
// ring_rows and smem_bytes come from the wrapper's `decode_split`.
// Returns cudaGetLastError() after the launch (0 = launched), or -1 for
// a shape the kernel does not take (Dh != 64, H / K not in {1, 2, 4, 8},
// a split outside 1..8 or one that does not cover the pool's rows, or
// less shared memory than the layout needs); the wrapper checks those
// before calling.
extern "C" int kvedge_paged_decode(int dtype_code, int quantized,
                                   const void* q, const void* pool_k,
                                   const void* pool_v, const float* scale_k,
                                   const float* scale_v, const int* tables,
                                   const int* q_pos, void* out, int B, int H,
                                   int K, int Dh, int page, int max_pages,
                                   int split, int slice_rows, int ring_rows,
                                   int smem_bytes, float divisor,
                                   void* stream) {
  if (Dh != kDh || K <= 0 || H % K != 0 || B <= 0) return -1;
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KVEDGE_ARGS                                                          \
  G, q, pool_k, pool_v, scale_k, scale_v, tables, q_pos, out, B, H, K, page, \
      max_pages, split, slice_rows, ring_rows, smem_bytes, divisor, st
  if (dtype_code == 0) {
    if (quantized) return launch_group<float, int8_t>(KVEDGE_ARGS);
    return launch_group<float, float>(KVEDGE_ARGS);
  }
  if (dtype_code == 1) {
    if (quantized) return launch_group<__nv_bfloat16, int8_t>(KVEDGE_ARGS);
    return launch_group<__nv_bfloat16, __nv_bfloat16>(KVEDGE_ARGS);
  }
#undef KVEDGE_ARGS
  return -1;
}
