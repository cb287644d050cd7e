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
// far below the bytes' time on this card.
//
// Design (the simple first version): one CTA of 256 threads per
// (sequence, kv head), covering that kv head's G = H / K query heads, so
// each K/V row is read once for all G heads. The CTA reads its own table
// row and q_pos and loops over live positions only. At decode lengths a
// CTA is bound by the latency of its loads, so both passes keep many
// rows in flight: 8 lanes per row, 16-byte loads, 4 rows per warp and 4
// unrolled rows per lane group (128 rows per CTA per step).
//   pass 1: each 8-lane group loads K rows (8 elements a lane) and
//           reduces each query head's dot with 3 shuffles; the rounded
//           scores go to a global fp32 scratch row [B, H, S_cap] the
//           wrapper allocates (it stays in L2 at serving lengths);
//   softmax: block reductions for the max and the sum; the weights
//           overwrite the scores in the scratch row;
//   pass 2: each 8-lane group owns a set of V rows, a lane 8 output
//           columns for every query head; shuffles and shared memory
//           reduce the partial sums across groups and warps.
// No online softmax: folding the score pass into a running max moves
// the rounding points (the retired TPU online-softmax kernel reached
// only 0.92 token agreement at live 512). Not yet: a cp.async/TMA page
// ring, and splitting one long row across CTAs (one row at live 4096
// runs on K CTAs only) — later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 8;                 // lanes sharing one row
constexpr int kElems = 8;                       // elements a lane holds
constexpr int kRowsPerWarp = 32 / kLanesPerRow; // rows a warp takes at once
constexpr int kGroups = kWarps * kRowsPerWarp;  // row groups in the CTA
constexpr int kUnroll = 4;                      // rows in flight per group
constexpr int kStride = kGroups * kUnroll;      // rows per CTA step

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

template <typename T, typename P, int DH, int G>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ pool_k,
                    const P* __restrict__ pool_v,
                    const float* __restrict__ scale_k,
                    const float* __restrict__ scale_v,
                    const int* __restrict__ tables,
                    const int* __restrict__ q_pos, T* __restrict__ out,
                    float* __restrict__ scratch, int H, int K, int page,
                    int max_pages, int s_cap, float divisor) {
  static_assert(DH == kLanesPerRow * kElems, "one row = 8 lanes x 8 elems");
  constexpr bool kQuant = sizeof(P) == 1;

  __shared__ float red[kWarps][G];
  __shared__ float acc_red[kWarps][G][DH];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % kLanesPerRow;             // column chunk of a row
  const int group = warp * kRowsPerWarp + lane / kLanesPerRow;
  const int h0 = kvh * G;
  const int* table = tables + static_cast<size_t>(b) * max_pages;
  float* srow = scratch + (static_cast<size_t>(b) * H + h0) * s_cap;
  T* orow = out + (static_cast<size_t>(b) * H + h0) * DH;

  int len = q_pos[b] + 1;
  len = min(len, max_pages * page);
  if (len <= 0) {  // no live key: not reachable from the serving path
    for (int i = tid; i < G * DH; i += kThreads) orow[i] = Num<T>::from(0.f);
    return;
  }

  // ---- pass 1: rounded scores of every live row, per query head -------
  float qr[G][kElems];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      qr[g][e] = Num<T>::to_float(
          q[(static_cast<size_t>(b) * H + h0 + g) * DH + sub * kElems + e]);

  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = __int_as_float(0xff800000);  // -inf

  for (int base = 0; base < len; base += kStride) {  // uniform trip count
    float kr[kUnroll][kElems];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u * kGroups + group;
      if (s < len) {
        const size_t row =
            (static_cast<size_t>(table[s / page]) * page + s % page) * K + kvh;
        load8(pool_k + row * DH + sub * kElems, kr[u]);
        dequant<T, P>(kr[u], kQuant ? scale_k[row] : 1.f);
      } else {
#pragma unroll
        for (int e = 0; e < kElems; ++e) kr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u * kGroups + group;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kElems; ++e) dot = fmaf(qr[g][e], kr[u][e], dot);
        dot = group_sum(dot);  // identical in the group's 8 lanes
        if (s < len) {
          const float sc = Num<T>::round(Num<T>::round(dot) / divisor);
          if (sub == 0) srow[static_cast<size_t>(g) * s_cap + s] = sc;
          mx[g] = fmaxf(mx[g], sc);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m = warp_max(mx[g]);
    if (lane == 0) red[warp][g] = m;
  }
  __syncthreads();  // scratch scores and per-warp maxima visible
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float m = red[0][g];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w][g]);
    mx[g] = m;
  }
  __syncthreads();  // red is reused below

  // ---- softmax: fp32 sum, weights rounded to the dtype ----------------
  float sum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) sum[g] = 0.f;
  for (int s = tid; s < len; s += kThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      sum[g] += expf(srow[static_cast<size_t>(g) * s_cap + s] - mx[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float w = warp_sum(sum[g]);
    if (lane == 0) red[warp][g] = w;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w][g];
    sum[g] = t;
  }
  for (int s = tid; s < len; s += kThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* p = srow + static_cast<size_t>(g) * s_cap + s;
      *p = Num<T>::round(expf(*p - mx[g]) / sum[g]);
    }
  }
  __syncthreads();  // weights visible to every thread

  // ---- pass 2: out = sum_s w[g, s] * v[s], fp32 accumulation ----------
  float acc[G][kElems];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[g][e] = 0.f;
  for (int base = 0; base < len; base += kStride) {
    float vr[kUnroll][kElems];
    float w[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u * kGroups + group;
      if (s < len) {
        const size_t row =
            (static_cast<size_t>(table[s / page]) * page + s % page) * K + kvh;
        load8(pool_v + row * DH + sub * kElems, vr[u]);
        dequant<T, P>(vr[u], kQuant ? scale_v[row] : 1.f);
#pragma unroll
        for (int g = 0; g < G; ++g) w[u][g] = srow[static_cast<size_t>(g) * s_cap + s];
      } else {
#pragma unroll
        for (int e = 0; e < kElems; ++e) vr[u][e] = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) w[u][g] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < kElems; ++e)
          acc[g][e] = fmaf(w[u][g], vr[u][e], acc[g][e]);
  }
  // The 4 row groups of a warp hold partial sums of the same columns.
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
        acc_red[warp][g][sub * kElems + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH;
    const int d = i % DH;
    float t = acc_red[0][g][d];
    for (int w = 1; w < kWarps; ++w) t += acc_red[w][g][d];
    orow[i] = Num<T>::from(t);
  }
}

template <typename T, typename P, int G>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const float* scale_k, const float* scale_v, const int* tables,
           const int* q_pos, void* out, float* scratch, int B, int H, int K,
           int page, int max_pages, int s_cap, float divisor,
           cudaStream_t stream) {
  const dim3 grid(B, K);
  paged_decode_kernel<T, P, 64, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pool_k),
      static_cast<const P*>(pool_v), scale_k, scale_v, tables, q_pos,
      static_cast<T*>(out), scratch, H, K, page, max_pages, s_cap, divisor);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_group(int G, const void* q, const void* pool_k, const void* pool_v,
                 const float* scale_k, const float* scale_v,
                 const int* tables, const int* q_pos, void* out,
                 float* scratch, int B, int H, int K, int page,
                 int max_pages, int s_cap, float divisor,
                 cudaStream_t stream) {
#define KVEDGE_LAUNCH(g)                                                    \
  return launch<T, P, g>(q, pool_k, pool_v, scale_k, scale_v, tables, q_pos, \
                         out, scratch, B, H, K, page, max_pages, s_cap,      \
                         divisor, stream)
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
// and scale_k/scale_v are [P, page, K] fp32. Returns cudaGetLastError()
// after the launch (0 = launched), or -1 for a shape the kernel does not
// take (Dh != 64, or H / K not in {1, 2, 4, 8}); the wrapper checks
// those before calling.
extern "C" int kvedge_paged_decode(int dtype_code, int quantized,
                                   const void* q, const void* pool_k,
                                   const void* pool_v, const float* scale_k,
                                   const float* scale_v, const int* tables,
                                   const int* q_pos, void* out,
                                   float* scratch, int B, int H, int K,
                                   int Dh, int page, int max_pages,
                                   int s_cap, float divisor, void* stream) {
  if (Dh != 64 || K <= 0 || H % K != 0 || B <= 0) return -1;
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) {
    if (quantized)
      return launch_group<float, int8_t>(G, q, pool_k, pool_v, scale_k,
                                         scale_v, tables, q_pos, out, scratch,
                                         B, H, K, page, max_pages, s_cap,
                                         divisor, st);
    return launch_group<float, float>(G, q, pool_k, pool_v, scale_k, scale_v,
                                      tables, q_pos, out, scratch, B, H, K,
                                      page, max_pages, s_cap, divisor, st);
  }
  if (dtype_code == 1) {
    if (quantized)
      return launch_group<__nv_bfloat16, int8_t>(
          G, q, pool_k, pool_v, scale_k, scale_v, tables, q_pos, out, scratch,
          B, H, K, page, max_pages, s_cap, divisor, st);
    return launch_group<__nv_bfloat16, __nv_bfloat16>(
        G, q, pool_k, pool_v, scale_k, scale_v, tables, q_pos, out, scratch, B,
        H, K, page, max_pages, s_cap, divisor, st);
  }
  return -1;
}
