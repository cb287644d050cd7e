// One-pass RMSNorm forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_fwd_kernel` of kvedge_tpu/ops/rmsnorm.py
// (:35, via `_rmsnorm_fwd_pallas` :46) on x [N, D] (row-major,
// contiguous; bf16 or fp32) and an fp32 gain [D], for every N >= 1 and
// D >= 1. (The reference falls back to plain jnp for row counts not
// divisible by 8, a TPU tiling rule; this kernel takes every N.)
//
// Rounding points, each `_rmsnorm`'s: the mean of squares in fp32 (each
// square rounded to fp32, then summed), scale = rsqrt(mean + 1e-6) in
// fp32, the scale rounded to the dtype, then y = (x * scale) * gain with
// each product rounded to the dtype and the gain rounded to the dtype
// first. Only the order of the fp32 sum of squares differs from a plain
// torch.mean (and rsqrtf may differ from torch's rsqrt by an ulp).
//
// Bound. At the flagship training shape ([32768, 512] bf16) one launch
// reads x (33.5 MB) and the gain and writes y (33.5 MB): 0.020 ms at
// 3.35 TB/s; its 4 N D operations are nothing beside that. Bound by the
// bytes, so the design keeps many bytes in flight and touches each once.
//
// Design. A warp takes one row at a time and holds it in registers:
// lane l reads vectors l, l + 32, .. (NV of them) of the row, 16 bytes
// each (8 bf16 or 4 fp32 values; scalars when D or an address does not
// allow it), neighbouring lanes on neighbouring addresses, all NV loads
// issued before the first square is summed. The sum of squares reduces
// across the warp with shuffles, and y is written from the same
// registers: x is read once, as ld.global.nc.L1::no_allocate (read-only,
// not kept in L1). y is stored plainly, so that it stays in L2 for the
// product that reads it next (evict-first stores measured no faster).
// NV comes from D, at most 8 vectors (32 registers) a lane: 2 at [*, 512]
// bf16, 4 at [*, 512] fp32. A row wider than 32 NV vectors is taken in
// segments of that width, its earlier segments read a second time. The
// gain, rounded to the dtype, is read once a warp and kept in registers
// across the rows it walks. CTAs of 8 warps; the grid is as many CTAs as
// the rows need, capped at what the SMs hold at once, and each warp walks
// the rows with that stride, so a small N (the swapped step's [2048,
// 512]) spreads over as many SMs as it can and a large one runs in waves
// of full SMs. (Several rows a warp, for more bytes in flight a lane,
// measured no faster at [32768, 512] and slower at [2048, 512]: PERF.md.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC values of a row: one 16-byte vector, or one scalar.
template <typename T, int VEC>
struct alignas(VEC == 1 ? alignof(T) : 16) Chunk {
  T v[VEC];
};

// Read-only, and not kept in L1: x is read once.
template <typename T, int VEC>
__device__ __forceinline__ Chunk<T, VEC> load_x(const T* p) {
  Chunk<T, VEC> c;
  if constexpr (VEC == 1) {
    c.v[0] = *p;
  } else {
    uint4 raw;
    asm volatile(
        "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w) : "l"(p));
    c = *reinterpret_cast<const Chunk<T, VEC>*>(&raw);
  }
  return c;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_y(T* p, const Chunk<T, VEC>& c) {
  if constexpr (VEC == 1) {
    *p = c.v[0];
  } else {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&c);
  }
}

// The gain at the lane's columns of the segment starting at c0, rounded
// to the dtype.
template <typename T, int VEC, int NV>
__device__ __forceinline__ void load_gain(T (&gd)[NV][VEC],
                                          const float* __restrict__ gain,
                                          int c0, int lane, int d) {
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = c0 + (32 * j + lane) * VEC + k;
      gd[j][k] = from_float<T>(c < d ? gain[c] : 0.f);
    }
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(32 * kWarps)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gain,
                   T* __restrict__ y, int n, int d) {
  constexpr int kSpan = 32 * VEC * NV;  // the columns a warp holds of a row
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  const int segs = (d + kSpan - 1) / kSpan;  // 1 unless D is past the budget

  T gd[NV][VEC];
  load_gain<T, VEC, NV>(gd, gain, 0, lane, d);
  Chunk<T, VEC> v[NV];

  // Segment seg of the row into v.
  auto load = [&](const T* xr, int seg) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = seg * kSpan + (32 * j + lane) * VEC;
      if (c < d)
        v[j] = load_x<T, VEC>(xr + c);
      else
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[j].v[k] = from_float<T>(0.f);
    }
  };

  // Whole warps walk the rows, so the shuffles below stay full.
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < n;
       row += stride) {
    const T* xr = x + static_cast<size_t>(row) * d;
    T* yr = y + static_cast<size_t>(row) * d;
    float ss = 0.f;
    for (int seg = 0; seg < segs; ++seg) {
      load(xr, seg);
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float f = to_float(v[j].v[k]);
          ss += __fmul_rn(f, f);  // the square rounded, not fused
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float scale = rsqrtf(ss / static_cast<float>(d) + kEps);
    const float sc = to_float(from_float<T>(scale));  // the scale in the dtype
    // The last segment is still in v; earlier ones are read again.
    for (int seg = segs - 1; seg >= 0; --seg) {
      if (seg != segs - 1) load(xr, seg);
      if (segs > 1) load_gain<T, VEC, NV>(gd, gain, seg * kSpan, lane, d);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = seg * kSpan + (32 * j + lane) * VEC;
        if (c >= d) continue;
        Chunk<T, VEC> out;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xs =
              to_float(from_float<T>(__fmul_rn(to_float(v[j].v[k]), sc)));
          out.v[k] = from_float<T>(__fmul_rn(xs, to_float(gd[j][k])));
        }
        store_y<T, VEC>(yr + c, out);
      }
    }
  }
}

// NV 16-byte vectors a lane per row, at most 8 (32 registers).
template <typename T, int VEC, int NV>
int launch(const void* x, const float* gain, void* y, int n, int d,
           cudaStream_t stream) {
  const auto kernel = rmsnorm_fwd_kernel<T, VEC, NV>;
  static int per_sm = 0;  // CTAs an SM holds at once
  if (per_sm == 0) {
    if (int rc = static_cast<int>(
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, 32 * kWarps, 0)))
      return rc;
  }
  int dev = 0, sms = 0;
  if (int rc = static_cast<int>(cudaGetDevice(&dev))) return rc;
  if (int rc = static_cast<int>(cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev)))
    return rc;
  const int want = (n + kWarps - 1) / kWarps;
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  kernel<<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), gain, static_cast<T*>(y), n, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_width(const void* x, const float* gain, void* y, int n, int d,
                 cudaStream_t stream) {
  const int per_lane = (d + 32 * VEC - 1) / (32 * VEC);
  if (per_lane <= 1) return launch<T, VEC, 1>(x, gain, y, n, d, stream);
  if (per_lane <= 2) return launch<T, VEC, 2>(x, gain, y, n, d, stream);
  if (per_lane <= 4) return launch<T, VEC, 4>(x, gain, y, n, d, stream);
  return launch<T, VEC, 8>(x, gain, y, n, d, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// C entry point bound with ctypes (kvedge_torch/ops/_build.py,
// kvedge_torch/ops/rmsnorm.py). dtype_code: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape it does not take (N or D < 1).
extern "C" int kvedge_rmsnorm_fwd(int dtype_code, const void* x,
                                  const float* gain, void* y, int n, int d,
                                  void* stream) {
  if ((dtype_code != 0 && dtype_code != 1) || n < 1 || d < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(y);
  if (dtype_code == 0) {
    if (vec && d % 4 == 0) return launch_width<float, 4>(x, gain, y, n, d, st);
    return launch_width<float, 1>(x, gain, y, n, d, st);
  }
  if (vec && d % 8 == 0) return launch_width<bf16, 8>(x, gain, y, n, d, st);
  return launch_width<bf16, 1>(x, gain, y, n, d, st);
}
