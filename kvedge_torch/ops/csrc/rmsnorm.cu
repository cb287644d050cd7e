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
// 3.35 TB/s; its 3 N D operations are nothing beside that. Bound by the
// bytes.
//
// Design. One warp per row, 8 rows a 256-thread CTA. Lanes read the row in
// 16-byte vectors (8 bf16 or 4 fp32 values; scalars when D or an address
// does not allow it), neighbouring lanes on neighbouring addresses. The
// first pass sums the squares and reduces them across the warp with
// shuffles; the second re-reads the row (from L1, a row is at most a few
// KB) and writes y. x is read from device memory once.

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

// VEC values of a row at column c: one 16-byte load, or one scalar.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(T (&out)[VEC], const T* p) {
  if constexpr (VEC == 1) {
    out[0] = *p;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = vals[k];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const T (&in)[VEC]) {
  if constexpr (VEC == 1) {
    *p = in[0];
  } else {
    uint4 raw;
    T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) vals[k] = in[k];
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kWarps)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gain,
                   T* __restrict__ y, int n, int d) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps only: the shuffles below stay full
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;

  float ss = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    T v[VEC];
    load_vec<T, VEC>(v, xr + c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float f = to_float(v[k]);
      ss += __fmul_rn(f, f);  // the square rounded, not fused into the sum
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float scale = rsqrtf(ss / static_cast<float>(d) + kEps);
  const float sc = to_float(from_float<T>(scale));  // the scale in the dtype

  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    T v[VEC];
    load_vec<T, VEC>(v, xr + c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float xs = to_float(from_float<T>(__fmul_rn(to_float(v[k]), sc)));
      const float gd = to_float(from_float<T>(gain[c + k]));
      v[k] = from_float<T>(__fmul_rn(xs, gd));
    }
    store_vec<T, VEC>(yr + c, v);
  }
}

template <typename T, int VEC>
int launch(const void* x, const float* gain, void* y, int n, int d,
           cudaStream_t stream) {
  const int grid = (n + kWarps - 1) / kWarps;
  rmsnorm_fwd_kernel<T, VEC><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), gain, static_cast<T*>(y), n, d);
  return static_cast<int>(cudaGetLastError());
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
    if (vec && d % 4 == 0) return launch<float, 4>(x, gain, y, n, d, st);
    return launch<float, 1>(x, gain, y, n, d, st);
  }
  if (vec && d % 8 == 0) return launch<bf16, 8>(x, gain, y, n, d, st);
  return launch<bf16, 1>(x, gain, y, n, d, st);
}
