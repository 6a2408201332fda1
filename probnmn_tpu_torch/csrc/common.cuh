// Shared device helpers for the port's kernels: float32 <-> compute-type
// conversion, 4-wide weight loads and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace probnmn {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// The value a float32 takes once stored as T (round to nearest even).
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// Four consecutive elements as float32: one 16-byte (float) or 8-byte (bf16)
// load; the pointer must be aligned to four elements.
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}

// Two consecutive elements as float32: one 8-byte (float) or 4-byte (bf16)
// load; the pointer must be aligned to two elements.
__device__ __forceinline__ void load2(const float* p, float out[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  out[0] = v.x; out[1] = v.y;
}
__device__ __forceinline__ void load2(const bf16* p, float out[2]) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = v.x; out[1] = v.y;
}

// Butterfly reductions: every lane ends with the same result.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
// First-occurrence argmax: the larger value wins, a tie goes to the smaller index.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

}  // namespace probnmn
