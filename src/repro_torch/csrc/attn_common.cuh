// Shared helpers of the attention kernels (paged_decode.cu,
// flash_attention.cu): 16-byte loads of f32 or bf16 rows unpacked to f32,
// and stores back in the input's type.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float NEG_INF = -1e30f;   // the reference's masked-score value

// Elements of T in one 16-byte vector.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack(const uint4 r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4 r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even
}

__device__ __forceinline__ float cap_score(float s, float cap) {
  return cap > 0.0f ? tanhf(s / cap) * cap : s;
}

}  // namespace attn
