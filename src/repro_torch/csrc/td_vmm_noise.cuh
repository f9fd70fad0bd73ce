// td_vmm's noise: the reference's hash32, uniform01 and Box-Muller gauss,
// bit for bit (accurate logf / sqrtf / cosf, explicit _rn products so
// nothing contracts into an FMA).  Shared by csrc/td_vmm.cu and any probe
// that times this arithmetic alone.
#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t GOLDEN = 0x9E3779B9u;

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fadd_rn(__fmul_rn((float)(bits >> 8), 1.0f / 16777216.0f),
                   0.5f / 16777216.0f);
}

__device__ __forceinline__ float gauss(uint32_t idx, uint32_t seed) {
  const float u1 = uniform01(hash32(idx ^ seed));
  const float u2 = uniform01(hash32(idx ^ seed ^ GOLDEN));
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(6.28318548f, u2)));
}

// z of NZ <= 4 planes of one output (noise indices idx + i * stride), the
// rest 0: independent Box-Muller chains in one call, interleaved by the
// compiler.  Not inlined: an epilogue holds 16 outputs a thread, and 16
// inlined copies of the accurate logf / sqrtf / cosf overflow the
// instruction cache.
template <int NZ>
__device__ __noinline__ float4 gauss_n(uint32_t idx, uint32_t stride,
                                       uint32_t seed) {
  static_assert(NZ >= 1 && NZ <= 4, "one to four chains");
  float4 z = make_float4(gauss(idx, seed), 0.0f, 0.0f, 0.0f);
  if (NZ > 1) z.y = gauss(idx + stride, seed);
  if (NZ > 2) z.z = gauss(idx + 2 * stride, seed);
  if (NZ > 3) z.w = gauss(idx + 3 * stride, seed);
  return z;
}

}  // namespace
