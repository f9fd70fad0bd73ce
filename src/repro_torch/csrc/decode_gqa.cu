// Fused GQA decode attention (flash-decode of one query row) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/decode_gqa/decode_gqa.py (pallas_call in
// `_decode_gqa_call`): q (B, Hq, D) against the KV cache k/v (B, S, Hkv, D)
// with a runtime fill level length (B,), clamped to S; positions at or past
// it are masked and a row with length 0 returns 0.
//
// What bounds it on the H100: bytes.  Each step reads the live prefix of
// the cache once (2*B*length*Hkv*D elements) for about 4*B*Hq*length*D
// operations, far below the card's ops-per-byte balance.  Design: one
// block per (batch, kv head) holds all g query heads of the group, so each
// K/V tile is read from device memory once for the whole group, and the
// loop stops at min(length, S) instead of visiting dead blocks.  length is
// read from device memory.  Not yet done: splitting S across blocks with a
// log-sum-exp combine (B * Hkv = 32 blocks leave most of the 132 SMs idle
// at the main path's batch of 4).
#include "attn_common.cuh"

namespace {

template <typename QT, typename KT>
__global__ void __launch_bounds__(attn::NT)
decode_gqa_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const int* __restrict__ length,
                  QT* __restrict__ o, int S, int Hq, int Hkv, int D,
                  float scale) {
  extern __shared__ float smem[];
  const attn::Smem s = attn::carve(smem, D);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = Hq / Hkv;
  const int len = min(max(length[b], 0), S);
  const QT* qb = q + ((size_t)b * Hq + (size_t)kvh * g) * D;
  for (int e = threadIdx.x; e < g * D; e += attn::NT)
    s.q[e] = __fmul_rn(attn::to_f32(qb[e]), scale);

  const size_t kv_row = (size_t)Hkv * D;
  const KT* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const KT* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;
  QT* ob = o + ((size_t)b * Hq + (size_t)kvh * g) * D;
  attn::attend<KT>(
      s, g, D, len,
      [&](int pos) { return kb + pos * kv_row; },
      [&](int pos) { return vb + pos * kv_row; },
      [&](int, int) { return true; },
      [&](int r, int d, float val) { ob[r * D + d] = attn::from_f32<QT>(val); });
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* o, int B, int S, int Hq, int Hkv, int D, float scale,
           cudaStream_t stream) {
  const size_t smem = attn::smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_gqa_kernel<QT, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  decode_gqa_kernel<QT, KT><<<grid, attn::NT, smem, stream>>>((const QT*)q, (const KT*)k,
                                         (const KT*)v, length, (QT*)o, S, Hq,
                                         Hkv, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, D), k/v (B, S, Hkv, D), o like q, all contiguous; q_bf16 /
// kv_bf16 select bf16 (1) or f32 (0) for q/o and for k/v.  length (B,) is
// int32 in device memory.  Needs D <= 128 and g = Hq / Hkv <= 64.  Returns
// the launch's cudaError_t.
extern "C" int decode_gqa_launch(const void* q, const void* k, const void* v,
                                 const void* length, void* o, int B, int S,
                                 int Hq, int Hkv, int D, float scale,
                                 int q_bf16, int kv_bf16, void* stream) {
  if (D > attn::MAX_D || Hq % Hkv != 0 || Hq / Hkv > attn::MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  auto len = (const int*)length;
  auto s = (cudaStream_t)stream;
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, len, o, B, S, Hq, Hkv, D, scale, s);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, k, v, len, o, B, S, Hq, Hkv, D, scale, s);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, len, o, B, S, Hq, Hkv, D, scale, s);
  return launch<float, float>(q, k, v, len, o, B, S, Hq, Hkv, D, scale, s);
}
