// Fused GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attn/flash_attn.py (pallas_call in
// `_flash_attn_call`): q (B, Sq, Hq, D) against k/v (B, Skv, Hkv, D), GQA
// with g = Hq / Hkv, runtime kv_len (B,) and q_offset, a rectangular causal
// mask (q_offset + i >= j) and output in q's dtype.
//
// What bounds it on the H100: at the prefill shapes of the main path
// (Sq = Skv ~ 128..4k, D = 128) the score products, about 4*B*Hq*Sq*Skv*D
// operations, against q, k, v and o read or written once.  Design: the TPU
// grid carried (m, l, acc) across sequential KV grid steps in VMEM; here
// one block owns one (batch, kv head, query tile) and loops over KV tiles
// itself, keeping the g heads of the group times BQ query positions (64
// rows) together so each K/V tile is loaded to shared memory once for all
// of them.  Dead tiles past kv_len or above the diagonal are never
// visited.  kv_len and q_offset are read from device memory.  Not yet
// used: tensor cores (scores and P@V run on CUDA cores in f32), TMA, or
// splitting long KV across blocks.
#include "attn_common.cuh"

namespace {

template <typename QT, typename KT>
__global__ void __launch_bounds__(attn::NT)
flash_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const int* __restrict__ kv_len,
                  const int* __restrict__ q_offset, QT* __restrict__ o,
                  int Sq, int Skv, int Hq, int Hkv, int D, int bq,
                  int causal, float scale) {
  extern __shared__ float smem[];
  const attn::Smem s = attn::carve(smem, D);
  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = Hq / Hkv;
  const int R = bq * g;                 // row r: position r / g, head r % g
  const int q0 = qt * bq;
  const int len = min(max(kv_len[b], 0), Skv);
  const int q_off = q_offset[0];

  for (int e = threadIdx.x; e < R * D; e += attn::NT) {
    const int r = e / D, d = e % D;
    const int qpos = q0 + r / g, h = kvh * g + r % g;
    s.q[e] = qpos < Sq
        ? __fmul_rn(attn::to_f32(q[(((size_t)b * Sq + qpos) * Hq + h) * D + d]), scale)
        : 0.0f;
  }
  // keys past the valid prefix, or (causal) past this tile's last query
  // position, are dead for every row of the block
  int n_pos = len;
  if (causal) n_pos = min(n_pos, max(q_off + q0 + bq, 0));

  const size_t kv_row = (size_t)Hkv * D;
  const KT* kb = k + (size_t)b * Skv * kv_row + (size_t)kvh * D;
  const KT* vb = v + (size_t)b * Skv * kv_row + (size_t)kvh * D;
  attn::attend<KT>(
      s, R, D, n_pos,
      [&](int pos) { return kb + pos * kv_row; },
      [&](int pos) { return vb + pos * kv_row; },
      [&](int r, int pos) {
        return !causal || q_off + q0 + r / g >= pos;
      },
      [&](int r, int d, float val) {
        const int qpos = q0 + r / g, h = kvh * g + r % g;
        if (qpos < Sq)
          o[(((size_t)b * Sq + qpos) * Hq + h) * D + d] = attn::from_f32<QT>(val);
      });
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           const int* q_offset, void* o, int B, int Sq, int Skv, int Hq,
           int Hkv, int D, int causal, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const int bq = attn::MAX_ROWS / g;
  const size_t smem = attn::smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<QT, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  flash_attn_kernel<QT, KT><<<grid, attn::NT, smem, stream>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, kv_len, q_offset, (QT*)o,
      Sq, Skv, Hq, Hkv, D, bq, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o like q, all contiguous;
// q_bf16 / kv_bf16 select bf16 (1) or f32 (0) for q/o and for k/v.
// kv_len (B,) and q_offset (1,) are int32 in device memory.  Needs
// D <= 128 and g = Hq / Hkv <= 64.  Returns the launch's cudaError_t.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 const void* kv_len, const void* q_offset,
                                 void* o, int B, int Sq, int Skv, int Hq,
                                 int Hkv, int D, int causal, float scale,
                                 int q_bf16, int kv_bf16, void* stream) {
  if (D > attn::MAX_D || Hq % Hkv != 0 || Hq / Hkv > attn::MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  auto lens = (const int*)kv_len;
  auto off = (const int*)q_offset;
  auto s = (cudaStream_t)stream;
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, lens, off, o, B, Sq, Skv, Hq, Hkv, D, causal, scale, s);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, k, v, lens, off, o, B, Sq, Skv, Hq, Hkv, D, causal, scale, s);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, lens, off, o, B, Sq, Skv, Hq, Hkv, D, causal, scale, s);
  return launch<float, float>(q, k, v, lens, off, o, B, Sq, Skv, Hq, Hkv, D, causal, scale, s);
}
