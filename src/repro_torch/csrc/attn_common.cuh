// Online-softmax attention over KV tiles, shared by flash_attn.cu and
// decode_gqa.cu.  One block of NT threads owns R query rows (R <= MAX_ROWS)
// that all attend to the same KV head, as the Pallas kernels' (g, bq) row
// groups do.  Scores and probabilities live only in shared memory; the
// running (m, l) per row sit in shared memory and the output accumulator
// in registers, all in float32.
//
// Numerics follow the Pallas kernels: masked scores are NEG_INF, masked
// probabilities are zeroed explicitly (NEG_INF - NEG_INF == 0 would
// otherwise give exp(0) = 1), and the output is acc / max(l, 1e-30), so a
// row with no live key returns 0.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int NT = 256;          // threads per block
constexpr int BK = 64;           // keys per tile
constexpr int MAX_ROWS = 64;     // query rows per block
constexpr int MAX_D = 128;       // head dim
constexpr int ACC_PER_THREAD = MAX_ROWS * MAX_D / NT;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Shared-memory layout of one block (floats): Q (R x D, pre-scaled),
// K (BK x (D+1), padded against bank conflicts), V (BK x D), P (R x BK),
// and m, l, alpha (R each).
struct Smem {
  float* q; float* k; float* v; float* p; float* m; float* l; float* alpha;
};

__host__ __device__ inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)MAX_ROWS * D + (size_t)BK * (D + 1) +
                          (size_t)BK * D + (size_t)MAX_ROWS * BK + 3 * MAX_ROWS);
}

__device__ inline Smem carve(float* base, int D) {
  Smem s;
  s.q = base;
  s.k = s.q + MAX_ROWS * D;
  s.v = s.k + BK * (D + 1);
  s.p = s.v + BK * D;
  s.m = s.p + MAX_ROWS * BK;
  s.l = s.m + MAX_ROWS;
  s.alpha = s.l + MAX_ROWS;
  return s;
}

// Runs the online softmax over key positions [0, n_pos) for the R rows
// whose scaled queries are already in s.q, then writes row r's output
// through out(r, d, value).  k_at(pos) / v_at(pos) give the start of the
// D-vector of key / value position pos; live(r, pos) is the mask.
template <typename KT, typename KAt, typename VAt, typename Live, typename Out>
__device__ void attend(const Smem& s, int R, int D, int n_pos, KAt k_at,
                       VAt v_at, Live live, Out out) {
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  float acc[ACC_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ACC_PER_THREAD; ++i) acc[i] = 0.0f;
  for (int r = t; r < R; r += NT) { s.m[r] = NEG_INF; s.l[r] = 0.0f; }
  __syncthreads();

  for (int k0 = 0; k0 < n_pos; k0 += BK) {
    const int kn = min(BK, n_pos - k0);
    for (int e = t; e < BK * D; e += NT) {
      const int j = e / D, d = e % D;
      float kv = 0.0f, vv = 0.0f;
      if (j < kn) {
        kv = to_f32(k_at(k0 + j)[d]);
        vv = to_f32(v_at(k0 + j)[d]);
      }
      s.k[j * (D + 1) + d] = kv;
      s.v[j * D + d] = vv;
    }
    __syncthreads();
    // scores of this tile, masked to NEG_INF
    for (int e = t; e < R * BK; e += NT) {
      const int r = e / BK, j = e % BK;
      float sc = NEG_INF;
      if (j < kn && live(r, k0 + j)) {
        const float* qr = s.q + r * D;
        const float* kr = s.k + j * (D + 1);
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot;
      }
      s.p[r * BK + j] = sc;
    }
    __syncthreads();
    // row statistics: one warp per row
    for (int r = warp; r < R; r += NT / 32) {
      float mx = NEG_INF;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, s.p[r * BK + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s.m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        const bool ok = j < kn && live(r, k0 + j);
        const float pj = ok ? expf(s.p[r * BK + j] - m_new) : 0.0f;
        s.p[r * BK + j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s.alpha[r] = alpha;
        s.l[r] = s.l[r] * alpha + sum;
        s.m[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V
#pragma unroll
    for (int i = 0; i < ACC_PER_THREAD; ++i) {
      const int e = t + NT * i;
      if (e < R * D) {
        const int r = e / D, d = e % D;
        const float* pr = s.p + r * BK;
        float pv = 0.0f;
        for (int j = 0; j < kn; ++j) pv = fmaf(pr[j], s.v[j * D + d], pv);
        acc[i] = acc[i] * s.alpha[r] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < ACC_PER_THREAD; ++i) {
    const int e = t + NT * i;
    if (e < R * D) {
      const int r = e / D, d = e % D;
      out(r, d, acc[i] / fmaxf(s.l[r], 1e-30f));
    }
  }
}

}  // namespace attn
