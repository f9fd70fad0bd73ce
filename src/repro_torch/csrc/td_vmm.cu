// Bit-serial noisy TD-VMM on signed LSQ codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_td_vmm_kernel` of
// src/repro/kernels/td_vmm/td_vmm.py (pallas_call in `_td_vmm_call`).
// Semantics, per (row, col) output and chain segment `seg` of n_chain
// contraction positions:
//   x' = x + 2^(bits_a-1), w' = w + 2^(bits_w-1), both 0 past k_true;
//   for each activation bit plane b (LSB first):
//     p  = sum_k bit_b(x'_k) * w'_k                     (exact integer)
//     p += sigma * sqrt(n_live / n_chain) * z           (z: Box-Muller of
//          hash32 at ((b*n_seg+seg)*M+row)*N+col, uint32, XOR seed)
//     p  = q * rint(p / q)                              (TDC rounding)
//     acc += 2^b * p
//   out += acc - (ow * sum_k x'_k + ox * sum_k w'_k)    (side sums)
// starting from out = k_true * ox * ow.  The float operations run in the
// same order as the Pallas kernel, with explicit _rn intrinsics where the
// compiler could otherwise contract into an FMA, so at sigma = 0 the
// result is bit-exact with it for any tdc_q.
//
// What bounds it on the H100: integer work.  Every plane is a full
// M x K x N product, so the op count is 2*M*K_pad*N*bits_a; at decode
// (M = batch) the int32 weight codes are read once and the kernel is bound
// by their bytes instead.  Design: the TPU carried the segment sum across
// sequential grid steps, which blocks on a GPU cannot do, so one block owns
// a 64 x 64 output tile and loops over segments and 32-deep k chunks
// itself, holding all bits_a plane sums of its 4 x 4 outputs per thread in
// int32 registers (exact: n_chain * (2^bits_w - 1) < 2^31).  x' and w'
// chunks are staged in shared memory with coalesced loads, and the side
// sums come from the same shared tiles.  sigma, q and the seed are read
// from device memory, so they stay runtime operands.  Not yet used:
// tensor cores (the 0/1 planes times 4-bit codes are exact in int8
// mma/wgmma), TMA, or narrower codes than int32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int TM = 4, TN = 4;          // outputs per thread: 16 x 16 threads
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

template <int BITS_A>
__global__ void __launch_bounds__(256)
td_vmm_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
              const float* __restrict__ params,
              const long long* __restrict__ seed_p,
              float* __restrict__ out, int M, int N, int K, int n_chain,
              int k_true, int bits_w) {
  __shared__ int32_t xs[BM][BK + 1];
  __shared__ int32_t ws[BK][BN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ox = 1 << (BITS_A - 1), ow = 1 << (bits_w - 1);
  const int n_seg = (K + n_chain - 1) / n_chain;
  const float sigma = params[0];
  const float q = fmaxf(params[1], 1.0f);
  const uint32_t seed = (uint32_t)seed_p[0];
  const bool noisy = sigma != 0.0f;     // sigma * z == +0 exactly otherwise

  float o[TM][TN];
  const float o0 = (float)(k_true * ox * ow);
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) o[r][c] = o0;

  for (int seg = 0; seg < n_seg; ++seg) {
    int p[BITS_A][TM][TN];
    int sx[TM], sw[TN];
#pragma unroll
    for (int b = 0; b < BITS_A; ++b)
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) p[b][r][c] = 0;
#pragma unroll
    for (int r = 0; r < TM; ++r) sx[r] = 0;
#pragma unroll
    for (int c = 0; c < TN; ++c) sw[c] = 0;

    const int seg_end = min((seg + 1) * n_chain, K);
    for (int k0 = seg * n_chain; k0 < seg_end; k0 += BK) {
      const int kc = min(BK, seg_end - k0);
      for (int i = threadIdx.x; i < BM * BK; i += 256) {
        const int r = i / BK, kk = i % BK;
        const int gr = m0 + r, gk = k0 + kk;
        xs[r][kk] = (gr < M && kk < kc && gk < k_true)
                        ? x[(size_t)gr * K + gk] + ox : 0;
      }
      for (int i = threadIdx.x; i < BK * BN; i += 256) {
        const int kk = i / BN, c = i % BN;
        const int gc = n0 + c, gk = k0 + kk;
        ws[kk][c] = (gc < N && kk < kc && gk < k_true)
                        ? w[(size_t)gk * N + gc] + ow : 0;
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        int xv[TM], wv[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) { xv[r] = xs[ty + 16 * r][kk]; sx[r] += xv[r]; }
#pragma unroll
        for (int c = 0; c < TN; ++c) { wv[c] = ws[kk][tx + 16 * c]; sw[c] += wv[c]; }
#pragma unroll
        for (int b = 0; b < BITS_A; ++b)
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const int bit = (xv[r] >> b) & 1;
#pragma unroll
            for (int c = 0; c < TN; ++c) p[b][r][c] += bit * wv[c];
          }
      }
      __syncthreads();
    }

    // segment epilogue: noise, TDC rounding, 2^b recomposition, side sums
    const float n_live = fminf((float)n_chain,
                               fmaxf(__fsub_rn((float)k_true,
                                               __fmul_rn((float)seg, (float)n_chain)),
                                     1.0f));
    const float sig_seg = __fmul_rn(sigma, sqrtf(__fdiv_rn(n_live, (float)n_chain)));
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const uint32_t row = (uint32_t)(m0 + ty + 16 * r);
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const uint32_t col = (uint32_t)(n0 + tx + 16 * c);
        float acc = 0.0f;
#pragma unroll
        for (int b = 0; b < BITS_A; ++b) {
          float part = (float)p[b][r][c];
          if (noisy) {
            const uint32_t idx =
                (((uint32_t)b * (uint32_t)n_seg + (uint32_t)seg) * (uint32_t)M + row)
                    * (uint32_t)N + col;
            part = __fadd_rn(part, __fmul_rn(sig_seg, gauss(idx, seed)));
          }
          part = __fmul_rn(q, rintf(__fdiv_rn(part, q)));
          acc = __fadd_rn(acc, __fmul_rn((float)(1 << b), part));
        }
        const float corr = __fadd_rn(__fmul_rn((float)ow, (float)sx[r]),
                                     __fmul_rn((float)ox, (float)sw[c]));
        o[r][c] = __fadd_rn(o[r][c], __fsub_rn(acc, corr));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gr = m0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = n0 + tx + 16 * c;
      if (gr < M && gc < N) out[(size_t)gr * N + gc] = o[r][c];
    }
  }
}

template <int B>
void launch(dim3 grid, cudaStream_t s, const int32_t* x, const int32_t* w,
            const float* params, const long long* seed, float* out, int M,
            int N, int K, int n_chain, int k_true, int bits_w) {
  td_vmm_kernel<B><<<grid, 256, 0, s>>>(x, w, params, seed, out, M, N, K,
                                        n_chain, k_true, bits_w);
}

}  // namespace

// x (M, K) int32 and w (K, N) int32 signed codes, row-major; params f32
// [sigma, tdc_q] and seed int64 (low 32 bits used) in device memory; out
// (M, N) f32.  Contraction positions >= k_true are masked, so K need not
// be a multiple of n_chain.  Returns cudaGetLastError() after the launch.
extern "C" int td_vmm_launch(const void* x, const void* w, const void* params,
                             const void* seed, void* out, int M, int N, int K,
                             int n_chain, int k_true, int bits_a, int bits_w,
                             void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  auto xi = (const int32_t*)x;
  auto wi = (const int32_t*)w;
  auto pp = (const float*)params;
  auto sp = (const long long*)seed;
  auto op = (float*)out;
  switch (bits_a) {
    case 1: launch<1>(grid, s, xi, wi, pp, sp, op, M, N, K, n_chain, k_true, bits_w); break;
    case 2: launch<2>(grid, s, xi, wi, pp, sp, op, M, N, K, n_chain, k_true, bits_w); break;
    case 3: launch<3>(grid, s, xi, wi, pp, sp, op, M, N, K, n_chain, k_true, bits_w); break;
    case 4: launch<4>(grid, s, xi, wi, pp, sp, op, M, N, K, n_chain, k_true, bits_w); break;
    case 5: launch<5>(grid, s, xi, wi, pp, sp, op, M, N, K, n_chain, k_true, bits_w); break;
    case 6: launch<6>(grid, s, xi, wi, pp, sp, op, M, N, K, n_chain, k_true, bits_w); break;
    case 7: launch<7>(grid, s, xi, wi, pp, sp, op, M, N, K, n_chain, k_true, bits_w); break;
    case 8: launch<8>(grid, s, xi, wi, pp, sp, op, M, N, K, n_chain, k_true, bits_w); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
