// Bit-serial noisy TD-VMM on signed LSQ codes, for Hopper (sm_90a), with the
// bit-plane products on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel `_td_vmm_kernel` of
// src/repro/kernels/td_vmm/td_vmm.py:110 (pallas_call at :229 in
// `_td_vmm_call`).  Semantics, per (row, col) output and chain segment
// `seg` of n_chain contraction positions:
//   x' = x + 2^(bits_a-1), w' = w + 2^(bits_w-1), both 0 past k_true;
//   for each activation bit plane b (LSB first):
//     p  = sum_k bit_b(x'_k) * w'_k                     (exact integer)
//     p += sigma * sqrt(n_live / n_chain) * z           (z: Box-Muller of
//          hash32 at ((b*n_seg+seg)*M+row)*N+col, uint32, XOR seed)
//     p  = q * rint(p / q)                              (TDC rounding)
//     acc += 2^b * p
//   out += acc - (ow * sum_k x'_k + ox * sum_k w'_k)    (side sums)
// starting from out = k_true * ox * ow and adding the segments in order.
// The float operations run in the Pallas kernel's order, with explicit _rn
// intrinsics where the compiler could otherwise contract into an FMA, so
// at sigma = 0 the result is bit-exact with it for any tdc_q.  Codes must
// lie in their ranges (x' < 2^bits_a, w' < 2^bits_w), as the quantizer
// gives them: both are narrowed to one byte.
//
// What bounds it on the H100, and what the design does about it:
// * The plane products.  A 0/1 plane times w' <= 255 is exact in the
//   tensor cores' u8 x u8 -> s32 MMA (mma.sync m16n8k32; n_chain * 255 <
//   2^31); its rate is not what bounds either route.  x and w arrive as
//   int32 through 16-byte cp.async (4-byte when a row is not 16-byte
//   aligned) into a ring of shared-memory stages, and each warp narrows
//   its own fragments from there in registers: four codes become four
//   offset bytes by three byte permutes and one LOP3 (flip bit b-1, keep b
//   bits), w transposed to K-major on the way (its stage is swizzled so
//   the reads are conflict-free).  No plane and no second copy of w is
//   materialised: a plane's fragment is (x' >> b) & 0x01010101 on four
//   packed bytes.  The side sums are two more MMAs per k step, of the same
//   fragments against a fragment of ones.  A segment is walked in chunks
//   whose last one is masked at the segment's end, so no MMA sums across a
//   segment boundary (n_chain 576, 48 and 16 all stay exact).
// * Route "block" (M > 8; prefill, training): a block owns a BM x 64
//   output tile and walks every segment in order.  Its two warpgroups own
//   a half (BM / 2 rows) each, with their own 2-stage ring of 64-deep
//   chunks and their own named barrier, and run free of each other: a
//   barrier spans 4 warps, and one half's epilogue issues beside the
//   other's loads and MMAs.  (On an H100 this was faster than one 8-warp
//   ring, than the same halves alternating their MMA phases in a strict
//   ping-pong or started half a period apart, and than each half a block
//   of its own.)  A warp holds the int32 sums of every plane of a 32 x 16
//   tile (16 x 16 when bits_a > 4): bits_a * 16 (bits_a * 8) registers,
//   which with the outputs and side sums is what two blocks an SM allow
//   (128 registers a thread), so BM is 64 for bits_a <= 4 and 32 above.
//   Its floors: the L2 traffic of the int32 tiles (each x tile read once
//   per column of tiles, each w tile once per half) and, with noise on,
//   the segment epilogue: per (plane, output) two hash32, accurate logf /
//   sqrtf / cosf and the TDC rounding (td_vmm_noise.cuh; chip_smoke.py
//   times this arithmetic alone), far more issue than the MMAs of a
//   576-deep segment.  The epilogue runs from registers, up to four
//   planes' noise in one call (gauss_n) for instruction-level
//   parallelism; at sigma == 0 it skips the noise, and at q == 1 the IEEE
//   division (p / 1 is p bit for bit).  The blocks of one column of tiles are launched
//   together, so w is read from device memory about once.
// * Route "split" (M <= 8, decode): bound by the bytes of w.  The operands
//   are swapped: 16 columns of w'^T fill the MMA's 16-row side, and the 8
//   rows of x (zero-padded) one 8-column tile per plane.  The grid splits
//   over segments as well as 128-column tiles, and each warp streams its
//   own 32 columns through a private 4-stage cp.async ring with no block
//   barrier.  Each block writes its segment's acc - corr to a scratch
//   buffer (n_seg x M x N f32, allocated by the wrapper); the last block of
//   a column tile (atomic counter, left at 0) adds the partials in segment
//   order onto k_true * ox * ow, so the result is bit-identical to the
//   block route's for any q.
// sigma, q and the seed are read from device memory, so they stay runtime
// operands.  One call is one launch.
//
// The lane axis (the reference's td_vmm under jax.vmap: one probe of the
// batched noise search, or one head of TD attention, a lane): both routes
// take `lanes` on gridDim.z.  Lane l reads x at l*M*K, w at
// (l % w_lanes)*w_stride (w_stride 0: one w shared by every lane; w_lanes
// below `lanes`: the P x E expert lanes of the MoE under the noise search,
// lane p*E + e reading expert e's w, with no copy of w a probe), params at
// 2*l and seed at l, and writes out
// at l*M*N; on the split route its scratch is at l*n_seg*M*N and its
// column-tile counters at l*N.  The offsets are 64-bit; the noise index
// stays the per-lane ((b*n_seg+seg)*M+row)*N+col in uint32, as vmap leaves
// the kernel body as it is.  So a lane equals a single-lane call with its
// operands bit for bit, noise included.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "td_vmm_noise.cuh"

namespace {

constexpr uint32_t ONES = 0x01010101u;     // a 1 in each byte
constexpr int BK = 32;                     // one k32 MMA step (split chunks)

// route "block": 2 warpgroups of 4 warps, each warp MI m16 x 2 n8 tiles
constexpr int B_WARPS_N = 4, B_THREADS = 256, WG_THREADS = 128;
constexpr int B_NJ = 2;
constexpr int B_BN = B_WARPS_N * 8 * B_NJ;         // 64 columns
constexpr int B_BK = 2 * BK;               // chunk depth: two k32 steps
constexpr int B_STAGES = 2;               // a warpgroup's ring
constexpr int XR = B_BK + 16;              // raw x row stride (int32); 16
                                           // mod 32 keeps fragment loads
                                           // conflict-free

// route "split": 4 warps of 32 columns each
constexpr int S_WARPS = 4, S_THREADS = 128;
constexpr int S_RT = 2;                    // m16 tiles (of w columns) a warp
constexpr int S_BN = S_WARPS * 16 * S_RT;  // 128 columns
constexpr int S_STAGES = 4;
constexpr int S_MP = 8;                    // rows of x a split block holds

__host__ __device__ constexpr int block_mi(int bits_a) {
  return bits_a <= 4 ? 2 : 1;
}

// The runtime operands of a segment's epilogue.
struct Noise {
  float sig_seg, q;
  uint32_t seed, plane_stride;             // index step between planes
  bool noisy, q_one;
};

__device__ __forceinline__ Noise segment_noise(const float* params,
                                               uint32_t seed, int seg,
                                               int n_seg, int n_chain,
                                               int k_true, int M, int N) {
  Noise nz;
  const float sigma = params[0];
  const float n_live = fminf(
      (float)n_chain,
      fmaxf(__fsub_rn((float)k_true, __fmul_rn((float)seg, (float)n_chain)),
            1.0f));
  nz.sig_seg = __fmul_rn(sigma, sqrtf(__fdiv_rn(n_live, (float)n_chain)));
  nz.q = fmaxf(params[1], 1.0f);
  nz.seed = seed;
  nz.plane_stride = (uint32_t)n_seg * (uint32_t)M * (uint32_t)N;
  nz.noisy = sigma != 0.0f;                // sigma * z == +0 exactly otherwise
  nz.q_one = nz.q == 1.0f;
  return nz;
}

// One output's segment term, (sum_b 2^b part_b, LSB first) - (ow sx + ox
// sw); `base` is the noise index of plane 0, (seg*M + row)*N + col.
template <int BITS_A>
__device__ __forceinline__ float seg_term(const int (&p)[BITS_A], int sx,
                                          int sw, int ox, int ow,
                                          const Noise& nz, uint32_t base) {
  constexpr int FULL4 = BITS_A / 4 * 4, TAIL = BITS_A % 4;
  float z[(BITS_A + 3) / 4 * 4];
  auto put = [&](int b, float4 v) {
    z[b] = v.x;
    z[b + 1] = v.y;
    z[b + 2] = v.z;
    z[b + 3] = v.w;
  };
  if (nz.noisy) {
    // four planes a call, then only the chains the last planes use
#pragma unroll
    for (int b = 0; b < FULL4; b += 4)
      put(b, gauss_n<4>(base + (uint32_t)b * nz.plane_stride,
                        nz.plane_stride, nz.seed));
    if constexpr (TAIL != 0)
      put(FULL4, gauss_n<TAIL>(base + (uint32_t)FULL4 * nz.plane_stride,
                               nz.plane_stride, nz.seed));
  }
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < BITS_A; ++b) {
    float part = (float)p[b];
    if (nz.noisy) part = __fadd_rn(part, __fmul_rn(nz.sig_seg, z[b]));
    // p / 1 is p bit for bit, so q == 1 needs no division
    part = nz.q_one ? rintf(part)
                    : __fmul_rn(nz.q, rintf(__fdiv_rn(part, nz.q)));
    acc = __fadd_rn(acc, __fmul_rn((float)(1 << b), part));
  }
  const float corr = __fadd_rn(__fmul_rn((float)ow, (float)sx),
                               __fmul_rn((float)ox, (float)sw));
  return __fsub_rn(acc, corr);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies; pred false fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// named barrier `id` over `n` threads (a warpgroup's own barrier)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// d += a * b: m16n8k32, u8 x u8 -> s32
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t plane(uint32_t v, int b) {
  return (v >> b) & ONES;
}

// Byte mask of the live positions among k..k+3 of a chunk of `len`.
__device__ __forceinline__ uint32_t live_bytes(int k, int len) {
  const int n = len - k;
  return n >= 4 ? 0xFFFFFFFFu : (n <= 0 ? 0u : 0xFFFFFFFFu >> (32 - 8 * n));
}

// Four codes in [-2^(b-1), 2^(b-1)) -> four offset bytes code + 2^(b-1):
// the low b bits of a code with bit b-1 flipped (`flip` = 2^(b-1) in each
// byte, `keep` = 2^b - 1 in each byte of a live position, else 0).
__device__ __forceinline__ uint32_t pack_off(int a, int b, int c, int d,
                                             uint32_t flip, uint32_t keep) {
  return (__byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                      0x5410) ^ flip) & keep;
}

// Column of int32 element (k, n) in a raw w tile: 16-byte groups swizzled
// by k / 4, so the lanes that read four consecutive k of one column (a
// K-major byte word) hit distinct banks.
__device__ __forceinline__ int wswz(int k, int n) {
  return n ^ (((k >> 2) & 3) << 3);
}

// ---------------------------------------------------------------------------
// route "block"
template <int BITS_A>
__global__ void __launch_bounds__(B_THREADS, 2)
td_vmm_block(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
             const float* __restrict__ params,
             const long long* __restrict__ seed_p, float* __restrict__ out,
             int M, int N, int K, int n_chain, int k_true, int bits_w,
             int vec, long long w_stride, int w_lanes) {
  constexpr int MI = block_mi(BITS_A);
  {  // this block's lane
    const long long lane = blockIdx.z;
    x += lane * M * K;
    w += (lane % w_lanes) * w_stride;
    params += 2 * lane;
    seed_p += lane;
    out += lane * M * N;
  }
  constexpr int HM = 16 * MI;                // rows of a warpgroup's half
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, tid = threadIdx.x & 127, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // this warpgroup's ring: [STAGES][HM][XR] of x, [STAGES][BK][BN] of w
  int32_t* raw_x = (int32_t*)smem + wg * B_STAGES * (HM * XR + B_BK * B_BN);
  int32_t* raw_w = raw_x + B_STAGES * HM * XR;
  const int m0 = (blockIdx.x * 2 + wg) * HM, n0 = blockIdx.y * B_BN;
  const int ox = 1 << (BITS_A - 1), ow = 1 << (bits_w - 1);
  const int n_seg = max(1, (K + n_chain - 1) / n_chain);
  const int cps = (n_chain + B_BK - 1) / B_BK;  // chunks of a full segment
  const int s_full = k_true / n_chain;          // segments live to the end
  const int rem_chunks = (k_true - s_full * n_chain + B_BK - 1) / B_BK;
  const int n_chunks = s_full * cps + rem_chunks;
  const uint32_t seed = (uint32_t)seed_p[0];

  // chunk gi: contraction start k0 and live length len (<= B_BK)
  auto chunk = [&](int gi, int& k0, int& len) {
    const int seg = gi < s_full * cps ? gi / cps : s_full;
    k0 = seg * n_chain + (gi - seg * cps) * B_BK;
    len = min(B_BK, min(seg * n_chain + n_chain, k_true) - k0);
  };
  auto load = [&](int gi) {
    if (gi < n_chunks) {
      int k0, len;
      chunk(gi, k0, len);
      int32_t* rx = raw_x + (gi % B_STAGES) * HM * XR;
      int32_t* rw = raw_w + (gi % B_STAGES) * B_BK * B_BN;
      if (vec) {
#pragma unroll
        for (int e = tid; e < HM * (B_BK / 4); e += WG_THREADS) {
          const int r = e / (B_BK / 4), kk = (e % (B_BK / 4)) * 4;
          const bool ok = m0 + r < M && kk < len;
          cp_async16(smem_u32(rx + r * XR + kk),
                     ok ? x + (size_t)(m0 + r) * K + k0 + kk : x, ok);
        }
#pragma unroll
        for (int e = tid; e < B_BK * (B_BN / 4); e += WG_THREADS) {
          const int kk = e / (B_BN / 4), c = (e % (B_BN / 4)) * 4;
          const bool ok = kk < len && n0 + c < N;
          cp_async16(smem_u32(rw + kk * B_BN + wswz(kk, c)),
                     ok ? w + (size_t)(k0 + kk) * N + n0 + c : w, ok);
        }
      } else {
        for (int e = tid; e < HM * B_BK; e += WG_THREADS) {
          const int r = e / B_BK, kk = e % B_BK;
          const bool ok = m0 + r < M && kk < len;
          cp_async4(smem_u32(rx + r * XR + kk),
                    ok ? x + (size_t)(m0 + r) * K + k0 + kk : x, ok);
        }
        for (int e = tid; e < B_BK * B_BN; e += WG_THREADS) {
          const int kk = e / B_BN, c = e % B_BN;
          const bool ok = kk < len && n0 + c < N;
          cp_async4(smem_u32(rw + kk * B_BN + wswz(kk, c)),
                    ok ? w + (size_t)(k0 + kk) * N + n0 + c : w, ok);
        }
      }
    }
    cp_async_commit();
  };

  int p[BITS_A][MI][B_NJ][4];      // plane sums of the current segment
  int sx[MI][4], sw[B_NJ][4];      // side sums of the current segment
  float o[MI][B_NJ][4];
  const float o0 = (float)((long long)k_true * ox * ow);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < B_NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[i][j][e] = o0;
        sx[i][e] = 0;
        sw[j][e] = 0;
#pragma unroll
        for (int b = 0; b < BITS_A; ++b) p[b][i][j][e] = 0;
      }

  // the MMAs of chunk gi: each warp narrows its own fragments from the
  // int32 stage in registers (x rows as 16-byte loads, w columns swizzled);
  // FULL chunks (every position live) need no position mask
  const uint32_t flip_x = (uint32_t)ox * ONES, keep_x = ((2u * ox) - 1) * ONES;
  const uint32_t flip_w = (uint32_t)ow * ONES, keep_w = ((2u * ow) - 1) * ONES;
  auto mma_steps = [&](const int32_t* rx, const int32_t* rw, int len,
                       auto full) {
    constexpr bool FULL = decltype(full)::value;
    const uint32_t ones[4] = {ONES, ONES, ONES, ONES};
#pragma unroll
    for (int ks = 0; ks < B_BK / BK; ++ks) {
      if (!FULL && ks * BK >= len) break;
      uint32_t ax[MI][4], bw[B_NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int32_t* r0 = rx + (i * 16 + g) * XR + ks * BK;
#pragma unroll
        for (int h = 0; h < 4; ++h) {     // (row g, g + 8) x (k, k + 16)
          const int kk = ks * BK + (h >> 1) * 16 + t * 4;
          const int4 v = *(const int4*)(r0 + (h & 1) * 8 * XR +
                                        (h >> 1) * 16 + t * 4);
          ax[i][h] = pack_off(v.x, v.y, v.z, v.w, flip_x,
                              FULL ? keep_x : keep_x & live_bytes(kk, len));
        }
        mma_u8(sx[i], ax[i], ONES, ONES);
      }
#pragma unroll
      for (int j = 0; j < B_NJ; ++j) {
        const int c = wn * 8 * B_NJ + j * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = ks * BK + h * 16 + t * 4;
          const int32_t* col = rw + kk * B_BN + wswz(kk, c);
          bw[j][h] = pack_off(col[0], col[B_BN], col[2 * B_BN], col[3 * B_BN],
                              flip_w,
                              FULL ? keep_w : keep_w & live_bytes(kk, len));
        }
        mma_u8(sw[j], ones, bw[j][0], bw[j][1]);
      }
#pragma unroll
      for (int b = 0; b < BITS_A; ++b)
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const uint32_t ab[4] = {plane(ax[i][0], b), plane(ax[i][1], b),
                                  plane(ax[i][2], b), plane(ax[i][3], b)};
#pragma unroll
          for (int j = 0; j < B_NJ; ++j)
            mma_u8(p[b][i][j], ab, bw[j][0], bw[j][1]);
        }
    }
  };
  auto mma_chunk = [&](int gi) {
    int k0, len;
    chunk(gi, k0, len);
    const int32_t* rx = raw_x + (gi % B_STAGES) * HM * XR;
    const int32_t* rw = raw_w + (gi % B_STAGES) * B_BK * B_BN;
    if (len == B_BK)
      mma_steps(rx, rw, len, std::true_type{});
    else
      mma_steps(rx, rw, len, std::false_type{});
  };

  // The two warpgroups run free of each other: each waits only on its own
  // ring (named barrier 1 + wg over 4 warps), so one's segment epilogue
  // can issue beside the other's loads and MMAs.
  for (int s = 0; s < B_STAGES - 1; ++s) load(s);
  int gi = 0;
  for (int seg = 0; seg < n_seg; ++seg) {
    const int nc = seg < s_full ? cps : (seg == s_full ? rem_chunks : 0);
    for (int c = 0; c < nc; ++c, ++gi) {
      cp_async_wait<B_STAGES - 2>();          // chunk gi has landed
      bar_sync(1 + wg, WG_THREADS);           // ... and chunk gi - 1 is read
      load(gi + B_STAGES - 1);
      mma_chunk(gi);
    }
    // segment epilogue, from registers: noise, TDC rounding, side sums
    const Noise nz = segment_noise(params, seed, seg, n_seg, n_chain, k_true,
                                   M, N);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < B_NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + i * 16 + g + (e >> 1) * 8;
          const int col = n0 + wn * 8 * B_NJ + j * 8 + t * 2 + (e & 1);
          if (row < M && col < N) {
            int pv[BITS_A];
#pragma unroll
            for (int b = 0; b < BITS_A; ++b) pv[b] = p[b][i][j][e];
            const uint32_t base =
                ((uint32_t)seg * (uint32_t)M + (uint32_t)row) * (uint32_t)N +
                (uint32_t)col;
            o[i][j][e] = __fadd_rn(
                o[i][j][e], seg_term<BITS_A>(pv, sx[i][e], sw[j][e], ox, ow,
                                             nz, base));
          }
        }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < B_NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sx[i][e] = 0;
          sw[j][e] = 0;
#pragma unroll
          for (int b = 0; b < BITS_A; ++b) p[b][i][j][e] = 0;
        }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < B_NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + i * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn * 8 * B_NJ + j * 8 + t * 2 + (e & 1);
        if (row < M && col < N) out[(size_t)row * N + col] = o[i][j][e];
      }
}

// ---------------------------------------------------------------------------
// route "split": grid (column tiles, segments)
template <int BITS_A>
__global__ void __launch_bounds__(S_THREADS, 3)
td_vmm_split(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
             const float* __restrict__ params,
             const long long* __restrict__ seed_p,
             float* __restrict__ scratch, int* __restrict__ counters,
             float* __restrict__ out, int M, int N, int K, int n_chain,
             int k_true, int bits_w, int vec, long long w_stride,
             int w_lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sm_last;
  {  // this block's lane
    const long long lane = blockIdx.z;
    x += lane * M * K;
    w += (lane % w_lanes) * w_stride;
    params += 2 * lane;
    seed_p += lane;
    out += lane * M * N;
    scratch += lane * gridDim.y * M * N;
    counters += lane * N;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * S_BN, nw0 = n0 + warp * 32;
  const int seg = blockIdx.y, n_seg = gridDim.y;
  const int ox = 1 << (BITS_A - 1), ow = 1 << (bits_w - 1);
  const int seg0 = seg * n_chain;
  const int live = max(0, min(n_chain, k_true - seg0));
  const int nc = (live + BK - 1) / BK;
  const int ncp = (n_chain + BK - 1) / BK;   // chunks of a segment, padded
  const int sxw = ncp * (BK / 4) + 4;        // words a row of x' (padded)
  int32_t* my = (int32_t*)smem + warp * S_STAGES * BK * 32;  // [STAGES][BK][32]
  uint32_t* xq = (uint32_t*)smem + S_WARPS * S_STAGES * BK * 32;  // [S_MP][sxw]

  // this warp's 32 columns of chunk c, rows past the chunk's end zero
  auto load = [&](int c) {
    if (c < nc) {
      const int k0 = seg0 + c * BK, len = min(BK, live - c * BK);
      int32_t* dst = my + (c % S_STAGES) * BK * 32;
      if (vec) {
#pragma unroll
        for (int it = 0; it < BK / 4; ++it) {
          const int kk = (lane >> 3) + 4 * it, cw = (lane & 7) * 4;
          const bool ok = kk < len && nw0 + cw < N;
          cp_async16(smem_u32(dst + kk * 32 + wswz(kk, cw)),
                     ok ? w + (size_t)(k0 + kk) * N + nw0 + cw : w, ok);
        }
      } else {
        for (int kk = 0; kk < BK; ++kk) {
          const bool ok = kk < len && nw0 + lane < N;
          cp_async4(smem_u32(dst + kk * 32 + wswz(kk, lane)),
                    ok ? w + (size_t)(k0 + kk) * N + nw0 + lane : w, ok);
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < S_STAGES - 1; ++s) load(s);
  // x' of this segment as u8 (rows >= M and positions >= live are 0)
  const uint32_t flip_x = (uint32_t)ox * ONES, keep_x = ((2u * ox) - 1) * ONES;
#pragma unroll 4
  for (int e = tid; e < S_MP * ncp * (BK / 4); e += S_THREADS) {
    const int m = e / (ncp * (BK / 4)), kw = e % (ncp * (BK / 4)), kk = kw * 4;
    int v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = m < M && kk + i < live ? x[(size_t)m * K + seg0 + kk + i] : 0;
    xq[m * sxw + kw] = m < M ? pack_off(v[0], v[1], v[2], v[3], flip_x,
                                        keep_x & live_bytes(kk, live))
                             : 0u;
  }
  __syncthreads();

  int p[BITS_A][S_RT][4], sx[4], sw[S_RT][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sx[e] = 0;
#pragma unroll
    for (int r = 0; r < S_RT; ++r) {
      sw[r][e] = 0;
#pragma unroll
      for (int b = 0; b < BITS_A; ++b) p[b][r][e] = 0;
    }
  }
  const uint32_t ones[4] = {ONES, ONES, ONES, ONES};
  const uint32_t flip_w = (uint32_t)ow * ONES, keep_w = ((2u * ow) - 1) * ONES;
  for (int c = 0; c < nc; ++c) {
    load(c + S_STAGES - 1);
    cp_async_wait<S_STAGES - 1>();            // chunk c has landed
    __syncwarp();
    const int len = min(BK, live - c * BK);
    const int32_t* src = my + (c % S_STAGES) * BK * 32;
    uint32_t a[S_RT][4];
#pragma unroll
    for (int r = 0; r < S_RT; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int n = r * 16 + g + rr * 8, kk = h * 16 + t * 4;
          const int* col = src + wswz(kk, n);
          a[r][h * 2 + rr] = pack_off(col[kk * 32], col[(kk + 1) * 32],
                                      col[(kk + 2) * 32], col[(kk + 3) * 32],
                                      flip_w, keep_w & live_bytes(kk, len));
        }
    const uint32_t bx0 = xq[g * sxw + c * (BK / 4) + t];
    const uint32_t bx1 = xq[g * sxw + c * (BK / 4) + 4 + t];
    mma_u8(sx, ones, bx0, bx1);
#pragma unroll
    for (int r = 0; r < S_RT; ++r) mma_u8(sw[r], a[r], ONES, ONES);
#pragma unroll
    for (int b = 0; b < BITS_A; ++b) {
      const uint32_t pb0 = plane(bx0, b), pb1 = plane(bx1, b);
#pragma unroll
      for (int r = 0; r < S_RT; ++r) mma_u8(p[b][r], a[r], pb0, pb1);
    }
    __syncwarp();                             // stage free for chunk c + 4
  }
  cp_async_wait<0>();

  // this segment's term of each output -> scratch[seg][m][n]
  const Noise nz = segment_noise(params, (uint32_t)seed_p[0], seg, n_seg,
                                 n_chain, k_true, M, N);
#pragma unroll
  for (int r = 0; r < S_RT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = nw0 + r * 16 + g + (e >> 1) * 8, m = 2 * t + (e & 1);
      if (m < M && n < N) {
        int pv[BITS_A];
#pragma unroll
        for (int b = 0; b < BITS_A; ++b) pv[b] = p[b][r][e];
        const uint32_t base =
            ((uint32_t)seg * (uint32_t)M + (uint32_t)m) * (uint32_t)N +
            (uint32_t)n;
        scratch[((size_t)seg * M + m) * N + n] =
            seg_term<BITS_A>(pv, sx[e], sw[r][e], ox, ow, nz, base);
      }
    }

  // the last block of this column tile adds the segments in order
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(counters + blockIdx.x, 1) == n_seg - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  const float o0 = (float)((long long)k_true * ox * ow);
  for (int e = tid; e < M * S_BN; e += S_THREADS) {
    const int m = e / S_BN, n = n0 + e % S_BN;
    if (n >= N) continue;
    const float* col = scratch + (size_t)m * N + n;
    const size_t step = (size_t)M * N;
    float o = o0;
    for (int s = 0; s < n_seg; s += 8) {
      float d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = s + j < n_seg ? __ldcg(col + (s + j) * step) : 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s + j < n_seg) o = __fadd_rn(o, d[j]);
    }
    out[(size_t)m * N + n] = o;
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

}  // namespace

namespace {

template <int BITS_A>
size_t block_smem() {
  constexpr int BM = 2 * 16 * block_mi(BITS_A);
  return sizeof(int32_t) * 2 * B_STAGES * (BM / 2 * XR + B_BK * B_BN);
}

size_t split_smem(int n_chain) {
  const int ncp = (n_chain + BK - 1) / BK;
  return sizeof(int32_t) * (S_WARPS * S_STAGES * BK * 32) +
         sizeof(uint32_t) * S_MP * (ncp * (BK / 4) + 4);
}

template <int B>
int launch(int route, cudaStream_t s, const int32_t* x, const int32_t* w,
           const float* params, const long long* seed, float* scratch,
           int* counters, float* out, int M, int N, int K, int n_chain,
           int k_true, int bits_w, int vec, int lanes, long long w_stride,
           int w_lanes) {
  if (route == 0) {
    constexpr int BM = 2 * 16 * block_mi(B);
    const size_t smem = block_smem<B>();
    static size_t allowed = 0;             // dynamic smem opted in so far
    if (smem > allowed) {
      cudaFuncSetAttribute(td_vmm_block<B>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      allowed = smem;
    }
    dim3 grid((M + BM - 1) / BM, (N + B_BN - 1) / B_BN, lanes);
    td_vmm_block<B><<<grid, B_THREADS, smem, s>>>(
        x, w, params, seed, out, M, N, K, n_chain, k_true, bits_w, vec,
        w_stride, w_lanes);
  } else {
    const size_t smem = split_smem(n_chain);
    static size_t allowed = 0;
    if (smem > allowed) {
      cudaFuncSetAttribute(td_vmm_split<B>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      allowed = smem;
    }
    dim3 grid((N + S_BN - 1) / S_BN, max(1, (K + n_chain - 1) / n_chain),
              lanes);
    td_vmm_split<B><<<grid, S_THREADS, smem, s>>>(
        x, w, params, seed, scratch, counters, out, M, N, K, n_chain,
        k_true, bits_w, vec, w_stride, w_lanes);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// `lanes` lanes of x (M, K) int32 and w (K, N) int32 signed codes,
// row-major, lane after lane (w's lane stride `w_stride` elements: K * N,
// or 0 for one w shared by every lane; lane l reads w number l % w_lanes,
// and w_lanes divides lanes); per lane params f32 [sigma, tdc_q]
// and seed int64 (low 32 bits used) in device memory; out (lanes, M, N)
// f32.  Contraction positions >= k_true are masked, so K need not be a
// multiple of n_chain.  route 0 is the block route; route 1 the split route
// (M <= 8), which takes a scratch buffer of lanes * n_seg * M * N f32 and
// lanes * N int32 counters that are 0 (the first ceil(N / 128) of each
// lane's N are used, and left 0).  Returns cudaGetLastError() after the
// launch.
extern "C" int td_vmm_launch(const void* x, const void* w, const void* params,
                             const void* seed, void* out, void* scratch,
                             void* counters, int M, int N, int K, int n_chain,
                             int k_true, int bits_a, int bits_w, int route,
                             int lanes, long long w_stride, int w_lanes,
                             void* stream) {
  if (route != 0 && (route != 1 || M > S_MP || !scratch || !counters))
    return (int)cudaErrorInvalidValue;
  if (n_chain < 1 || bits_a < 1 || bits_a > 8 || bits_w < 1 || bits_w > 8)
    return (int)cudaErrorInvalidValue;
  if (lanes < 1 || lanes > 65535 || (w_stride != 0 &&
                                     w_stride != (long long)K * N) ||
      w_lanes < 1 || lanes % w_lanes != 0)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need every lane's rows 16-byte aligned: K and N
  // multiples of 4 make the lane strides M * K and K * N multiples of 4
  const bool vec = K % 4 == 0 && N % 4 == 0 && n_chain % 4 == 0 &&
                   (long long)M * K % 4 == 0 && w_stride % 4 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto xi = (const int32_t*)x;
  auto wi = (const int32_t*)w;
  auto pp = (const float*)params;
  auto sp = (const long long*)seed;
  auto sc = (float*)scratch;
  auto cn = (int*)counters;
  auto op = (float*)out;
#define TD_VMM_CASE(B)                                                      \
  case B:                                                                   \
    return launch<B>(route, s, xi, wi, pp, sp, sc, cn, op, M, N, K, n_chain, \
                     k_true, bits_w, vec, lanes, w_stride, w_lanes);
  switch (bits_a) {
    TD_VMM_CASE(1) TD_VMM_CASE(2) TD_VMM_CASE(3) TD_VMM_CASE(4)
    TD_VMM_CASE(5) TD_VMM_CASE(6) TD_VMM_CASE(7) TD_VMM_CASE(8)
  }
#undef TD_VMM_CASE
  return (int)cudaErrorInvalidValue;
}
