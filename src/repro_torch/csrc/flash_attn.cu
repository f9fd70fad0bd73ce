// Fused GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attn/flash_attn.py (pallas_call in
// `_flash_attn_call`): q (B, Sq, Hq, D) against k/v (B, Skv, Hkv, D), GQA
// with g = Hq / Hkv, runtime kv_len (B,) and q_offset, a rectangular causal
// mask (q_offset + i >= j) and output in q's dtype.
//
// What bounds it on the H100: the two products, 4*D operations per live
// (query, key) pair at bf16 tensor-core rates, against q, k, v and o read
// or written once: operations from Sq ~ 1k up (train_4k), bytes and
// latency at the main path's Sq 128.
//
// Design.  The TPU grid carried (m, l, acc) across sequential KV grid steps
// in VMEM; here one block owns one (batch, kv head, query tile) and loops
// over key tiles itself (64 keys on the tensor cores, 32 on the CUDA
// cores).  A query tile is 64 rows, the g heads of the group times 64 / g
// positions (row r: position r / g, head r % g), so each K/V tile is read
// once for the whole group.  Dead tiles past kv_len or above the diagonal
// are never visited; kv_len and q_offset are read from device memory (no
// host sync).
//
// Routes.  bf16 q with a bf16 cache at D 64 or 128 runs on the tensor
// cores (`flash_wg<HD, NSPLIT>`): D 128 serves the dense decoders' prefill
// and bf16 training; D 64 the MoE (granite-moe), the enc-dec family's
// encoder, decoder and cross-attention (Sq 1 too) and zamba2's shared
// block.  f32 q, an f32 cache, or any other D (the f32-compute paths: the
// LM sweep's QAT and probes, the f32 card-against-CPU checks; bf16 q
// against an f32 cache; the smoke models' D 16 and 32) runs on the CUDA
// cores (`flash_cc<QT, KT, DP>`, below), in f32: TF32 would lose the f32
// parity those checks hold.
//
// The CUDA-core route replaces the CUDA-core half of the Pallas `_kernel`
// (src/repro/kernels/flash_attn/flash_attn.py:55, pallas_call :174).  What
// bounds it: at the LM sweep's shapes (13 probes x batch 8, Sq = Skv 32,
// causal, f32) the bytes of q, k, v and o, 0.041 ms at granite-8b's heads
// against 0.013 ms of f32 FMAs at 67 TFLOP/s, so the CUDA cores are the
// right unit and the design moves bytes and keeps the FMA pipes fed:
//  * register tiles: thread (rg, kg) of 128 owns 4 rows x 4 keys of S and
//    4 rows x DP / 8 dims of O; Q, K, V and P are read from shared memory
//    as 16-byte (or, for a bf16 cache, 8-byte) quads, 8 FMAs per quad of S,
//    in layouts without bank conflicts (Q's quads XOR-swizzled by row, K
//    rows padded by 16 bytes, P rows of 40 floats);
//  * 32-key tiles: the sweep's causal query tiles see 16 or 32 keys, and
//    P V stops at the tile's last live quad of keys;
//  * K and V in buffers of their own, 16-byte cp.async, the next K tile in
//    flight through the softmax and P V, the next V tile through the next
//    S (a ring of two stages); the first tile is requested before kv_len
//    arrives.  A bf16 cache stays bf16 in shared memory (half the bytes)
//    and is widened exactly at its read; rows that are not whole 16-byte
//    chunks (D 20, odd D) load element by element;
//  * shared memory: Q (64 x DP f32, scaled once), K, V and P: 74.5 KB at D
//    128 with an f32 cache (58.5 KB bf16), 42.5 KB at D 64, 26.5 KB at D
//    <= 32 (DP is D rounded up to 32, 64 or 128, zeros past D).  At D 128
//    168 registers a thread and 3 blocks an SM; at D <= 64 128 registers
//    and 4 blocks (ptxas's reports: build/kernels/*.log).
// Numerics of the CUDA-core route: each score a sum over d in
// ascending order from q already scaled (`__fmul_rn(q, scale)`); masked
// scores out of the max and p = 0; `expf`; a row's sum as the butterfly
// of a warp's shuffle tree over its 32 keys; each P V sum over keys in
// ascending order, then acc * alpha + pv in one FMA; acc / max(l, 1e-30),
// so a row with no live key is 0.  On one key tile (Skv <= 32) the outputs
// equal the plain version's on the card bit for bit (chip_smoke's
// phase_flash prints the differences).
//
// The tensor-core route: one warpgroup of 4 warps, each owning 16 of the
// 64 rows.  S = Q K^T is wgmma.m64n64k16 over D / 16 k-steps and O += P V
// is wgmma.m64n<D>k16, f32 accumulation, A from registers (Q's fragments,
// loaded once straight from global memory; then P, straight from the S
// accumulators, which have the A-fragment layout), B from shared memory
// through matrix descriptors (K K-major; V MN-major, transposed).  wgmma
// rather than mma.sync: at 16 rows a warp, mma.sync reads each K and V
// fragment from shared memory for one 16-row product, which kept an
// mma.sync version of this kernel waiting on shared memory; wgmma reads B
// once for all 64 rows and issues at twice the rate (the two versions'
// times: PERF.md, Findings).  K/V tiles stay bf16 in shared memory in the
// 128-byte swizzled layout the descriptors address (64 keys of D bf16:
// one swizzle atom a row at D 64, 8 KB a tile; two at D 128, 16 KB),
// loaded with cp.async into a ring of two stages: tile t + 1 is in flight
// while tile t is multiplied, and the first tile is requested before
// kv_len arrives.  Scores, running max and sum and the output accumulator
// live in registers; K and V pass through shared memory, and O on its way
// out (16-byte stores, staged in the first K stage).  With Q kept out of
// shared memory a block needs 65 KB at D 128 (three blocks share an SM
// where the grid has them) and 33 KB at D 64 (four).
// The softmax keeps its running max in log2 units and makes each
// probability one FFMA and one MUFU exp2, and the row-to-(position, head)
// map uses a multiply, not a division: at the main path's short shapes a
// block's time is mostly such instruction latencies (PERF.md, Findings).
// Numerics: the scale is applied to the f32 scores after the product
// (folded with log2(e) into an exp2, one rounding); masked probabilities
// are zeroed explicitly; P enters the second product as P_hi + P_lo, two
// bf16 wgmmas (one bf16 P changed 27-40% of the bf16 outputs against the
// f32 plain version, the split 0.14-0.35%); the output is
// acc * (1 / max(l, 1e-30)), within an f32 ulp of the reference's
// quotient, so a row with no live key is 0.
// Grid (both routes; kv_split 1 on the CUDA cores): (query tiles *
// kv_split, Hkv, B), the last query tile first: under
// a causal mask it has the most keys, so the longest blocks start in the
// first wave and the short ones fill the last.  When the query tiles alone
// give fewer blocks than SMs (the train microbatch, B 1, Sq 128: 64
// tiles; a cross-attention decode row, B 4 x 16 heads over 2048 frames:
// 64 tiles of 32 key tiles each), the wrapper's `flash_plan` sets kv_split
// to 2, 4 or 8: the blocks of a thread block cluster take interleaved key
// tiles of one query tile (part p: tiles p, p + kv_split, ...) and merge
// their (m, l, O) fragments through distributed shared memory in a fixed
// tree (rank r + step into rank r at step 1, 2, 4), so two launches on
// the same inputs are bit-equal.  The cross decode then runs 512 blocks
// of 4 key tiles.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;   // a masked score
constexpr int MAX_D = 128;          // head dim
constexpr int MAX_G = 64;           // query heads a KV head

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; pred false fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

namespace tc {

constexpr int BK = 64;                    // keys per tile
constexpr int ROWS = 64;                  // query rows per block
constexpr int NT = 128;                   // one warpgroup
constexpr int MAX_SPLIT = 8;              // the portable cluster size
// bytes of a K or V tile at head dim HD (64 keys of HD bf16: one 128-byte
// swizzle atom a row at HD 64, two at HD 128)
template <int HD> __host__ __device__ constexpr uint32_t tile_bytes() {
  return BK * HD * 2;
}
// shared memory: two K and two V stages (the first K stage stages O on
// its way out) + 1 KB for alignment; and (key split) the receive area of
// the merge, one (m, l, O) payload of [HD / 8 + 1][NT] float4s
template <int HD> __host__ __device__ constexpr size_t smem_bytes() {
  return 4 * tile_bytes<HD>() + 1024;
}
template <int HD> __host__ __device__ constexpr size_t recv_bytes() {
  return (size_t)(HD / 8 + 1) * NT * 16;
}

// 2^x, flushing results below 2^-126 to 0 (one MUFU op: exp2f adds a
// rescaling for subnormal results, which a probability never needs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// the part of (lo, hi) that packing to bf16 rounded away, packed to bf16
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi,
                                                   uint32_t packed) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&packed);
  return pack_bf16(lo - __low2float(p), hi - __high2float(p));
}

// byte offset of 16-byte chunk c of row r of the O staging tile (rows of
// HD bf16, chunks XOR-swizzled by row against bank conflicts)
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * HD * 2 + ((c ^ (r & 7)) << 4));
}

// K and V tiles in the 128-byte swizzled layout the wgmma descriptors read:
// HD / 64 column blocks of BK rows of 128 B, 16-byte chunk c of row r at
// chunk (c & 7) ^ (r & 7) of its row (tiles 1024-byte aligned)
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return (uint32_t)((c >> 3) * (BK * 128) + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

// shared-memory matrix descriptor: start, leading and stride byte
// offsets, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64 f32 over the warpgroup) (+)= a (this warp's 16 x 16 bf16 A
// fragment, as for mma.sync) x B (descriptor; K-major, or with TRANS
// MN-major: transposed)
template <int TRANS>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t* a,
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(desc),
        "n"(TRANS));
}
// d (64 x 128 f32) += a x B (descriptor, MN-major: transposed)
__device__ __forceinline__ void wgmma_n128t(float (&d)[16][4],
                                            const uint32_t* a, uint64_t desc,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(desc));
}
// O += P V for one 16-key k-step: n64 at HD 64, n128 at HD 128
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 8][4],
                                         const uint32_t* a, uint64_t desc) {
  if constexpr (HD == 64)
    wgmma_n64<1>(d, a, desc, 1);
  else
    wgmma_n128t(d, a, desc, 1);
}

// blocks resident on an SM at each head dim (registers and shared memory
// as ptxas reports them: PERF.md, Findings)
template <int HD> __host__ __device__ constexpr int min_blocks() {
  return HD == 128 ? 3 : 4;
}

template <int HD, int NSPLIT>
__global__ void __launch_bounds__(NT, min_blocks<HD>())
flash_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, const int* __restrict__ kv_len,
         const int* __restrict__ q_offset, bf16* __restrict__ o, int Sq,
         int Skv, int Hq, int Hkv, int bq, int causal, float scale) {
  constexpr int CH = HD / 8, KSTEPS = HD / 16, NB = BK / 8, ND = HD / 8;
  constexpr uint32_t TILE = tile_bytes<HD>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t base = smem_u32(tc_smem);
  const uint32_t sK = (base + 1023) & ~1023u;   // descriptors: 1 KB atoms
  unsigned char* gK = tc_smem + (sK - base);    // K stages 0, 1, V 0, 1
  float* recv = reinterpret_cast<float*>(gK + 4 * TILE);
  if constexpr (NSPLIT > 1)    // "started" phase: waited on before writing
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int qt = gridDim.x / NSPLIT - 1 - blockIdx.x / NSPLIT;
  const int part = blockIdx.x % NSPLIT;         // rank in the cluster
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = Hq / Hkv, R = bq * g, q0 = qt * bq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // r / g for a row r < 64 as (r * ginv) >> 16, exact there for g <= 64
  // (a runtime division costs tens of instructions a use)
  const int ginv = (65536 + g - 1) / g;

  const size_t kv_row = (size_t)Hkv * HD;
  const bf16* kb = k + (size_t)b * Skv * kv_row + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * Skv * kv_row + (size_t)kvh * HD;
  // keys [t * BK, t * BK + BK) below n_live, zeros past them
  auto load_tile = [&](int t, int stage, int n_live) {
    const int k0 = t * BK;
    for (int e = tid; e < BK * CH; e += NT) {
      const int j = e / CH, c = e % CH;
      const bool ok = k0 + j < n_live;
      const size_t off = ok ? (size_t)(k0 + j) * kv_row + c * 8 : 0;
      cp_async16(sK + stage * TILE + swz128(j, c), kb + off, ok);
      cp_async16(sK + (2 + stage) * TILE + swz128(j, c), vb + off, ok);
    }
  };
  // this block's first tile is requested before kv_len arrives (its rows
  // lie in the cache either way; V rows past the live keys are zeroed)
  load_tile(part, 0, Skv);
  cp_async_commit();
  // Q's A fragments straight from global memory into registers (what
  // ldmatrix of a row-major tile gives): rows row0 + gid and + 8 of the
  // tile, columns 16 ks + 2 t4 (+ 8), zeros past the live rows
  const int gid = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16;
  uint32_t qf[KSTEPS][4];
  {
    const uint32_t* qrow[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int r = row0 + gid + 8 * i2, rq = (r * ginv) >> 16;
      const int qpos = q0 + rq, h = kvh * g + r - rq * g;
      qrow[i2] = r < R && qpos < Sq
          ? reinterpret_cast<const uint32_t*>(
                q + (((size_t)b * Sq + qpos) * Hq + h) * HD) + t4
          : nullptr;
    }
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qf[ks][j] = qrow[j & 1] ? __ldg(qrow[j & 1] + ks * 8 + (j >> 1) * 4)
                                : 0u;
  }
  const int len = min(max(kv_len[b], 0), Skv);
  const int q_off = q_offset[0];
  // keys past the valid prefix, or (causal) past this tile's last query
  // position, are dead for every row of the block
  int n_pos = len;
  if (causal) n_pos = min(n_pos, max(q_off + min(q0 + bq, Sq), 0));
  const int n_tiles = (n_pos + BK - 1) / BK;

  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  // absolute query positions of this thread's two rows (gid, gid + 8)
  const int qp[2] = {q_off + q0 + (((row0 + gid) * ginv) >> 16),
                     q_off + q0 + (((row0 + gid + 8) * ginv) >> 16)};
  float oacc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.0f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};

  // this block's tiles: part, part + NSPLIT, ...
  for (int t = part, i = 0; t < n_tiles; t += NSPLIT, ++i) {
    const int st = i & 1;
    if (t + NSPLIT < n_tiles) {
      load_tile(t + NSPLIT, st ^ 1, n_pos);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int k0 = t * BK;
    if (i == 0 && n_pos < k0 + BK) {
      // dead V rows of the first tile: 0.  Each thread clears the chunks
      // it copied itself, which its wait above has seen land.
      for (int e = tid; e < BK * CH; e += NT)
        if (k0 + e / CH >= n_pos)
          *reinterpret_cast<uint4*>(gK + 2 * TILE + swz128(e / CH, e % CH)) =
              make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();            // visible to the tensor cores' reads
    __syncthreads();
    const uint32_t sk = sK + st * TILE, sv = sK + (2 + st) * TILE;

    // S = Q K^T: the warpgroup's 64 rows against the tile's 64 keys
    float s[NB][4];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      wgmma_n64<0>(s, qf[ks],
                   gmma_desc(sk + (ks >> 2) * (BK * 128) + (ks & 3) * 32, 16,
                             1024),
                   ks > 0);
    wg_commit();
    wg_wait0();

    // online softmax on the accumulators: element (nb, 2i + j) is row
    // gid + 8i of this warp's 16, key k0 + nb*8 + 2*t4 + j.  In a tile
    // that reaches past kv_len or the diagonal, row i's live keys are
    // those with nb*8 + j < lim[i]; elsewhere every key is live, and the
    // unmasked instance of `softmax` runs.  The running max is kept in
    // log2 units (scale > 0, so the max of the raw scores, scaled, is the
    // max of the scaled scores) and each probability is one FFMA and one
    // exp2.
    const bool edge = k0 + BK > len || (causal && k0 + BK - 1 > q_off + q0);
    int lim[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2)
      lim[i2] = (causal ? min(len, qp[i2] + 1) : len) - k0 - 2 * t4;
    float alpha[2], sum[2] = {0.0f, 0.0f};
    auto softmax = [&](auto masked) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i2 = e >> 1;
          if (!decltype(masked)::value || nb * 8 + (e & 1) < lim[i2])
            mx[i2] = fmaxf(mx[i2], s[nb][e]);
        }
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
        mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
        const float m_new = fmaxf(m_r[i2], mx[i2] * sl2);
        alpha[i2] = ex2(m_r[i2] - m_new);
        m_r[i2] = m_new;
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i2 = e >> 1;
          // a row with no live key yet has m = NEG_INF * sl2: its masked
          // entries would give exp2(0) = 1, so they are zeroed explicitly
          float p = ex2(fmaf(s[nb][e], sl2, -m_r[i2]));
          if (decltype(masked)::value && nb * 8 + (e & 1) >= lim[i2])
            p = 0.0f;
          s[nb][e] = p;
          sum[i2] += p;
        }
      }
    };
    if (edge)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) l_r[i2] = l_r[i2] * alpha[i2] + sum[i2];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      oacc[nd][0] *= alpha[0];
      oacc[nd][1] *= alpha[0];
      oacc[nd][2] *= alpha[1];
      oacc[nd][3] *= alpha[1];
    }

    // O += P V: the S accumulators of key blocks 2kk, 2kk + 1 are the A
    // fragment of k-step kk
    uint32_t a[BK / 16][4], a_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // j: (key block 2kk + j / 2, row half j % 2)
        const int nb = 2 * kk + (j >> 1), e = 2 * (j & 1);
        a[kk][j] = pack_bf16(s[nb][e], s[nb][e + 1]);
        a_lo[kk][j] = pack_bf16_rest(s[nb][e], s[nb][e + 1], a[kk][j]);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = gmma_desc(sv + kk * 16 * 128, BK * 128, 1024);
      wgmma_pv<HD>(oacc, a[kk], dv);
      wgmma_pv<HD>(oacc, a_lo[kk], dv);
    }
    wg_commit();
    wg_wait0();
    // stage st is reloaded by the next iteration, if it loads
    if (t + 2 * NSPLIT < n_tiles) __syncthreads();
  }
  cp_async_wait<0>();

  if constexpr (NSPLIT > 1) {
    // the cluster's blocks merge their (m, l, O) fragments, thread for
    // thread, in a fixed tree: at step 1, 2, 4, the block of rank
    // part = r + step (r a multiple of 2 step) hands its fragments to
    // rank r, which merges them into its own.  Every block takes part in
    // every barrier; rank 0 writes the output.
    namespace cg = cooperative_groups;
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
    for (int step = 1; step < NSPLIT; step <<= 1) {
      const int low = part & (2 * step - 1);
      if (low == step) {
        float4* rc4 = reinterpret_cast<float4*>(
            cg::this_cluster().map_shared_rank(recv, part - step));
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
          rc4[nd * NT + tid] =
              make_float4(oacc[nd][0], oacc[nd][1], oacc[nd][2], oacc[nd][3]);
        rc4[ND * NT + tid] = make_float4(m_r[0], m_r[1], l_r[0], l_r[1]);
      }
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      if (low == 0) {
        const float4* rv4 = reinterpret_cast<const float4*>(recv);
        const float4 ml = rv4[ND * NT + tid];
        const float m1[2] = {ml.x, ml.y}, l1[2] = {ml.z, ml.w};
        float w0[2], w1[2];
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const float mm = fmaxf(m_r[i2], m1[i2]);
          w0[i2] = ex2(m_r[i2] - mm);
          w1[i2] = ex2(m1[i2] - mm);
          m_r[i2] = mm;
          l_r[i2] = w0[i2] * l_r[i2] + w1[i2] * l1[i2];
        }
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const float4 x = rv4[nd * NT + tid];
          oacc[nd][0] = w0[0] * oacc[nd][0] + w1[0] * x.x;
          oacc[nd][1] = w0[0] * oacc[nd][1] + w1[0] * x.y;
          oacc[nd][2] = w0[1] * oacc[nd][2] + w1[1] * x.z;
          oacc[nd][3] = w0[1] * oacc[nd][3] + w1[1] * x.w;
        }
      }
      if (2 * step < NSPLIT) {
        // the receivers have read their area before the next step writes
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
        asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      }
    }
    if (part != 0) return;
  }

  // O / max(l, 1e-30) in bf16, staged through the first K stage's shared
  // memory so each row leaves as 16-byte stores
  __syncthreads();                 // every copy into it has landed
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    float l = l_r[i2];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = __frcp_rn(fmaxf(l, 1e-30f));
    const int r = row0 + gid + 8 * i2;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(gK + swz<HD>(r, nd) + 4 * t4) =
          pack_bf16(oacc[nd][2 * i2] * inv, oacc[nd][2 * i2 + 1] * inv);
  }
  __syncthreads();
  for (int r = tid / CH; r < ROWS; r += NT / CH) {
    const int rq = (r * ginv) >> 16;
    const int qpos = q0 + rq, h = kvh * g + r - rq * g;
    if (r < R && qpos < Sq)
      *reinterpret_cast<uint4*>(o + (((size_t)b * Sq + qpos) * Hq + h) * HD +
                                (tid % CH) * 8) =
          *reinterpret_cast<const uint4*>(gK + swz<HD>(r, tid % CH));
  }
}

template <int HD, int NSPLIT>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           const int* q_offset, void* o, int B, int Sq, int Skv, int Hq,
           int Hkv, int bq, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem =
      smem_bytes<HD>() + (NSPLIT > 1 ? recv_bytes<HD>() : 0);
  auto kern = flash_wg<HD, NSPLIT>;
  static uint64_t attr_set = 0;           // devices whose limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(attr_set >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set |= uint64_t{1} << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Sq + bq - 1) / bq * NSPLIT, Hkv, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = NSPLIT;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = NSPLIT > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kern, (const bf16*)q, (const bf16*)k,
                                 (const bf16*)v, kv_len, q_offset, (bf16*)o,
                                 Sq, Skv, Hq, Hkv, bq, causal, scale);
}

template <int HD>
int launch_split(int kv_split, const void* q, const void* k, const void* v,
                 const int* kv_len, const int* q_offset, void* o, int B,
                 int Sq, int Skv, int Hq, int Hkv, int bq, int causal,
                 float scale, cudaStream_t s) {
  switch (kv_split) {
    case 1: return launch<HD, 1>(q, k, v, kv_len, q_offset, o, B, Sq, Skv, Hq, Hkv, bq, causal, scale, s);
    case 2: return launch<HD, 2>(q, k, v, kv_len, q_offset, o, B, Sq, Skv, Hq, Hkv, bq, causal, scale, s);
    case 4: return launch<HD, 4>(q, k, v, kv_len, q_offset, o, B, Sq, Skv, Hq, Hkv, bq, causal, scale, s);
    case 8: return launch<HD, 8>(q, k, v, kv_len, q_offset, o, B, Sq, Skv, Hq, Hkv, bq, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

namespace cc {

constexpr int NT = 128;             // four warps
constexpr int ROWS = 64;            // query rows a block
constexpr int BN = 32;              // keys a tile
constexpr int PSTRIDE = BN + 8;     // floats a row of P in shared memory

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive elements as f32: one 16-byte load of f32, one 8-byte
// load of bf16 widened exactly (a bf16 is the top half of its f32)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Shared memory of a block (bytes): Q (ROWS x DP f32, pre-scaled; the
// 16-byte quads of row r XOR-swizzled by r & 7), K (BN rows of DP
// elements in the cache's type, padded by 16 bytes), V (BN x DP, the
// cache's type) and P (ROWS x PSTRIDE f32).  DP is D rounded up to 32, 64
// or 128; the dims past D are zeros in Q and K.
template <typename KT, int DP> struct Layout {
  static constexpr int KROW = DP + 16 / (int)sizeof(KT);
  static constexpr size_t Q = (size_t)ROWS * DP * 4;
  static constexpr size_t K = (size_t)BN * KROW * sizeof(KT);
  static constexpr size_t V = (size_t)BN * DP * sizeof(KT);
  static constexpr size_t P = (size_t)ROWS * PSTRIDE * 4;
  static constexpr size_t bytes = Q + K + V + P;
};

// Keys [k0, k0 + BN) of one (batch, KV head) slab (rows `row` elements
// apart) into shared-memory rows `stride` elements apart, keys at or past
// n_live as zeros: 16-byte cp.async when a row is whole 16-byte chunks,
// else element by element.
template <typename KT>
__device__ __forceinline__ void load_tile(KT* dst, int stride,
                                          const KT* src, size_t row, int k0,
                                          int n_live, int D, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(KT);
    const int ch = D / E;
    for (int e = threadIdx.x; e < BN * ch; e += NT) {
      const int j = e / ch, c = e - j * ch;
      const bool ok = k0 + j < n_live;
      cp_async16(smem_u32(dst + j * stride + c * E),
                 src + (ok ? (size_t)(k0 + j) * row : 0) + c * E, ok);
    }
  } else {
    for (int e = threadIdx.x; e < BN * D; e += NT) {
      const int j = e / D, d = e - j * D;
      dst[j * stride + d] = k0 + j < n_live
          ? src[(size_t)(k0 + j) * row + d] : from_f32<KT>(0.0f);
    }
  }
}
// zeros over rows [from, BN) of a tile, each thread over the elements it
// loaded itself (its own copies have landed once it has waited for them)
template <typename KT>
__device__ __forceinline__ void zero_rows(KT* dst, int stride, int from,
                                          int D, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(KT);
    const int ch = D / E;
    for (int e = threadIdx.x; e < BN * ch; e += NT) {
      const int j = e / ch, c = e - j * ch;
      if (j >= from)
        *reinterpret_cast<uint4*>(dst + j * stride + c * E) =
            make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = threadIdx.x; e < BN * D; e += NT) {
      const int j = e / D;
      if (j >= from) dst[j * stride + e - j * D] = from_f32<KT>(0.0f);
    }
  }
}

// Thread (rg, kg) of the block, rg = warp * 4 + lane / 8 and kg = lane %
// 8, owns rows rg + 16 i (i < 4) of the 64: their scores against keys
// kg + 8 j (j < 4) of a tile, and their outputs at the dim quads kg + 8 c
// (c < DP / 32).  A row's eight threads are eight lanes of one warp, so
// its max and sum are three shuffles.
template <typename QT, typename KT, int DP>
__global__ void __launch_bounds__(NT, DP == 128 ? 3 : 4)
flash_cc(const QT* __restrict__ q, const KT* __restrict__ k,
         const KT* __restrict__ v, const int* __restrict__ kv_len,
         const int* __restrict__ q_offset, QT* __restrict__ o, int Sq,
         int Skv, int Hq, int Hkv, int D, int bq, int causal, float scale) {
  using L = Layout<KT, DP>;
  constexpr int QQ = DP / 4;          // quads a Q row
  constexpr int NQ = DP / 32;         // output quads a thread
  constexpr int QP = NQ < 2 ? NQ : 2; // output quads a pass over P V
  extern __shared__ __align__(16) unsigned char cc_smem[];
  float* Qs = reinterpret_cast<float*>(cc_smem);
  KT* Ks = reinterpret_cast<KT*>(cc_smem + L::Q);
  KT* Vs = reinterpret_cast<KT*>(cc_smem + L::Q + L::K);
  float* Ps = reinterpret_cast<float*>(cc_smem + L::Q + L::K + L::V);

  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest tiles first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = Hq / Hkv, R = bq * g, q0 = qt * bq;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = (tid >> 5) * 4 + (lane >> 3), kg = lane & 7;
  const int ginv = (65536 + g - 1) / g;  // r / g = (r * ginv) >> 16, r < 64
  const bool kvec = D * (int)sizeof(KT) % 16 == 0, qvec = D % 4 == 0;

  const size_t kv_row = (size_t)Hkv * D;
  const KT* kb = k + (size_t)b * Skv * kv_row + (size_t)kvh * D;
  const KT* vb = v + (size_t)b * Skv * kv_row + (size_t)kvh * D;
  // the first tile is requested before kv_len arrives (its rows lie in
  // the cache either way; V rows past the live keys are zeroed below)
  load_tile(Ks, L::KROW, kb, kv_row, 0, Skv, D, kvec);
  cp_async_commit();
  load_tile(Vs, DP, vb, kv_row, 0, Skv, D, kvec);
  cp_async_commit();
  const int len = min(max(kv_len[b], 0), Skv);
  const int q_off = q_offset[0];
  for (int e = tid; e < BN * (DP - D); e += NT) {  // K's dims past D
    const int j = e / (DP - D);
    Ks[j * L::KROW + D + e - j * (DP - D)] = from_f32<KT>(0.0f);
  }
  // Q, scaled (one rounding, as the plain version's q * scale), zeros
  // past D and in rows outside the tile
  for (int e = tid; e < ROWS * QQ; e += NT) {
    const int r = e / QQ, qd = e - r * QQ;
    const int rq = (r * ginv) >> 16, qpos = q0 + rq;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < R && qpos < Sq) {
      const QT* src = q + (((size_t)b * Sq + qpos) * Hq + kvh * g + r -
                           rq * g) * D + 4 * qd;
      if (qvec) {
        if (4 * qd < D) x = ld4(src);
      } else {
        float t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          t[i] = 4 * qd + i < D ? to_f32(src[i]) : 0.0f;
        x = make_float4(t[0], t[1], t[2], t[3]);
      }
      x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                      __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
    }
    reinterpret_cast<float4*>(Qs)[r * QQ + (qd ^ (r & 7))] = x;
  }

  // keys past the valid prefix, or (causal) past this tile's last query
  // position, are dead for every row of the block
  int n_pos = len;
  if (causal) n_pos = min(n_pos, max(q_off + min(q0 + bq, Sq), 0));
  const int n_tiles = (n_pos + BN - 1) / BN;
  // the last live key of each of this thread's rows
  int last[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    last[i] = causal ? min(len - 1, q_off + q0 + ((r * ginv) >> 16))
                     : len - 1;
  }
  float acc[4][NQ][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NQ; ++c)
      acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.0f;
  }
  const float4* Q4 = reinterpret_cast<const float4*>(Qs);
  const int xr = rg & 7;                // the Q swizzle of this thread's rows

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    cp_async_wait<1>();                 // K of tile t
    __syncthreads();
    // S = (q * scale) K^T: each score a sum over d in ascending order
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll 4
    for (int qd = 0; qd < QQ; ++qd) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Q4[(rg + 16 * i) * QQ + (qd ^ xr)];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(Ks + (kg + 8 * j) * L::KROW + 4 * qd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();                    // every read of K is done
    if (t + 1 < n_tiles)
      load_tile(Ks, L::KROW, kb, kv_row, k0 + BN, n_pos, D, kvec);
    cp_async_commit();

    // online softmax: masked scores leave the max out and give p = 0
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + kg + 8 * j <= last[i]) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = k0 + kg + 8 * j <= last[i] ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(rg + 16 * i) * PSTRIDE + kg + 8 * j] = p[j];
      }
      // the row's sum as a butterfly over its 32 keys (key pairs 16, 8,
      // 4, 2, 1 apart): the order of a warp's shuffle tree over a 32-key
      // row
      float sum = (p[0] + p[2]) + (p[1] + p[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l[i] = fmaf(l[i], alpha[i], sum);
      m[i] = m_new;
    }
    cp_async_wait<1>();                 // V of tile t
    if (t == 0 && n_pos < BN) zero_rows(Vs, DP, n_pos, D, kvec);
    __syncthreads();

    // acc = acc * alpha + P V: each sum over the live key quads in
    // ascending order (keys past the live ones have p = 0 and V = 0)
    const int kq = (min(BN, n_pos - k0) + 3) >> 2;
#pragma unroll
    for (int c0 = 0; c0 < NQ; c0 += QP) {
      float pv[4][QP][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < QP; ++c)
          pv[i][c][0] = pv[i][c][1] = pv[i][c][2] = pv[i][c][3] = 0.0f;
      for (int jq = 0; jq < kq; ++jq) {
        float4 p4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p4[i] = ld4(Ps + (rg + 16 * i) * PSTRIDE + 4 * jq);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float4 vv[QP];
#pragma unroll
          for (int c = 0; c < QP; ++c)
            vv[c] = ld4(Vs + (4 * jq + jj) * DP + 4 * (kg + 8 * (c0 + c)));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = comp(p4[i], jj);
#pragma unroll
            for (int c = 0; c < QP; ++c) {
              pv[i][c][0] = fmaf(p, vv[c].x, pv[i][c][0]);
              pv[i][c][1] = fmaf(p, vv[c].y, pv[i][c][1]);
              pv[i][c][2] = fmaf(p, vv[c].z, pv[i][c][2]);
              pv[i][c][3] = fmaf(p, vv[c].w, pv[i][c][3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < QP; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c0 + c][e] = fmaf(acc[i][c0 + c][e], alpha[i], pv[i][c][e]);
    }
    __syncthreads();                    // every read of V and P is done
    if (t + 1 < n_tiles)
      load_tile(Vs, DP, vb, kv_row, k0 + BN, n_pos, D, kvec);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // O = acc / max(l, 1e-30): a row with no live key is 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i, rq = (r * ginv) >> 16, qpos = q0 + rq;
    if (r >= R || qpos >= Sq) continue;
    QT* dst = o + (((size_t)b * Sq + qpos) * Hq + kvh * g + r - rq * g) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      const int d0 = 4 * (kg + 8 * c);
      const float4 x = make_float4(acc[i][c][0] / den, acc[i][c][1] / den,
                                   acc[i][c][2] / den, acc[i][c][3] / den);
      if (qvec) {
        if (d0 < D) st4(dst + d0, x);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d0 + e < D) dst[d0 + e] = from_f32<QT>(comp(x, e));
      }
    }
  }
}

template <typename QT, typename KT, int DP>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           const int* q_offset, void* o, int B, int Sq, int Skv, int Hq,
           int Hkv, int D, int bq, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<KT, DP>::bytes;
  auto kern = flash_cc<QT, KT, DP>;
  static uint64_t attr_set = 0;           // devices whose limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(attr_set >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set |= uint64_t{1} << dev;
  }
  dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  kern<<<grid, NT, smem, stream>>>((const QT*)q, (const KT*)k, (const KT*)v,
                                   kv_len, q_offset, (QT*)o, Sq, Skv, Hq, Hkv,
                                   D, bq, causal, scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int launch_d(const void* q, const void* k, const void* v, const int* kv_len,
             const int* q_offset, void* o, int B, int Sq, int Skv, int Hq,
             int Hkv, int D, int bq, int causal, float scale,
             cudaStream_t s) {
  if (D <= 32)
    return launch<QT, KT, 32>(q, k, v, kv_len, q_offset, o, B, Sq, Skv, Hq, Hkv, D, bq, causal, scale, s);
  if (D <= 64)
    return launch<QT, KT, 64>(q, k, v, kv_len, q_offset, o, B, Sq, Skv, Hq, Hkv, D, bq, causal, scale, s);
  return launch<QT, KT, 128>(q, k, v, kv_len, q_offset, o, B, Sq, Skv, Hq, Hkv, D, bq, causal, scale, s);
}

}  // namespace cc

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o like q, all contiguous and
// 16-byte aligned; q_bf16 / kv_bf16 select bf16 (1) or f32 (0) for q/o and
// for k/v.  kv_len (B,) and q_offset (1,) are int32 in device memory.
// Needs D <= 128 and g = Hq / Hkv <= 64.  kv_split (1, 2, 4 or 8; more
// than 1 on the tensor-core path only: bf16 q and k/v at D 64 or 128;
// other cases take the CUDA-core path) is the number of blocks sharing a
// query tile's key tiles.  Returns the launch's cudaError_t.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 const void* kv_len, const void* q_offset,
                                 void* o, int B, int Sq, int Skv, int Hq,
                                 int Hkv, int D, int causal, float scale,
                                 int q_bf16, int kv_bf16, int kv_split,
                                 void* stream) {
  const bool tc_path = q_bf16 && kv_bf16 && (D == 64 || D == 128);
  const bool split_ok = kv_split == 1 || kv_split == 2 || kv_split == 4 ||
                        kv_split == tc::MAX_SPLIT;
  if (D < 1 || D > MAX_D || Hq % Hkv != 0 || Hq / Hkv > MAX_G ||
      !split_ok || (kv_split > 1 && !tc_path))
    return (int)cudaErrorInvalidValue;
  const int bq = tc::ROWS / (Hq / Hkv);
  auto lens = (const int*)kv_len;
  auto off = (const int*)q_offset;
  auto s = (cudaStream_t)stream;
  if (tc_path)
    return D == 64
        ? tc::launch_split<64>(kv_split, q, k, v, lens, off, o, B, Sq, Skv, Hq, Hkv, bq, causal, scale, s)
        : tc::launch_split<128>(kv_split, q, k, v, lens, off, o, B, Sq, Skv, Hq, Hkv, bq, causal, scale, s);
  if (q_bf16 && kv_bf16)
    return cc::launch_d<bf16, bf16>(q, k, v, lens, off, o, B, Sq, Skv, Hq, Hkv, D, bq, causal, scale, s);
  if (q_bf16)
    return cc::launch_d<bf16, float>(q, k, v, lens, off, o, B, Sq, Skv, Hq, Hkv, D, bq, causal, scale, s);
  if (kv_bf16)
    return cc::launch_d<float, bf16>(q, k, v, lens, off, o, B, Sq, Skv, Hq, Hkv, D, bq, causal, scale, s);
  return cc::launch_d<float, float>(q, k, v, lens, off, o, B, Sq, Skv, Hq, Hkv, D, bq, causal, scale, s);
}
