// Fused GQA decode attention (flash-decode of one query row, split along
// the cache) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/decode_gqa/decode_gqa.py (pallas_call in
// `_decode_gqa_call`): q (B, Hq, D) against the KV cache k/v (B, S, Hkv, D)
// with a runtime fill level length (B,), clamped to S; positions at or past
// it are masked and a row with length 0 returns 0.
//
// What bounds it on the H100: bytes.  Each step reads the live prefix of
// the cache once (2*B*length*Hkv*D elements) for about 4*B*Hq*length*D
// operations: at g = 4 about 4 operations per byte, far below the card's
// balance, so CUDA-core f32 FMAs suffice and the design is about bytes in
// flight.  The TPU kernel walked the cache in sequential grid steps; one
// block per (batch, kv head) would put B * Hkv = 32 blocks on 132 SMs.
//
// Design: split-cache flash-decode in one launch.  Grid (Hkv * row
// groups, B, n_split): block z owns the keys [z * chunk, (z + 1) * chunk)
// of one (batch, kv head) and up to GT query heads of its group (all g of
// them for g <= 8), which stay in registers and share every loaded key
// row.  Its half-warps (`Shape`) share the keys of every 32-key step; a
// lane holds 8 of the D dims, so one 128-dim bf16 row is 16 lanes x
// 16-byte loads, and the next step's rows are in flight while this step's
// are used (two register stages).  The first step's rows are requested before
// length arrives (they lie inside the cache either way; rows at or past
// length are zeroed in registers once it is known).  Each half-warp keeps
// its own running (m, l, acc) in f32 registers; the two halves of a warp
// merge by shuffles and the block's warps in shared memory, giving one
// unnormalised partial (acc, m, l) per query head, which also goes to the
// workspace (B, Hq, n_split, D + 2), f32.  In each merge a thread takes two
// adjacent dims of one row and computes that row's weights itself, so a
// merge costs no barrier beyond the one that publishes its inputs: at
// the serve decode shape the time after the last block's loads land is
// this merge chain (PERF.md, Findings).  A block whose chunk starts at or
// past min(length, S) contributes an empty partial (m = NEG_INF, l = 0,
// acc = 0).  The partials merge by the log-sum-exp rule,
//   o = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30),
// so a row with length 0 (every partial empty) is exactly 0:
//   * n_split <= 8 and chunks of at most 256 keys (short caches, where
//     latency decides): the group's
//     blocks form a thread block cluster; each writes its partial into
//     block 0's shared memory and arrives on the cluster barrier, and
//     block 0 merges them.  A last-block counter (below) cost about 1.5 us
//     more here in fences and L2 round trips.
//   * otherwise (long caches, where bytes decide): the last block of the
//     group to finish, found by an atomic counter, reads the partials back
//     from the workspace, merges them, and sets the counter back to 0.
// The wrapper plans (n_split, chunk) on the host from S, B and Hkv alone
// and allocates the workspace (torch.empty) and the counters (zeroed
// once, left zeroed by every call); length is only ever read on the
// device, so one plan serves the whole decode loop with no host sync.
// One template serves f32 and bf16 caches and queries.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int KEY_TILE = 32;        // keys per block per step
constexpr int MAX_D = 128;          // 16 lanes x 8 dims
constexpr int MAX_CLUSTER = 8;      // portable thread block cluster size

// A block's shape: half-warps of 16 lanes, each taking U keys of every
// step.  Short chunks (the cluster merge, latency-bound) run 128 threads
// with 4 keys a half-warp, so the block merge has 4 warps to weigh; long
// chunks (the counter merge, bytes-bound) run 256 threads with 2 keys a
// half-warp, twice the warps to hide each load's latency.  Each shape was
// the faster at its own kind of chunk (PERF.md, Findings).
template <bool CLUSTER>
struct Shape {
  static constexpr int NT = CLUSTER ? 128 : 256;   // threads
  static constexpr int HW = NT / 16;               // half-warps
  static constexpr int NWARP = NT / 32;            // warps
  static constexpr int U = KEY_TILE / HW;          // keys a half-warp a step
};
// splits the counter merge takes (its weights staged in the warps' area)
constexpr int MAX_SPLIT = Shape<false>::NWARP * MAX_D / 2;
constexpr int CLUSTER_CHUNK = 256;  // longest chunk merged in a cluster
constexpr float NEG_INF = -1e30f;

// e^x as one multiply and the hardware exp2 (2 ulp; results below 2^-126
// flush to 0, which no weight here needs: exp2f would add a rescaling)
__device__ __forceinline__ float exp_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y)
      : "f"(x * 1.4426950408889634f));
  return y;
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// two adjacent outputs as one store
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// 8 consecutive elements of a query or cache row, loaded as 16-byte
// vectors and read back as f32
template <typename T> struct Row8;
template <> struct Row8<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float operator[](int e) const {
    const uint32_t w = (&u.x)[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float operator[](int e) const {
    return e < 4 ? (&a.x)[e] : (&b.x)[e - 4];
  }
};

// Shared memory (dynamic, floats): the warps' states, then (cluster
// merge) the receive area of block 0: [MAX_CLUSTER][GT] m and l and
// [MAX_CLUSTER][GT][MAX_D] acc.
template <int GT, bool CLUSTER>
constexpr size_t smem_floats() {
  return (size_t)Shape<CLUSTER>::NWARP * GT * (2 + MAX_D) +
         (CLUSTER ? (size_t)MAX_CLUSTER * GT * (2 + MAX_D) : 0);
}

template <typename QT, typename KT, int GT, bool CLUSTER>
__global__ void __launch_bounds__(Shape<CLUSTER>::NT, 2)
decode_split(const QT* __restrict__ q, const KT* __restrict__ k,
             const KT* __restrict__ v, const int* __restrict__ length,
             float* __restrict__ ws, int* __restrict__ counters,
             QT* __restrict__ o, int S, int Hq, int Hkv, int D, int n_rg,
             int n_split, int chunk, float scale) {
  constexpr int NT = Shape<CLUSTER>::NT, HW = Shape<CLUSTER>::HW;
  constexpr int NWARP = Shape<CLUSTER>::NWARP, U = Shape<CLUSTER>::U;
  extern __shared__ float4 dsm4[];
  float* dsm = reinterpret_cast<float*>(dsm4);
  float* sm_m = dsm;                            // [NWARP][GT]
  float* sm_l = sm_m + NWARP * GT;              // [NWARP][GT]
  float* sm_acc = sm_l + NWARP * GT;            // [NWARP][GT][MAX_D]
  float* rc_m = sm_acc + NWARP * GT * MAX_D;    // [MAX_CLUSTER][GT]
  float* rc_l = rc_m + MAX_CLUSTER * GT;        // [MAX_CLUSTER][GT]
  float* rc_acc = rc_l + MAX_CLUSTER * GT;      // [MAX_CLUSTER][GT][MAX_D]
  __shared__ bool sm_last;
  if constexpr (CLUSTER)       // "started" phase: waited on before writing
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int kvh = blockIdx.x / n_rg, rg = blockIdx.x % n_rg;
  const int b = blockIdx.y, z = blockIdx.z;
  const int g = Hq / Hkv;
  const int h0 = kvh * g + rg * GT;             // first query head
  const int n_rows = min(GT, g - rg * GT);      // live rows of the block
  const int tid = threadIdx.x, warp = tid >> 5, hw = tid >> 4, ln = tid & 15;
  const int d0 = ln * 8;                        // this lane's 8 dims
  const bool lane_live = d0 < D;
  const int c0 = z * chunk, c_cap = min(c0 + chunk, S);
  const size_t ws_row = (size_t)D + 2;
  // e / D for e < GT * MAX_D as (e * dinv) >> 20, exact there for D <= 128
  // (a runtime division costs tens of instructions a use)
  const int dinv = ((1 << 20) + D - 1) / D;
  const size_t kv_row = (size_t)Hkv * D;
  const KT* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D + d0;
  const KT* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D + d0;

  // two register stages of U K and V rows; the first step's rows and the
  // queries are requested before length arrives
  Row8<KT> kr[2][U], vr[2][U];
  using Stage0 = std::integral_constant<int, 0>;
  using Stage1 = std::integral_constant<int, 1>;
  auto load_step = [&](int base, auto stage) {
    constexpr int st = decltype(stage)::value;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + u * HW + hw;
      if (key < c_cap && lane_live) {
        kr[st][u].load(kb + (size_t)key * kv_row);
        vr[st][u].load(vb + (size_t)key * kv_row);
      } else {
        kr[st][u].zero();
        vr[st][u].zero();
      }
    }
  };
  load_step(c0, Stage0{});
  Row8<QT> qr[GT];
#pragma unroll
  for (int r = 0; r < GT; ++r) {
    if (r < n_rows && lane_live)
      qr[r].load(q + ((size_t)b * Hq + h0 + r) * D + d0);
    else
      qr[r].zero();
  }
  const int len = min(max(length[b], 0), S);
  const int c1 = min(c0 + chunk, len);

  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int r = 0; r < GT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
  }
  if (c0 < len) {
    float qv[GT][8];
#pragma unroll
    for (int r = 0; r < GT; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[r][e] = __fmul_rn(qr[r][e], scale);
    auto step = [&](int base, auto stage) {
      constexpr int st = decltype(stage)::value;
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        live[u] = base + u * HW + hw < c1;
        if (!live[u]) {          // rows at or past length: never used
          kr[st][u].zero();
          vr[st][u].zero();
        }
      }
      // all U * GT partial dots, then their sums over the half-warp's 16
      // lanes stage by stage, so the shuffles of a stage overlap
      float sc[U][GT];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < GT; ++r) {
          float dot = 0.0f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qv[r][e], kr[st][u][e], dot);
          sc[u][r] = dot;
        }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < GT; ++r)
            sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], o);
#pragma unroll
      for (int r = 0; r < GT; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int u = 0; u < U; ++u)
          mx = fmaxf(mx, live[u] ? sc[u][r] : NEG_INF);
        const float m_new = fmaxf(m[r], mx);
        const float alpha = exp_(m[r] - m_new);
        m[r] = m_new;
        float p[U], sum = 0.0f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // masked probabilities are zeroed explicitly
          p[u] = live[u] ? exp_(sc[u][r] - m_new) : 0.0f;
          sum += p[u];
        }
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float a = acc[r][e] * alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(p[u], vr[st][u][e], a);
          acc[r][e] = a;
        }
      }
    };
    // steps in pairs, so the register stage of each is a constant
    for (int base = c0; base < c1; base += 2 * KEY_TILE) {
      if (base + KEY_TILE < c1) load_step(base + KEY_TILE, Stage1{});
      step(base, Stage0{});
      if (base + KEY_TILE >= c1) break;
      if (base + 2 * KEY_TILE < c1) load_step(base + 2 * KEY_TILE, Stage0{});
      step(base + KEY_TILE, Stage1{});
    }
    // the warp's two half-warps (same dims, other keys) merge by shuffles
#pragma unroll
    for (int r = 0; r < GT; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], 16);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], 16);
      const float mm = fmaxf(m[r], mo);
      const float w0 = exp_(m[r] - mm), w1 = exp_(mo - mm);
      m[r] = mm;
      l[r] = w0 * l[r] + w1 * lo;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] = w0 * acc[r][e] +
                    w1 * __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
    }
  }
  // the warps' states (empty for an empty chunk) in shared memory
  if ((tid & 31) == 0) {
#pragma unroll
    for (int r = 0; r < GT; ++r) {
      sm_m[warp * GT + r] = m[r];
      sm_l[warp * GT + r] = l[r];
    }
  }
  if ((tid & 16) == 0 && lane_live) {
#pragma unroll
    for (int r = 0; r < GT; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sm_acc[(warp * GT + r) * MAX_D + d0 + e] = acc[r][e];
  }
  __syncthreads();
  // one partial (acc, m, l) per query head from the warps' states: a
  // thread takes two adjacent dims of one row and weighs the row's states
  // itself, e^(m_w - M), so no second barrier is needed
  float* wsb = ws + (((size_t)b * Hq + h0) * n_split + z) * ws_row;
  float* rc = nullptr;                          // block 0's receive area
  if constexpr (CLUSTER) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    namespace cg = cooperative_groups;
    rc = cg::this_cluster().map_shared_rank(rc_m, 0);
  }
  for (int e = 2 * tid; e < n_rows * D; e += 2 * NT) {
    const int r = (e * dinv) >> 20, d = e - r * D;
    float mw[NWARP], mm = NEG_INF;
#pragma unroll
    for (int i = 0; i < NWARP; ++i) {
      mw[i] = sm_m[i * GT + r];
      mm = fmaxf(mm, mw[i]);
    }
    float a0 = 0.0f, a1 = 0.0f, ll = 0.0f;
#pragma unroll
    for (int i = 0; i < NWARP; ++i) {
      const float w = exp_(mw[i] - mm);
      const float2 x = *reinterpret_cast<const float2*>(
          sm_acc + (i * GT + r) * MAX_D + d);
      a0 = fmaf(w, x.x, a0);
      a1 = fmaf(w, x.y, a1);
      ll = fmaf(w, sm_l[i * GT + r], ll);
    }
    float* w = wsb + (size_t)r * n_split * ws_row;
    store2(w + d, a0, a1);
    if (d == 0) {
      w[D] = mm;
      w[D + 1] = ll;
    }
    if constexpr (CLUSTER) {
      store2(rc + 2 * MAX_CLUSTER * GT + (z * GT + r) * MAX_D + d, a0, a1);
      if (d == 0) {
        rc[z * GT + r] = mm;
        rc[MAX_CLUSTER * GT + z * GT + r] = ll;
      }
    }
  }
  if constexpr (CLUSTER) {
    // block 0 merges once every block's partial has landed in its memory
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (z != 0) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    // o = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30): a
    // thread takes two adjacent dims of one row and weighs the row's
    // partials itself, so no barrier is needed
    for (int e = 2 * tid; e < n_rows * D; e += 2 * NT) {
      const int r = (e * dinv) >> 20, d = e - r * D;
      float mi[MAX_CLUSTER], mm = NEG_INF;
#pragma unroll
      for (int i = 0; i < MAX_CLUSTER; ++i) {
        mi[i] = i < n_split ? rc_m[i * GT + r] : NEG_INF;
        mm = fmaxf(mm, mi[i]);
      }
      float a0 = 0.0f, a1 = 0.0f, ll = 0.0f;
#pragma unroll
      for (int i = 0; i < MAX_CLUSTER; ++i) {
        if (i < n_split) {
          const float w = exp_(mi[i] - mm);
          const float2 x = *reinterpret_cast<const float2*>(
              rc_acc + (i * GT + r) * MAX_D + d);
          a0 = fmaf(w, x.x, a0);
          a1 = fmaf(w, x.y, a1);
          ll = fmaf(w, rc_l[i * GT + r], ll);
        }
      }
      ll = fmaxf(ll, 1e-30f);
      store2(o + ((size_t)b * Hq + h0 + r) * D + d, a0 / ll, a1 / ll);
    }
    return;
  }

  // counter merge: the last block of the (batch, kv head, row group) to
  // finish merges its n_split partials, then leaves the counter at 0
  int* counter = counters + ((size_t)b * Hkv + kvh) * n_rg + rg;
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(counter, 1) == n_split - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // weights e^(m_i - M) and the sum of e^(m_i - M) l_i per row, staged in
  // shared memory (one round of loads), then the acc sums with 8 splits'
  // loads in flight at a time
  float* sw = sm_acc;                           // [GT][MAX_SPLIT] weights
  float* sl = sw + GT * MAX_SPLIT;              // [GT][MAX_SPLIT] l
  for (int e = tid; e < n_rows * n_split; e += NT) {
    const int r = e / n_split, i = e % n_split;
    const float* w = ws + (((size_t)b * Hq + h0 + r) * n_split + i) * ws_row;
    sw[r * MAX_SPLIT + i] = __ldcg(w + D);
    sl[r * MAX_SPLIT + i] = __ldcg(w + D + 1);
  }
  __syncthreads();
  if (tid < n_rows) {
    float mm = NEG_INF;
    for (int i = 0; i < n_split; ++i) mm = fmaxf(mm, sw[tid * MAX_SPLIT + i]);
    float ll = 0.0f;
    for (int i = 0; i < n_split; ++i) {
      const float w = exp_(sw[tid * MAX_SPLIT + i] - mm);
      sw[tid * MAX_SPLIT + i] = w;
      ll = fmaf(w, sl[tid * MAX_SPLIT + i], ll);
    }
    sl[tid * MAX_SPLIT] = fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < n_rows * D; e += NT) {
    const int r = (e * dinv) >> 20, d = e - r * D;
    const float* w = ws + ((size_t)b * Hq + h0 + r) * n_split * ws_row + d;
    float a = 0.0f;
    for (int i = 0; i < n_split; i += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = i + j < n_split ? __ldcg(w + (i + j) * ws_row) : 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i + j < n_split) a = fmaf(sw[r * MAX_SPLIT + i + j], x[j], a);
    }
    o[((size_t)b * Hq + h0 + r) * D + d] =
        from_f32<QT>(a / sl[r * MAX_SPLIT]);
  }
  if (tid == 0) *counter = 0;
}

template <typename QT, typename KT, int GT>
int launch(const void* q, const void* k, const void* v, const int* length,
           float* ws, int* counters, void* o, int B, int S, int Hq, int Hkv,
           int D, int n_split, int chunk, float scale, cudaStream_t stream) {
  const int n_rg = (Hq / Hkv + GT - 1) / GT;
  const dim3 grid(Hkv * n_rg, B, n_split);
  // the cluster merge for short chunks only: a long-running cluster of
  // up to 8 blocks must find its slots free all at once
  const bool cluster = n_split <= MAX_CLUSTER && chunk <= CLUSTER_CHUNK;
  const size_t smem = (cluster ? smem_floats<GT, true>()
                                : smem_floats<GT, false>()) * sizeof(float);
  auto kern = cluster ? decode_split<QT, KT, GT, true>
                      : decode_split<QT, KT, GT, false>;
  static uint64_t attr_set[2] = {0, 0};   // devices whose limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(attr_set[cluster] >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[cluster] |= uint64_t{1} << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(cluster ? Shape<true>::NT : Shape<false>::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = n_split;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kern, (const QT*)q, (const KT*)k,
                                 (const KT*)v, length, ws, counters, (QT*)o,
                                 S, Hq, Hkv, D, n_rg, n_split, chunk, scale);
}

template <typename QT, typename KT>
int launch_g(const void* q, const void* k, const void* v, const int* length,
             float* ws, int* counters, void* o, int B, int S, int Hq,
             int Hkv, int D, int n_split, int chunk, float scale,
             cudaStream_t s) {
  const int g = Hq / Hkv;
  if (g == 1)
    return launch<QT, KT, 1>(q, k, v, length, ws, counters, o, B, S, Hq, Hkv, D, n_split, chunk, scale, s);
  if (g == 2)
    return launch<QT, KT, 2>(q, k, v, length, ws, counters, o, B, S, Hq, Hkv, D, n_split, chunk, scale, s);
  if (g <= 4)
    return launch<QT, KT, 4>(q, k, v, length, ws, counters, o, B, S, Hq, Hkv, D, n_split, chunk, scale, s);
  return launch<QT, KT, 8>(q, k, v, length, ws, counters, o, B, S, Hq, Hkv, D, n_split, chunk, scale, s);
}

}  // namespace

// Keys per block per step of decode_split (the wrapper's chunk must be a
// multiple of it) and the most splits its merge takes.
extern "C" int decode_gqa_key_tile() { return KEY_TILE; }
extern "C" int decode_gqa_max_split() { return MAX_SPLIT; }

// q (B, Hq, D), k/v (B, S, Hkv, D), o like q, all contiguous and 16-byte
// aligned; q_bf16 / kv_bf16 select bf16 (1) or f32 (0) for q/o and for
// k/v.  length (B,) is int32 in device memory.  ws is the f32 workspace
// (B, Hq, n_split, D + 2), n_split <= MAX_SPLIT; counters holds
// B * Hkv * ceil(g / GT) int32 zeros, GT = min(8, g rounded up to a power
// of 2), and is left zero; n_split * chunk >= S, chunk a multiple of the
// key tile.  Needs D % 8 == 0 and D <= 128.  One launch on stream;
// returns its cudaError_t.
extern "C" int decode_gqa_launch(const void* q, const void* k, const void* v,
                                 const void* length, void* ws,
                                 void* counters, void* o, int B, int S,
                                 int Hq, int Hkv, int D, int n_split,
                                 int chunk, float scale, int q_bf16,
                                 int kv_bf16, void* stream) {
  if (D > MAX_D || D % 8 != 0 || Hq % Hkv != 0 || n_split < 1 ||
      n_split > MAX_SPLIT || chunk % KEY_TILE != 0 ||
      (long long)n_split * chunk < S)
    return (int)cudaErrorInvalidValue;
  auto len = (const int*)length;
  auto w = (float*)ws;
  auto c = (int*)counters;
  auto s = (cudaStream_t)stream;
  if (q_bf16 && kv_bf16)
    return launch_g<bf16, bf16>(q, k, v, len, w, c, o, B, S, Hq, Hkv, D, n_split, chunk, scale, s);
  if (q_bf16)
    return launch_g<bf16, float>(q, k, v, len, w, c, o, B, S, Hq, Hkv, D, n_split, chunk, scale, s);
  if (kv_bf16)
    return launch_g<float, bf16>(q, k, v, len, w, c, o, B, S, Hq, Hkv, D, n_split, chunk, scale, s);
  return launch_g<float, float>(q, k, v, len, w, c, o, B, S, Hq, Hkv, D, n_split, chunk, scale, s);
}
