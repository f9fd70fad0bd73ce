// Fused LSQ fake-quantization, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/lsq_quant/lsq_quant.py (pallas_call in
// `lsq_quant_pallas`).  Semantics, elementwise over x of any shape:
//   s_  = max(s, 1e-8)                    (1e-8 in x's dtype; NaN kept)
//   out = clip(round(x / s_), qn, qp) * s_
// with `round` half to even (rintf; roundf would round half away from
// zero) and every operation rounded as the reference rounds it: in f32 the
// division and product are __fdiv_rn / __fmul_rn (no FMA contraction, no
// approximate division); in bf16 the quotient is rounded to bf16 before
// rintf and the product is rounded to bf16, as the JAX program rounds
// after each op.  One f32 division or product of two bf16 operands rounded
// once more to bf16 equals the bf16 operation, so the double rounding is
// harmless.  The clip keeps a NaN, as jnp.clip does (fminf/fmaxf drop it),
// and turns -0 into +0 at a lower bound of 0, as XLA's max does.
//
// What bounds it on the H100: bytes.  Each element is read once and
// written once, so the least time is 2 * numel * itemsize / 3.35 TB/s.
// Design: a grid-stride loop over the flattened tensor with 16-byte vector
// loads and stores (4 f32 or 8 bf16 a thread), a scalar loop for the tail
// and for operands that are not 16-byte aligned.  s is read from device
// memory, so a new step size needs no host sync and no rebuild.  The
// TPU kernel's 1024-element blocking is a VMEM tiling and is not copied.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a float rounded to T and back (identity for f32)
template <typename T>
__device__ __forceinline__ float in_t(float v) {
  return to_f(from_f<T>(v));
}

template <typename T>
__device__ __forceinline__ T fake_quant(T x, float s, float qn, float qp) {
  float r = rintf(in_t<T>(__fdiv_rn(to_f(x), s)));
  // NaN passes through; -0 clipped to qn = 0 becomes +0, as jnp.clip
  // (XLA's max) gives it
  r = r <= qn ? qn : (r > qp ? qp : r);
  return from_f<T>(__fmul_rn(r, s));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lsq_quant_kernel(const T* __restrict__ x, const T* __restrict__ s_p,
                 T* __restrict__ out, long long n, int qn_i, int qp_i,
                 int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const float floor_s = in_t<T>(1e-8f);
  const float sv = to_f(s_p[0]);
  const float s = (sv > floor_s || sv != sv) ? sv : floor_s;
  const float qn = in_t<T>((float)qn_i);
  const float qp = in_t<T>((float)qp_i);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec_ok) {
    const long long nv = n / VEC;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      uint4 raw = xv[i];
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = fake_quant(e[j], s, qn, qp);
      ov[i] = raw;
    }
    done = nv * VEC;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = fake_quant(x[i], s, qn, qp);
}

template <typename T>
int launch(const void* x, const void* s, void* out, long long n, int qn,
           int qp, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec_ok = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long work = vec_ok ? n / VEC + n % VEC : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  lsq_quant_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)x, (const T*)s, (T*)out, n, qn, qp, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

// x and out: n contiguous elements of one dtype (0 f32, 1 bf16); s: one
// element of the same dtype in device memory.  qn, qp: the integer clip
// range.  Returns cudaGetLastError() after the launch.
extern "C" int lsq_quant_launch(const void* x, const void* s, void* out,
                                long long n, int qn, int qp, int dtype,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(x, s, out, n, qn, qp, st);
    case 1: return launch<__nv_bfloat16>(x, s, out, n, qn, qp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
