// Bahdanau attention energy, forward (K1) and backward (K2), with keys and q
// stored in S = float or __nv_bfloat16 (the compute dtype):
//
//   t[b, t, a] = tanh(keys[b, t, a] + q[b, a])           (rounded to S)
//   e[b, t]    = sum_a v[a] * t                           (f32)
//   w          = de[b, t] * v[a] * (1 - t^2)              (f32)
//   dkeys      = w,   dq[b] = sum_t w[b, t]               (rounded to S)
//   dv         = sum_{b, t} t * de[b, t]                  (f32)
//
// Replaces the TPU kernels tacotron_tpu/ops/pallas/attn_energy.py
// _fwd_kernel (:63, launched at :94) and _bwd_kernel (:69, launched at
// :119), in both of their modes: keys/q in f32, or in bf16 under
// compute_dtype="bfloat16". As there, the (B, T_in, A) tanh never reaches
// device memory: the forward reads keys once and writes e; the backward
// recomputes the tanh and writes dkeys, the only (B, T_in, A) output.
//
// Rounding points in bf16 are the TPU kernel's: the sum keys + q and its
// tanh are each rounded to bf16 (jnp.tanh on bf16 operands); v, de, the
// products with them and every sum are f32; dkeys and dq are rounded once,
// from f32. w is formed with __fmul_rn / __fsub_rn, never contracted into an
// fma, because the plain version rounds after each of its operations and a
// single-rounding fma can flip a bf16 result.
//
// What bounds it on an H100: bytes. Both kernels do a few operations per
// element they move (an add, a tanh, one or two multiply-adds), far below
// the ~20 flops per byte at which f32 arithmetic would be the limit. At the
// training path's shapes (B 32, T_in 128, A 256) keys is 4.2 MB in f32 and
// 2.1 MB in bf16, so K1 needs ~1.3 us (f32) or ~0.64 us (bf16) of memory
// time and K2 (keys in, dkeys out) ~2.5 us or ~1.3 us; a launch costs about
// as much, so launch latency dominates.
//
// Design. K1: one warp per (b, t) row, 16-byte loads along A (4 f32 or 8
// bf16 values a lane), a shuffle reduction, one store per row. K2: the TPU
// kernel carried dv across a sequential grid; blocks here run in no order,
// so block (b, c) covers a chunk of rows of batch row b, one thread per
// column a, and writes its partial dq and dv sums in f32; a second launch
// adds the partials in a fixed order (dq over the chunks of its row, dv over
// every (b, c) in order) and rounds dq to S. The result is deterministic: no
// float atomics.
//
// tanhf is the accurate libm version (no fast-math), so the kernels agree
// with PyTorch's tanh to a few ulp.
#include "common.cuh"

namespace {

constexpr int kFwdWarps = 8;  // rows per forward block

// tanh(k + q) with the sum and the result rounded to the storage type S
template <typename S>
__device__ __forceinline__ float act(float k, float q) {
  return tt::round_to<S>(tanhf(tt::round_to<S>(k + q)));
}

template <typename S>
__global__ void __launch_bounds__(kFwdWarps * 32)
energy_fwd(const S* __restrict__ keys, const S* __restrict__ q,
           const float* __restrict__ v, float* __restrict__ e, int rows,
           int T, int A, int vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFwdWarps + warp;
  if (row >= rows) return;  // whole warps leave together
  const S* k = keys + (size_t)row * A;
  const S* qb = q + (size_t)(row / T) * A;
  float acc = 0.f;
  if (vec) {
    constexpr int V = tt::Vec<S>::V;
    for (int a = lane * V; a < A; a += 32 * V) {
      float kk[V], qq[V], vv[V];
      tt::Vec<S>::load(k + a, kk);
      tt::Vec<S>::load(qb + a, qq);
#pragma unroll
      for (int j = 0; j < V; j += 4) tt::Vec<float>::load(v + a + j, vv + j);
#pragma unroll
      for (int i = 0; i < V; ++i) acc += vv[i] * act<S>(kk[i], qq[i]);
    }
  } else {
    for (int a = lane; a < A; a += 32)
      acc += v[a] * act<S>(tt::to_f32(k[a]), tt::to_f32(qb[a]));
  }
  acc = tt::warp_sum(acc);
  if (lane == 0) e[row] = acc;
}

// Block (b, c) takes rows t in [c * TC, min(T, (c + 1) * TC)) of batch row
// b; partials are laid out (B, C, A).
template <typename S>
__global__ void __launch_bounds__(256)
energy_bwd_partial(const S* __restrict__ keys, const S* __restrict__ q,
                   const float* __restrict__ v, const float* __restrict__ de,
                   S* __restrict__ dkeys, float* __restrict__ part_dq,
                   float* __restrict__ part_dv, int T, int A, int TC) {
  const int b = blockIdx.x, c = blockIdx.y, C = gridDim.y;
  const int t0 = c * TC, t1 = min(T, t0 + TC);
  const float* deb = de + (size_t)b * T;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const float qa = tt::to_f32(q[(size_t)b * A + a]), va = v[a];
    float dq = 0.f, dv = 0.f;
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      const size_t i = ((size_t)b * T + t) * A + a;
      const float th = act<S>(tt::to_f32(keys[i]), qa);
      const float d = deb[t];
      const float w = __fmul_rn(__fmul_rn(d, va), __fsub_rn(1.f, __fmul_rn(th, th)));
      dkeys[i] = tt::to_storage<S>(w);
      dq += w;
      dv += th * d;
    }
    const size_t p = ((size_t)b * C + c) * A + a;
    part_dq[p] = dq;
    part_dv[p] = dv;
  }
}

// Blocks 0..B-1 sum dq[b] over the chunks of row b; block B sums dv over
// all (b, c) in order.
template <typename S>
__global__ void __launch_bounds__(256)
energy_bwd_reduce(const float* __restrict__ part_dq,
                  const float* __restrict__ part_dv, S* __restrict__ dq,
                  float* __restrict__ dv, int B, int C, int A) {
  const int b = blockIdx.x;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    float s = 0.f;
    if (b < B) {
      for (int c = 0; c < C; ++c) s += part_dq[((size_t)b * C + c) * A + a];
      dq[(size_t)b * A + a] = tt::to_storage<S>(s);
    } else {
      for (int r = 0; r < B * C; ++r) s += part_dv[(size_t)r * A + a];
      dv[a] = s;
    }
  }
}

int threads_for(int A) { return A >= 256 ? 256 : ((A + 31) / 32) * 32; }

template <typename S>
int launch_fwd(const void* keys, const void* q, const float* v, float* e, int B,
               int T, int A, int vec, cudaStream_t st) {
  const int rows = B * T;
  const int blocks = (rows + kFwdWarps - 1) / kFwdWarps;
  energy_fwd<S><<<blocks, kFwdWarps * 32, 0, st>>>(
      static_cast<const S*>(keys), static_cast<const S*>(q), v, e, rows, T, A, vec);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_bwd(const void* keys, const void* q, const float* v, const float* de,
               void* dkeys, void* dq, float* dv, float* scratch, int B, int T,
               int A, int TC, cudaStream_t st) {
  const int C = (T + TC - 1) / TC;
  float* part_dq = scratch;
  float* part_dv = scratch + (size_t)B * C * A;
  energy_bwd_partial<S><<<dim3(B, C), threads_for(A), 0, st>>>(
      static_cast<const S*>(keys), static_cast<const S*>(q), v, de,
      static_cast<S*>(dkeys), part_dq, part_dv, T, A, TC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  energy_bwd_reduce<S><<<B + 1, threads_for(A), 0, st>>>(
      part_dq, part_dv, static_cast<S*>(dq), dv, B, C, A);
  return (int)cudaGetLastError();
}

}  // namespace

// keys (B, T, A) and q (B, A) in f32 (bf16 == 0) or bf16 (bf16 == 1); v
// (A,) and e (B, T) f32; all contiguous. vec: the caller vouches that A is a
// multiple of 16 / sizeof(S) and keys, q, v are 16-byte aligned.
extern "C" int tt_attn_energy_fwd(const void* keys, const void* q,
                                  const float* v, float* e, int B, int T,
                                  int A, int vec, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(keys, q, v, e, B, T, A, vec, st)
              : launch_fwd<float>(keys, q, v, e, B, T, A, vec, st);
}

// de (B, T) f32; dkeys (B, T, A) and dq (B, A) in keys' type; dv (A,) f32;
// scratch holds 2 * B * C * A floats with C = ceil(T / TC).
extern "C" int tt_attn_energy_bwd(const void* keys, const void* q,
                                  const float* v, const float* de, void* dkeys,
                                  void* dq, float* dv, float* scratch, int B,
                                  int T, int A, int TC, int bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(keys, q, v, de, dkeys, dq, dv, scratch,
                                          B, T, A, TC, st)
              : launch_bwd<float>(keys, q, v, de, dkeys, dq, dv, scratch, B, T,
                                  A, TC, st);
}
