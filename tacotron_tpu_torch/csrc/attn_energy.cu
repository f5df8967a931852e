// Bahdanau attention energy, forward (K1) and backward (K2), f32:
//
//   e[b, t]  = sum_a v[a] * tanh(keys[b, t, a] + q[b, a])
//   w        = de[b, t] * v[a] * (1 - tanh(keys[b, t, a] + q[b, a])^2)
//   dkeys    = w,   dq[b] = sum_t w[b, t],   dv = sum_{b, t} tanh(..) * de[b, t]
//
// Replaces the TPU kernels tacotron_tpu/ops/pallas/attn_energy.py
// _fwd_kernel (:63, launched at :94) and _bwd_kernel (:69, launched at
// :119). As there, the (B, T_in, A) tanh never reaches device memory: the
// forward reads keys once and writes e; the backward recomputes the tanh
// and writes dkeys, the only (B, T_in, A) output.
//
// What bounds it on an H100: bytes. Both kernels do a few operations per
// element they move (an add, a tanh, one or two multiply-adds), far below
// the ~20 flops per byte at which f32 arithmetic would be the limit. At the
// training path's shapes (B 32, T_in 128, A 256) keys is 4.2 MB, so K1
// needs ~1.3 us of memory time and K2 (keys in, dkeys out) ~2.5 us; a
// launch costs about as much, so launch latency dominates.
//
// Design. K1: one warp per (b, t) row, 16-byte loads along A, a shuffle
// reduction, one store per row. K2: the TPU kernel carried dv across a
// sequential grid; blocks here run in no order, so block (b, c) covers a
// chunk of rows of batch row b, one thread per column a, and writes its
// partial dq and dv sums; a second launch adds the partials in a fixed
// order (dq over the chunks of its row, dv over every (b, c) in order).
// The result is deterministic: no float atomics.
//
// tanhf is the accurate libm version (no fast-math), so the kernels agree
// with PyTorch's tanh to a few ulp.
#include "common.cuh"

namespace {

constexpr int kFwdWarps = 8;  // rows per forward block

__global__ void __launch_bounds__(kFwdWarps * 32)
energy_fwd(const float* __restrict__ keys, const float* __restrict__ q,
           const float* __restrict__ v, float* __restrict__ e, int rows,
           int T, int A, int vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFwdWarps + warp;
  if (row >= rows) return;  // whole warps leave together
  const float* k = keys + (size_t)row * A;
  const float* qb = q + (size_t)(row / T) * A;
  float acc = 0.f;
  if (vec) {
    for (int a = lane * 4; a < A; a += 128) {
      float kk[4], qq[4], vv[4];
      tt::Vec<float>::load(k + a, kk);
      tt::Vec<float>::load(qb + a, qq);
      tt::Vec<float>::load(v + a, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc += vv[i] * tanhf(kk[i] + qq[i]);
    }
  } else {
    for (int a = lane; a < A; a += 32) acc += v[a] * tanhf(k[a] + qb[a]);
  }
  acc = tt::warp_sum(acc);
  if (lane == 0) e[row] = acc;
}

// Block (b, c) takes rows t in [c * TC, min(T, (c + 1) * TC)) of batch row
// b; partials are laid out (B, C, A).
__global__ void __launch_bounds__(256)
energy_bwd_partial(const float* __restrict__ keys, const float* __restrict__ q,
                   const float* __restrict__ v, const float* __restrict__ de,
                   float* __restrict__ dkeys, float* __restrict__ part_dq,
                   float* __restrict__ part_dv, int T, int A, int TC) {
  const int b = blockIdx.x, c = blockIdx.y, C = gridDim.y;
  const int t0 = c * TC, t1 = min(T, t0 + TC);
  const float* deb = de + (size_t)b * T;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const float qa = q[(size_t)b * A + a], va = v[a];
    float dq = 0.f, dv = 0.f;
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      const size_t i = ((size_t)b * T + t) * A + a;
      const float th = tanhf(keys[i] + qa);
      const float d = deb[t];
      const float w = d * va * (1.f - th * th);
      dkeys[i] = w;
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
__global__ void __launch_bounds__(256)
energy_bwd_reduce(const float* __restrict__ part_dq,
                  const float* __restrict__ part_dv, float* __restrict__ dq,
                  float* __restrict__ dv, int B, int C, int A) {
  const int b = blockIdx.x;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    float s = 0.f;
    if (b < B) {
      for (int c = 0; c < C; ++c) s += part_dq[((size_t)b * C + c) * A + a];
      dq[(size_t)b * A + a] = s;
    } else {
      for (int r = 0; r < B * C; ++r) s += part_dv[(size_t)r * A + a];
      dv[a] = s;
    }
  }
}

int threads_for(int A) { return A >= 256 ? 256 : ((A + 31) / 32) * 32; }

}  // namespace

// keys (B, T, A), q (B, A), v (A,), e (B, T); all f32, contiguous. vec: the
// caller vouches that A % 4 == 0 and keys, q, v are 16-byte aligned.
extern "C" int tt_attn_energy_fwd(const float* keys, const float* q,
                                  const float* v, float* e, int B, int T,
                                  int A, int vec, void* stream) {
  const int rows = B * T;
  const int blocks = (rows + kFwdWarps - 1) / kFwdWarps;
  energy_fwd<<<blocks, kFwdWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, q, v, e, rows, T, A, vec);
  return (int)cudaGetLastError();
}

// de (B, T); dkeys (B, T, A), dq (B, A), dv (A,); scratch holds
// 2 * B * C * A floats with C = ceil(T / TC).
extern "C" int tt_attn_energy_bwd(const float* keys, const float* q,
                                  const float* v, const float* de,
                                  float* dkeys, float* dq, float* dv,
                                  float* scratch, int B, int T, int A, int TC,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = (T + TC - 1) / TC;
  float* part_dq = scratch;
  float* part_dv = scratch + (size_t)B * C * A;
  energy_bwd_partial<<<dim3(B, C), threads_for(A), 0, st>>>(
      keys, q, v, de, dkeys, part_dq, part_dv, T, A, TC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  energy_bwd_reduce<<<B + 1, threads_for(A), 0, st>>>(part_dq, part_dv, dq, dv,
                                                       B, C, A);
  return (int)cudaGetLastError();
}
