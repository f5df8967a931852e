// Helpers shared by the port's hand-written kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round an f32 value to the storage type T and back (round to nearest
// even, as jnp .astype does); identity for T = float.
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Store an f32 value in the storage type T (round to nearest even).
template <typename T> __device__ __forceinline__ T to_storage(float x);
template <> __device__ __forceinline__ float to_storage<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 to_storage<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16-byte vector load of V = 16 / sizeof(T) consecutive values as f32, and
// store of V f32 values rounded to T (round to nearest even).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __float22bfloat162_rn(make_float2(in[2 * i], in[2 * i + 1]));
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The items [lo, hi) of n that cluster rank r of c owns: floor(r n / c) to
// floor((r + 1) n / c), so slices differ by at most one item.
// ops/decode_loop.py::cluster_slice is the same rule.
struct Slice {
  int lo, hi;
  __device__ Slice(int n, int c, int r) : lo(r * n / c), hi((r + 1) * n / c) {}
};

// Pushes into every block's copy of a shared buffer. Warp-level: every lane
// holds the value (after a butterfly warp_sum), and lane p < C stores it
// into block p's copy (the block's own copy included).
struct Peers {
  float* smem;  // this block's dynamic shared memory
  float* peer;  // lane p < C: block p's, mapped into the cluster's window
  int C;
  __device__ __forceinline__ void push(float* buf, int i, float v, int lane) const {
    if (lane < C) peer[(buf - smem) + i] = v;
  }
};

// The counter's old value, incremented (wrapping to 0 past `limit`) with
// release and acquire at device scope: one thread's ticket orders the
// block's writes before it (after a __syncthreads) and the block's reads
// after it (before a __syncthreads).
__device__ __forceinline__ unsigned ticket_acq_rel(unsigned* p, unsigned limit) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(limit) : "memory");
  return old;
}

}  // namespace tt
