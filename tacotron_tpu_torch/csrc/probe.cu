// Capability probes: what the Griffin-Lim kernel design needs from the
// card, asked of the card itself.
//
// Replaces the two TPU probes of scripts/probe_pallas.py:
//   probe_vmem(mb)  can a kernel hold mb MiB of VMEM scratch and use it
//                                                    -> tt_probe_smem
//   probe_ops()     the op shapes the kernel relies on: an NT product, two
//                   overlapping row-offset accumulations into scratch, an
//                   unaligned one-row slice reversed by a permutation
//                   product, a loop inside the kernel   -> tt_probe_ops
// On Hopper the scarce on-chip memory is a block's shared memory: up to 227
// KiB of an SM's 256 KiB, and above 48 KiB only as dynamic shared memory
// after an opt-in. tt_probe_smem asks for `kib` KiB, opts in, and uses the
// allocation; a refusal comes back as the CUDA error, never as a pass.
//
// Both are a single block and a few microseconds of work: launch latency
// bounds them, not bytes or operations. The shared-memory probe moves its
// 16 KiB in one round trip: 1024 threads, each one 16-byte load, one store
// into the scratch, one barrier, one 16-byte store of another warp's slot;
// the scratch sits at the top of the allocation, so its last byte is used.
//
// tt_probe_cluster_barrier answers a question of the fused decode's design
// (csrc/decode_loop.cu), which ends each phase of a step with one cluster
// barrier: what one barrier costs. It launches clusters whose blocks do
// nothing but n barriers; the time over n is the cost.
//
// tt_probe_empty gives the floor of a small kernel's device time: a kernel
// that does nothing, launched with a given grid, block and cluster size
// (those of the attention-energy kernels in csrc/attn_energy.cu). No
// redesign of a kernel that small can take less.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kProbeRows = 8, kProbeCols = 512;
constexpr int kProbeThreads = kProbeRows * kProbeCols / 4;   // one float4 each

// scratch[base:base + 1024] = x * 2 (as float4); out = that scratch, each
// thread storing the slot of the thread 32 away (the next or previous warp)
__global__ void __launch_bounds__(kProbeThreads)
probe_smem_kernel(const float4* __restrict__ x, float4* __restrict__ out, int base) {
  extern __shared__ float4 scratch[];
  const int t = threadIdx.x;
  const float4 v = x[t];
  scratch[base + t] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  __syncthreads();
  const int u = t ^ 32;
  out[u] = scratch[base + u];
}

constexpr int PF = 64, PS = 256, PH = 275, PK = 32, PT = 512;
constexpr int kOpsSmem = ((PF + 8) * PH + PF * PH + PF * PK + PH * (PK + 1)) * 4 + 64;

// spec (64, 256), d (275, 256), p (275, 275) -> out (72, 275), one block.
__global__ void __launch_bounds__(PT)
probe_ops_kernel(const float* __restrict__ spec, const float* __restrict__ d,
                 const float* __restrict__ p, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* y = smem;                        // (72, 275) scratch
  float* prod = y + (PF + 8) * PH;        // (64, 275) the NT product
  float* a_t = prod + PF * PH;            // (64, 32) tile of spec
  float* b_t = a_t + PF * PK;             // (275, 33) tile of d, padded
  float* red = b_t + PH * (PK + 1);       // 16 partial sums
  const int tid = threadIdx.x;

  // NT product: contract dimension 1 of both, from shared-memory tiles
  for (int i = tid; i < PF * PH; i += PT) prod[i] = 0.f;
  for (int k0 = 0; k0 < PS; k0 += PK) {
    __syncthreads();
    for (int i = tid; i < PF * PK; i += PT)
      a_t[i] = spec[(i / PK) * PS + k0 + i % PK];
    for (int i = tid; i < PH * PK; i += PT)
      b_t[(i / PK) * (PK + 1) + i % PK] = d[(i / PK) * PS + k0 + i % PK];
    __syncthreads();
    for (int i = tid; i < PF * PH; i += PT) {
      const int f = i / PH, h = i % PH;
      float acc = prod[i];
#pragma unroll
      for (int k = 0; k < PK; ++k) acc = fmaf(a_t[f * PK + k], b_t[h * (PK + 1) + k], acc);
      prod[i] = acc;
    }
  }
  // two overlapping row-offset accumulations, in order
  for (int i = tid; i < (PF + 8) * PH; i += PT) y[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < PF * PH; i += PT) y[3 * PH + i] += prod[i];
  __syncthreads();
  for (int i = tid; i < PF * PH; i += PT) y[5 * PH + i] += prod[i] * 0.5f;
  __syncthreads();
  // an unaligned one-row slice times the permutation, into row 7
  float rev = 0.f;
  if (tid < PH)
    for (int k = 0; k < PH; ++k) rev = fmaf(y[5 * PH + k], p[k * PH + tid], rev);
  __syncthreads();
  if (tid < PH) y[7 * PH + tid] = rev;
  __syncthreads();
  // a loop inside the kernel with a carried value
  float s = 0.f;
  for (int trip = 0; trip < 4; ++trip) {
    float part = 0.f;
    for (int i = tid; i < 8 * PH; i += PT) part += y[i];
    part = tt::warp_sum(part);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    float total = 0.f;
    for (int w = 0; w < PT / 32; ++w) total += red[w];
    s = s + total * 1e-9f;
    __syncthreads();
  }
  for (int i = tid; i < (PF + 8) * PH; i += PT) out[i] = y[i] + s;
}

// n cluster barriers and nothing else, in blocks of the decode's 512
// threads that each hold enough shared memory to have an SM to themselves
constexpr int kBarrierThreads = 512, kBarrierSmem = 120 * 1024, kMaxCluster = 16;

__global__ void __launch_bounds__(kBarrierThreads, 1) probe_cluster_barrier_kernel(int n) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) smem[0] = 0.f;
  for (int i = 0; i < n; ++i) cluster.sync();
}

__global__ void probe_empty_kernel() {}

}  // namespace

// x, out: (8, 512) f32 on the device. Launches one block with `kib` KiB of
// dynamic shared memory. *max_optin receives
// cudaDevAttrMaxSharedMemoryPerBlockOptin in bytes. Returns the CUDA error
// of the opt-in or of the launch, 0 on success.
extern "C" int tt_probe_smem(const float* x, float* out, int kib, int* max_optin,
                             void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int bytes = kib * 1024;
  err = cudaFuncSetAttribute(probe_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported to the caller; leave no error behind for the next call
    return (int)err;
  }
  probe_smem_kernel<<<1, kProbeThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
      bytes / 16 - kProbeThreads);
  return (int)cudaGetLastError();
}

// spec (64, 256), d (275, 256), p (275, 275), out (72, 275), f32 on the device.
extern "C" int tt_probe_ops(const float* spec, const float* d, const float* p, float* out,
                            void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_ops_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOpsSmem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  probe_ops_kernel<<<1, PT, kOpsSmem, static_cast<cudaStream_t>(stream)>>>(spec, d, p, out);
  return (int)cudaGetLastError();
}

// `clusters` clusters of `cluster` blocks (1..16; 16 non-portable), each
// block running n cluster barriers. Returns the CUDA error of the
// attributes or of the launch, 0 on success.
extern "C" int tt_probe_cluster_barrier(int clusters, int cluster, int n, void* stream) {
  if (clusters < 1 || cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      probe_cluster_barrier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBarrierSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(probe_cluster_barrier_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(kBarrierThreads);
  cfg.dynamicSmemBytes = kBarrierSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, probe_cluster_barrier_kernel, n);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// An empty kernel on `blocks` blocks of `threads` threads, in clusters of
// `cluster` (1..8; blocks a multiple of it). Returns the CUDA error of the
// launch, 0 on success.
extern "C" int tt_probe_empty(int blocks, int threads, int cluster, void* stream) {
  if (blocks < 1 || cluster < 1 || cluster > 8 || blocks % cluster) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, probe_empty_kernel);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// The runtime's name and description of a CUDA error code.
extern "C" const char* tt_probe_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
extern "C" const char* tt_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
