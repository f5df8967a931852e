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
// The shared-memory probe is a single block and a few microseconds of
// work: launch latency bounds it, not bytes or operations. It moves its
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
// that does nothing, launched with a given grid, block, cluster size and
// shared memory (those of the attention-energy kernels in
// csrc/attn_energy.cu, and of the ops probe). No redesign of a kernel that
// small can take less.
//
// The ops probe spreads its 4.5 M FMAs over one thread-block cluster; its
// design is at probe_ops_kernel.
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

// ---- P2, the ops probe ----
// spec (64, 256), d (275, 256), p (275, 275) -> out (72, 275):
//   prod = spec d^T; y = 0; y[3:67] += prod; y[5:69] += prod / 2;
//   y[7] = y[5] p; s: 4 trips of s += 1e-9 sum(y[0:8]); out = y + s.
// In one block this is bound by one SM's shared-memory loads (two scalar
// loads per FMA, 4.5 M FMAs: ~150 us). Here one thread-block cluster of C
// blocks splits the COLUMNS of the output: rank r owns columns [col0(r),
// col0(r + 1)) of every row. Splitting columns, not rows, needs no halo
// (output row i takes product rows i - 3 and i - 5 of the same column) and
// reads each of d's rows on one SM only; every rank reads all of spec (64
// KiB), one bulk copy (TMA without a tensor map) per row, counted by one
// mbarrier, the ranks starting at different rows.
// The permutation product rev[j] = sum_k y5[k] p[k][j] is split by k: y5's
// columns k are the rank's own, so rank r reads p's rows col0(r) ..
// col0(r + 1) (into registers while its operands are copied) and forms a
// partial rev over all 275 j. One exchange: every rank pushes each
// column's partial into the shared memory of the rank owning that column,
// and its partial of sum(y[0:8]) into every rank; then one cluster
// barrier. After it every rank sums the C partials in rank order, so every
// rank computes the same s from the same numbers, and writes its columns
// of all 72 rows. No float atomics: the same bits on every call.
// The product: 4 x 4 outputs a thread (rows rg + 16 i, columns cg +
// kColGroups j), 16-byte shared loads along the contraction (8 loads for
// 64 FMAs); the 256-deep contraction is split over 4 thread groups and
// their partial products summed in group order. The operand rows are
// padded to 260 floats, so the 8 row groups of a quarter warp hit 8
// distinct bank groups, and its one column group is a broadcast.
// What bounds it (scripts/probe_study.py's phase clock, C 16, on an H100):
// bringing 82 KiB into each SM (~2.2 us; 16-byte cp.async by every thread
// took longer, and a bulk copy per quarter row, each quarter with its own
// mbarrier so that the product could start early, longer still: issuing
// 328 copies took 4.6 us), the product (~2.9 us, 43% of the FMA peak) and
// the one cluster barrier (~0.8 us).
constexpr int PF = 64, PS = 256, PH = 275;
constexpr int kOpsLd = PS + 4;        // operand row stride in shared memory, floats
constexpr int kOpsRowGroups = 16;     // a thread's product rows: rg + 16 i, i < 4
constexpr int kOpsSplit = 4;          // the contraction split over thread groups
constexpr int kOpsRows = PF / kOpsRowGroups;
constexpr int kOpsDepth = PS / kOpsSplit;
constexpr int kOpsCluster = 16;       // the cluster size (8 in scripts/probe_study.py: slower)

#ifdef TT_PROBE_PHASE_CLOCK
// The ops kernel's phase clock (scripts/probe_study.py): per block,
// %globaltimer (ns) at each mark; thread 0 of the block writes it.
constexpr int kOpsMarks = 7, kOpsClockBlocks = 16;
__device__ unsigned long long g_ops_clock[kOpsClockBlocks][kOpsMarks];
#define OPS_MARK(k)                                                             \
  if (threadIdx.x == 0 && blockIdx.x < kOpsClockBlocks) {                       \
    unsigned long long ns;                                                      \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                      \
    g_ops_clock[blockIdx.x][k] = ns;                                            \
  }
#else
#define OPS_MARK(k)
#endif

// first column of rank r: floor(r PH / C) (ops_plan in probe.py mirrors it)
__host__ __device__ constexpr int ops_col0(int r, int C) { return r * PH / C; }

// the rank owning column j
__device__ __forceinline__ int ops_owner(int j, int C) {
  const int t = j * C / PH;
  return j >= ops_col0(t + 1, C) ? t + 1 : t;
}

template <int C> struct OpsGeom {
  static constexpr int kCols = (PH + C - 1) / C;           // most columns a rank owns
  static constexpr int kColGroups = (kCols + 3) / 4;
  static constexpr int kColsPad = 4 * kColGroups;
  static constexpr int kThreads = kOpsRowGroups * kColGroups * kOpsSplit;
  // shared memory, floats: spec; the rank's rows of d; the 4 groups'
  // partial products, then the product in group 0's place; every rank's
  // partial rev for this rank's columns; every rank's partial sum of
  // y[0:8]; one sum per warp
  static constexpr int kA = 0, kB = kA + PF * kOpsLd, kPart = kB + kColsPad * kOpsLd,
                       kRecv = kPart + kOpsSplit * PF * kColsPad, kSig = kRecv + C * kColsPad,
                       kWarp = kSig + C, kFloats = kWarp + 32;
  static constexpr int kBytes = kFloats * 4;
  static_assert(kThreads >= PH && kThreads <= 1024, "one thread per column of p");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One bulk copy (TMA, no tensor map) of `bytes` from global into this
// block's shared memory; the barrier counts the bytes as they land.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait for phase 0 of the barrier; a wait that never ends traps, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void bar_wait0(uint64_t* bar) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

template <int C>
__global__ void __launch_bounds__(OpsGeom<C>::kThreads)
probe_ops_kernel(const float* __restrict__ spec, const float* __restrict__ d,
                 const float* __restrict__ p, float* __restrict__ out) {
  using G = OpsGeom<C>;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t loaded;   // the operands' bulk copies have landed
  float* a = smem + G::kA;
  float* b = smem + G::kB;
  float* part = smem + G::kPart;
  float* recv = smem + G::kRecv;
  float* sig = smem + G::kSig;
  float* wsum = smem + G::kWarp;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = ops_col0(rank, C), n = ops_col0(rank + 1, C) - c0;
  const int tid = threadIdx.x;
  OPS_MARK(0);
  // every block of the cluster runs before any pushes into its shared
  // memory: arrive now, wait just before the pushes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // 1. spec, and d's rows of this rank's columns, into shared memory: one
  // bulk copy per row (a row of the padded tiles is contiguous), one
  // thread each, the ranks starting at different rows of spec
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&loaded)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(&loaded)), "r"((uint32_t)((PF + n) * PS * 4))
                 : "memory");
  }
  __syncthreads();
  if (tid < PF) {
    const int row = (tid + rank * (PF / C)) % PF;
    bulk_load(a + row * kOpsLd, spec + row * PS, PS * 4, &loaded);
  } else if (tid < PF + n) {
    const int row = tid - PF;
    bulk_load(b + row * kOpsLd, d + (size_t)(c0 + row) * PS, PS * 4, &loaded);
  }
  for (int i = tid; i < (G::kColsPad - n) * (PS / 4); i += G::kThreads) {
    const int row = n + i / (PS / 4), q = 4 * (i % (PS / 4));
    *reinterpret_cast<float4*>(b + row * kOpsLd + q) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // p's rows of this rank's columns, thread j holding column j, loaded
  // while the copies are in flight
  float pk[G::kCols];
#pragma unroll
  for (int k = 0; k < G::kCols; ++k)
    pk[k] = (tid < PH && k < n) ? __ldg(p + (size_t)(c0 + k) * PH + tid) : 0.f;
  bar_wait0(&loaded);
  __syncthreads();              // the zeroed rows
  OPS_MARK(1);

  // 2. the NT product, one quarter of the contraction per thread group
  {
    const int rg = tid % kOpsRowGroups, cgr = (tid / kOpsRowGroups) % G::kColGroups;
    const int ks = tid / (kOpsRowGroups * G::kColGroups);
    const float* ar = a + rg * kOpsLd + ks * kOpsDepth;
    const float* br = b + cgr * kOpsLd + ks * kOpsDepth;
    float acc[kOpsRows][4] = {};
#pragma unroll 2
    for (int k = 0; k < kOpsDepth; k += 4) {
      float4 av[kOpsRows], bv[4];
#pragma unroll
      for (int i = 0; i < kOpsRows; ++i)
        av[i] = *reinterpret_cast<const float4*>(ar + i * kOpsRowGroups * kOpsLd + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(br + j * G::kColGroups * kOpsLd + k);
#pragma unroll
      for (int i = 0; i < kOpsRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
    }
    float* pp = part + ks * PF * G::kColsPad;
#pragma unroll
    for (int i = 0; i < kOpsRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pp[(rg + i * kOpsRowGroups) * G::kColsPad + cgr + j * G::kColGroups] = acc[i][j];
  }
  __syncthreads();
  OPS_MARK(2);
  // 3. the product: the groups' partial products summed in group order
  for (int e = tid; e < PF * G::kColsPad; e += G::kThreads) {
    float s = part[e];
#pragma unroll
    for (int ks = 1; ks < kOpsSplit; ++ks) s += part[ks * PF * G::kColsPad + e];
    part[e] = s;
  }
  __syncthreads();
  OPS_MARK(3);
  const float* prod = part;   // (PF, kColsPad): prod[f][j] of column c0 + j

  // 4. this rank's partial rev[tid] over its columns k, and its partial of
  // sum(y[0:8]): that rev partial plus rows 3..6 of its columns (rows 0..2
  // are 0)
  float mine = 0.f;
#pragma unroll
  for (int k = 0; k < G::kCols; ++k)
    if (k < n) mine = fmaf(prod[2 * G::kColsPad + k] + prod[k] * 0.5f, pk[k], mine);
  float sum8 = tid < PH ? mine : 0.f;
  if (tid < n) {
    const float y3 = prod[tid], y4 = prod[G::kColsPad + tid];
    const float y5 = prod[2 * G::kColsPad + tid] + prod[tid] * 0.5f;
    const float y6 = prod[3 * G::kColsPad + tid] + prod[G::kColsPad + tid] * 0.5f;
    sum8 += ((y3 + y4) + y5) + y6;
  }
  sum8 = tt::warp_sum(sum8);
  if ((tid & 31) == 0) wsum[tid >> 5] = sum8;
  OPS_MARK(4);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  // 5. the exchange: rev partials to their columns' owners, the partial
  // sum to every rank, then the one cluster barrier
  if (tid < PH) {
    const int t = ops_owner(tid, C);
    cluster.map_shared_rank(recv, t)[rank * G::kColsPad + tid - ops_col0(t, C)] = mine;
  }
  __syncthreads();
  if (tid < C) {
    float s = 0.f;
    for (int w = 0; w < G::kThreads / 32; ++w) s += wsum[w];
    cluster.map_shared_rank(sig, tid)[rank] = s;
  }
  cluster.sync();
  OPS_MARK(5);

  // 6. s from the ranks' partial sums in rank order, the same on every
  // rank; the loop with a carried value stays a loop
  float total = 0.f;
  for (int q = 0; q < C; ++q) total += sig[q];
  float s = 0.f;
#pragma unroll 1
  for (int trip = 0; trip < 4; ++trip) s = __fadd_rn(s, __fmul_rn(total, 1e-9f));
  // 7. this rank's columns of every row
  for (int e = tid; e < (PF + 8) * n; e += G::kThreads) {
    const int i = e / n, j = e % n;
    float y = 0.f;
    if (i == 7) {
      for (int q = 0; q < C; ++q) y += recv[q * G::kColsPad + j];
    } else {
      if (i >= 3 && i < PF + 3) y = prod[(i - 3) * G::kColsPad + j];
      if (i >= 5 && i < PF + 5) y = y + prod[(i - 5) * G::kColsPad + j] * 0.5f;
    }
    out[(size_t)i * PH + c0 + j] = y + s;
  }
  OPS_MARK(6);
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

// Launch `kern` on `blocks` blocks of `threads` threads in clusters of
// `cluster` (non-portable sizes allowed), with `smem` bytes of dynamic
// shared memory opted in. Returns the CUDA error of the attributes or of
// the launch, 0 on success.
template <typename... Params, typename... Args>
int launch_clusters(void (*kern)(Params...), int blocks, int threads, int cluster, int smem,
                    void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, args...);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported to the caller; leave no error behind for the next call
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// spec (64, 256), d (275, 256), p (275, 275), out (72, 275), f32 on the
// device; spec and d 16-byte aligned. One cluster of kOpsCluster blocks.
extern "C" int tt_probe_ops(const float* spec, const float* d, const float* p, float* out,
                            void* stream) {
  using G = OpsGeom<kOpsCluster>;
  return launch_clusters(probe_ops_kernel<kOpsCluster>, kOpsCluster, G::kThreads, kOpsCluster,
                         G::kBytes, stream, spec, d, p, out);
}

// `clusters` clusters of `cluster` blocks (1..16; 16 non-portable), each
// block running n cluster barriers. Returns the CUDA error of the
// attributes or of the launch, 0 on success.
extern "C" int tt_probe_cluster_barrier(int clusters, int cluster, int n, void* stream) {
  if (clusters < 1 || cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  return launch_clusters(probe_cluster_barrier_kernel, clusters * cluster, kBarrierThreads,
                         cluster, kBarrierSmem, stream, n);
}

// An empty kernel on `blocks` blocks of `threads` threads with `smem` bytes
// of dynamic shared memory, in clusters of `cluster` (1..16; blocks a
// multiple of it). Returns the CUDA error of the launch, 0 on success.
extern "C" int tt_probe_empty(int blocks, int threads, int cluster, int smem, void* stream) {
  if (blocks < 1 || cluster < 1 || cluster > kMaxCluster || blocks % cluster)
    return (int)cudaErrorInvalidValue;
  return launch_clusters(probe_empty_kernel, blocks, threads, cluster, smem, stream);
}

#ifdef TT_PROBE_PHASE_CLOCK
// The last ops launch's phase clock -> host (kOpsClockBlocks x kOpsMarks).
extern "C" int tt_probe_ops_clock(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_ops_clock, sizeof(g_ops_clock));
}
#endif

// The runtime's name and description of a CUDA error code.
extern "C" const char* tt_probe_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
extern "C" const char* tt_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
