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
// single-rounding fma can flip a bf16 result. tanhf is the accurate libm
// version (no fast-math, no tanh.approx), so the kernels agree with
// PyTorch's tanh to a few ulp and round the tanh to bf16 as it does.
//
// What bounds it on an H100. Bytes, by the count: a few operations per
// element moved, far below the ~20 flops per byte at which f32 arithmetic
// would be the limit. At the training path's shapes (B 32, T_in 128, A 256)
// keys is 4.2 MB in f32 and 2.1 MB in bf16, so K1 needs ~1.3 us (f32) or
// ~0.64 us (bf16) of memory time and K2 (keys in, dkeys out) ~2.5 or ~1.3
// us. In practice keys sits in L2 on the training path, and what takes the
// time is the issue of ~30-35 instructions an element (the accurate tanh,
// in bf16 its roundings) over ~8 K elements an SM, and in K2 the chain of
// latencies after it (a cluster barrier, the ticket, the dv sum):
// scripts/energy_study.py's phase clock. The design keeps every load of a
// warp in flight at once, every sum on chip, and one launch.
//
// Layout shared by both kernels: one warp spans a chunk of 256 columns of
// A; a lane owns 8 columns of the chunk, one 16-byte group in bf16 (columns
// 8 l .. 8 l + 7) or two in f32 (4 l .. 4 l + 3 and 128 + 4 l ..), loaded
// with 16-byte loads (the scalar path, for A not a multiple of the group or
// unaligned pointers, loads them one by one). q[b, .] and v are loaded into
// registers once per chunk and serve every row the warp takes. Wider A
// walks more chunks.
//
// K1: a block of 8 warps takes 8 R consecutive rows t of one batch row b,
// R per warp (2 in bf16, 1 in f32); each lane issues the R rows' loads
// before any tanh, keeps a partial sum per row, and the warp reduces its R
// rows at once with a multi-row butterfly (log2 R exchange levels that
// halve the rows a lane holds, then plain ones: 5 shuffles for 2 rows, not
// 10) and stores them with one instruction.
//
// K2, one launch: one thread-block cluster of C blocks (C 1, 2, 4 or 8) per
// batch row b; block `rank` takes rows [rank * rows, (rank + 1) * rows) of
// that batch row, its warp w the rows t0 + w, t0 + w + 8, ... in order,
// loading 2 rows before computing either. dq and dv partials stay in
// registers, then are summed over the 8 warps in order through shared
// memory, and each block pushes its sums into rank 0's shared memory
// (distributed shared memory; a split cluster barrier from the kernel's
// start makes sure every block runs first). After one cluster barrier rank
// 0 sums them in rank order, rounds and writes dq[b], and writes the row's
// f32 dv partial to scratch (B x A); the other blocks leave, since nothing
// reads their shared memory. Rank 0 then takes a ticket from a counter (one
// int per device, kept by the wrapper; atom.inc wraps it back to 0 at each
// call's last ticket), with release and acquire. The cluster that draws the
// last ticket sums the B partials in the order b = 0 .. B - 1 and writes
// dv: the bits do not depend on which cluster came last, there are no float
// atomics, and no block waits on another cluster, so any B runs. The
// wrapper runs on one stream: two calls that overlap would share the
// counter.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#ifdef TT_ENERGY_PHASE_CLOCK
// K2's phase clock (scripts/energy_study.py): per block, %globaltimer (ns)
// at each mark; thread 0 of the block writes it.
constexpr int kMarks = 8, kMaxClockBlocks = 1024;
__device__ unsigned long long g_energy_clock[kMaxClockBlocks][kMarks];
#define ENERGY_MARK(k)                                                          \
  if (threadIdx.x == 0 && blockIdx.x < kMaxClockBlocks) {                       \
    unsigned long long ns;                                                      \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                      \
    g_energy_clock[blockIdx.x][k] = ns;                                         \
  }
#else
#define ENERGY_MARK(k)
#endif

namespace {

using tt::ticket_acq_rel;

constexpr int kCols = 8;                  // columns a lane owns in a chunk
constexpr int kChunk = 32 * kCols;        // columns a warp spans
constexpr int kWarps = 8, kThreads = kWarps * 32;              // K1 block
// K1 rows per warp: 2 in bf16, 1 in f32 (in f32 the 8 warps' loads already
// cover the latency; more rows per warp only lengthen each warp's chain)
template <typename S> constexpr int kFwdRows = sizeof(S) == 2 ? 2 : 1;
constexpr int kBwdWarps = 8, kBwdThreads = kBwdWarps * 32;     // K2 block
constexpr int kBwdBatch = 2;              // K2 rows whose loads go out together
                                          // (2: 80 registers, 3 blocks an SM)
constexpr int kTailBatch = 32;            // dv rows whose loads go out together
constexpr int kMaxCluster = 8;            // portable

// Column (within its chunk) of a lane's j-th value: groups of V = 16 bytes
// of S, group g at g * 32 V + lane V.
template <typename S>
__device__ __forceinline__ int col_of(int lane, int j) {
  constexpr int V = tt::Vec<S>::V;
  return (j / V) * (32 * V) + lane * V + j % V;
}

// The kCols values of row[] at a lane's columns of the chunk at c0, in S's
// layout; X is the data's type (S, or float for v). Columns at or past A
// read as 0, which adds nothing to any sum below.
template <typename S, typename X, bool VEC>
__device__ __forceinline__ void load_cols(const X* __restrict__ row, int c0, int A, int lane,
                                          float (&out)[kCols]) {
  constexpr int V = tt::Vec<S>::V, P = tt::Vec<X>::V;
#pragma unroll
  for (int g = 0; g < kCols / V; ++g) {
    const int c = c0 + g * 32 * V + lane * V;
#pragma unroll
    for (int i = 0; i < V; i += P) {
      float* o = out + g * V + i;
      if (VEC) {
        if (c < A) {
          tt::Vec<X>::load(row + c + i, o);
        } else {
#pragma unroll
          for (int k = 0; k < P; ++k) o[k] = 0.f;
        }
      } else {
#pragma unroll
        for (int k = 0; k < P; ++k) o[k] = c + i + k < A ? tt::to_f32(row[c + i + k]) : 0.f;
      }
    }
  }
}

// Store a lane's kCols values into row[] at its columns of the chunk at c0.
template <typename S, bool VEC>
__device__ __forceinline__ void store_cols(S* __restrict__ row, int c0, int A, int lane,
                                           const float (&w)[kCols]) {
  constexpr int V = tt::Vec<S>::V;
#pragma unroll
  for (int g = 0; g < kCols / V; ++g) {
    const int c = c0 + g * 32 * V + lane * V;
    if (VEC) {
      if (c < A) tt::Vec<S>::store(row + c, w + g * V);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (c + i < A) row[c + i] = tt::to_storage<S>(w[g * V + i]);
    }
  }
}

// tanh(k + q) of two neighbouring columns, the sum and the result each
// rounded to S (in bf16 two values per conversion instruction)
template <typename S> __device__ __forceinline__ float2 act2(float2 k, float2 q);
template <> __device__ __forceinline__ float2 act2<float>(float2 k, float2 q) {
  return make_float2(tanhf(k.x + q.x), tanhf(k.y + q.y));
}
template <> __device__ __forceinline__ float2 act2<__nv_bfloat16>(float2 k, float2 q) {
  const float2 s = __bfloat1622float2(__float22bfloat162_rn(make_float2(k.x + q.x, k.y + q.y)));
  return __bfloat1622float2(__float22bfloat162_rn(make_float2(tanhf(s.x), tanhf(s.y))));
}

// Each lane holds partials p[0..R) of R rows (R a power of 2 <= 32); returns
// the whole warp's sum of row lane / (32 / R). Exchange levels at lane
// offsets 16, 8, ... halve the rows a lane holds (the lane with the offset's
// bit keeps the upper half and sends the lower); plain levels finish. Every
// add joins the partials of lanes l and l ^ o, so each row's sum is the
// same tree as a plain xor butterfly with offsets 16, 8, 4, 2, 1.
template <int R>
__device__ __forceinline__ float rows_sum(float (&p)[R], int lane) {
#pragma unroll
  for (int n = R, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? p[i] : p[i + n / 2];
      const float keep = upper ? p[i + n / 2] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float s = p[0];
#pragma unroll
  for (int o = 16 / R; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename S, bool VEC>
__global__ void __launch_bounds__(kThreads)
energy_fwd(const S* __restrict__ keys, const S* __restrict__ q,
           const float* __restrict__ v, float* __restrict__ e, int T, int A,
           int blocks_per_row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / blocks_per_row;
  constexpr int R = kFwdRows<S>;
  const int t0 = (blockIdx.x % blocks_per_row) * (kWarps * R) + warp * R;
  const S* kb = keys + (size_t)b * T * A;
  float p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) p[r] = 0.f;
  for (int c0 = 0; c0 < A; c0 += kChunk) {
    float qq[kCols], vv[kCols], kk[R][kCols];
    load_cols<S, S, VEC>(q + (size_t)b * A, c0, A, lane, qq);
    load_cols<S, float, VEC>(v, c0, A, lane, vv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (t0 + r < T) {
        load_cols<S, S, VEC>(kb + (size_t)(t0 + r) * A, c0, A, lane, kk[r]);
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) kk[r][j] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < kCols; j += 2) {
        const float2 th = act2<S>(make_float2(kk[r][j], kk[r][j + 1]),
                                  make_float2(qq[j], qq[j + 1]));
        p[r] = fmaf(vv[j], th.x, p[r]);
        p[r] = fmaf(vv[j + 1], th.y, p[r]);
      }
  }
  const float s = rows_sum<R>(p, lane);
  constexpr int kLanesPerRow = 32 / R;
  const int t = t0 + lane / kLanesPerRow;
  if (lane % kLanesPerRow == 0 && t < T) e[(size_t)b * T + t] = s;   // one store a warp
}

template <typename S, bool VEC>
__global__ void __launch_bounds__(kBwdThreads)
energy_bwd(const S* __restrict__ keys, const S* __restrict__ q,
           const float* __restrict__ v, const float* __restrict__ de,
           S* __restrict__ dkeys, S* __restrict__ dq, float* __restrict__ dv,
           float* dv_part, unsigned* ticket, int B, int T, int A, int rows) {
  __shared__ float red[2][kBwdWarps][kChunk];   // each warp's dq, dv sums at (j, lane)
  __shared__ float recv[kMaxCluster][2 * kChunk];   // rank 0's: every rank's block sums
  __shared__ bool last;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = rank * rows, t1 = min(T, t0 + rows);
  const S* kb = keys + (size_t)b * T * A;
  S* dkb = dkeys + (size_t)b * T * A;
  const float* deb = de + (size_t)b * T;
  ENERGY_MARK(0);
  // every block of the cluster runs before any writes into rank 0's shared
  // memory: arrive now, wait just before the first push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  for (int c0 = 0; c0 < A; c0 += kChunk) {
    float qq[kCols], vv[kCols], gq[kCols], gv[kCols];
    load_cols<S, S, VEC>(q + (size_t)b * A, c0, A, lane, qq);
    load_cols<S, float, VEC>(v, c0, A, lane, vv);
#pragma unroll
    for (int j = 0; j < kCols; ++j) gq[j] = gv[j] = 0.f;
    for (int t = t0 + warp; t < t1; t += kBwdWarps * kBwdBatch) {
      float kk[kBwdBatch][kCols], d[kBwdBatch];
#pragma unroll
      for (int r = 0; r < kBwdBatch; ++r) {
        const int tr = t + r * kBwdWarps;
        if (tr < t1) {
          load_cols<S, S, VEC>(kb + (size_t)tr * A, c0, A, lane, kk[r]);
          d[r] = __ldg(deb + tr);
        }
      }
#pragma unroll
      for (int r = 0; r < kBwdBatch; ++r) {
        const int tr = t + r * kBwdWarps;
        if (tr >= t1) break;              // the same for the whole warp
        float w[kCols];
#pragma unroll
        for (int j = 0; j < kCols; j += 2) {
          const float2 th = act2<S>(make_float2(kk[r][j], kk[r][j + 1]),
                                    make_float2(qq[j], qq[j + 1]));
          const float ths[2] = {th.x, th.y};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            w[j + u] = __fmul_rn(__fmul_rn(d[r], vv[j + u]),
                                 __fsub_rn(1.f, __fmul_rn(ths[u], ths[u])));
            gq[j + u] = __fadd_rn(gq[j + u], w[j + u]);
            gv[j + u] = fmaf(ths[u], d[r], gv[j + u]);
          }
        }
        store_cols<S, VEC>(dkb + (size_t)tr * A, c0, A, lane, w);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      red[0][warp][j * 32 + lane] = gq[j];
      red[1][warp][j * 32 + lane] = gv[j];
    }
    __syncthreads();
    ENERGY_MARK(1);
    if (c0 == 0) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    // 2 kChunk sums (dq, then dv), each over the warps in order, pushed
    // into rank 0's recv[rank]
    float* to = cluster.map_shared_rank(&recv[0][0], 0) + rank * 2 * kChunk;
    for (int i = threadIdx.x; i < 2 * kChunk; i += kBwdThreads) {
      const float* x = &red[i / kChunk][0][i % kChunk];
      float s = x[0];
#pragma unroll
      for (int w = 1; w < kBwdWarps; ++w) s += x[w * kChunk];
      to[i] = s;
    }
    ENERGY_MARK(2);
    cluster.sync();                       // rank 0 holds every rank's sums
    ENERGY_MARK(3);
    if (rank == 0) {
      for (int i = threadIdx.x; i < 2 * kChunk; i += kBwdThreads) {
        float s = 0.f;
        for (int r = 0; r < C; ++r) s += recv[r][i];
        const int k = i % kChunk, c = c0 + col_of<S>(k & 31, k >> 5);
        if (c < A) {
          if (i < kChunk) dq[(size_t)b * A + c] = tt::to_storage<S>(s);
          else dv_part[(size_t)b * A + c] = s;
        }
      }
    }
    ENERGY_MARK(4);
    if (c0 + kChunk < A) cluster.sync();  // rank 0 has read recv: the next chunk's pushes
  }
  ENERGY_MARK(5);
  if (rank != 0) return;                  // nothing reads this block's shared memory
  __syncthreads();                        // the row's dv partial is written ...
  if (threadIdx.x == 0) last = ticket_acq_rel(ticket, (unsigned)(B - 1)) == (unsigned)(B - 1);
  __syncthreads();                        // ... before the ticket (release), and read after (acquire)
  ENERGY_MARK(6);
  if (!last) return;                      // the counter wrapped to 0 on this ticket
  for (int c = threadIdx.x; c < A; c += kBwdThreads) {
    float s = 0.f;
    for (int r0 = 0; r0 < B; r0 += kTailBatch) {
      float x[kTailBatch];
#pragma unroll
      for (int k = 0; k < kTailBatch; ++k)
        x[k] = r0 + k < B ? __ldcg(dv_part + (size_t)(r0 + k) * A + c) : 0.f;
#pragma unroll
      for (int k = 0; k < kTailBatch; ++k) s += x[k];   // rows past B add 0
    }
    dv[c] = s;
  }
  ENERGY_MARK(7);
}

template <typename S>
int launch_fwd(const void* keys, const void* q, const float* v, float* e, int B,
               int T, int A, int vec, cudaStream_t st) {
  constexpr int rows = kWarps * kFwdRows<S>;
  const int per_row = (T + rows - 1) / rows;
  auto kern = vec ? energy_fwd<S, true> : energy_fwd<S, false>;
  kern<<<B * per_row, kThreads, 0, st>>>(static_cast<const S*>(keys),
                                         static_cast<const S*>(q), v, e, T, A, per_row);
  return (int)cudaGetLastError();
}

cudaLaunchConfig_t bwd_config(int blocks, int cluster, cudaStream_t st,
                              cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename S>
int launch_bwd(const void* keys, const void* q, const float* v, const float* de,
               void* dkeys, void* dq, float* dv, float* dv_part, unsigned* ticket, int B,
               int T, int A, int cluster, int rows, int vec, cudaStream_t st) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = bwd_config(B * cluster, cluster, st, &attr);
  auto kern = vec ? energy_bwd<S, true> : energy_bwd<S, false>;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const S*>(keys), static_cast<const S*>(q), v, de,
      static_cast<S*>(dkeys), static_cast<S*>(dq), dv, dv_part, ticket, B, T, A, rows);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
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
// dv_part (B, A) f32 scratch; ticket one int on the device, 0 before the
// call and after it. cluster (1..8) blocks per batch row, each taking `rows`
// rows (cluster * rows >= T). vec as above, and dkeys 16-byte aligned too.
extern "C" int tt_attn_energy_bwd(const void* keys, const void* q, const float* v,
                                  const float* de, void* dkeys, void* dq, float* dv,
                                  float* dv_part, void* ticket, int B, int T, int A,
                                  int cluster, int rows, int vec, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* tk = static_cast<unsigned*>(ticket);
  return bf16 ? launch_bwd<__nv_bfloat16>(keys, q, v, de, dkeys, dq, dv, dv_part, tk, B, T,
                                          A, cluster, rows, vec, st)
              : launch_bwd<float>(keys, q, v, de, dkeys, dq, dv, dv_part, tk, B, T, A,
                                  cluster, rows, vec, st);
}

// How many clusters of `cluster` K2 blocks (16-byte path, bf16 or f32) the
// current device holds at once (cudaOccupancyMaxActiveClusters), written to
// *out. Returns the CUDA error.
extern "C" int tt_attn_energy_bwd_resident(int bf16, int cluster, int* out) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = bwd_config(cluster, cluster, nullptr, &attr);
  return (int)(bf16 ? cudaOccupancyMaxActiveClusters(out, energy_bwd<__nv_bfloat16, true>, &cfg)
                    : cudaOccupancyMaxActiveClusters(out, energy_bwd<float, true>, &cfg));
}

#ifdef TT_ENERGY_PHASE_CLOCK
// K2's phase clock of the last launch: min(blocks, kMaxClockBlocks) x kMarks
// nanoseconds.
extern "C" int tt_attn_energy_clock(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_energy_clock, sizeof(g_energy_clock));
}
#endif
