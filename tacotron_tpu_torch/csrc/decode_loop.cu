// Fused feed-previous Tacotron decode: every decoder step in ONE launch.
//
// Replaces the TPU kernel tacotron_tpu/ops/pallas/decode_loop.py
// (_make_kernel, launched by decode_loop). Each step: prenet (+ dropout),
// attention GRU, Bahdanau energy, masked softmax, context, input
// projection, two residual GRUs and the r-frame projection; frames and
// alignments stream out to global memory every step.
//
// What bounds it on an H100: the steps form a serial chain, and each step
// is a chain of dependent matrix-vector products over ~1.57 M decoder
// weights (3.1 MB in bf16). That is too big for one SM's 227 KB of shared
// memory, so the weights are read from global memory every step; after the
// first step they are served by the 50 MB L2. The step is bound by the L2's
// latency and by the share of L2 bandwidth that the SMs reading it get:
// FLOPs and HBM bytes are far below the card's rates.
//
// Design: each batch row runs on one thread-block cluster of C blocks (C =
// 1, 2, 4, 8 or 16; the wrapper picks the largest C for which all B
// clusters are resident at once), one block per SM, walking all steps.
// The TPU kernel steps a tile of rows in one core; this one spreads one row
// over C SMs, because SMs are what the H100 has in excess at small B.
// Every block keeps its own full copy of the row's state and the step's
// vectors in f32 shared memory. Each phase of a step is split over the
// cluster: the block of rank r computes its slice of the phase's outputs
// (output units of a product, encoder positions of the energy, memory
// columns of the context) and pushes each output into every block's copy
// through distributed shared memory; one cluster barrier follows, then
// every block stages its own rounded product inputs from its copy. The
// softmax and the GRU state updates are not split: every block computes
// them whole, from bit-equal inputs in the same order, so the copies stay
// bit-equal. 13 cluster barriers per step. A cluster of 1 is one block per
// row, the same work in the same order.
//
// Products are warp-per-output dot products over the weight row (PyTorch
// (out, in) layout, 16-byte vector loads, f32 accumulation, shuffle
// reduction), the same in every block whatever C is. Storage T is bf16
// (lowp) or f32; the TPU kernel's rounding points are kept: dot inputs are
// rounded to T, the energy is tanh(keys + q) in T, the v-contraction is
// f32, the context product is formed in T and summed in f32. Dropout uses
// a counter-based hash keyed by (seed, row, step, layer, unit), evaluated
// by the unit's owner: keep iff bits < keep * 2^32, scaled by 1/keep; so
// the masks do not depend on C. The seed is an int64 in device memory, of
// which every block reads the low 32 bits once: a caller draws it on the
// device, inside a CUDA graph too, and no host read comes between.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using tt::Peers;
using tt::Slice;

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;  // non-portable above 8; one GPC at most
// The context's partial sums: at most 32 parts of the positions per column
// (one warp adds them), each thread's of up to 8 columns (a bf16 vector)
constexpr int kMaxParts = 32;
constexpr int kPartVec = 8;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Built with -DTT_DECODE_PHASE_CLOCK (scripts/k3_study.py), thread 0
// of block 0 (row 0, rank 0) adds up the SM clock spent in each phase of
// every step, waits at the phase's barrier included, into kPhases
// counters that tt_decode_loop_phase_cycles reads back. Otherwise the
// marks compile to nothing.
constexpr int kPhases = 14;
#ifdef TT_DECODE_PHASE_CLOCK
__device__ unsigned long long g_phase_cycles[kPhases];
#define PHASE_MARK(k)                                            \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                     \
    const long long now = clock64();                             \
    phase_cycles[k] += (unsigned long long)(now - phase_last);   \
    phase_last = now;                                            \
  }
#else
#define PHASE_MARK(k)
#endif
enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3 };

template <typename T> struct DecW {
  const T *p_w0, *p_b0, *p_w1, *p_b1;
  const T *ag_wg, *ag_bg, *ag_wc, *ag_bc;
  const T *at_wq, *at_v;
  const T *ip_w, *ip_b;
  const T *d0_wg, *d0_bg, *d0_wc, *d0_bc;
  const T *d1_wg, *d1_bg, *d1_wc, *d1_bc;
  const T *f_w, *f_b;
};

struct Dims {
  int B, T, M, A, NM, R, P0, P1, AG, D, n_steps;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16; h *= 0x85ebca6bu; h ^= h >> 13; h *= 0xc2b2ae35u; h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t row,
                                                 uint32_t step, uint32_t layer,
                                                 uint32_t unit) {
  uint32_t h = fmix32(seed + 0x9e3779b9u);
  h = fmix32(h ^ (row * 0x85ebca6bu));
  h = fmix32(h ^ (step * 0xc2b2ae35u));
  return fmix32(h ^ ((layer << 20) ^ unit));
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu: return fmaxf(x, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-x));
    case kTanh: return tanhf(x);
    default: return x;
  }
}

// act(sum_i x[i] * W[o][i] + b[o]) for the outputs o in [lo, hi); x is
// already rounded to the storage type. One warp per output; each warp works
// on U outputs at once so that U weight loads are in flight together (the
// product is bound by L2 latency, not by arithmetic). epi(o, y, lane) is
// called by all 32 lanes of the output's warp.
template <typename T, typename Epi>
__device__ __forceinline__ void matvec(const T* __restrict__ W, const T* __restrict__ bias,
                                       int K, Slice s, const float* x, int act, Epi epi) {
  constexpr int V = tt::Vec<T>::V;
  constexpr int U = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool vec = (K % V) == 0;
  for (int o0 = s.lo + warp; o0 < s.hi; o0 += nwarps * U) {
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.f;
    if (vec) {
      for (int i = lane * V; i < K; i += 32 * V) {
        float wv[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int o = o0 + u * nwarps;
          if (o < s.hi) {
            tt::Vec<T>::load(W + (size_t)o * K + i, wv[u]);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) wv[u][j] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xv = x[i + j];
#pragma unroll
          for (int u = 0; u < U; ++u) acc[u] = fmaf(wv[u][j], xv, acc[u]);
        }
      }
    } else {
      for (int i = lane; i < K; i += 32) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int o = o0 + u * nwarps;
          const float wv = o < s.hi ? tt::to_f32(W[(size_t)o * K + i]) : 0.f;
          acc[u] = fmaf(wv, x[i], acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int o = o0 + u * nwarps;
      const float v = tt::warp_sum(acc[u]);
      if (o < s.hi) epi(o, activate(v + (bias ? tt::to_f32(bias[o]) : 0.f), act), lane);
    }
  }
}

// dst[i] = round_to<T>(src[i]) for i < n
template <typename T>
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = tt::round_to<T>(src[i]);
}

// The context columns [VV g.lo, VV g.hi) (g: groups of VV columns; VV is
// the vector width, or 1 where M is not a multiple of it): sum_t
// round(round(al[t]) * mem[t][m]) in f32. Threads take (group, part of the
// positions); the parts' sums go through part, and one warp adds a
// column's parts in a fixed shuffle order and pushes the column.
template <typename T, int VV>
__device__ __forceinline__ void context(const T* __restrict__ mem, const float* al, int Tn,
                                        int M, Slice g, float* part, float* ctx,
                                        const Peers& pe) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nvec = g.hi - g.lo, width = nvec * VV;
  const int ntp = nvec > 0 ? max(1, min(kMaxParts, (int)blockDim.x / nvec)) : 0;
  for (int it = threadIdx.x; it < nvec * ntp; it += blockDim.x) {
    const int vi = it % nvec, tp = it / nvec;
    const int m0 = (g.lo + vi) * VV;
    float acc[VV];
#pragma unroll
    for (int j = 0; j < VV; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int t = tp; t < Tn; t += ntp) {
      float mv[VV];
      if constexpr (VV == 1) {
        mv[0] = tt::to_f32(mem[(size_t)t * M + m0]);
      } else {
        tt::Vec<T>::load(mem + (size_t)t * M + m0, mv);
      }
      const float a = tt::round_to<T>(al[t]);
#pragma unroll
      for (int j = 0; j < VV; ++j) acc[j] += tt::round_to<T>(a * mv[j]);
    }
#pragma unroll
    for (int j = 0; j < VV; ++j) part[tp * width + vi * VV + j] = acc[j];
  }
  __syncthreads();
  for (int e = warp; e < width; e += nwarps) {
    float s = 0.f;
    for (int tp = lane; tp < ntp; tp += 32) s += part[tp * width + e];
    pe.push(ctx, g.lo * VV + e, tt::warp_sum(s), lane);
  }
}

// Shared memory, in floats, in this order. The state (prev .. hs) comes
// first, zeroed at the start.
struct Layout {
  int NM, P0, P1, AG, M, D, KI, HD, A, T, part;
  __host__ __device__ explicit Layout(const Dims& d)
      : NM(d.NM), P0(d.P0), P1(d.P1), AG(d.AG), M(d.M), D(d.D),
        KI(imax(imax(d.NM, d.P0), imax(d.P1 + d.M + d.AG, imax(d.AG + d.M, 2 * d.D)))),
        HD(imax(d.AG, d.D)), A(d.A), T(d.T),
        // parts x columns: at most one thread's vector each, or all M
        // columns in one part where there are more than threads
        part(imax(kThreads * kPartVec, d.M)) {}
  __host__ __device__ int state() const { return NM + P0 + P1 + AG + M + 3 * D; }
  __host__ __device__ int floats() const {
    return state() + KI + 2 * HD + 2 * D + HD + A + T + A + part;
  }
  // floats, then the keep counters: one of this block's, one per rank
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * floats() + sizeof(int) * (1 + kMaxCluster);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
decode_loop_kernel(const T* __restrict__ memory, const T* __restrict__ keys,
                   const float* __restrict__ maskbias, DecW<T> w, Dims dm,
                   const long long* __restrict__ seed_ptr, uint32_t keep_threshold,
                   float keep_scale,
                   int dropout, float* __restrict__ frames,
                   float* __restrict__ aligns, int* __restrict__ keep_counts) {
  constexpr int V = tt::Vec<T>::V;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int Tn = dm.T, M = dm.M, A = dm.A, NM = dm.NM;
  const int P0 = dm.P0, P1 = dm.P1, AG = dm.AG, D = dm.D;
  const int RN = dm.R * NM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const Layout L(dm);
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);

  // Buffers and their writers. "pushed": every block's copy is written by
  // the owners of its slices in one phase, and read by every block after
  // that phase's cluster barrier; "local": each block writes its own copy.
  // A pushed buffer's next push comes at least one cluster barrier after
  // its last read (checked phase by phase below), so one barrier per phase
  // is enough. The two GRU gate buffers alternate (ruA: attention GRU and
  // decoder GRU 1; ruB: decoder GRU 0) because decoder GRU 1's gates are
  // pushed in the phase whose staging still reads decoder GRU 0's update
  // gate.
  extern __shared__ float smem[];
  float* prev = smem;                // NM  pushed, phase 14; read phase 1
  float* x0 = prev + NM;             // P0  pushed, phase 1; read phase 2
  float* x1 = x0 + P0;               // P1  pushed, phase 2; read phase 3
  float* h_att = x1 + P1;            // AG  local, phase 5; read 3, 4, 5, 9
  float* ctx = h_att + AG;           // M   pushed, phase 8; read 9, 3 (next step)
  float* h0 = ctx + M;               // D   local, phase 12; read 10, 11, 12
  float* h1 = h0 + D;                // D   local, phase 14; read 12, 13, 14
  float* hs = h1 + D;                // D   pushed, phase 9; local 12, 14; read 10, 12, 14
  float* inb = hs + D;               // KI  local: each phase's rounded product inputs
  float* ruA = inb + L.KI;           // 2HD pushed, phases 3, 12; read 4, 5, 13, 14
  float* ruB = ruA + 2 * L.HD;       // 2D  pushed, phase 10; read 11, 12
  float* cand = ruB + 2 * D;         // HD  pushed, phases 4, 11, 13; read 5, 12, 14
  float* q = cand + L.HD;            // A   pushed, phase 5; read 6
  float* sc = q + A;                 // T   pushed, phase 6; softmax in place (local) 7; read 8
  float* vv = sc + Tn;               // A   the energy vector in f32, constant
  float* part = vv + A;              // context partial sums, local, phase 8
  int* kc = reinterpret_cast<int*>(part + L.part);  // this block's keep count
  int* kc_rank = kc + 1;             // rank 0's: pushed phase 3, read phase 14

  Peers pe{smem, cluster.map_shared_rank(smem, lane < C ? lane : 0), C};
  auto push_to = [&](float* buf) {
    return [&pe, buf](int o, float y, int ln) { pe.push(buf, o, y, ln); };
  };
  auto drop = [&](int step, int layer, float* buf) {
    return [=, &pe](int o, float y, int ln) {
      if (dropout) {
        const bool keep = dropout_bits(seed, row, step, layer, o) < keep_threshold;
        y = keep ? y * keep_scale : 0.f;
        if (keep_counts && keep && ln == 0) atomicAdd(kc, 1);
      }
      pe.push(buf, o, y, ln);
    };
  };

  for (int i = threadIdx.x; i < L.state(); i += blockDim.x) smem[i] = 0.f;
  for (int i = threadIdx.x; i < A; i += blockDim.x) vv[i] = tt::to_f32(w.at_v[i]);
#ifdef TT_DECODE_PHASE_CLOCK
  __shared__ unsigned long long phase_cycles[kPhases];
  long long phase_last = 0;
  if (threadIdx.x < kPhases) phase_cycles[threadIdx.x] = 0;
#endif
  // every block of the cluster has started and zeroed its state before any
  // block pushes into it
  cluster.sync();
#ifdef TT_DECODE_PHASE_CLOCK
  phase_last = clock64();
#endif

  for (int step = 0; step < dm.n_steps; ++step) {
    // 1. prenet layer 0: Dense + ReLU + dropout, split by output unit
    if (threadIdx.x == 0) *kc = 0;
    stage<T>(inb, prev, NM);
    __syncthreads();
    matvec<T>(w.p_w0, w.p_b0, NM, Slice(P0, C, rank), inb, kRelu, drop(step, 0, x0));
    cluster.sync();
    PHASE_MARK(0);
    // 2. prenet layer 1
    stage<T>(inb, x0, P0);
    __syncthreads();
    matvec<T>(w.p_w1, w.p_b1, P0, Slice(P1, C, rank), inb, kRelu, drop(step, 1, x1));
    cluster.sync();
    PHASE_MARK(1);

    // 3. attention GRU gates on [prenet out, previous context, h_att]; this
    // block's keep count goes to rank 0
    if (keep_counts && threadIdx.x == 0) *cluster.map_shared_rank(kc_rank + rank, 0) = *kc;
    const int KA = P1 + M;
    stage<T>(inb, x1, P1);
    stage<T>(inb + P1, ctx, M);
    stage<T>(inb + KA, h_att, AG);
    __syncthreads();
    matvec<T>(w.ag_wg, w.ag_bg, KA + AG, Slice(2 * AG, C, rank), inb, kSigmoid, push_to(ruA));
    cluster.sync();
    PHASE_MARK(2);
    // 4. attention GRU candidate on [x, r * h_att]
    for (int i = threadIdx.x; i < AG; i += blockDim.x)
      inb[KA + i] = tt::round_to<T>(ruA[i] * h_att[i]);
    __syncthreads();
    matvec<T>(w.ag_wc, w.ag_bc, KA + AG, Slice(AG, C, rank), inb, kTanh, push_to(cand));
    cluster.sync();
    PHASE_MARK(3);
    // 5. h_att = u * h_att + (1 - u) * cand in every block; the query
    for (int i = threadIdx.x; i < AG; i += blockDim.x) {
      const float u = ruA[AG + i];
      h_att[i] = u * h_att[i] + (1.f - u) * cand[i];
      inb[i] = tt::round_to<T>(h_att[i]);
    }
    __syncthreads();
    matvec<T>(w.at_wq, (const T*)nullptr, AG, Slice(A, C, rank), inb, kNone, push_to(q));
    cluster.sync();
    PHASE_MARK(4);

    // 6. Bahdanau energy, split by encoder position: one warp per position
    {
      const Slice s(Tn, C, rank);
      for (int t = s.lo + warp; t < s.hi; t += nwarps) {
        const T* k = keys + ((size_t)row * Tn + t) * A;
        float acc = 0.f;
        if (A % V == 0) {
          for (int i = lane * V; i < A; i += 32 * V) {
            float kv[V];
            tt::Vec<T>::load(k + i, kv);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              float e = tt::round_to<T>(kv[j] + tt::round_to<T>(q[i + j]));
              acc = fmaf(tt::round_to<T>(tanhf(e)), vv[i + j], acc);
            }
          }
        } else {
          for (int i = lane; i < A; i += 32) {
            float e = tt::round_to<T>(tt::to_f32(k[i]) + tt::round_to<T>(q[i]));
            acc = fmaf(tt::round_to<T>(tanhf(e)), vv[i], acc);
          }
        }
        acc = tt::warp_sum(acc);
        pe.push(sc, t, acc + maskbias[(size_t)row * Tn + t], lane);
      }
    }
    cluster.sync();
    PHASE_MARK(5);
    // 7. masked softmax over all positions, whole in every block; rank 0
    // writes the alignment row
    if (warp == 0) {
      float mx = __int_as_float(0xff800000);  // -inf
      for (int t = lane; t < Tn; t += 32) mx = fmaxf(mx, sc[t]);
      mx = tt::warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < Tn; t += 32) {
        float e = expf(sc[t] - mx);
        sc[t] = e;
        sum += e;
      }
      sum = tt::warp_sum(sum);
      float* ao = aligns + ((size_t)row * dm.n_steps + step) * Tn;
      for (int t = lane; t < Tn; t += 32) {
        float a = sc[t] / sum;
        sc[t] = a;
        if (rank == 0) ao[t] = a;
      }
    }
    __syncthreads();
    PHASE_MARK(6);
    // 8. context, split by memory column
    {
      const T* mem = memory + (size_t)row * Tn * M;
      if (M % V == 0)
        context<T, V>(mem, sc, Tn, M, Slice(M / V, C, rank), part, ctx, pe);
      else
        context<T, 1>(mem, sc, Tn, M, Slice(M, C, rank), part, ctx, pe);
    }
    cluster.sync();
    PHASE_MARK(7);

    // 9. input projection of [h_att, context]: the residual stream
    stage<T>(inb, h_att, AG);
    stage<T>(inb + AG, ctx, M);
    __syncthreads();
    matvec<T>(w.ip_w, w.ip_b, AG + M, Slice(D, C, rank), inb, kNone, push_to(hs));
    cluster.sync();
    PHASE_MARK(8);
    // 10. decoder GRU 0 gates on [hs, h0]
    stage<T>(inb, hs, D);
    stage<T>(inb + D, h0, D);
    __syncthreads();
    matvec<T>(w.d0_wg, w.d0_bg, 2 * D, Slice(2 * D, C, rank), inb, kSigmoid, push_to(ruB));
    cluster.sync();
    PHASE_MARK(9);
    // 11. decoder GRU 0 candidate
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      inb[D + i] = tt::round_to<T>(ruB[i] * h0[i]);
    __syncthreads();
    matvec<T>(w.d0_wc, w.d0_bc, 2 * D, Slice(D, C, rank), inb, kTanh, push_to(cand));
    cluster.sync();
    PHASE_MARK(10);
    // 12. h0 update, hs += h0; decoder GRU 1 gates on [hs, h1]
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float u = ruB[D + i];
      h0[i] = u * h0[i] + (1.f - u) * cand[i];
      hs[i] += h0[i];
      inb[i] = tt::round_to<T>(hs[i]);
      inb[D + i] = tt::round_to<T>(h1[i]);
    }
    __syncthreads();
    matvec<T>(w.d1_wg, w.d1_bg, 2 * D, Slice(2 * D, C, rank), inb, kSigmoid, push_to(ruA));
    cluster.sync();
    PHASE_MARK(11);
    // 13. decoder GRU 1 candidate
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      inb[D + i] = tt::round_to<T>(ruA[i] * h1[i]);
    __syncthreads();
    matvec<T>(w.d1_wc, w.d1_bc, 2 * D, Slice(D, C, rank), inb, kTanh, push_to(cand));
    cluster.sync();
    PHASE_MARK(12);
    // 14. h1 update, hs += h1; the r-frame projection: the owner writes the
    // frame, and the last frame feeds the next step
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float u = ruA[D + i];
      h1[i] = u * h1[i] + (1.f - u) * cand[i];
      hs[i] += h1[i];
      inb[i] = tt::round_to<T>(hs[i]);
    }
    __syncthreads();
    float* fo = frames + ((size_t)row * dm.n_steps + step) * RN;
    matvec<T>(w.f_w, w.f_b, D, Slice(RN, C, rank), inb, kNone,
              [&](int o, float y, int ln) {
                if (ln == 0) fo[o] = y;
                if (o >= RN - NM) pe.push(prev, o - (RN - NM), y, ln);
              });
    if (keep_counts && rank == 0 && threadIdx.x == 0) {
      int n = 0;
      for (int r = 0; r < C; ++r) n += kc_rank[r];
      keep_counts[(size_t)row * dm.n_steps + step] = n;
    }
    // also the last: no block leaves while a peer may still push into it
    cluster.sync();
    PHASE_MARK(13);
  }
#ifdef TT_DECODE_PHASE_CLOCK
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int k = 0; k < kPhases; ++k) g_phase_cycles[k] = phase_cycles[k];
#endif
}

template <typename T>
cudaError_t configure(size_t smem) {
  auto kern = decode_loop_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t launch_config(int blocks, int cluster, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
cudaError_t launch(const void* memory, const void* keys, const float* maskbias,
                   const void* const* wp, const Dims& d, int cluster, const long long* seed,
                   uint32_t keep_threshold, float keep_scale, int dropout,
                   float* frames, float* aligns, int* keep_counts,
                   cudaStream_t stream) {
  DecW<T> w;
  const T** f = reinterpret_cast<const T**>(&w);
  for (int i = 0; i < 22; ++i) f[i] = static_cast<const T*>(wp[i]);
  const size_t smem = Layout(d).bytes();
  cudaError_t err = configure<T>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(d.B * cluster, cluster, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, decode_loop_kernel<T>, static_cast<const T*>(memory),
                           static_cast<const T*>(keys), maskbias, w, d, seed,
                           keep_threshold, keep_scale, dropout, frames, aligns,
                           keep_counts);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t resident(const Dims& d, int cluster, int* out) {
  const size_t smem = Layout(d).bytes();
  cudaError_t err = configure<T>(smem);
  if (err != cudaSuccess) return err;
  if (cluster == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_loop_kernel<T>,
                                                          kThreads, smem);
    *out = sms * per_sm;
    return err;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, cluster, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, decode_loop_kernel<T>, &cfg);
}

Dims dims_of(const int* dims) {
  return Dims{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
              dims[6], dims[7], dims[8], dims[9], dims[10]};
}

}  // namespace

// dims: B, T_in, mem_dim, att_dim, n_mels, r, prenet0, prenet1,
// att_gru_dim, dec_gru_dim, n_steps. weights: the 22 DecoderWeights device
// pointers in field order. cluster: blocks per batch row, 1..16 (B x
// cluster blocks). seed: one int64 in device memory (its low 32 bits key
// the dropout hash). keep_counts may be null. Returns the CUDA error; a
// cluster size the card cannot place is refused by the launch.
extern "C" int tt_decode_loop(const void* memory, const void* keys,
                              const float* maskbias, const void* const* weights,
                              const int* dims, int lowp, int cluster,
                              const long long* seed, unsigned int keep_threshold,
                              float keep_scale, int dropout, float* frames,
                              float* aligns, int* keep_counts, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  const Dims d = dims_of(dims);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = lowp
      ? launch<__nv_bfloat16>(memory, keys, maskbias, weights, d, cluster, seed,
                              keep_threshold, keep_scale, dropout, frames, aligns,
                              keep_counts, s)
      : launch<float>(memory, keys, maskbias, weights, d, cluster, seed, keep_threshold,
                      keep_scale, dropout, frames, aligns, keep_counts, s);
  return (int)err;
}

// The dynamic shared memory one block of a launch needs, for the wrapper's
// check against the device limit (the same whatever the cluster size).
extern "C" long long tt_decode_loop_smem(const int* dims) {
  return (long long)Layout(dims_of(dims)).bytes();
}

// How many clusters of `cluster` blocks of this kernel the current device
// can hold at once (cudaOccupancyMaxActiveClusters; for 1, blocks per SM x
// SMs), written to *out. Returns the CUDA error.
extern "C" int tt_decode_loop_resident(const int* dims, int lowp, int cluster, int* out) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  const Dims d = dims_of(dims);
  return (int)(lowp ? resident<__nv_bfloat16>(d, cluster, out)
                    : resident<float>(d, cluster, out));
}

#ifdef TT_DECODE_PHASE_CLOCK
// The phase clock of the last launch, kPhases counters of SM cycles.
extern "C" int tt_decode_loop_phase_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
}
#endif
