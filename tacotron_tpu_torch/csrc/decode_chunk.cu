// Feed-previous Tacotron decoder steps in f32, a chunk of them in ONE launch:
// the early-exit decode's chunk (infer/early_exit.py WhileDecode) with its
// exit rule, and the fixed-length decode's steps (models/decoder.py
// Decoder on a CUDA device).
//
// Each step is while_decoder_step's: prenet (dropout from masks drawn by
// the caller), attention GRU, query, tanh(keys + q) . v plus the 0 /
// NEG_INF mask bias, softmax, context, input projection, two residual
// GRUs and the r-frame projection. Every product input and every sum is
// f32 (no TF32). The step state (h_att, h0, h1, context, previous frame)
// is read from global memory at the start of a launch and written back at
// its end, so a decode may be cut into launches anywhere: the same steps
// give the same bits whatever the chunks.
//
// The layout is the fused decode's (csrc/decode_loop.cu, K3): each batch
// row runs on one thread-block cluster of C blocks, one block per SM; every
// block keeps its own f32 copy of the row's state and of the step's
// vectors in shared memory; each phase of a step is split over the
// cluster (output units of a product, encoder positions of the energy,
// memory columns of the context) and its outputs are pushed into every
// block's copy through distributed shared memory, one cluster barrier per
// phase (13 a step). The softmax and the GRU updates are computed whole in
// every block (the softmax by all its threads). Every sum is taken in an
// order that does not depend on C: a product's output by one warp (each
// lane's columns in order, then a butterfly), a score by one warp, a
// context column as 32 parts of the positions (each in order, then a
// butterfly), the softmax's by thread, warp and then warp order. So every
// cluster size gives the same bits. The biases, v and the row's mask bias
// sit in shared memory for the launch.
//
// What bounds a step (H100, C 8, B 8: ~45 us; scripts/decode_chunk_study.py):
// the chain of 14 dependent phases, each a cluster barrier (~0.7 us of
// wait), its inputs' staging and its warps' work; with the weights' loads
// left out a step still takes ~31 us. A warp issues every load of its (up
// to) 4 output rows' first 640 columns at once, so a phase waits for one
// L2 round trip and not one per 128 columns. Each kind of work is one
// function called from every phase that does it (not inlined): the
// kernel's code is ~100 KB instead of ~285 KB.
//
// The exit rule (early-exit mode). Every block's frames and alignments go
// straight to the step's slot. At the end of the launch each row's rank 0
// flags the row's silent steps (the frame's peak below the threshold) from
// the frames its cluster wrote, and the cluster that draws the last ticket
// of the carry's counter (atom.inc wraps it to 0, so it is 0 again after
// every launch) applies WhileDecode's rule to the steps in order: a step is
// active while t < n_steps and not every row's silent run has reached
// min_steps; an inactive step's frames and alignments are zeroed; run, t
// and the slot advance as WhileDecode advances them, and the done flag is
// written.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using tt::Peers;
using tt::Slice;
using tt::ticket_acq_rel;

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;  // non-portable above 8; one GPC at most
constexpr int kMaxChunk = 64;    // steps per launch
constexpr int kU = 4;            // output rows a warp works on at once
constexpr int kNI = 5;           // float4 loads per lane and row in flight: 640 columns
constexpr int kParts = 32;       // a context column's parts of the positions

// Built with -DTT_CHUNK_PHASE_CLOCK (scripts/decode_chunk_study.py), thread
// 0 of block 0 (row 0, rank 0) adds up the SM clock spent in each phase of
// every step, the wait at its barrier included, and of that the wait alone
// (from its arrival at the barrier) and the staging of its inputs (to the
// block barrier after it), into 3 kPhases counters that
// tt_decode_chunk_phase_cycles reads back. Otherwise the marks compile to
// nothing.
#ifdef TT_CHUNK_PHASE_CLOCK
constexpr int kPhases = 14;
__device__ unsigned long long g_phase_cycles[3 * kPhases];
#define STAGED()                                                              \
  if (blockIdx.x == 0 && threadIdx.x == 0) phase_staged = clock64();
#define ARRIVE()                                                              \
  if (blockIdx.x == 0 && threadIdx.x == 0) phase_arrive = clock64();
#define PHASE_MARK(k)                                                         \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                                  \
    const long long now = clock64();                                          \
    phase_cycles[k] += (unsigned long long)(now - phase_last);                \
    phase_cycles[kPhases + k] += (unsigned long long)(now - phase_arrive);    \
    phase_cycles[2 * kPhases + k] += (unsigned long long)(phase_staged - phase_last); \
    phase_last = phase_staged = now;                                          \
  }
#else
#define STAGED()
#define ARRIVE()
#define PHASE_MARK(k)
#endif

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3 };

struct DecW {
  const float *p_w0, *p_b0, *p_w1, *p_b1;
  const float *ag_wg, *ag_bg, *ag_wc, *ag_bc;
  const float *at_wq, *at_v;
  const float *ip_w, *ip_b;
  const float *d0_wg, *d0_bg, *d0_wc, *d0_bc;
  const float *d1_wg, *d1_bg, *d1_wc, *d1_bc;
  const float *f_w, *f_b;
};

struct Dims {
  int B, T, M, A, NM, R, P0, P1, AG, D;
};

// The pre-net's uniform draws of each step: u[2 k] (B, P0), u[2 k + 1]
// (B, P1); a unit is kept where its draw is below keep
struct Masks {
  const float* u[2 * kMaxChunk];
};

// The step state, (B, width) each, read at the start and written at the end
struct State {
  float *h_att, *h0, *h1, *ctx, *prev;
};

// frames (B, slots, R NM) and alignments (B, slots, T): step k of the launch
// goes to slot slot0 + k (early-exit mode: *Exit::slot + k); a slot past
// `slots` is not written
struct Out {
  float *frames, *aligns;
  int slots, slot0;
};

// The early-exit carry (t null: no exit rule, the fixed decode)
struct Exit {
  long long *t, *run, *slot;
  bool* done;
  int* silent;         // (B, kMaxChunk) scratch: each row's flags of the launch
  unsigned* ticket;    // 0 between launches
  float threshold;
  int min_steps, n_steps;
};

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu: return fmaxf(x, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-x));
    case kTanh: return tanhf(x);
    default: return x;
  }
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Where a product's outputs go: every block's copy of `buf` (pushed), after
// the dropout of `keep` (keep flags by output; null: none) and, for the
// frame projection, lane 0's store into `frame` (global memory; null: none).
struct Epi {
  float* buf;
  const unsigned char* keep;
  float* frame;
};

// act(sum_i x[i] W[o][i] + b[o]) for the outputs o of the slice; x and b in
// this block's shared memory (x 16-byte aligned, b may be null). One warp
// per output, kU outputs at a time; the columns in tiles of kNI * 128, every
// load of a tile issued before the first product. Lane l sums its columns
// (4 l + 128 j + e) in order, then the warp's butterfly: the same order for
// any slice.
__device__ __noinline__ void matvec(const float* __restrict__ W, const float* bias, int K,
                                    Slice s, const float* x, int act, Epi e, float scale,
                                    Peers pe) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool vec = (K & 3) == 0;
  for (int o0 = s.lo + warp; o0 < s.hi; o0 += nwarps * kU) {
    float acc[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[u] = 0.f;
    if (vec) {
      for (int k0 = 0; k0 < K; k0 += kNI * 128) {
        float4 w[kU][kNI];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int o = o0 + u * nwarps;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int i = k0 + lane * 4 + 128 * j;
            w[u][j] = (o < s.hi && i < K)
                ? __ldg(reinterpret_cast<const float4*>(W + (size_t)o * K + i)) : zero4();
          }
        }
#pragma unroll
        for (int j = 0; j < kNI; ++j) {
          const int i = k0 + lane * 4 + 128 * j;
          if (i < K) {
            const float4 xv = *reinterpret_cast<const float4*>(x + i);
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              acc[u] = fmaf(w[u][j].x, xv.x, acc[u]);
              acc[u] = fmaf(w[u][j].y, xv.y, acc[u]);
              acc[u] = fmaf(w[u][j].z, xv.z, acc[u]);
              acc[u] = fmaf(w[u][j].w, xv.w, acc[u]);
            }
          }
        }
      }
    } else {
      for (int i = lane; i < K; i += 32) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int o = o0 + u * nwarps;
          const float wv = o < s.hi ? __ldg(W + (size_t)o * K + i) : 0.f;
          acc[u] = fmaf(wv, x[i], acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[u] = tt::warp_sum(acc[u]);
    // one copy of the epilogue, its output picked by u
#pragma unroll 1
    for (int u = 0; u < kU; ++u) {
      const int o = o0 + u * nwarps;
      if (o >= s.hi) break;
      float y = acc[0];
#pragma unroll
      for (int v = 1; v < kU; ++v)
        if (u == v) y = acc[v];
      y = activate(y + (bias ? bias[o] : 0.f), act);
      if (e.keep) y = e.keep[o] ? y * scale : 0.f;
      if (e.frame && lane == 0) e.frame[o] = y;
      pe.push(e.buf, o, y, lane);
    }
  }
}

// softmax of sc[0..Tn) in place, whole in every block, and into `ao` where
// it is not null: each thread's positions in order, then the warps'
// butterflies, then the warps in order
__device__ __noinline__ void softmax(float* sc, int Tn, float* ao) {
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float m = __int_as_float(0xff800000);  // -inf
  for (int t = threadIdx.x; t < Tn; t += blockDim.x) m = fmaxf(m, sc[t]);
  m = tt::warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  float mx = red[0];
  for (int i = 1; i < nwarps; ++i) mx = fmaxf(mx, red[i]);
  float sum = 0.f;
  for (int t = threadIdx.x; t < Tn; t += blockDim.x) {
    const float e = expf(sc[t] - mx);
    sc[t] = e;
    sum += e;
  }
  sum = tt::warp_sum(sum);
  __syncthreads();  // every thread has read the maxima
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = red[0];
  for (int i = 1; i < nwarps; ++i) sum += red[i];
  for (int t = threadIdx.x; t < Tn; t += blockDim.x) {
    const float a = sc[t] / sum;
    sc[t] = a;
    if (ao) ao[t] = a;
  }
  __syncthreads();
}

// acc + sum over the 4 columns of tanh(k + q) v, in order
__device__ __noinline__ float tanh_dot4(float4 k, float4 q, float4 v, float acc) {
  acc = fmaf(tanhf(k.x + q.x), v.x, acc);
  acc = fmaf(tanhf(k.y + q.y), v.y, acc);
  acc = fmaf(tanhf(k.z + q.z), v.z, acc);
  return fmaf(tanhf(k.w + q.w), v.w, acc);
}

// The scores of the slice's positions t: sum_a tanh(keys[t][a] + q[a]) v[a]
// plus the mask bias, one warp per position (each lane's columns in order,
// then the butterfly), pushed into sc
__device__ __noinline__ void scores(const float* __restrict__ kr, int A, Slice s,
                                    const float* q, const float* vv, const float* mb, float* sc,
                                    Peers pe) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool vec = (A & 3) == 0;
  for (int t = s.lo + warp; t < s.hi; t += nwarps) {
    const float* k = kr + (size_t)t * A;
    float acc = 0.f;
    if (vec) {
      for (int a0 = 0; a0 < A; a0 += kNI * 128) {
        float4 kv[kNI];
#pragma unroll
        for (int j = 0; j < kNI; ++j) {
          const int i = a0 + lane * 4 + 128 * j;
          kv[j] = i < A ? __ldg(reinterpret_cast<const float4*>(k + i)) : zero4();
        }
#pragma unroll
        for (int j = 0; j < kNI; ++j) {
          const int i = a0 + lane * 4 + 128 * j;
          if (i < A)
            acc = tanh_dot4(kv[j], *reinterpret_cast<const float4*>(q + i),
                            *reinterpret_cast<const float4*>(vv + i), acc);
        }
      }
    } else {
      for (int i = lane; i < A; i += 32) acc = fmaf(tanhf(__ldg(k + i) + q[i]), vv[i], acc);
    }
    acc = tt::warp_sum(acc);
    pe.push(sc, t, acc + mb[t], lane);
  }
}

__device__ __forceinline__ void copy_f32(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Multiples of 4 floats, so that every buffer is 16-byte aligned
__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared memory: floats in this order, then the keep flags (bytes) of the
// launch's steps
// The biases in shared memory, in this order (DecW's)
enum Bias { kBP0, kBP1, kBAgG, kBAgC, kBIp, kBD0G, kBD0C, kBD1G, kBD1C, kBF, kBiases };

struct Layout {
  int fr, x0, x1, h_att, ctx, h0, h1, hs, inb, ruA, ruB, cand, q, sc, vv, mb, part, floats;
  int bias[kBiases], bias_n[kBiases];
  int keep_stride;
  __host__ __device__ explicit Layout(const Dims& d) {
    const int HD = imax(d.AG, d.D);
    const int KI = imax(imax(d.NM, d.P0), imax(d.P1 + d.M + d.AG, imax(d.AG + d.M, 2 * d.D)));
    int o = 0;
    fr = o;    o += up4(d.R * d.NM);
    x0 = o;    o += up4(d.P0);
    x1 = o;    o += up4(d.P1);
    h_att = o; o += up4(d.AG);
    ctx = o;   o += up4(d.M);
    h0 = o;    o += up4(d.D);
    h1 = o;    o += up4(d.D);
    hs = o;    o += up4(d.D);
    inb = o;   o += up4(KI);
    ruA = o;   o += up4(2 * HD);
    ruB = o;   o += up4(2 * d.D);
    cand = o;  o += up4(HD);
    q = o;     o += up4(d.A);
    sc = o;    o += up4(d.T);
    vv = o;    o += up4(d.A);
    mb = o;    o += up4(d.T);
    const int n[kBiases] = {d.P0, d.P1, 2 * d.AG, d.AG, d.D, 2 * d.D, d.D, 2 * d.D, d.D,
                            d.R * d.NM};
    for (int i = 0; i < kBiases; ++i) {
      bias[i] = o;
      bias_n[i] = n[i];
      o += up4(n[i]);
    }
    part = o;  o += kParts * up4(d.M);
    floats = o;
    keep_stride = up4(d.P0 + d.P1);
  }
  __host__ __device__ size_t bytes(int steps) const {
    return sizeof(float) * floats + (size_t)keep_stride * steps;
  }
};

// A context column's sum over the positions: sum_t al[t] mem[t][m] as kParts
// parts (part p: the positions p, p + kParts, ... in order), then one
// warp's butterfly over the parts. The block's columns [VV g.lo, VV g.hi)
// (VV = 4 where M is a multiple of 4, else 1).
template <int VV>
__device__ __noinline__ void context(const float* __restrict__ mem, const float* al, int Tn,
                                     int M, Slice g, float* part, float* ctx, Peers pe) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nvec = g.hi - g.lo, width = nvec * VV;
  for (int it = threadIdx.x; it < nvec * kParts; it += blockDim.x) {
    const int vi = it % nvec, p = it / nvec;
    const int m0 = (g.lo + vi) * VV;
    float acc[VV];
#pragma unroll
    for (int j = 0; j < VV; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int t = p; t < Tn; t += kParts) {
      float mv[VV];
      if constexpr (VV == 1) {
        mv[0] = __ldg(mem + (size_t)t * M + m0);
      } else {
        tt::Vec<float>::load(mem + (size_t)t * M + m0, mv);
      }
      const float a = al[t];
#pragma unroll
      for (int j = 0; j < VV; ++j) acc[j] = fmaf(a, mv[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < VV; ++j) part[p * width + vi * VV + j] = acc[j];
  }
  __syncthreads();
  for (int e = warp; e < width; e += nwarps)
    pe.push(ctx, g.lo * VV + e, tt::warp_sum(part[lane * width + e]), lane);
}

// The largest of x[0..n) in global memory, NaN if any is NaN (torch.amax's),
// by one warp
__device__ __forceinline__ float warp_nanmax(const float* x, int n) {
  const int lane = threadIdx.x & 31;
  float m = __int_as_float(0xff800000);  // -inf
  for (int i = lane; i < n; i += 32) {
    const float v = __ldcg(x + i);
    if (v > m || isnan(v)) m = v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, m, o);
    if (y > m || isnan(y)) m = y;
  }
  return m;
}

__global__ void __launch_bounds__(kThreads, 1)
decode_chunk_kernel(const float* __restrict__ memory, const float* __restrict__ keys,
                    const float* __restrict__ maskbias, DecW w, Dims dm, int n, Masks mk,
                    int dropout, float keep, float scale, State st, Out out, Exit ex) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int Tn = dm.T, M = dm.M, A = dm.A, NM = dm.NM;
  const int P0 = dm.P0, P1 = dm.P1, AG = dm.AG, D = dm.D;
  const int RN = dm.R * NM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const Layout L(dm);

  // Buffers and their writers, as decode_loop.cu's: "pushed" buffers are
  // written into every block's copy by the owners of their slices and read
  // after the phase's cluster barrier, "local" ones by each block alone. A
  // pushed buffer's next push comes at least one barrier after its last
  // read; ruA and ruB alternate for that.
  extern __shared__ __align__(16) float smem[];
  float* fr = smem + L.fr;        // RN  pushed, phase 14; prev = its last NM, read phase 1
  float* prev = fr + RN - NM;
  float* x0 = smem + L.x0;        // P0  pushed, phase 1; read phase 2
  float* x1 = smem + L.x1;        // P1  pushed, phase 2; read phase 3
  float* h_att = smem + L.h_att;  // AG  local, phase 5; read 3, 4, 5, 9
  float* ctx = smem + L.ctx;      // M   pushed, phase 8; read 9, 3 (next step)
  float* h0 = smem + L.h0;        // D   local, phase 12; read 10, 11, 12
  float* h1 = smem + L.h1;        // D   local, phase 14; read 12, 13, 14
  float* hs = smem + L.hs;        // D   pushed, phase 9; local 12, 14; read 10, 12, 14
  float* inb = smem + L.inb;      // KI  local: each phase's product inputs
  float* ruA = smem + L.ruA;      // 2HD pushed, phases 3, 12; read 4, 5, 13, 14
  float* ruB = smem + L.ruB;      // 2D  pushed, phase 10; read 11, 12
  float* cand = smem + L.cand;    // HD  pushed, phases 4, 11, 13; read 5, 12, 14
  float* q = smem + L.q;          // A   pushed, phase 5; read 6
  float* sc = smem + L.sc;        // T   pushed, phase 6; softmax in place (local) 7; read 8
  float* vv = smem + L.vv;        // A   the energy vector, constant
  float* mb = smem + L.mb;        // T   the row's mask bias, constant
  float* part = smem + L.part;    // context parts, local, phase 8
  unsigned char* kp = reinterpret_cast<unsigned char*>(smem + L.floats);  // keep flags
  auto bias = [&](int b) { return smem + L.bias[b]; };

  Peers pe{smem, cluster.map_shared_rank(smem, lane < C ? lane : 0), C};
  auto to = [](float* buf) { return Epi{buf, nullptr, nullptr}; };
  const Slice s_p0(P0, C, rank), s_p1(P1, C, rank), s_agg(2 * AG, C, rank);
  const Slice s_agc(AG, C, rank), s_q(A, C, rank), s_t(Tn, C, rank), s_d(D, C, rank);
  const Slice s_dg(2 * D, C, rank), s_f(RN, C, rank);
  const float* keys_row = keys + (size_t)row * Tn * A;

  // the row's state, the constants (v, the biases, the mask bias) and the
  // keep flags of every step of the launch
  copy_f32(h_att, st.h_att + (size_t)row * AG, AG);
  copy_f32(h0, st.h0 + (size_t)row * D, D);
  copy_f32(h1, st.h1 + (size_t)row * D, D);
  copy_f32(ctx, st.ctx + (size_t)row * M, M);
  copy_f32(prev, st.prev + (size_t)row * NM, NM);
  copy_f32(vv, w.at_v, A);
  copy_f32(mb, maskbias + (size_t)row * Tn, Tn);
  {
    const float* src[kBiases] = {w.p_b0, w.p_b1, w.ag_bg, w.ag_bc, w.ip_b,
                                 w.d0_bg, w.d0_bc, w.d1_bg, w.d1_bc, w.f_b};
    for (int b = 0; b < kBiases; ++b) copy_f32(bias(b), src[b], L.bias_n[b]);
  }
  if (dropout) {
    for (int k = 0; k < n; ++k)
      for (int i = threadIdx.x; i < P0 + P1; i += blockDim.x)
        kp[k * L.keep_stride + i] = i < P0 ? __ldg(mk.u[2 * k] + (size_t)row * P0 + i) < keep
                                           : __ldg(mk.u[2 * k + 1] + (size_t)row * P1 + i - P0) < keep;
  }
  const long long slot0 = ex.t ? *ex.slot : (long long)out.slot0;
  // every block of the cluster has its state before any block pushes into it
  cluster.sync();
#ifdef TT_CHUNK_PHASE_CLOCK
  __shared__ unsigned long long phase_cycles[3 * kPhases];
  if (threadIdx.x < 3 * kPhases) phase_cycles[threadIdx.x] = 0;
  long long phase_last = clock64(), phase_arrive = phase_last, phase_staged = phase_last;
#endif

  for (int k = 0; k < n; ++k) {
    const long long slot = slot0 + k;
    const bool write = slot < out.slots;
    const unsigned char* kk = kp + k * L.keep_stride;
    // 1. prenet layer 0: Dense + ReLU + dropout, split by output unit
    copy_f32(inb, prev, NM);
    __syncthreads();
    STAGED();
    matvec(w.p_w0, bias(kBP0), NM, s_p0, inb, kRelu, Epi{x0, dropout ? kk : nullptr, nullptr},
           scale, pe);
    ARRIVE();
    cluster.sync();
    PHASE_MARK(0);
    // 2. prenet layer 1
    copy_f32(inb, x0, P0);
    __syncthreads();
    STAGED();
    matvec(w.p_w1, bias(kBP1), P0, s_p1, inb, kRelu,
           Epi{x1, dropout ? kk + P0 : nullptr, nullptr}, scale, pe);
    const int KA = P1 + M;
    ARRIVE();
    cluster.sync();
    PHASE_MARK(1);
    // 3. attention GRU gates on [prenet out, previous context, h_att]
    copy_f32(inb, x1, P1);
    copy_f32(inb + P1, ctx, M);
    copy_f32(inb + KA, h_att, AG);
    __syncthreads();
    STAGED();
    matvec(w.ag_wg, bias(kBAgG), KA + AG, s_agg, inb, kSigmoid, to(ruA), scale, pe);
    ARRIVE();
    cluster.sync();
    PHASE_MARK(2);
    // 4. attention GRU candidate on [x, r * h_att]
    for (int i = threadIdx.x; i < AG; i += blockDim.x) inb[KA + i] = ruA[i] * h_att[i];
    __syncthreads();
    STAGED();
    matvec(w.ag_wc, bias(kBAgC), KA + AG, s_agc, inb, kTanh, to(cand), scale, pe);
    ARRIVE();
    cluster.sync();
    PHASE_MARK(3);
    // 5. h_att = u * h_att + (1 - u) * cand in every block; the query
    for (int i = threadIdx.x; i < AG; i += blockDim.x) {
      const float u = ruA[AG + i];
      h_att[i] = u * h_att[i] + (1.f - u) * cand[i];
      inb[i] = h_att[i];
    }
    __syncthreads();
    STAGED();
    matvec(w.at_wq, nullptr, AG, s_q, inb, kNone, to(q), scale, pe);
    ARRIVE();
    cluster.sync();
    PHASE_MARK(4);

    // 6. the scores, split by encoder position
    scores(keys_row, A, s_t, q, vv, mb, sc, pe);
    ARRIVE();
    cluster.sync();
    PHASE_MARK(5);
    // 7. softmax over all positions, whole in every block; rank 0 writes
    // the alignment row
    softmax(sc, Tn, rank == 0 && write ? out.aligns + ((size_t)row * out.slots + slot) * Tn
                                       : nullptr);
    ARRIVE();
    PHASE_MARK(6);
    STAGED();
    // 8. context, split by memory column
    {
      const float* mem = memory + (size_t)row * Tn * M;
      if ((M & 3) == 0)
        context<4>(mem, sc, Tn, M, Slice(M / 4, C, rank), part, ctx, pe);
      else
        context<1>(mem, sc, Tn, M, Slice(M, C, rank), part, ctx, pe);
    }
    ARRIVE();
    cluster.sync();
    PHASE_MARK(7);

    // 9. input projection of [h_att, context]: the residual stream
    copy_f32(inb, h_att, AG);
    copy_f32(inb + AG, ctx, M);
    __syncthreads();
    STAGED();
    matvec(w.ip_w, bias(kBIp), AG + M, s_d, inb, kNone, to(hs), scale, pe);
    ARRIVE();
    cluster.sync();
    PHASE_MARK(8);
    // 10. decoder GRU 0 gates on [hs, h0]
    copy_f32(inb, hs, D);
    copy_f32(inb + D, h0, D);
    __syncthreads();
    STAGED();
    matvec(w.d0_wg, bias(kBD0G), 2 * D, s_dg, inb, kSigmoid, to(ruB), scale, pe);
    ARRIVE();
    cluster.sync();
    PHASE_MARK(9);
    // 11. decoder GRU 0 candidate
    for (int i = threadIdx.x; i < D; i += blockDim.x) inb[D + i] = ruB[i] * h0[i];
    __syncthreads();
    STAGED();
    matvec(w.d0_wc, bias(kBD0C), 2 * D, s_d, inb, kTanh, to(cand), scale, pe);
    ARRIVE();
    cluster.sync();
    PHASE_MARK(10);
    // 12. h0 update, hs += h0; decoder GRU 1 gates on [hs, h1]
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float u = ruB[D + i];
      h0[i] = u * h0[i] + (1.f - u) * cand[i];
      hs[i] += h0[i];
      inb[i] = hs[i];
      inb[D + i] = h1[i];
    }
    __syncthreads();
    STAGED();
    matvec(w.d1_wg, bias(kBD1G), 2 * D, s_dg, inb, kSigmoid, to(ruA), scale, pe);
    ARRIVE();
    cluster.sync();
    PHASE_MARK(11);
    // 13. decoder GRU 1 candidate
    for (int i = threadIdx.x; i < D; i += blockDim.x) inb[D + i] = ruA[i] * h1[i];
    __syncthreads();
    STAGED();
    matvec(w.d1_wc, bias(kBD1C), 2 * D, s_d, inb, kTanh, to(cand), scale, pe);
    ARRIVE();
    cluster.sync();
    PHASE_MARK(12);
    // 14. h1 update, hs += h1; the r-frame projection: the owner writes the
    // frame, and the whole frame goes into every block's copy (its last
    // NM values feed the next step)
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float u = ruA[D + i];
      h1[i] = u * h1[i] + (1.f - u) * cand[i];
      hs[i] += h1[i];
      inb[i] = hs[i];
    }
    __syncthreads();
    float* fo = out.frames + ((size_t)row * out.slots + slot) * RN;
    matvec(w.f_w, bias(kBF), D, s_f, inb, kNone, Epi{fr, nullptr, write ? fo : nullptr}, scale,
           pe);
    // also the last: no block leaves while a peer may still push into it
    ARRIVE();
    cluster.sync();
    PHASE_MARK(13);
  }

#ifdef TT_CHUNK_PHASE_CLOCK
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int i = 0; i < 3 * kPhases; ++i) g_phase_cycles[i] += phase_cycles[i];
#endif
  // the state for the next launch
  if (rank == 0) {
    for (int i = threadIdx.x; i < AG; i += blockDim.x) st.h_att[(size_t)row * AG + i] = h_att[i];
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      st.h0[(size_t)row * D + i] = h0[i];
      st.h1[(size_t)row * D + i] = h1[i];
    }
    for (int i = threadIdx.x; i < M; i += blockDim.x) st.ctx[(size_t)row * M + i] = ctx[i];
    for (int i = threadIdx.x; i < NM; i += blockDim.x) st.prev[(size_t)row * NM + i] = prev[i];
  }
  if (!ex.t) return;

  // The exit rule. Rank 0 flags the row's silent steps (the frame's peak,
  // NaN if any is NaN, below the threshold; a step past the slots is not
  // silent) from the frames its cluster wrote, visible since the last
  // cluster barrier. Every block's frames and alignments, and rank 0's
  // flags, are written and fenced before the row's ticket (release); the
  // cluster with the last ticket reads them after it (acquire).
  if (rank == 0)
    for (int k = warp; k < n; k += nwarps) {
      bool silent = false;
      if (slot0 + k < out.slots) {
        const float m = warp_nanmax(out.frames + ((size_t)row * out.slots + slot0 + k) * RN, RN);
        silent = m < ex.threshold;
      }
      if (lane == 0) ex.silent[row * kMaxChunk + k] = silent;
    }
  __threadfence();
  cluster.sync();
  if (rank != 0) return;
  __shared__ int last, all_ok[kMaxChunk + 1], first_off, done_s;
  if (threadIdx.x == 0) last = ticket_acq_rel(ex.ticket, (unsigned)(dm.B - 1)) == (unsigned)(dm.B - 1);
  for (int k = threadIdx.x; k <= n; k += blockDim.x) all_ok[k] = 1;
  __syncthreads();
  if (!last) return;  // the counter wrapped to 0 on this ticket
  // each row's silent run after k of the launch's steps, as if all were
  // active: all_ok[k] holds while every row's run is >= min_steps
  for (int b = threadIdx.x; b < dm.B; b += blockDim.x) {
    long long r = __ldcg(ex.run + b);
    if (r < ex.min_steps) all_ok[0] = 0;
    for (int k = 0; k < n; ++k) {
      r = __ldcg(ex.silent + b * kMaxChunk + k) ? r + 1 : 0;
      if (r < ex.min_steps) all_ok[k + 1] = 0;
    }
  }
  __syncthreads();
  const long long t0 = __ldcg(ex.t);
  if (threadIdx.x == 0) {
    // steps are active up to the first k at which WhileDecode's condition
    // fails (t stops there and stays); done is the condition after them
    int k0 = 0;
    while (k0 < n && !(t0 + k0 >= ex.n_steps || all_ok[k0])) ++k0;
    first_off = k0;
    done_s = t0 + k0 >= ex.n_steps || all_ok[k0];
  }
  __syncthreads();
  const int k0 = first_off;
  for (int b = threadIdx.x; b < dm.B; b += blockDim.x) {
    long long r = __ldcg(ex.run + b);
    for (int k = 0; k < k0; ++k) r = __ldcg(ex.silent + b * kMaxChunk + k) ? r + 1 : 0;
    ex.run[b] = r;
  }
  // the inactive steps' frames and alignments are zero
  for (int k = k0; k < n; ++k) {
    const long long slot = slot0 + k;
    if (slot >= out.slots) break;
    for (int b = 0; b < dm.B; ++b) {
      float* fo = out.frames + ((size_t)b * out.slots + slot) * RN;
      float* ao = out.aligns + ((size_t)b * out.slots + slot) * Tn;
      for (int i = threadIdx.x; i < RN; i += blockDim.x) fo[i] = 0.f;
      for (int i = threadIdx.x; i < Tn; i += blockDim.x) ao[i] = 0.f;
    }
  }
  if (threadIdx.x == 0) {
    *ex.t = t0 + k0;
    *ex.slot = slot0 + n;
    *ex.done = done_s != 0;
  }
}

cudaError_t configure(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(decode_chunk_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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

Dims dims_of(const int* d) {
  return Dims{d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9]};
}

}  // namespace

// dims: B, T_in, mem_dim, att_dim, n_mels, r, prenet0, prenet1,
// att_gru_dim, dec_gru_dim. weights: the 22 DecoderWeights device pointers
// in field order, f32. n: the launch's steps, 1..64. masks: 2 n pointers
// (per step the pre-net's layer 0 and layer 1 uniform draws, (B, P0) and
// (B, P1)) when dropout is set. state: h_att, h0, h1, context, previous
// frame. frames (B, slots, r n_mels), aligns (B, slots, T_in): step k to
// slot slot0 + k, or *exit[2] + k in early-exit mode. exit: null (no exit
// rule), or t, run (B,), slot (int64), done (bool), silent (B x 64 int32
// scratch), ticket (uint32, 0) device pointers. cluster: blocks per batch
// row, 1..16. Returns the CUDA error.
extern "C" int tt_decode_chunk(const float* memory, const float* keys, const float* maskbias,
                               const void* const* weights, const int* dims, int n,
                               const void* const* masks, int dropout, float keep, float scale,
                               void* const* state, float* frames, float* aligns, int slots,
                               int slot0, void* const* exit, float threshold, int min_steps,
                               int n_steps, int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || n < 1 || n > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  const Dims d = dims_of(dims);
  DecW w;
  const float** f = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < 22; ++i) f[i] = static_cast<const float*>(weights[i]);
  Masks mk = {};
  if (dropout)
    for (int i = 0; i < 2 * n; ++i) mk.u[i] = static_cast<const float*>(masks[i]);
  State st{static_cast<float*>(state[0]), static_cast<float*>(state[1]),
           static_cast<float*>(state[2]), static_cast<float*>(state[3]),
           static_cast<float*>(state[4])};
  Out out{frames, aligns, slots, slot0};
  Exit ex = {};
  if (exit) {
    ex.t = static_cast<long long*>(exit[0]);
    ex.run = static_cast<long long*>(exit[1]);
    ex.slot = static_cast<long long*>(exit[2]);
    ex.done = static_cast<bool*>(exit[3]);
    ex.silent = static_cast<int*>(exit[4]);
    ex.ticket = static_cast<unsigned*>(exit[5]);
    ex.threshold = threshold;
    ex.min_steps = min_steps;
    ex.n_steps = n_steps;
  }
  const size_t smem = Layout(d).bytes(n);
  cudaError_t err = configure(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(d.B * cluster, cluster, smem,
                                         static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, decode_chunk_kernel, memory, keys, maskbias, w, d, n, mk,
                           dropout, keep, scale, st, out, ex);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The dynamic shared memory one block of a launch of `n` steps needs.
extern "C" long long tt_decode_chunk_smem(const int* dims, int n) {
  return (long long)Layout(dims_of(dims)).bytes(n);
}

// How many clusters of `cluster` blocks the current device holds at once for
// a launch of `n` steps (for 1: blocks per SM x SMs), written to *out.
extern "C" int tt_decode_chunk_resident(const int* dims, int n, int cluster, int* out) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(dims_of(dims)).bytes(n);
  cudaError_t err = configure(smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_chunk_kernel,
                                                          kThreads, smem);
    *out = sms * per_sm;
    return (int)err;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, cluster, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, decode_chunk_kernel, &cfg);
}

#ifdef TT_CHUNK_PHASE_CLOCK
// The phase clock since the last reset: 3 kPhases counters of SM cycles,
// each phase's, each phase's wait at its barrier, and each phase's staging
// of its inputs.
extern "C" int tt_decode_chunk_phase_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
}

extern "C" int tt_decode_chunk_phase_reset() {
  const unsigned long long zero[3 * kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif
