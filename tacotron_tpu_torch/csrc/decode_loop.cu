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
// first step they are served by the 50 MB L2. The step is latency-bound:
// FLOPs and HBM bytes are far below the card's rates.
//
// Design: one persistent thread block walks all steps for its batch row
// (kRows rows; the code is written for ROWS rows per block).
// Recurrent state (h_att, h0, h1, context, previous frame) and the step's
// activations live in shared memory in f32. Products are warp-per-output
// dot products over the weight row (PyTorch (out, in) layout, 16-byte
// vector loads, f32 accumulation, shuffle reduction). The softmax over T_in
// is one warp per row; the context is a weighted sum over the row's memory.
// Storage T is bf16 (lowp) or f32; the TPU kernel's rounding points are
// kept: dot inputs are rounded to T, the energy is tanh(keys + q) in T,
// the v-contraction is f32, the context product is formed in T and summed
// in f32. Dropout uses a counter-based hash keyed by (seed, row, step,
// layer, unit): keep iff bits < keep * 2^32, scaled by 1/keep.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
// Batch rows per block. One row per block spreads a batch of up to 132 rows
// over the SMs; the step's latency, not its arithmetic, sets the time.
// Rows > 1 would let one weight read serve several rows (the lever for
// batches beyond the SM count); only 1 is built and tested.
constexpr int kRows = 1;
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

// y[r][o] = act(sum_i x[r][i] * W[o][i] + b[o]) for ROWS rows; x is already
// rounded to the storage type. One warp per output column; each warp works
// on U columns at once so that U weight loads are in flight together (the
// product is bound by L2 latency, not by arithmetic).
template <int ROWS, typename T>
__device__ void matvec(const T* __restrict__ W, const T* __restrict__ bias,
                       int K, int N, const float* x, int ldx, float* y,
                       int ldy, int act) {
  constexpr int V = tt::Vec<T>::V;
  constexpr int U = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool vec = (K % V) == 0;
  for (int o0 = warp; o0 < N; o0 += nwarps * U) {
    float acc[U][ROWS];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[u][r] = 0.f;
    if (vec) {
      for (int i = lane * V; i < K; i += 32 * V) {
        float wv[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int o = o0 + u * nwarps;
          if (o < N) {
            tt::Vec<T>::load(W + (size_t)o * K + i, wv[u]);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) wv[u][j] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < V; ++j)
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float xv = x[r * ldx + i + j];
#pragma unroll
            for (int u = 0; u < U; ++u) acc[u][r] = fmaf(wv[u][j], xv, acc[u][r]);
          }
      }
    } else {
      for (int i = lane; i < K; i += 32) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int o = o0 + u * nwarps;
          const float wv = o < N ? tt::to_f32(W[(size_t)o * K + i]) : 0.f;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[u][r] = fmaf(wv, x[r * ldx + i], acc[u][r]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int o = o0 + u * nwarps;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[u][r] = tt::warp_sum(acc[u][r]);
      if (lane == 0 && o < N) {
        const float b = bias ? tt::to_f32(bias[o]) : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) y[r * ldy + o] = activate(acc[u][r] + b, act);
      }
    }
  }
}

// dst[r][off + i] = round_to<T>(src[r][i]) for i < n
template <int ROWS, typename T>
__device__ void stage(float* dst, int ldd, int off, const float* src, int lds,
                      int n) {
  for (int idx = threadIdx.x; idx < ROWS * n; idx += blockDim.x) {
    int r = idx / n, i = idx % n;
    dst[r * ldd + off + i] = tt::round_to<T>(src[r * lds + i]);
  }
}

// TF1 GRU step on shared-memory state h (ROWS x d) with input x (ROWS x kx),
// staged in inb: ru = sigmoid(Wg [x, h] + bg); c = tanh(Wc [x, r*h] + bc);
// h = u*h + (1-u)*c. The caller has staged rounded x in inb[:, 0:kx].
template <int ROWS, typename T>
__device__ void gru_step(const T* wg, const T* bg, const T* wc, const T* bc,
                         int kx, int d, float* h, float* inb, int ldi,
                         float* ru, float* cand) {
  stage<ROWS, T>(inb, ldi, kx, h, d, d);
  __syncthreads();
  matvec<ROWS, T>(wg, bg, kx + d, 2 * d, inb, ldi, ru, 2 * d, kSigmoid);
  __syncthreads();
  for (int idx = threadIdx.x; idx < ROWS * d; idx += blockDim.x) {
    int r = idx / d, i = idx % d;
    inb[r * ldi + kx + i] = tt::round_to<T>(ru[r * 2 * d + i] * h[r * d + i]);
  }
  __syncthreads();
  matvec<ROWS, T>(wc, bc, kx + d, d, inb, ldi, cand, d, kTanh);
  __syncthreads();
  for (int idx = threadIdx.x; idx < ROWS * d; idx += blockDim.x) {
    int r = idx / d, i = idx % d;
    float u = ru[r * 2 * d + d + i];
    h[idx] = u * h[idx] + (1.f - u) * cand[idx];
  }
  __syncthreads();
}

template <int ROWS, typename T>
__global__ void __launch_bounds__(kThreads)
decode_loop_kernel(const T* __restrict__ memory, const T* __restrict__ keys,
                   const float* __restrict__ maskbias, DecW<T> w, Dims dm,
                   uint32_t seed, uint32_t keep_threshold, float keep_scale,
                   int dropout, float* __restrict__ frames,
                   float* __restrict__ aligns, int* __restrict__ keep_counts) {
  constexpr int V = tt::Vec<T>::V;
  const int B = dm.B, Tn = dm.T, M = dm.M, A = dm.A, NM = dm.NM;
  const int P0 = dm.P0, P1 = dm.P1, AG = dm.AG, D = dm.D;
  const int RN = dm.R * NM;
  const int KI = max(max(NM, P0), max(P1 + M + AG, max(AG + M, 2 * D)));
  const int HD = max(AG, D);
  const int row0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* prev = smem;                  // ROWS x NM
  float* x0 = prev + ROWS * NM;        // ROWS x P0
  float* x1 = x0 + ROWS * P0;          // ROWS x P1
  float* h_att = x1 + ROWS * P1;       // ROWS x AG
  float* ctx = h_att + ROWS * AG;      // ROWS x M
  float* h0 = ctx + ROWS * M;          // ROWS x D
  float* h1 = h0 + ROWS * D;           // ROWS x D
  float* hs = h1 + ROWS * D;           // ROWS x D: residual stream
  float* inb = hs + ROWS * D;          // ROWS x KI: rounded product inputs
  float* ru = inb + ROWS * KI;         // ROWS x 2*HD
  float* cand = ru + ROWS * 2 * HD;    // ROWS x HD
  float* q = cand + ROWS * HD;         // ROWS x A
  float* fr = q + ROWS * A;            // ROWS x RN
  float* sc = fr + ROWS * RN;          // ROWS x T: scores, then alignment
  float* vv = sc + ROWS * Tn;          // A: energy vector in f32
  float* part = vv + A;                // nwarps x M: context partial sums
  int* kc = reinterpret_cast<int*>(part + nwarps * M);  // ROWS keep counters

  int rows[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) rows[r] = min(row0 + r, B - 1);

  for (int i = threadIdx.x; i < ROWS * (NM + P0 + P1 + AG + M + 3 * D); i += blockDim.x)
    smem[i] = 0.f;
  for (int i = threadIdx.x; i < A; i += blockDim.x) vv[i] = tt::to_f32(w.at_v[i]);
  __syncthreads();

  for (int step = 0; step < dm.n_steps; ++step) {
    if (threadIdx.x < ROWS) kc[threadIdx.x] = 0;
    // ---- prenet: two Dense+ReLU layers, each followed by dropout
    stage<ROWS, T>(inb, KI, 0, prev, NM, NM);
    __syncthreads();
    matvec<ROWS, T>(w.p_w0, w.p_b0, NM, P0, inb, KI, x0, P0, kRelu);
    __syncthreads();
    for (int layer = 0; layer < 2; ++layer) {
      float* xl = layer == 0 ? x0 : x1;
      const int n = layer == 0 ? P0 : P1;
      if (dropout) {
        for (int idx = threadIdx.x; idx < ROWS * n; idx += blockDim.x) {
          int r = idx / n, u = idx % n;
          bool keep = dropout_bits(seed, rows[r], step, layer, u) < keep_threshold;
          xl[idx] = keep ? xl[idx] * keep_scale : 0.f;
          if (keep_counts && keep) atomicAdd(&kc[r], 1);
        }
        __syncthreads();
      }
      if (layer == 0) {
        stage<ROWS, T>(inb, KI, 0, x0, P0, P0);
        __syncthreads();
        matvec<ROWS, T>(w.p_w1, w.p_b1, P0, P1, inb, KI, x1, P1, kRelu);
        __syncthreads();
      }
    }

    // ---- attention GRU on [prenet out, previous context]
    stage<ROWS, T>(inb, KI, 0, x1, P1, P1);
    stage<ROWS, T>(inb, KI, P1, ctx, M, M);
    gru_step<ROWS, T>(w.ag_wg, w.ag_bg, w.ag_wc, w.ag_bc, P1 + M, AG, h_att,
                      inb, KI, ru, cand);

    // ---- Bahdanau energy, masked softmax, context
    stage<ROWS, T>(inb, KI, 0, h_att, AG, AG);
    __syncthreads();
    matvec<ROWS, T>(w.at_wq, nullptr, AG, A, inb, KI, q, A, kNone);
    __syncthreads();
    for (int p = warp; p < ROWS * Tn; p += nwarps) {
      const int r = p / Tn, t = p % Tn;
      const T* k = keys + ((size_t)rows[r] * Tn + t) * A;
      const float* qr = q + r * A;
      float acc = 0.f;
      if (A % V == 0) {
        for (int i = lane * V; i < A; i += 32 * V) {
          float kv[V];
          tt::Vec<T>::load(k + i, kv);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            float s = tt::round_to<T>(kv[j] + tt::round_to<T>(qr[i + j]));
            acc = fmaf(tt::round_to<T>(tanhf(s)), vv[i + j], acc);
          }
        }
      } else {
        for (int i = lane; i < A; i += 32) {
          float s = tt::round_to<T>(tt::to_f32(k[i]) + tt::round_to<T>(qr[i]));
          acc = fmaf(tt::round_to<T>(tanhf(s)), vv[i], acc);
        }
      }
      acc = tt::warp_sum(acc);
      if (lane == 0) sc[r * Tn + t] = acc + maskbias[(size_t)rows[r] * Tn + t];
    }
    __syncthreads();
    if (warp < ROWS) {
      float* s = sc + warp * Tn;
      float mx = __int_as_float(0xff800000);  // -inf
      for (int t = lane; t < Tn; t += 32) mx = fmaxf(mx, s[t]);
      mx = tt::warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < Tn; t += 32) {
        float e = expf(s[t] - mx);
        s[t] = e;
        sum += e;
      }
      sum = tt::warp_sum(sum);
      const bool out = row0 + warp < B;
      float* ao = out ? aligns + ((size_t)(row0 + warp) * dm.n_steps + step) * Tn : nullptr;
      for (int t = lane; t < Tn; t += 32) {
        float a = s[t] / sum;
        s[t] = a;
        if (out) ao[t] = a;
      }
    }
    __syncthreads();
    // context: each warp sums a strided subset of encoder steps into part,
    // then the warps' partial sums are added in a fixed order
    for (int r = 0; r < ROWS; ++r) {
      const T* mem = memory + (size_t)rows[r] * Tn * M;
      const float* al = sc + r * Tn;
      if (M % V == 0) {
        for (int m0 = lane * V; m0 < M; m0 += 32 * V) {
          float acc[V];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = 0.f;
          for (int t = warp; t < Tn; t += nwarps) {
            float mv[V];
            tt::Vec<T>::load(mem + (size_t)t * M + m0, mv);
            const float a = tt::round_to<T>(al[t]);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] += tt::round_to<T>(a * mv[j]);
          }
#pragma unroll
          for (int j = 0; j < V; ++j) part[warp * M + m0 + j] = acc[j];
        }
      } else {
        for (int m = lane; m < M; m += 32) {
          float acc = 0.f;
          for (int t = warp; t < Tn; t += nwarps)
            acc += tt::round_to<T>(tt::round_to<T>(al[t]) * tt::to_f32(mem[(size_t)t * M + m]));
          part[warp * M + m] = acc;
        }
      }
      __syncthreads();
      for (int m = threadIdx.x; m < M; m += blockDim.x) {
        float s = 0.f;
        for (int wi = 0; wi < nwarps; ++wi) s += part[wi * M + m];
        ctx[r * M + m] = s;
      }
      __syncthreads();
    }

    // ---- input projection and two residual GRUs
    stage<ROWS, T>(inb, KI, 0, h_att, AG, AG);
    stage<ROWS, T>(inb, KI, AG, ctx, M, M);
    __syncthreads();
    matvec<ROWS, T>(w.ip_w, w.ip_b, AG + M, D, inb, KI, hs, D, kNone);
    __syncthreads();
    for (int layer = 0; layer < 2; ++layer) {
      float* hl = layer == 0 ? h0 : h1;
      stage<ROWS, T>(inb, KI, 0, hs, D, D);
      if (layer == 0)
        gru_step<ROWS, T>(w.d0_wg, w.d0_bg, w.d0_wc, w.d0_bc, D, D, hl, inb, KI, ru, cand);
      else
        gru_step<ROWS, T>(w.d1_wg, w.d1_bg, w.d1_wc, w.d1_bc, D, D, hl, inb, KI, ru, cand);
      for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) hs[idx] += hl[idx];
      __syncthreads();
    }

    // ---- r-frame projection; the last frame feeds the next step
    stage<ROWS, T>(inb, KI, 0, hs, D, D);
    __syncthreads();
    matvec<ROWS, T>(w.f_w, w.f_b, D, RN, inb, KI, fr, RN, kNone);
    __syncthreads();
    for (int idx = threadIdx.x; idx < ROWS * RN; idx += blockDim.x) {
      const int r = idx / RN, i = idx % RN;
      if (row0 + r < B) frames[((size_t)(row0 + r) * dm.n_steps + step) * RN + i] = fr[idx];
      if (i >= RN - NM) prev[r * NM + i - (RN - NM)] = fr[idx];
    }
    if (keep_counts && threadIdx.x < ROWS && row0 + threadIdx.x < B)
      keep_counts[(size_t)(row0 + threadIdx.x) * dm.n_steps + step] = kc[threadIdx.x];
    __syncthreads();
  }
}

size_t smem_bytes(const Dims& d, int rows) {
  const int KI = std::max(std::max(d.NM, d.P0),
                          std::max(d.P1 + d.M + d.AG, std::max(d.AG + d.M, 2 * d.D)));
  const int HD = std::max(d.AG, d.D);
  size_t per_row = d.NM + d.P0 + d.P1 + d.AG + d.M + 3 * d.D + KI + 3 * HD + d.A +
                   d.R * d.NM + d.T;
  return sizeof(float) * (rows * per_row + d.A + (kThreads / 32) * d.M) +
         sizeof(int) * rows;
}

template <int ROWS, typename T>
cudaError_t launch(const void* memory, const void* keys, const float* maskbias,
                   const void* const* wp, const Dims& d, uint32_t seed,
                   uint32_t keep_threshold, float keep_scale, int dropout,
                   float* frames, float* aligns, int* keep_counts,
                   cudaStream_t stream) {
  DecW<T> w;
  const T** f = reinterpret_cast<const T**>(&w);
  for (int i = 0; i < 22; ++i) f[i] = static_cast<const T*>(wp[i]);
  const size_t smem = smem_bytes(d, ROWS);
  auto kern = decode_loop_kernel<ROWS, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (d.B + ROWS - 1) / ROWS;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(memory), static_cast<const T*>(keys), maskbias, w,
      d, seed, keep_threshold, keep_scale, dropout, frames, aligns, keep_counts);
  return cudaGetLastError();
}

}  // namespace

// dims: B, T_in, mem_dim, att_dim, n_mels, r, prenet0, prenet1,
// att_gru_dim, dec_gru_dim, n_steps. weights: the 22 DecoderWeights device
// pointers in field order. keep_counts may be null.
extern "C" int tt_decode_loop(const void* memory, const void* keys,
                              const float* maskbias, const void* const* weights,
                              const int* dims, int lowp,
                              unsigned int seed, unsigned int keep_threshold,
                              float keep_scale, int dropout, float* frames,
                              float* aligns, int* keep_counts, void* stream) {
  Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
         dims[6], dims[7], dims[8], dims[9], dims[10]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = lowp
      ? launch<kRows, __nv_bfloat16>(memory, keys, maskbias, weights, d, seed, keep_threshold,
                                     keep_scale, dropout, frames, aligns, keep_counts, s)
      : launch<kRows, float>(memory, keys, maskbias, weights, d, seed, keep_threshold,
                             keep_scale, dropout, frames, aligns, keep_counts, s);
  return (int)err;
}

// Upper bound on the dynamic shared memory one launch needs, for the
// wrapper's check against the device limit.
extern "C" long long tt_decode_loop_smem(const int* dims) {
  Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
         dims[6], dims[7], dims[8], dims[9], dims[10]};
  return (long long)smem_bytes(d, kRows);
}
