// Griffin-Lim phase recovery: every iteration as three hand-written
// launches, f32 products and f32 carried spectrum.
//
// Replaces the TPU kernel tacotron_tpu/dsp/pallas_gl.py
// (_make_gl_call_fused, body _iteration_body), which runs all iterations in
// one launch with the spectrum resident in VMEM. Here each iteration is
//   1. synthesis: frames (B*F, win) = spectrum (B*F, 2*n_bins) x windowed
//      inverse-DFT basis (2*n_bins, win), a shared-memory tiled product;
//   2. overlap-add + normalise: a gather-form OLA (each output sample sums
//      its frames in a fixed order: deterministic, no atomics) times
//      1/max(wss, 1e-11), with the centre n_fft/2 stripped;
//   3. analysis: spectrum (B*F, 2*n_bins) = frames x windowed DFT basis
//      (win, 2*n_bins), a tiled product whose operand loader reads each
//      frame straight from the normalised signal, computing the centre
//      reflect padding by index arithmetic (the TPU kernel used permutation
//      matmuls). Its epilogue does the magnitude projection
//      mag / max(|X|, 1e-8) and the momentum extrapolation s + b (s - prev).
// Only the window's nonzero span [lpad, lpad + win) of each frame takes
// part, so the dead chunks of the TPU plan are skipped here too.
//
// What bounds it on an H100: the two products, 2 x (B*F) x win x 2*n_bins
// multiply-adds per iteration in f32, run on the CUDA cores (67 TFLOP/s
// peak at 700 W); the carried spectrum (B*F x 2050 x 4 bytes) and the
// frames cross device memory each iteration but take far less time than
// the products. The design answers the compute bound with a register-
// blocked tile (128 x 128 per block, 8 x 8 outputs per thread, operands
// staged through shared memory with one tile prefetched in registers).
// The spectrum is stored interleaved (re, im per bin) so that a thread's
// output tile holds both parts of each bin for the projection.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8, kThreads = 256;

// MODE 0 (synthesis): A = spectrum rows, C written out.
// MODE 1 (analysis): A gathered from the signal with reflect padding; the
// epilogue projects onto the target magnitude.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gl_gemm(int M, int N, int K, const float* __restrict__ A,
        const float* __restrict__ Bm, float* __restrict__ C, int F, int L,
        int hop, int off, const float* __restrict__ mag,
        const float* __restrict__ s_cur, float* __restrict__ s_new,
        float beta) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // A tile: row ar, k offsets ak..ak+3; B tile: k row bk, columns bn..bn+3
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const int bk = tid >> 5, bn = (tid & 31) * 4;
  const int am = m0 + ar;
  const bool arow_ok = am < M;
  const float* arow;
  int abase = 0;
  if (MODE == 0) {
    arow = A + (size_t)(arow_ok ? am : 0) * K;
  } else {
    const int b = arow_ok ? am / F : 0, f = arow_ok ? am % F : 0;
    arow = A + (size_t)b * L;
    abase = f * hop + off;
  }

  float ra[4], rb[4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ak + i;
      float v = 0.f;
      if (arow_ok && k < K) {
        if (MODE == 0) {
          v = arow[k];
        } else {
          int idx = abase + k;
          idx = idx < 0 ? -idx : idx;
          idx = idx >= L ? 2 * (L - 1) - idx : idx;
          v = arow[idx];
        }
      }
      ra[i] = v;
    }
    const int kb = k0 + bk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + bn + i;
      rb[i] = (kb < K && n < N) ? Bm[(size_t)kb * N + n] : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[ak + i][ar] = ra[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) Bs[bk][bn + i] = rb[i];
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 4 + (i < 4 ? i : 60 + i);
    if (m >= M) continue;
    if (MODE == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx * 4 + (j < 4 ? j : 60 + j);
        if (n < N) C[(size_t)m * N + n] = acc[i][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int n = n0 + tx * 4 + (j < 4 ? j : 60 + j);   // even: (re, im)
        if (n >= N) continue;
        const float re = acc[i][j], im = acc[i][j + 1];
        const float scale = mag[(size_t)m * (N / 2) + n / 2] /
                            fmaxf(sqrtf(re * re + im * im), 1e-8f);
        const float nr = re * scale, ni = im * scale;
        const size_t o = (size_t)m * N + n;
        if (s_new) {
          const float cr = s_cur[o], ci = s_cur[o + 1];
          s_new[o] = nr;
          s_new[o + 1] = ni;
          C[o] = nr + beta * (nr - cr);
          C[o + 1] = ni + beta * (ni - ci);
        } else {
          C[o] = nr;
          C[o + 1] = ni;
        }
      }
    }
  }
}

// sig[b, s] = invwss[s + pad] * sum_f frames[b, f, s + pad - f*hop - lpad],
// over the frames whose live span [lpad, lpad + NC) covers the sample.
__global__ void gl_ola(const float* __restrict__ frames,
                       const float* __restrict__ invwss, float* __restrict__ sig,
                       int Bn, int F, int NC, int hop, int lpad, int pad, int L) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)Bn * L) return;
  const int b = (int)(idx / L), s = (int)(idx % L);
  const int t = s + pad, c = t - lpad;
  const int f_hi = c < 0 ? -1 : min(F - 1, c / hop);
  const int lo_num = c - NC + 1;
  const int f_lo = lo_num <= 0 ? 0 : (lo_num + hop - 1) / hop;
  float y = 0.f;
  for (int f = f_lo; f <= f_hi; ++f)
    y += frames[((size_t)b * F + f) * NC + (c - f * hop)];
  sig[idx] = y * invwss[t];
}

}  // namespace

// n_iter Griffin-Lim iterations, three launches each, on `stream`.
//   mag (B*F, n_bins); e (B*F, 2*n_bins): synthesis input, holds the
//   zero-phase start and, with beta == 0, the result; s0/s1 (same shape,
//   only with beta != 0): s0 holds the start, the result ends in s1 when
//   n_iter is odd, else in s0. bwd (2*n_bins, win), fwd (win, 2*n_bins):
//   live-span DFT bases with interleaved (re, im) rows/columns. frames
//   (B*F, win) and sig (B, L) are scratch; invwss has n_fft + hop*(F-1)
//   entries.
extern "C" int tt_griffin_lim(const float* mag, float* e, float* s0, float* s1,
                              const float* bwd, const float* fwd,
                              const float* invwss, float* frames, float* sig,
                              int B, int F, int n_bins, int n_fft, int hop,
                              int win, int n_iter, float beta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * F, S = 2 * n_bins;
  const int lpad = (n_fft - win) / 2, pad = n_fft / 2;
  const int L = hop * (F - 1);
  const dim3 g_syn((win + BN - 1) / BN, (M + BM - 1) / BM);
  const dim3 g_ana((S + BN - 1) / BN, (M + BM - 1) / BM);
  const size_t n_sig = (size_t)B * L;
  const int ola_blocks = (int)((n_sig + 255) / 256);
  for (int it = 0; it < n_iter; ++it) {
    float* s_cur = (it % 2 == 0) ? s0 : s1;
    float* s_new = (it % 2 == 0) ? s1 : s0;
    gl_gemm<0><<<g_syn, kThreads, 0, st>>>(M, win, S, e, bwd, frames, 0, 0, 0,
                                           0, nullptr, nullptr, nullptr, 0.f);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gl_ola<<<ola_blocks, 256, 0, st>>>(frames, invwss, sig, B, F, win, hop,
                                       lpad, pad, L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gl_gemm<1><<<g_ana, kThreads, 0, st>>>(
        M, S, win, sig, fwd, e, F, L, hop, lpad - pad, mag,
        beta != 0.f ? s_cur : nullptr, beta != 0.f ? s_new : nullptr, beta);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
