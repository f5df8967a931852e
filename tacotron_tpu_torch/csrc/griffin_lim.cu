// Griffin-Lim phase recovery: every iteration as three hand-written
// launches. Two storage modes: f32 throughout, or bf16 (carried spectrum,
// previous iterate, both DFT bases and both product operands in bf16, f32
// accumulation, everything else f32).
//
// Replaces two TPU kernels of tacotron_tpu/dsp/pallas_gl.py that share one
// iteration body (_iteration_body):
//   _make_gl_call_fused  all iterations in one launch, the spectrum resident
//                        in VMEM, momentum           -> tt_griffin_lim
//   _make_gl_call        one iteration per launch, separate re and im arrays
//                        in and out through HBM, no momentum
//                                                    -> tt_griffin_lim_step
// Here each iteration is
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
// bf16 mode, the rounding points of the TPU body: the analysis operand is
// rounded to bf16 after the reflect gather from the f32 signal; the
// projection runs in f32 and its result is rounded to bf16 (the carrier);
// the extrapolation is formed in f32 from the bf16 carriers and rounded to
// bf16 as the next synthesis operand. bf16 values are widened to f32 and
// multiplied with fmaf: a product of two bf16 values is exact in f32, so
// this is a tensor-core bf16 product up to the order of the sum.
//
// What bounds it on an H100: the two products, 2 x (B*F) x win x 2*n_bins
// multiply-adds per iteration. As written they run on the CUDA cores in
// both modes (67 TFLOP/s peak at 700 W), while the bf16 mode's bound is the
// tensor cores' (989 TFLOP/s): moving its tiles to wgmma is what is left
// to do. The carried spectrum and the frames cross device memory each
// iteration but take far less time than the products. The design answers
// the compute bound with a register-blocked tile (128 x 128 per block, 8 x
// 8 outputs per thread, operands staged through shared memory with one
// tile prefetched in registers). tt_griffin_lim stores the spectrum
// interleaved (re, im per bin) so that a thread's output tile holds both
// parts of each bin for the projection; tt_griffin_lim_step keeps the TPU
// kernel's planar re / im interface and reads and writes the two arrays
// through the same tiles.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8, kThreads = 256;

template <typename T> __device__ __forceinline__ void store_pair(T* p, float a, float b);
template <> __device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store_pair<__nv_bfloat16>(
    __nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The spectrum operand / result of one product. Interleaved: one array
// (M, 2*n_bins), (re, im) per bin. Planar: a = re, b = im, each (M, n_bins).
template <typename T> struct Spec {
  T* a;
  T* b;
};

// MODE 0 (synthesis): A = spectrum rows (src), frames written out.
// MODE 1 (analysis): A gathered from the signal with reflect padding; the
// epilogue projects onto the target magnitude and writes the spectrum (dst).
// T: storage type of the spectrum and the basis. PLANAR: spectrum layout.
template <int MODE, typename T, bool PLANAR>
__global__ void __launch_bounds__(kThreads)
gl_gemm(int M, int N, int K, Spec<const T> src, const float* __restrict__ sig,
        const T* __restrict__ Bm, float* __restrict__ frames, Spec<T> dst,
        int F, int L, int hop, int off, const float* __restrict__ mag,
        const T* __restrict__ s_cur, T* __restrict__ s_new, float beta) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // A tile: row ar, k offsets ak..ak+3; B tile: k row bk, columns bn..bn+3
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const int bk = tid >> 5, bn = (tid & 31) * 4;
  const int am = m0 + ar;
  const bool arow_ok = am < M;
  const size_t arow = arow_ok ? am : 0;
  const float* srow = sig;
  int abase = 0;
  if (MODE == 1) {
    const int b = arow_ok ? am / F : 0, f = arow_ok ? am % F : 0;
    srow = sig + (size_t)b * L;
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
          v = PLANAR ? tt::to_f32(((k & 1) ? src.b : src.a)[arow * (K / 2) + (k >> 1)])
                     : tt::to_f32(src.a[arow * K + k]);
        } else {
          int idx = abase + k;
          idx = idx < 0 ? -idx : idx;
          idx = idx >= L ? 2 * (L - 1) - idx : idx;
          v = tt::round_to<T>(srow[idx]);
        }
      }
      ra[i] = v;
    }
    const int kb = k0 + bk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + bn + i;
      rb[i] = (kb < K && n < N) ? tt::to_f32(Bm[(size_t)kb * N + n]) : 0.f;
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
        if (n < N) frames[(size_t)m * N + n] = acc[i][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int n = n0 + tx * 4 + (j < 4 ? j : 60 + j);   // even: (re, im)
        if (n >= N) continue;
        const float re = acc[i][j], im = acc[i][j + 1];
        const float scale = mag[(size_t)m * (N / 2) + n / 2] /
                            fmaxf(sqrtf(re * re + im * im), 1e-8f);
        // the projected value as the carrier holds it
        const float nr = tt::round_to<T>(re * scale), ni = tt::round_to<T>(im * scale);
        if (PLANAR) {
          const size_t o = (size_t)m * (N / 2) + n / 2;
          dst.a[o] = tt::to_storage<T>(nr);
          dst.b[o] = tt::to_storage<T>(ni);
          continue;
        }
        const size_t o = (size_t)m * N + n;
        if (s_new) {
          const float cr = tt::to_f32(s_cur[o]), ci = tt::to_f32(s_cur[o + 1]);
          store_pair<T>(s_new + o, nr, ni);
          // two roundings, as the plain version's separate multiply and add
          store_pair<T>(dst.a + o, __fadd_rn(nr, __fmul_rn(beta, nr - cr)),
                        __fadd_rn(ni, __fmul_rn(beta, ni - ci)));
        } else {
          store_pair<T>(dst.a + o, nr, ni);
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

struct Geometry {
  int M, S, win, F, L, hop, lpad, pad, B;
  dim3 g_syn, g_ana;
  int ola_blocks;
  Geometry(int B_, int F_, int n_bins, int n_fft, int hop_, int win_)
      : M(B_ * F_), S(2 * n_bins), win(win_), F(F_), L(hop_ * (F_ - 1)), hop(hop_),
        lpad((n_fft - win_) / 2), pad(n_fft / 2), B(B_),
        g_syn((win_ + BN - 1) / BN, (M + BM - 1) / BM),
        g_ana((S + BN - 1) / BN, (M + BM - 1) / BM),
        ola_blocks((int)(((size_t)B_ * L + 255) / 256)) {}
};

// One iteration: synthesis from `src`, overlap-add, analysis into `dst`.
template <typename T, bool PLANAR>
cudaError_t iterate(const Geometry& g, Spec<const T> src, Spec<T> dst, const float* mag,
                    const T* bwd, const T* fwd, const float* invwss, float* frames,
                    float* sig, const T* s_cur, T* s_new, float beta, cudaStream_t st) {
  gl_gemm<0, T, PLANAR><<<g.g_syn, kThreads, 0, st>>>(
      g.M, g.win, g.S, src, nullptr, bwd, frames, Spec<T>{nullptr, nullptr}, 0, 0, 0, 0,
      nullptr, nullptr, nullptr, 0.f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gl_ola<<<g.ola_blocks, 256, 0, st>>>(frames, invwss, sig, g.B, g.F, g.win, g.hop, g.lpad,
                                       g.pad, g.L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gl_gemm<1, T, PLANAR><<<g.g_ana, kThreads, 0, st>>>(
      g.M, g.S, g.win, Spec<const T>{nullptr, nullptr}, sig, fwd, nullptr, dst, g.F, g.L,
      g.hop, g.lpad - g.pad, mag, s_cur, s_new, beta);
  return cudaGetLastError();
}

template <typename T>
int run_loop(const Geometry& g, const float* mag, void* e_, void* s0_, void* s1_,
             const void* bwd, const void* fwd, const float* invwss, float* frames,
             float* sig, int n_iter, float beta, cudaStream_t st) {
  T* e = static_cast<T*>(e_);
  T* s0 = static_cast<T*>(s0_);
  T* s1 = static_cast<T*>(s1_);
  for (int it = 0; it < n_iter; ++it) {
    T* s_cur = (it % 2 == 0) ? s0 : s1;
    T* s_new = (it % 2 == 0) ? s1 : s0;
    cudaError_t err = iterate<T, false>(
        g, Spec<const T>{e, nullptr}, Spec<T>{e, nullptr}, mag, static_cast<const T*>(bwd),
        static_cast<const T*>(fwd), invwss, frames, sig, beta != 0.f ? s_cur : nullptr,
        beta != 0.f ? s_new : nullptr, beta, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int run_step(const Geometry& g, const float* mag, const void* re, const void* im,
             void* out_re, void* out_im, const void* bwd, const void* fwd,
             const float* invwss, float* frames, float* sig, cudaStream_t st) {
  return (int)iterate<T, true>(
      g, Spec<const T>{static_cast<const T*>(re), static_cast<const T*>(im)},
      Spec<T>{static_cast<T*>(out_re), static_cast<T*>(out_im)}, mag,
      static_cast<const T*>(bwd), static_cast<const T*>(fwd), invwss, frames, sig, nullptr,
      nullptr, 0.f, st);
}

}  // namespace

// n_iter Griffin-Lim iterations, three launches each, on `stream`.
//   lowp: 1 = bf16 storage of e, s0, s1, bwd and fwd; 0 = f32.
//   mag (B*F, n_bins) f32; e (B*F, 2*n_bins): synthesis input, holds the
//   zero-phase start and, with beta == 0, the result; s0/s1 (same shape,
//   only with beta != 0): s0 holds the start, the result ends in s1 when
//   n_iter is odd, else in s0. bwd (2*n_bins, win), fwd (win, 2*n_bins):
//   live-span DFT bases with interleaved (re, im) rows/columns. frames
//   (B*F, win) and sig (B, L) are f32 scratch; invwss has n_fft + hop*(F-1)
//   f32 entries.
extern "C" int tt_griffin_lim(const float* mag, void* e, void* s0, void* s1,
                              const void* bwd, const void* fwd,
                              const float* invwss, float* frames, float* sig,
                              int B, int F, int n_bins, int n_fft, int hop,
                              int win, int n_iter, int lowp, float beta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g(B, F, n_bins, n_fft, hop, win);
  return lowp ? run_loop<__nv_bfloat16>(g, mag, e, s0, s1, bwd, fwd, invwss, frames, sig,
                                        n_iter, beta, st)
              : run_loop<float>(g, mag, e, s0, s1, bwd, fwd, invwss, frames, sig, n_iter,
                                beta, st);
}

// ONE Griffin-Lim iteration without momentum, three launches, on `stream`:
// planar re, im (B*F, n_bins) in the storage type in, out_re, out_im out;
// the other arguments as tt_griffin_lim's.
extern "C" int tt_griffin_lim_step(const float* mag, const void* re, const void* im,
                                   void* out_re, void* out_im, const void* bwd,
                                   const void* fwd, const float* invwss, float* frames,
                                   float* sig, int B, int F, int n_bins, int n_fft,
                                   int hop, int win, int lowp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g(B, F, n_bins, n_fft, hop, win);
  return lowp ? run_step<__nv_bfloat16>(g, mag, re, im, out_re, out_im, bwd, fwd, invwss,
                                        frames, sig, st)
              : run_step<float>(g, mag, re, im, out_re, out_im, bwd, fwd, invwss, frames,
                                sig, st);
}
