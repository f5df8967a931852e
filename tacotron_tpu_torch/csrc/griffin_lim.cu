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
//      inverse-DFT basis (2*n_bins, win);
//   2. overlap-add + normalise: a gather-form OLA (each output sample sums
//      its frames in a fixed order: deterministic, no atomics) times
//      1/max(wss, 1e-11), with the centre n_fft/2 stripped;
//   3. analysis: spectrum (B*F, 2*n_bins) = reflect-padded frames of that
//      signal x windowed DFT basis (win, 2*n_bins), with the magnitude
//      projection mag / max(|X|, 1e-8) and the momentum extrapolation
//      s + b (s - prev) in the product's epilogue.
// Only the window's nonzero span [lpad, lpad + win) of each frame takes
// part, so the dead chunks of the TPU plan are skipped here too. The
// spectrum is stored interleaved (re, im per bin), so that the thread that
// holds a bin's real part also holds its imaginary part for the projection;
// tt_griffin_lim_step keeps the TPU kernel's planar re / im interface.
//
// What bounds it on an H100: the two products, 2 x (B*F) x win x 2*n_bins
// multiply-adds per iteration (72.3 GFLOP at B*F = 8000, n_fft 2048, win
// 1102); the carried spectrum, the frames and the analysis operand cross
// device memory once or twice per iteration, some 250 MB, 80 us at 3.35
// TB/s, much of it in the 50 MB L2.
//
// f32 mode (gl_gemm, gl_ola): CUDA-core products, 67 TFLOP/s peak. A
// register-blocked tile, 128 x 128 per block, 8 x 8 outputs per thread,
// operands staged through shared memory with one tile prefetched in
// registers; the analysis loader reads each frame straight from the f32
// signal, reflect padding by index arithmetic. TF32 would change its
// results, so it stays off the tensor cores.
//
// bf16 mode (gl_wgmma, gl_ola_frame, gl_pack): both products on the tensor
// cores (989 TFLOP/s bf16). Every operand is K-major and zero-padded to a
// multiple of 64 columns once per call (bases: _Plan in dsp/fused_gl.py;
// carriers: row stride S_pad = 2112 at 2048/1102), so that TMA can read it
// and rows are 16-byte aligned:
//   synthesis  frames (M, win_pad) f32 = e (M, S_pad) . bwd_t (win_pad, S_pad)^T
//   OLA+frame  each thread sums one signal sample once, as gl_ola does,
//              rounds it to bf16 and writes it into every (frame, column)
//              slot of the analysis operand ana (M, win_pad) where it
//              appears, reflected slots at both edges included: each slot
//              is written exactly once per iteration. (Frame starts sit
//              hop = 275 samples apart, so frames of the signal itself are
//              neither aligned nor describable to TMA.)
//   analysis   spectrum = ana . fwd_t (S_pad, win_pad)^T, the projection and
//              momentum in the epilogue; only columns n < 2*n_bins are
//              written, so the carriers' pad columns stay zero.
// The product kernel: two consumer warpgroups issue wgmma.mma_async
// m64n128k16 with both operands in shared memory (128-byte swizzle); one
// producer warp keeps a ring of 64-deep A and B tiles full with TMA loads,
// full/empty mbarriers between them. Both products take 128 x 128 tiles;
// analysis keeps one wgmma group in flight while the next stage's barrier
// is awaited (6 stages). Synthesis waits for each k-tile's group and adds
// its sum into the accumulator with rounded f32 adds (4 stages): summed on
// the tensor cores alone, its frames drifted from the plain loop's by more
// than a bf16 ulp where the spectrogram sits at its floor (see gl_wgmma).
// That costs it a second 64-register fragment, so its tile is 128 rows, not
// the 256 that served it best before (168 registers per thread is the limit
// for 288 threads). The analysis epilogue's inputs (magnitude, current
// iterate) are loaded into registers before the products start: loaded
// after them, one dependent load at a time, they doubled the analysis time.
// A tensor-core accumulator fragment gives a thread columns 2c and 2c+1 of
// its row: both parts of one bin, as the projection needs. Wave
// quantisation at [main]'s shape (M 8000): 63 x 9 = 567 synthesis tiles and
// 63 x 17 = 1071 analysis tiles on 132 SMs with one block each, 4.3 and 8.1
// waves.
// Rounding points (those of gl_step_reference / gl_spectrum_reference): the
// carriers are bf16; the extrapolation is formed in f32 with two roundings
// and rounded to bf16 as the synthesis operand; both products take bf16
// operands and accumulate in f32 (in the tensor cores' order, synthesis with
// a rounded add per 64 terms); frames, OLA, 1/wss and the reflect pad are
// f32; the analysis operand is rounded to bf16 after the normalise; |X|^2,
// the sqrt and the division of the projection round as the plain version's
// separate operations do, and the projected values are rounded to the bf16
// carrier. tt_griffin_lim_step packs its planar input into the padded
// interleaved carrier (one launch) and then runs the same three launches as
// tt_griffin_lim, so at beta 0 the two are bit-equal.
#include <cuda.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- f32 mode

constexpr int BM = 128, BN = 128, BK = 8, kThreads = 256;

// The spectrum operand / result of one product. Interleaved: one array
// (M, 2*n_bins), (re, im) per bin. Planar: a = re, b = im, each (M, n_bins).
template <typename T> struct Spec {
  T* a;
  T* b;
};

// MODE 0 (synthesis): A = spectrum rows (src), frames written out.
// MODE 1 (analysis): A gathered from the signal with reflect padding; the
// epilogue projects onto the target magnitude and writes the spectrum (dst).
// PLANAR: spectrum layout.
template <int MODE, bool PLANAR>
__global__ void __launch_bounds__(kThreads)
gl_gemm(int M, int N, int K, Spec<const float> src, const float* __restrict__ sig,
        const float* __restrict__ Bm, float* __restrict__ frames, Spec<float> dst,
        int F, int L, int hop, int off, const float* __restrict__ mag,
        const float* __restrict__ s_cur, float* __restrict__ s_new, float beta) {
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
          v = PLANAR ? ((k & 1) ? src.b : src.a)[arow * (K / 2) + (k >> 1)]
                     : src.a[arow * K + k];
        } else {
          int idx = abase + k;
          idx = idx < 0 ? -idx : idx;
          idx = idx >= L ? 2 * (L - 1) - idx : idx;
          v = srow[idx];
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
        const float nr = re * scale, ni = im * scale;
        if (PLANAR) {
          const size_t o = (size_t)m * (N / 2) + n / 2;
          dst.a[o] = nr;
          dst.b[o] = ni;
          continue;
        }
        const size_t o = (size_t)m * N + n;
        if (s_new) {
          const float cr = s_cur[o], ci = s_cur[o + 1];
          *reinterpret_cast<float2*>(s_new + o) = make_float2(nr, ni);
          // two roundings, as the plain version's separate multiply and add
          *reinterpret_cast<float2*>(dst.a + o) = make_float2(
              __fadd_rn(nr, __fmul_rn(beta, nr - cr)), __fadd_rn(ni, __fmul_rn(beta, ni - ci)));
        } else {
          *reinterpret_cast<float2*>(dst.a + o) = make_float2(nr, ni);
        }
      }
    }
  }
}

// One sample's overlap-add: the sum over the frames whose live span [lpad,
// lpad + NC) covers it, in frame order; c = the sample's column in frame 0
// (s + pad - lpad), frame f holds it at column c - f*hop.
__device__ __forceinline__ float ola_sample(const float* __restrict__ frames, int ldf, int F,
                                            int NC, int hop, int c) {
  const int f_hi = c < 0 ? -1 : min(F - 1, c / hop);
  const int lo_num = c - NC + 1;
  const int f_lo = lo_num <= 0 ? 0 : (lo_num + hop - 1) / hop;
  float y = 0.f;
  for (int f = f_lo; f <= f_hi; ++f) y += frames[(size_t)f * ldf + (c - f * hop)];
  return y;
}

// sig[b, s] = invwss[s + pad] * sum_f frames[b, f, s + pad - f*hop - lpad],
// over the frames whose live span [lpad, lpad + NC) covers the sample.
__global__ void gl_ola(const float* __restrict__ frames,
                       const float* __restrict__ invwss, float* __restrict__ sig,
                       int Bn, int F, int NC, int hop, int lpad, int pad, int L) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)Bn * L) return;
  const int b = (int)(idx / L), s = (int)(idx % L);
  const int t = s + pad;
  sig[idx] = ola_sample(frames + (size_t)b * F * NC, NC, F, NC, hop, t - lpad) * invwss[t];
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

// One f32 iteration: synthesis from `src`, overlap-add, analysis into `dst`.
template <bool PLANAR>
cudaError_t iterate_f32(const Geometry& g, Spec<const float> src, Spec<float> dst,
                        const float* mag, const float* bwd, const float* fwd,
                        const float* invwss, float* frames, float* sig, const float* s_cur,
                        float* s_new, float beta, cudaStream_t st) {
  gl_gemm<0, PLANAR><<<g.g_syn, kThreads, 0, st>>>(
      g.M, g.win, g.S, src, nullptr, bwd, frames, Spec<float>{nullptr, nullptr}, 0, 0, 0, 0,
      nullptr, nullptr, nullptr, 0.f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gl_ola<<<g.ola_blocks, 256, 0, st>>>(frames, invwss, sig, g.B, g.F, g.win, g.hop, g.lpad,
                                       g.pad, g.L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gl_gemm<1, PLANAR><<<g.g_ana, kThreads, 0, st>>>(
      g.M, g.S, g.win, Spec<const float>{nullptr, nullptr}, sig, fwd, nullptr, dst, g.F, g.L,
      g.hop, g.lpad - g.pad, mag, s_cur, s_new, beta);
  return cudaGetLastError();
}

// ------------------------------------------------------------- bf16 mode

namespace tc {

constexpr int kPad = 64;                       // column padding of every operand
constexpr int BK = 64;                         // one 128-byte swizzle row of bf16
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // + one producer warp

// A block's tile: each consumer warpgroup owns WM x 64 rows and all WN x 128
// columns; a ring of STAGES stages of (BM x 64 A, BN x 64 B) tiles.
template <int WM_, int WN_, int STAGES_>
struct Tile {
  static constexpr int WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int BM = 2 * 64 * WM, BN = 128 * WN;
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr int SMEM = STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8 + 1024;
};
using SynTile = Tile<1, 1, 4>;                 // synthesis: frames = e . bwd_t^T
using AnaTile = Tile<1, 1, 6>;                 // analysis: spectrum = ana . fwd_t^T

__host__ __device__ constexpr int padded(int n) { return (n + kPad - 1) / kPad * kPad; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A wait
// that never ends (a fault in the pipeline) traps, so the launch fails with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

// TMA: the box at (column c0, row c1) of `map` into shared memory; the
// barrier counts the bytes as they land.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with
// the 128-byte swizzle (as TMA writes it): start address >> 4, leading
// byte offset 16 (unused by this layout), stride byte offset 1024 (one
// 8-row swizzle atom), layout 1 = SWIZZLE_128B. The tile's 8-row atoms
// start on 1024-byte boundaries; a k16 step advances the start by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Keep the compiler from moving accumulator registers across the async MMAs.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32, the warpgroup's fragment) = A (64 x 16) . B (128 x 16)^T,
// plus d when `accumulate`
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// C (M x N) = A (M x K) . B (N x K)^T, A and B bf16 K-major behind TMA maps
// (K a multiple of 64; rows past M or N read as zeros), f32 accumulation.
// MODE 0 (synthesis): C stored as f32 frames (row stride ldc), n < N.
// MODE 1 (analysis): C is the interleaved spectrum, n < N = 2*n_bins; the
// epilogue projects it onto `mag` and writes planar re / im (dst_a, dst_b;
// PLANAR) or the interleaved carrier dst_a (row stride ldc), with momentum
// also s_new = projection and dst_a = s_new + beta (s_new - s_cur).
template <int MODE, bool PLANAR, class T>
__global__ void __launch_bounds__(kThreads, 1)
gl_wgmma(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
         int M, int N, int K, int ldc, float* __restrict__ frames,
         const float* __restrict__ mag, int nb, bf16* __restrict__ dst_a,
         bf16* __restrict__ dst_b, const bf16* __restrict__ s_cur, bf16* __restrict__ s_new,
         float beta) {
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = reinterpret_cast<bf16*>(smem + STAGES * T::A_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * (T::A_BYTES + T::B_BYTES));
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int n_k = K / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {   // the producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], T::A_BYTES + T::B_BYTES);
        tma_load(sa + s * T::BM * BK, &tm_a, &full[s], kt * BK, m0);
        tma_load(sb + s * T::BN * BK, &tm_b, &full[s], kt * BK, n0);
      }
    }
    return;
  }

  // fragment of one m64n128 product: d[4c + 2h + {0, 1}] = C[row, col + {0,
  // 1}], row = 16 w + lane/4 + 8h, col = 8c + 2 (lane % 4), w the warp
  // within the warpgroup; this warpgroup's rows: wg * WM * 64 .. + WM * 64 - 1
  const int wg = tid >> 7, t = tid & 127, lane = t & 31;
  auto row = [&](int i, int h) {
    return m0 + (wg * T::WM + i) * 64 + (t >> 5) * 16 + (lane >> 2) + 8 * h;
  };
  auto col = [&](int j, int c) { return n0 + j * 128 + 8 * c + 2 * (lane & 3); };

  // the analysis epilogue's inputs (the magnitude and, with momentum, the
  // current iterate), loaded while the products run: loaded in the
  // epilogue, each waited on its own, they doubled the analysis time
  float mg[T::WM][T::WN][16][2];
  __nv_bfloat162 cur[T::WM][T::WN][16][2];
  if constexpr (MODE == 1) {
#pragma unroll
    for (int i = 0; i < T::WM; ++i)
#pragma unroll
      for (int j = 0; j < T::WN; ++j)
#pragma unroll
        for (int c = 0; c < 16; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = row(i, h), n = col(j, c);
            const bool ok = m < M && n < N;
            mg[i][j][c][h] = ok ? __ldg(mag + (size_t)m * nb + n / 2) : 0.f;
            if (!PLANAR && s_new)
              cur[i][j][c][h] = ok ? *reinterpret_cast<const __nv_bfloat162*>(
                                         s_cur + (size_t)m * ldc + n)
                                   : __floats2bfloat162_rn(0.f, 0.f);
          }
  }

  // The tensor cores do not round each f32 add to nearest as an fmaf chain
  // does. The synthesis sums cancel most of their 2112 terms where the
  // spectrogram is near its floor, and accumulated on the tensor cores they
  // drifted from the plain f32 loop by more than one bf16 ulp of the frames.
  // So synthesis sums each 64-deep k-tile from zero on the tensor cores
  // (`part`) and adds it to the f32 accumulator with a rounded add; the
  // analysis sums need no such step and accumulate in place.
  constexpr bool PROMOTE = MODE == 0;
  float acc[T::WM][T::WN][64], part[T::WM][T::WN][64];
#pragma unroll
  for (int i = 0; i < T::WM; ++i)
#pragma unroll
    for (int j = 0; j < T::WN; ++j)
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[i][j][r] = part[i][j][r] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const bf16* a = sa + s * T::BM * BK + wg * T::WM * 64 * BK;
    const bf16* b = sb + s * T::BN * BK;
#pragma unroll
    for (int i = 0; i < T::WM; ++i)
#pragma unroll
      for (int j = 0; j < T::WN; ++j) {
        if constexpr (PROMOTE)
          fence_acc(part[i][j]);
        else
          fence_acc(acc[i][j]);
      }
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < T::WM; ++i)
#pragma unroll
        for (int j = 0; j < T::WN; ++j) {
          const uint64_t da = sw128_desc(a + i * 64 * BK + kk * 16),
                         db = sw128_desc(b + j * 128 * BK + kk * 16);
          if constexpr (PROMOTE)
            wgmma_m64n128k16(part[i][j], da, db, kk > 0);
          else
            wgmma_m64n128k16(acc[i][j], da, db, 1);
        }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if constexpr (PROMOTE) {
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < T::WM; ++i)
#pragma unroll
        for (int j = 0; j < T::WN; ++j) fence_acc(part[i][j]);
      if (t == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < T::WM; ++i)
#pragma unroll
        for (int j = 0; j < T::WN; ++j)
#pragma unroll
          for (int r = 0; r < 64; ++r) acc[i][j][r] = __fadd_rn(acc[i][j][r], part[i][j][r]);
    } else {
#pragma unroll
      for (int i = 0; i < T::WM; ++i)
#pragma unroll
        for (int j = 0; j < T::WN; ++j) fence_acc(acc[i][j]);
      // the previous stage's products are done: hand its buffers back
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (kt > 0 && t == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int i = 0; i < T::WM; ++i)
#pragma unroll
    for (int j = 0; j < T::WN; ++j) fence_acc(acc[i][j]);

#pragma unroll
  for (int i = 0; i < T::WM; ++i)
#pragma unroll
    for (int j = 0; j < T::WN; ++j)
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row(i, h), n = col(j, c);
          if (m >= M || n >= N) continue;
          const float re = acc[i][j][4 * c + 2 * h], im = acc[i][j][4 * c + 2 * h + 1];
          if constexpr (MODE == 0) {
            *reinterpret_cast<float2*>(frames + (size_t)m * ldc + n) = make_float2(re, im);
          } else {
            const float scale = mg[i][j][c][h] /
                                fmaxf(sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im))),
                                      1e-8f);
            const bf16 br = __float2bfloat16_rn(re * scale);
            const bf16 bi = __float2bfloat16_rn(im * scale);
            if constexpr (PLANAR) {
              dst_a[(size_t)m * nb + n / 2] = br;
              dst_b[(size_t)m * nb + n / 2] = bi;
              continue;
            }
            const size_t o = (size_t)m * ldc + n;
            if (s_new) {
              const float nr = __bfloat162float(br), ni = __bfloat162float(bi);
              const float2 cv = __bfloat1622float2(cur[i][j][c][h]);
              *reinterpret_cast<__nv_bfloat162*>(s_new + o) = __halves2bfloat162(br, bi);
              // two roundings, as the plain version's separate multiply and add
              *reinterpret_cast<__nv_bfloat162*>(dst_a + o) =
                  __floats2bfloat162_rn(__fadd_rn(nr, __fmul_rn(beta, nr - cv.x)),
                                        __fadd_rn(ni, __fmul_rn(beta, ni - cv.y)));
            } else {
              *reinterpret_cast<__nv_bfloat162*>(dst_a + o) = __halves2bfloat162(br, bi);
            }
          }
        }
}

// Write v into every slot (f, c - f*hop) of rows (frame f's row, stride
// lda) whose live column range [0, NC) holds column c of frame 0.
__device__ __forceinline__ void put_slots(bf16* __restrict__ rows, int lda, int F, int NC,
                                          int hop, int c, bf16 v) {
  if (c < 0) return;
  const int f_hi = min(F - 1, c / hop);
  const int lo_num = c - NC + 1;
  for (int f = lo_num <= 0 ? 0 : (lo_num + hop - 1) / hop; f <= f_hi; ++f)
    rows[(size_t)f * lda + (c - f * hop)] = v;
}

// Overlap-add, normalise and frame: thread (b, s) forms signal sample s as
// gl_ola does, rounds it to bf16 and writes it into the analysis operand
// ana (B*F rows, stride lda) wherever the reflect-padded framing reads it.
// Slot (f, k) reads sample reflect(f*hop + k - off), off = pad - lpad: the
// sample itself (column c = s + off of frame 0), its mirror -s at the left
// edge (s > 0) and its mirror 2(L-1) - s at the right edge (s < L-1); each
// slot has exactly one such sample.
__global__ void gl_ola_frame(const float* __restrict__ frames, int ldf,
                             const float* __restrict__ invwss, bf16* __restrict__ ana, int lda,
                             int Bn, int F, int NC, int hop, int lpad, int pad, int L) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)Bn * L) return;
  const int b = (int)(idx / L), s = (int)(idx % L);
  const int off = pad - lpad;
  const float y = ola_sample(frames + (size_t)b * F * ldf, ldf, F, NC, hop, s + off);
  const bf16 v = __float2bfloat16_rn(y * invwss[s + pad]);
  bf16* rows = ana + (size_t)b * F * lda;
  put_slots(rows, lda, F, NC, hop, s + off, v);
  if (s > 0) put_slots(rows, lda, F, NC, hop, off - s, v);
  if (s < L - 1) put_slots(rows, lda, F, NC, hop, off + 2 * (L - 1) - s, v);
}

// Planar re, im (M, nb) -> the interleaved carrier e (row stride lde).
__global__ void gl_pack(const bf16* __restrict__ re, const bf16* __restrict__ im,
                        bf16* __restrict__ e, int lde, int M, int nb) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * nb) return;
  const size_t m = idx / nb, j = idx % nb;
  *reinterpret_cast<__nv_bfloat162*>(e + m * lde + 2 * j) = __halves2bfloat162(re[idx], im[idx]);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver (libcuda); the runtime hands
// out its entry point, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a (rows, cols) bf16 matrix with row stride ld, read in
// boxes of box_rows x 64 with the 128-byte swizzle; rows past `rows` read
// as zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                       int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The bf16 mode's shapes and the TMA maps of its four product operands
// (they depend only on the buffers, so are built once per C call).
struct TcPlan {
  int M, S, S_pad, win, win_pad, nb, F, L, hop, lpad, pad, B;
  dim3 g_syn, g_ana;
  int ola_blocks;
  CUtensorMap syn_a, syn_b, ana_a, ana_b;
  TcPlan(int B_, int F_, int n_bins, int n_fft, int hop_, int win_)
      : M(B_ * F_), S(2 * n_bins), S_pad(padded(2 * n_bins)), win(win_),
        win_pad(padded(win_)), nb(n_bins), F(F_), L(hop_ * (F_ - 1)), hop(hop_),
        lpad((n_fft - win_) / 2), pad(n_fft / 2), B(B_),
        g_syn((win_pad + SynTile::BN - 1) / SynTile::BN, (M + SynTile::BM - 1) / SynTile::BM),
        g_ana((S + AnaTile::BN - 1) / AnaTile::BN, (M + AnaTile::BM - 1) / AnaTile::BM),
        ola_blocks((int)(((size_t)B_ * L + 255) / 256)) {}

  cudaError_t init(const bf16* e, const bf16* bwd_t, const bf16* ana, const bf16* fwd_t) {
    cudaError_t err;
    if ((err = tensor_map(&syn_a, e, M, S_pad, S_pad, SynTile::BM)) != cudaSuccess) return err;
    if ((err = tensor_map(&syn_b, bwd_t, win_pad, S_pad, S_pad, SynTile::BN)) != cudaSuccess)
      return err;
    if ((err = tensor_map(&ana_a, ana, M, win_pad, win_pad, AnaTile::BM)) != cudaSuccess)
      return err;
    if ((err = tensor_map(&ana_b, fwd_t, S_pad, win_pad, win_pad, AnaTile::BN)) != cudaSuccess)
      return err;
    const void* kernels[] = {(const void*)gl_wgmma<1, false, AnaTile>,
                             (const void*)gl_wgmma<1, true, AnaTile>};
    for (const void* k : kernels)
      if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      AnaTile::SMEM)) != cudaSuccess)
        return err;
    return cudaFuncSetAttribute((const void*)gl_wgmma<0, false, SynTile>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, SynTile::SMEM);
  }
};

// One bf16 iteration: synthesis from the carrier behind syn_a, overlap-add
// + frame into the analysis operand, analysis into dst.
template <bool PLANAR>
cudaError_t iterate_bf16(const TcPlan& g, const float* mag, const float* invwss, float* frames,
                         bf16* ana, bf16* dst_a, bf16* dst_b, const bf16* s_cur, bf16* s_new,
                         float beta, cudaStream_t st) {
  gl_wgmma<0, false, SynTile><<<g.g_syn, kThreads, SynTile::SMEM, st>>>(
      g.syn_a, g.syn_b, g.M, g.win_pad, g.S_pad, g.win_pad, frames, nullptr, 0, nullptr,
      nullptr, nullptr, nullptr, 0.f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gl_ola_frame<<<g.ola_blocks, 256, 0, st>>>(frames, g.win_pad, invwss, ana, g.win_pad, g.B,
                                             g.F, g.win, g.hop, g.lpad, g.pad, g.L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gl_wgmma<1, PLANAR, AnaTile><<<g.g_ana, kThreads, AnaTile::SMEM, st>>>(
      g.ana_a, g.ana_b, g.M, g.S, g.win_pad, g.S_pad, nullptr, mag, g.nb, dst_a, dst_b, s_cur,
      s_new, beta);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace

// n_iter Griffin-Lim iterations, three launches each, on `stream`.
//   lowp 0 (f32): mag (B*F, n_bins) f32; e (B*F, 2*n_bins): synthesis
//   input, holds the zero-phase start and, with beta == 0, the result;
//   s0/s1 (same shape, only with beta != 0): s0 holds the start, the result
//   ends in s1 when n_iter is odd, else in s0. bwd (2*n_bins, win), fwd
//   (win, 2*n_bins): live-span DFT bases with interleaved (re, im)
//   rows/columns. frames (B*F, win) and work = the signal (B, L) are f32
//   scratch; invwss has n_fft + hop*(F-1) f32 entries.
//   lowp 1 (bf16): e, s0, s1 bf16 (B*F, S_pad), S_pad = 2*n_bins rounded up
//   to a multiple of 64, pad columns zero; bwd = bwd^T (win_pad, S_pad), fwd
//   = fwd^T (S_pad, win_pad) bf16, zero-padded (win_pad: win rounded up to a
//   multiple of 64); frames (B*F, win_pad) f32; work = the analysis operand
//   (B*F, win_pad) bf16, pad columns zero.
extern "C" int tt_griffin_lim(const float* mag, void* e, void* s0, void* s1,
                              const void* bwd, const void* fwd,
                              const float* invwss, float* frames, void* work,
                              int B, int F, int n_bins, int n_fft, int hop,
                              int win, int n_iter, int lowp, float beta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!lowp) {
    const Geometry g(B, F, n_bins, n_fft, hop, win);
    float* ef = static_cast<float*>(e);
    for (int it = 0; it < n_iter; ++it) {
      float* s_cur = static_cast<float*>(it % 2 == 0 ? s0 : s1);
      float* s_new = static_cast<float*>(it % 2 == 0 ? s1 : s0);
      const cudaError_t err = iterate_f32<false>(
          g, Spec<const float>{ef, nullptr}, Spec<float>{ef, nullptr}, mag,
          static_cast<const float*>(bwd), static_cast<const float*>(fwd), invwss, frames,
          static_cast<float*>(work), beta != 0.f ? s_cur : nullptr,
          beta != 0.f ? s_new : nullptr, beta, st);
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  tc::TcPlan g(B, F, n_bins, n_fft, hop, win);
  bf16* eb = static_cast<bf16*>(e);
  bf16* ana = static_cast<bf16*>(work);
  cudaError_t err = g.init(eb, static_cast<const bf16*>(bwd), ana, static_cast<const bf16*>(fwd));
  if (err != cudaSuccess) return (int)err;
  for (int it = 0; it < n_iter; ++it) {
    bf16* s_cur = static_cast<bf16*>(it % 2 == 0 ? s0 : s1);
    bf16* s_new = static_cast<bf16*>(it % 2 == 0 ? s1 : s0);
    err = tc::iterate_bf16<false>(g, mag, invwss, frames, ana, eb, nullptr,
                              beta != 0.f ? s_cur : nullptr, beta != 0.f ? s_new : nullptr,
                              beta, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ONE Griffin-Lim iteration without momentum, on `stream`: planar re, im
// (B*F, n_bins) in the storage type in, out_re, out_im out; the other
// arguments as tt_griffin_lim's. f32: three launches. bf16: four, the
// first packing re, im into e (the padded interleaved carrier, B*F x S_pad,
// pad columns zero), then tt_griffin_lim's three.
extern "C" int tt_griffin_lim_step(const float* mag, const void* re, const void* im,
                                   void* out_re, void* out_im, const void* bwd,
                                   const void* fwd, const float* invwss, float* frames,
                                   void* work, void* e, int B, int F, int n_bins, int n_fft,
                                   int hop, int win, int lowp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!lowp) {
    const Geometry g(B, F, n_bins, n_fft, hop, win);
    return (int)iterate_f32<true>(
        g, Spec<const float>{static_cast<const float*>(re), static_cast<const float*>(im)},
        Spec<float>{static_cast<float*>(out_re), static_cast<float*>(out_im)}, mag,
        static_cast<const float*>(bwd), static_cast<const float*>(fwd), invwss, frames,
        static_cast<float*>(work), nullptr, nullptr, 0.f, st);
  }
  tc::TcPlan g(B, F, n_bins, n_fft, hop, win);
  bf16* eb = static_cast<bf16*>(e);
  bf16* ana = static_cast<bf16*>(work);
  cudaError_t err = g.init(eb, static_cast<const bf16*>(bwd), ana, static_cast<const bf16*>(fwd));
  if (err != cudaSuccess) return (int)err;
  const int n = g.M * n_bins;
  tc::gl_pack<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const bf16*>(re),
                                           static_cast<const bf16*>(im), eb, g.S_pad, g.M,
                                           n_bins);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)tc::iterate_bf16<true>(g, mag, invwss, frames, ana, static_cast<bf16*>(out_re),
                                 static_cast<bf16*>(out_im), nullptr, nullptr, 0.f, st);
}

// Dynamic shared memory of one block of the bf16 mode's synthesis (0) or
// analysis (1) product, bytes.
extern "C" int tt_griffin_lim_smem(int analysis) {
  return analysis ? tc::AnaTile::SMEM : tc::SynTile::SMEM;
}
