// Griffin-Lim phase recovery: every iteration as three hand-written
// launches. Two storage modes: f32 throughout, or bf16 (carried spectrum,
// previous iterate, both DFT bases and both product operands in bf16, f32
// accumulation, everything else f32). Both run their two DFT products on
// the tensor cores.
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
//   2. overlap-add + normalise + frame: a gather-form OLA (each output sample
//      sums its frames in a fixed order: deterministic, no atomics) times
//      1/max(wss, 1e-11), with the centre n_fft/2 stripped, written into the
//      reflect-padded frames of the next product's operand;
//   3. analysis: spectrum (B*F, 2*n_bins) = those frames x windowed DFT
//      basis (win, 2*n_bins), with the magnitude projection
//      mag / max(|X|, 1e-8) and the momentum extrapolation s + b (s - prev)
//      in the product's epilogue.
// Only the window's nonzero span [lpad, lpad + win) of each frame takes
// part, so the dead chunks of the TPU plan are skipped here too. The
// spectrum is stored interleaved (re, im per bin), so that the thread that
// holds a bin's real part also holds its imaginary part for the projection;
// tt_griffin_lim_step keeps the TPU kernel's planar re / im interface and
// packs it into the interleaved carrier first (a fourth launch).
//
// What bounds it on an H100: the two products, 2 x (B*F) x win x 2*n_bins
// multiply-adds per iteration (72.3 GFLOP at B*F = 8000, n_fft 2048, win
// 1102); the carried spectrum, the frames and the analysis operand cross
// device memory once or twice per iteration, some 250 MB (f32), 80 us at
// 3.35 TB/s, much of it in the 50 MB L2. In bf16 the products' bound is
// 73.1 us at 989 TFLOP/s.
//
// f32 mode: the TPU kernel's f32 products are jax.lax.dot_general calls on
// its matrix unit. One TF32 pass keeps 11 of f32's 24 significant bits, so
// each f32 product is taken as several: every operand is split into TF32
// pieces (x0 = tf32(x), x1 = tf32(x - x0), ..., round to nearest even), and
// the tensor cores take the products of pieces i and j with i + j <= 2,
// each exact in f32, with f32 accumulation. The operand that changes every
// iteration (carried spectrum, analysis operand) gets three pieces, which
// hold it exactly; the DFT bases two (kPiecesA, kPiecesB below): five
// products, as exact as the plain f32 loop on every magnitude measured
// (two pieces of each operand keep 22 bits and were not, with three
// products or four; see kPiecesA). tests/test_torch_split_tf32.py emulates
// it on the CPU. The bound is that of the least split, big.big + big.small
// + small.big: 3 x 72.3 = 216.9 GFLOP of TF32 work per iteration, 0.438 ms
// at 495 TFLOP/s; the same products on the CUDA cores (67 TFLOP/s f32)
// are bound at 1.079 ms. The five products taken here are 361.5 GFLOP,
// 0.730 ms at the TF32 peak: the design pays the two extra products for
// exactness, on tensor cores seven times the CUDA cores' rate. The bases are
// split once per call on the host (K-major, zero-padded). The changing
// operand stays one f32 array in device memory: each consumer warpgroup
// splits its rows of every A tile in shared memory after the TMA load
// (piece 0 in place, the others beside it), so no extra byte crosses HBM.
// Each 32-deep k-tile's products are summed from zero on the tensor cores,
// the smallest first, and added into the f32 accumulator with a rounded add
// (the tensor cores' accumulation is not an IEEE f32 sum; see gl_wgmma), in
// both products. A stage holds five 16 KiB tiles (A three pieces, B two):
// two stages, 161 KiB of shared memory per block.
//
// bf16 mode: both products on the tensor cores (989 TFLOP/s bf16), one pass.
//
// Both modes: every operand is K-major and zero-padded to a multiple of 64
// columns once per call (bases: _Plan in dsp/fused_gl.py; carriers: row
// stride S_pad = 2112 at 2048/1102), so that TMA can read it and rows are
// 16-byte aligned:
//   synthesis  frames (M, win_pad) f32 = e (M, S_pad) . bwd_t (win_pad, S_pad)^T
//   OLA+frame  each thread sums one signal sample once, rounds it to the
//              storage type and writes it into every (frame, column) slot of
//              the analysis operand ana (M, win_pad) where it appears,
//              reflected slots at both edges included: each slot is written
//              exactly once per iteration. (Frame starts sit hop = 275
//              samples apart, so frames of the signal itself are neither
//              aligned nor describable to TMA.)
//   analysis   spectrum = ana . fwd_t (S_pad, win_pad)^T, the projection and
//              momentum in the epilogue; only columns n < 2*n_bins are
//              written, so the carriers' pad columns stay zero.
// The product kernel: two consumer warpgroups issue wgmma.mma_async
// m64n128k16 (bf16) or m64n128k8 (tf32) with both operands in shared memory
// (128-byte swizzle: one swizzle row is one k-tile row, 64 bf16 or 32 f32);
// one producer warp keeps a ring of A and B tiles full with TMA loads,
// full/empty mbarriers between them. Both products take 128 x 128 tiles.
// bf16 analysis keeps one wgmma group in flight while the next stage's
// barrier is awaited (6 stages). bf16 synthesis, and both f32 products,
// wait for each k-tile's group and add its sum into the accumulator with
// rounded f32 adds (bf16 synthesis 4 stages): summed on the tensor cores
// alone, the bf16 frames drifted from the plain loop's by more than a bf16
// ulp where the spectrogram sits at its floor (see gl_wgmma). That costs a
// second 64-register fragment, so the tile is 128 rows (168 registers per
// thread is the limit for 288 threads). The bf16 analysis epilogue's inputs
// (magnitude, current iterate) are loaded into registers before the
// products start: loaded after them, one dependent load at a time, they
// doubled the analysis time; the f32 epilogue, with no registers to spare
// during its products, loads them after the products in batches. A
// tensor-core accumulator fragment gives a thread columns 2c and 2c+1 of
// its row: both parts of one bin, as the projection needs. Wave
// quantisation at [main]'s shape (M 8000): 63 x 9 = 567 synthesis tiles and
// 63 x 17 = 1071 analysis tiles on 132 SMs with one block each, 4.3 and 8.1
// waves.
// Rounding points (those of gl_step_reference / gl_spectrum_reference): the
// carriers are in the storage type; the extrapolation is formed in f32 with
// two roundings and rounded to the storage type as the synthesis operand;
// both products accumulate in f32 (bf16: bf16 operands, in the tensor cores'
// order, synthesis with a rounded add per 64 terms; f32: the split products,
// a rounded add per 32 terms); frames, OLA, 1/wss and the reflect pad are
// f32; the analysis operand is rounded to the storage type after the
// normalise; |X|^2, the sqrt and the division of the projection round as
// the plain version's separate operations do, and the projected values are
// rounded to the carrier. tt_griffin_lim_step packs its planar input into
// the padded interleaved carrier (one launch) and then runs the same three
// launches as tt_griffin_lim, so at beta 0 the two are bit-equal.
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

namespace tc {

constexpr int kPad = 64;                       // column padding of every operand
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // + one producer warp

// The f32 mode's split: TF32 pieces of the A operand (the carried spectrum
// or the analysis operand, split in shared memory) and of the B operand
// (the bases, split on the host into kPiecesB pieces: TF32_PIECES in
// dsp/fused_gl.py, which a test holds equal to these); the products of
// pieces i of A and j of B with i + j <= 2 are taken, five for 3 and 2.
// Three pieces hold an f32 value exactly, two keep 22 of its 24
// significant bits. On an H100 80GB HBM3 at 700.00 W
// (scripts/gl_tf32_precision.py) one step's largest error against an f64
// step, over the plain f32 step's, is past 2x on a speech-like spectrogram
// whose synthesis sums cancel 100-fold for 2 and 2 pieces (3.4x with the
// classic three products, 3.2x with small.small as well) and 0.38-0.52x
// for 3 and 2; 3 and 3 (six products) 0.20-0.30x at 10% more time. 3 and 2
// without small.small (four products) passes the step rule, 9% faster,
// but its product alone is 2.5x the plain f32 product's error where the
// sums cancel 100-fold (five: 1.4x; tests/test_torch_split_tf32.py).
constexpr int kPiecesA = 3;
constexpr int kPiecesB = 2;

// A block's tile: each consumer warpgroup owns WM x 64 rows and all WN x 128
// columns; a ring of STAGES stages of (BM x BK A, BN x BK B) tiles, BK the
// k-tile depth in elements of E: one 128-byte swizzle row (64 bf16, 32 f32).
// E = float is the f32 mode: each stage holds PA pieces of the A tile and PB
// of the B tile, and there are as many stages as fit (at most 3).
template <int WM_, int WN_, int STAGES_, class E_ = bf16>
struct Tile {
  using E = E_;
  static constexpr bool SPLIT = std::is_same<E, float>::value;
  static constexpr int PA = SPLIT ? kPiecesA : 1, PB = SPLIT ? kPiecesB : 1;
  static constexpr int WM = WM_, WN = WN_;
  static constexpr int BK = 128 / (int)sizeof(E);
  static constexpr int BM = 2 * 64 * WM, BN = 128 * WN;
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
  static constexpr int STAGE_BYTES = PA * A_BYTES + PB * B_BYTES;
  static constexpr int FIT = (232448 - 1024 - 64) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_ < FIT ? STAGES_ : FIT;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};
using SynTile = Tile<1, 1, 4>;                 // synthesis: frames = e . bwd_t^T
using AnaTile = Tile<1, 1, 6>;                 // analysis: spectrum = ana . fwd_t^T
using SynTileF32 = Tile<1, 1, 3, float>;       // the same, f32 mode (split TF32)
using AnaTileF32 = Tile<1, 1, 3, float>;

// The B operand's TMA maps: one per piece (the f32 mode's split bases).
struct BMaps {
  CUtensorMap m[3];
};
static_assert(kPiecesA <= 3 && kPiecesB <= 3, "three pieces hold an f32 value exactly");

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
// start on 1024-byte boundaries; a k-step (k16 bf16, k8 tf32) advances the
// start by 32 bytes.
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

#define TT_WGMMA_D64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "          \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
#define TT_WGMMA_D64_OUT(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),           \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
      "+f"(d[62]), "+f"(d[63])

// d (64 x 128, f32, the warpgroup's fragment) = A (64 x K) . B (128 x K)^T,
// plus d when `accumulate`; K = 16 bf16 or 8 tf32 (32 bytes of each row)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TT_WGMMA_D64
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : TT_WGMMA_D64_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TT_WGMMA_D64
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : TT_WGMMA_D64_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <class E>
__device__ __forceinline__ void wgmma_k_step(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
  if constexpr (std::is_same<E, float>::value)
    wgmma_m64n128k8_tf32(d, a, b, accumulate);
  else
    wgmma_m64n128k16(d, a, b, accumulate);
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest even; as
// tf32_round in dsp/fused_gl.py
__device__ __forceinline__ float tf32_rn(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7F800000u) != 0x7F800000u) u += 0xFFFu + ((u >> 13) & 1u);
  return __uint_as_float(u & 0xFFFFE000u);
}

__device__ __forceinline__ float4 tf32_rn4(float4 v) {
  return make_float4(tf32_rn(v.x), tf32_rn(v.y), tf32_rn(v.z), tf32_rn(v.w));
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// Split this warpgroup's 64 rows of an f32 A tile (64 x 128 bytes,
// contiguous whatever the swizzle) into P TF32 pieces: piece 0 in place,
// piece p at the same offset of piece(p) (each p = tf32(what the earlier
// pieces leave)); then make the stores visible to the tensor cores and wait
// for the warpgroup. Elementwise, so the swizzle does not matter.
template <int P, class Piece>
__device__ __forceinline__ void split_rows(float* rows, Piece piece, int t, int wg) {
  float4* r4 = reinterpret_cast<float4*>(rows);
#pragma unroll
  for (int i = 0; i < 64 * 32 / 4 / 128; ++i) {
    const int idx = t + 128 * i;
    float4 r = r4[idx];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 v = tf32_rn4(r);
      reinterpret_cast<float4*>(p == 0 ? rows : piece(p))[idx] = v;
      r = sub4(r, v);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// A bin's (re, im) pair in the storage type, and its 4- or 8-byte store.
template <class E>
using Pair = typename std::conditional<std::is_same<E, float>::value, float2,
                                       __nv_bfloat162>::type;
__device__ __forceinline__ float2 pair_f32(float2 p) { return p; }
__device__ __forceinline__ float2 pair_f32(__nv_bfloat162 p) { return __bfloat1622float2(p); }
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, bf16 a, bf16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

// The projection and storage of one bin (re, im) at row m, column n (even)
// of the analysis epilogue; cur = the current iterate's pair (momentum only).
template <bool PLANAR, class E>
__device__ __forceinline__ void project_store(float re, float im, float mg, float2 cur, size_t m,
                                              int n, int nb, int ldc, E* __restrict__ dst_a,
                                              E* __restrict__ dst_b, E* __restrict__ s_new,
                                              float beta) {
  const float scale =
      mg / fmaxf(sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im))), 1e-8f);
  const E br = tt::to_storage<E>(__fmul_rn(re, scale));
  const E bi = tt::to_storage<E>(__fmul_rn(im, scale));
  if constexpr (PLANAR) {
    dst_a[m * nb + n / 2] = br;
    dst_b[m * nb + n / 2] = bi;
    return;
  }
  const size_t o = m * ldc + n;
  if (s_new) {
    const float nr = tt::to_f32(br), ni = tt::to_f32(bi);
    store_pair(s_new + o, br, bi);
    // two roundings, as the plain version's separate multiply and add
    store_pair(dst_a + o, tt::to_storage<E>(__fadd_rn(nr, __fmul_rn(beta, nr - cur.x))),
               tt::to_storage<E>(__fadd_rn(ni, __fmul_rn(beta, ni - cur.y))));
  } else {
    store_pair(dst_a + o, br, bi);
  }
}

// C (M x N) = A (M x K) . B (N x K)^T, A and B K-major behind TMA maps in
// the storage type T::E (K a multiple of T::BK; rows past M or N read as
// zeros), f32 accumulation. E = float (T::SPLIT): split TF32 products, B's
// pieces behind tm_b.m[0 .. PB-1].
// MODE 0 (synthesis): C stored as f32 frames (row stride ldc), n < N.
// MODE 1 (analysis): C is the interleaved spectrum, n < N = 2*n_bins; the
// epilogue projects it onto `mag` and writes planar re / im (dst_a, dst_b;
// PLANAR) or the interleaved carrier dst_a (row stride ldc), with momentum
// also s_new = projection and dst_a = s_new + beta (s_new - s_cur).
template <int MODE, bool PLANAR, class T>
__global__ void __launch_bounds__(kThreads, 1)
gl_wgmma(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ BMaps tm_b,
         int M, int N, int K, int ldc,
         float* __restrict__ frames, const float* __restrict__ mag, int nb,
         typename T::E* __restrict__ dst_a, typename T::E* __restrict__ dst_b,
         const typename T::E* __restrict__ s_cur, typename T::E* __restrict__ s_new,
         float beta) {
  using E = typename T::E;
  constexpr int STAGES = T::STAGES, BK = T::BK, PA = T::PA, PB = T::PB;
  constexpr bool SPLIT = T::SPLIT;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  E* sa = reinterpret_cast<E*>(smem);
  E* sb = reinterpret_cast<E*>(smem + STAGES * T::A_BYTES);
  // f32 mode: pieces 1.. of A and B, stage for stage
  E* sa_more = reinterpret_cast<E*>(smem + STAGES * (T::A_BYTES + T::B_BYTES));
  E* sb_more = reinterpret_cast<E*>(smem + STAGES * (PA * T::A_BYTES + T::B_BYTES));
  // piece p of stage s's B tile
  auto b_piece = [&](int s, int p) {
    return p == 0 ? sb + s * T::BN * BK : sb_more + (s * (PB - 1) + p - 1) * T::BN * BK;
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * T::STAGE_BYTES);
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
        mbar_expect_tx(&full[s], T::A_BYTES + PB * T::B_BYTES);
        tma_load(sa + s * T::BM * BK, &tm_a, &full[s], kt * BK, m0);
#pragma unroll
        for (int p = 0; p < PB; ++p) tma_load(b_piece(s, p), &tm_b.m[p], &full[s], kt * BK, n0);
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

  // the bf16 analysis epilogue's inputs (the magnitude and, with momentum,
  // the current iterate), loaded while the products run: loaded in the
  // epilogue, each waited on its own, they doubled the analysis time
  constexpr bool PRELOAD = MODE == 1 && !SPLIT;
  float mg[T::WM][T::WN][16][2];
  Pair<E> cur[T::WM][T::WN][16][2];
  if constexpr (PRELOAD) {
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
              cur[i][j][c][h] = ok ? *reinterpret_cast<const Pair<E>*>(s_cur + (size_t)m * ldc + n)
                                   : Pair<E>{};
          }
  }

  // The tensor cores do not round each f32 add to nearest as an fmaf chain
  // does. The synthesis sums cancel most of their 2112 terms where the
  // spectrogram is near its floor, and accumulated on the tensor cores they
  // drifted from the plain f32 loop by more than one bf16 ulp of the frames.
  // So synthesis sums each k-tile from zero on the tensor cores (`part`) and
  // adds it to the f32 accumulator with a rounded add; the bf16 analysis
  // sums need no such step and accumulate in place. The f32 mode, held to
  // the plain f32 loop's own error, rounds in both products.
  constexpr bool PROMOTE = MODE == 0;
  float acc[T::WM][T::WN][64], part[T::WM][T::WN][64];
#pragma unroll
  for (int i = 0; i < T::WM; ++i)
#pragma unroll
    for (int j = 0; j < T::WN; ++j)
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[i][j][r] = part[i][j][r] = 0.f;
  // a k-step is 32 bytes of each row: 16 bf16 or 8 f32
  constexpr int KS = 32 / (int)sizeof(E);
  auto desc = [&](const E* p, int r, int kk) { return sw128_desc(p + r * BK + kk * KS); };
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    E* a = sa + s * T::BM * BK + wg * T::WM * 64 * BK;
    const E* b = b_piece(s, 0);
    if constexpr (SPLIT) {
      static_assert(T::WM == 1 && T::WN == 1, "one m64n128 fragment per warpgroup");
      auto a_piece = [&](int p) {
        return p == 0 ? a : sa_more + (s * (PA - 1) + p - 1) * T::BM * BK + wg * 64 * BK;
      };
      split_rows<PA>(a, a_piece, t, wg);
      // the products of pieces i, j with i + j <= 2 over this k-tile, summed
      // from zero on the tensor cores, the smallest first; the sum is added
      // into acc, rounded
      fence_acc(part[0][0]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      int started = 0;
#pragma unroll
      for (int o = 2; o >= 0; --o)
#pragma unroll
        for (int i = 0; i < PA; ++i) {
          const int j = o - i;
          if (j < 0 || j >= PB) continue;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_k_step<E>(part[0][0], desc(a_piece(i), 0, kk), desc(b_piece(s, j), 0, kk),
                            started);
            started = 1;
          }
        }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(part[0][0]);
      if (t == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[0][0][r] = __fadd_rn(acc[0][0][r], part[0][0][r]);
      continue;
    }
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
    for (int kk = 0; kk < BK / KS; ++kk)
#pragma unroll
      for (int i = 0; i < T::WM; ++i)
#pragma unroll
        for (int j = 0; j < T::WN; ++j) {
          const uint64_t da = desc(a, i * 64, kk), db = desc(b, j * 128, kk);
          if constexpr (PROMOTE)
            wgmma_k_step<E>(part[i][j], da, db, kk > 0);
          else
            wgmma_k_step<E>(acc[i][j], da, db, 1);
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
      for (int c0 = 0; c0 < 16; c0 += 4) {
        if constexpr (MODE == 1 && SPLIT) {
          // the f32 epilogue's inputs, four bins per row at a time, all
          // loads issued before the first is used
#pragma unroll
          for (int c = c0; c < c0 + 4; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = row(i, h), n = col(j, c);
              const bool ok = m < M && n < N;
              mg[i][j][c][h] = ok ? __ldg(mag + (size_t)m * nb + n / 2) : 0.f;
              if (!PLANAR && s_new)
                cur[i][j][c][h] = ok ? *reinterpret_cast<const Pair<E>*>(
                                           s_cur + (size_t)m * ldc + n)
                                     : Pair<E>{};
            }
        }
#pragma unroll
        for (int c = c0; c < c0 + 4; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = row(i, h), n = col(j, c);
            if (m >= M || n >= N) continue;
            const float re = acc[i][j][4 * c + 2 * h], im = acc[i][j][4 * c + 2 * h + 1];
            if constexpr (MODE == 0) {
              *reinterpret_cast<float2*>(frames + (size_t)m * ldc + n) = make_float2(re, im);
            } else {
              project_store<PLANAR, E>(re, im, mg[i][j][c][h], pair_f32(cur[i][j][c][h]),
                                       (size_t)m, n, nb, ldc, dst_a, dst_b, s_new, beta);
            }
          }
      }
}

// Write v into every slot (f, c - f*hop) of rows (frame f's row, stride
// lda) whose live column range [0, NC) holds column c of frame 0.
template <class E>
__device__ __forceinline__ void put_slots(E* __restrict__ rows, int lda, int F, int NC, int hop,
                                          int c, E v) {
  if (c < 0) return;
  const int f_hi = min(F - 1, c / hop);
  const int lo_num = c - NC + 1;
  for (int f = lo_num <= 0 ? 0 : (lo_num + hop - 1) / hop; f <= f_hi; ++f)
    rows[(size_t)f * lda + (c - f * hop)] = v;
}

// Overlap-add, normalise and frame: thread (b, s) forms signal sample s,
// rounds it to the storage type E and writes it into the analysis operand
// ana (B*F rows, stride lda) wherever the reflect-padded framing reads it.
// Slot (f, k) reads sample reflect(f*hop + k - off), off = pad - lpad: the
// sample itself (column c = s + off of frame 0), its mirror -s at the left
// edge (s > 0) and its mirror 2(L-1) - s at the right edge (s < L-1); each
// slot has exactly one such sample.
template <class E>
__global__ void gl_ola_frame(const float* __restrict__ frames, int ldf,
                             const float* __restrict__ invwss, E* __restrict__ ana, int lda,
                             int Bn, int F, int NC, int hop, int lpad, int pad, int L) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)Bn * L) return;
  const int b = (int)(idx / L), s = (int)(idx % L);
  const int off = pad - lpad;
  const float y = ola_sample(frames + (size_t)b * F * ldf, ldf, F, NC, hop, s + off);
  const E v = tt::to_storage<E>(y * invwss[s + pad]);
  E* rows = ana + (size_t)b * F * lda;
  put_slots(rows, lda, F, NC, hop, s + off, v);
  if (s > 0) put_slots(rows, lda, F, NC, hop, off - s, v);
  if (s < L - 1) put_slots(rows, lda, F, NC, hop, off + 2 * (L - 1) - s, v);
}

// Planar re, im (M, nb) -> the interleaved carrier e (row stride lde).
template <class E>
__global__ void gl_pack(const E* __restrict__ re, const E* __restrict__ im, E* __restrict__ e,
                        int lde, int M, int nb) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * nb) return;
  const size_t m = idx / nb, j = idx % nb;
  store_pair(e + m * lde + 2 * j, re[idx], im[idx]);
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

// The TMA map of a (rows, cols) matrix of E with row stride ld, read in
// boxes of box_rows x (128 bytes) with the 128-byte swizzle; rows past
// `rows` read as zeros.
template <class E>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                       int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(E)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(E)), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map,
                         std::is_same<E, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         2, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One storage mode's tiles: bf16 or f32 (split TF32).
template <class E> struct Tiles;
template <> struct Tiles<bf16> {
  using Syn = SynTile;
  using Ana = AnaTile;
};
template <> struct Tiles<float> {
  using Syn = SynTileF32;
  using Ana = AnaTileF32;
};

// One mode's shapes and the TMA maps of its product operands (they depend
// only on the buffers, so are built once per C call). In the f32 mode each
// basis holds its kPiecesB TF32 pieces one after the other.
template <class E>
struct TcPlan {
  using Syn = typename Tiles<E>::Syn;
  using Ana = typename Tiles<E>::Ana;
  int M, S, S_pad, win, win_pad, nb, F, L, hop, lpad, pad, B;
  dim3 g_syn, g_ana;
  int ola_blocks;
  CUtensorMap syn_a, ana_a;
  BMaps syn_b, ana_b;
  TcPlan(int B_, int F_, int n_bins, int n_fft, int hop_, int win_)
      : M(B_ * F_), S(2 * n_bins), S_pad(padded(2 * n_bins)), win(win_),
        win_pad(padded(win_)), nb(n_bins), F(F_), L(hop_ * (F_ - 1)), hop(hop_),
        lpad((n_fft - win_) / 2), pad(n_fft / 2), B(B_),
        g_syn((win_pad + Syn::BN - 1) / Syn::BN, (M + Syn::BM - 1) / Syn::BM),
        g_ana((S + Ana::BN - 1) / Ana::BN, (M + Ana::BM - 1) / Ana::BM),
        ola_blocks((int)(((size_t)B_ * L + 255) / 256)) {}

  cudaError_t init(const E* e, const E* bwd_t, const E* ana, const E* fwd_t) {
    cudaError_t err;
    if ((err = tensor_map<E>(&syn_a, e, M, S_pad, S_pad, Syn::BM)) != cudaSuccess) return err;
    if ((err = tensor_map<E>(&ana_a, ana, M, win_pad, win_pad, Ana::BM)) != cudaSuccess)
      return err;
    for (int p = 0; p < Syn::PB; ++p) {
      const size_t piece = (size_t)p * win_pad * S_pad;
      if ((err = tensor_map<E>(&syn_b.m[p], bwd_t + piece, win_pad, S_pad, S_pad, Syn::BN)) !=
              cudaSuccess ||
          (err = tensor_map<E>(&ana_b.m[p], fwd_t + piece, S_pad, win_pad, win_pad, Ana::BN)) !=
              cudaSuccess)
        return err;
    }
    const void* kernels[] = {(const void*)gl_wgmma<1, false, Ana>,
                             (const void*)gl_wgmma<1, true, Ana>};
    for (const void* k : kernels)
      if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      Ana::SMEM)) != cudaSuccess)
        return err;
    return cudaFuncSetAttribute((const void*)gl_wgmma<0, false, Syn>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, Syn::SMEM);
  }
};

// One iteration: synthesis from the carrier behind syn_a, overlap-add +
// frame into the analysis operand, analysis into dst.
template <bool PLANAR, class E>
cudaError_t iterate(const TcPlan<E>& g, const float* mag, const float* invwss, float* frames,
                    E* ana, E* dst_a, E* dst_b, const E* s_cur, E* s_new, float beta,
                    cudaStream_t st) {
  using Syn = typename TcPlan<E>::Syn;
  using Ana = typename TcPlan<E>::Ana;
  gl_wgmma<0, false, Syn><<<g.g_syn, kThreads, Syn::SMEM, st>>>(
      g.syn_a, g.syn_b, g.M, g.win_pad, g.S_pad, g.win_pad, frames, nullptr, 0,
      nullptr, nullptr, nullptr, nullptr, 0.f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gl_ola_frame<E><<<g.ola_blocks, 256, 0, st>>>(frames, g.win_pad, invwss, ana, g.win_pad, g.B,
                                                g.F, g.win, g.hop, g.lpad, g.pad, g.L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gl_wgmma<1, PLANAR, Ana><<<g.g_ana, kThreads, Ana::SMEM, st>>>(
      g.ana_a, g.ana_b, g.M, g.S, g.win_pad, g.S_pad, nullptr, mag, g.nb, dst_a, dst_b,
      s_cur, s_new, beta);
  return cudaGetLastError();
}

template <class E>
int run_loop(const float* mag, void* e, void* s0, void* s1, const void* bwd, const void* fwd,
             const float* invwss, float* frames, void* work, int B, int F, int n_bins, int n_fft,
             int hop, int win, int n_iter, float beta, cudaStream_t st) {
  TcPlan<E> g(B, F, n_bins, n_fft, hop, win);
  E* ee = static_cast<E*>(e);
  E* ana = static_cast<E*>(work);
  cudaError_t err = g.init(ee, static_cast<const E*>(bwd), ana, static_cast<const E*>(fwd));
  if (err != cudaSuccess) return (int)err;
  for (int it = 0; it < n_iter; ++it) {
    E* s_cur = static_cast<E*>(it % 2 == 0 ? s0 : s1);
    E* s_new = static_cast<E*>(it % 2 == 0 ? s1 : s0);
    err = iterate<false, E>(g, mag, invwss, frames, ana, ee, nullptr,
                            beta != 0.f ? s_cur : nullptr, beta != 0.f ? s_new : nullptr, beta,
                            st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <class E>
int run_step(const float* mag, const void* re, const void* im, void* out_re, void* out_im,
             const void* bwd, const void* fwd, const float* invwss, float* frames, void* work,
             void* e, int B, int F, int n_bins, int n_fft, int hop, int win, cudaStream_t st) {
  TcPlan<E> g(B, F, n_bins, n_fft, hop, win);
  E* ee = static_cast<E*>(e);
  E* ana = static_cast<E*>(work);
  cudaError_t err = g.init(ee, static_cast<const E*>(bwd), ana, static_cast<const E*>(fwd));
  if (err != cudaSuccess) return (int)err;
  const int n = g.M * n_bins;
  gl_pack<E><<<(n + 255) / 256, 256, 0, st>>>(static_cast<const E*>(re),
                                              static_cast<const E*>(im), ee, g.S_pad, g.M,
                                              n_bins);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)iterate<true, E>(g, mag, invwss, frames, ana, static_cast<E*>(out_re),
                               static_cast<E*>(out_im), nullptr, nullptr, 0.f, st);
}

}  // namespace tc
}  // namespace

// n_iter Griffin-Lim iterations, three launches each, on `stream`. E is the
// storage type: bf16 (lowp 1) or f32 (lowp 0).
//   mag (B*F, n_bins) f32; e, s0, s1 E (B*F, S_pad), S_pad = 2*n_bins rounded
//   up to a multiple of 64, pad columns zero: e is the synthesis input, holds
//   the zero-phase start and, with beta == 0, the result; s0/s1 (only with
//   beta != 0): s0 holds the start, the result ends in s1 when n_iter is odd,
//   else in s0. bwd = bwd^T (win_pad, S_pad), fwd = fwd^T (S_pad, win_pad)
//   in E, zero-padded (win_pad: win rounded up to a multiple of 64); in the
//   f32 mode each is its kPiecesB TF32 pieces one after the other (pieces,
//   ...).
//   frames (B*F, win_pad) f32; work = the analysis operand (B*F, win_pad)
//   E, pad columns zero; invwss has n_fft + hop*(F-1) f32 entries.
extern "C" int tt_griffin_lim(const float* mag, void* e, void* s0, void* s1,
                              const void* bwd, const void* fwd,
                              const float* invwss, float* frames, void* work,
                              int B, int F, int n_bins, int n_fft, int hop,
                              int win, int n_iter, int lowp, float beta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lowp ? tc::run_loop<bf16>(mag, e, s0, s1, bwd, fwd, invwss, frames, work, B, F,
                                   n_bins, n_fft, hop, win, n_iter, beta, st)
              : tc::run_loop<float>(mag, e, s0, s1, bwd, fwd, invwss, frames, work, B, F,
                                    n_bins, n_fft, hop, win, n_iter, beta, st);
}

// ONE Griffin-Lim iteration without momentum, on `stream`: planar re, im
// (B*F, n_bins) in the storage type in, out_re, out_im out; the other
// arguments as tt_griffin_lim's. Four launches: the first packs re, im into
// e (the padded interleaved carrier, B*F x S_pad, pad columns zero), then
// tt_griffin_lim's three.
extern "C" int tt_griffin_lim_step(const float* mag, const void* re, const void* im,
                                   void* out_re, void* out_im, const void* bwd,
                                   const void* fwd, const float* invwss, float* frames,
                                   void* work, void* e, int B, int F, int n_bins, int n_fft,
                                   int hop, int win, int lowp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lowp ? tc::run_step<bf16>(mag, re, im, out_re, out_im, bwd, fwd, invwss, frames, work,
                                   e, B, F, n_bins, n_fft, hop, win, st)
              : tc::run_step<float>(mag, re, im, out_re, out_im, bwd, fwd, invwss, frames,
                                    work, e, B, F, n_bins, n_fft, hop, win, st);
}

// Dynamic shared memory of one block of the synthesis (0) or analysis (1)
// product of the bf16 (lowp 1) or f32 (lowp 0) mode, bytes.
extern "C" int tt_griffin_lim_smem(int analysis, int lowp) {
  if (lowp) return analysis ? tc::AnaTile::SMEM : tc::SynTile::SMEM;
  return analysis ? tc::AnaTileF32::SMEM : tc::SynTileF32::SMEM;
}
