// Tacotron 2's feed-previous decoder steps in f32, a chunk of them in ONE
// launch with the stop gate's exit rule: the early-exit decode's chunk
// (infer/early_exit.py WhileDecode given models/tacotron2.py StepWeights).
// The JAX package has no Tacotron 2, so this kernel replaces no TPU kernel;
// it replaces the chunk graph's library operations (cuBLAS products at M B,
// the LSTM cells, the location convolution, the gate rule's small kernels).
//
// Each step is tacotron2.decoder_step's: pre-net (2 x Dense + ReLU + dropout
// from masks drawn by the caller), the attention LSTM on [x; ctx] with
// test-time zoneout, the location term W_l conv([alpha; alpha_cum]) added to
// the keys, the energies v . tanh(keys + loc + W_q h_a) plus the 0 / NEG_INF
// mask bias, softmax, context, alpha_cum, the decoder LSTM on [h_a; ctx]
// with zoneout, the frame projection and the gate logit on [h_d; ctx].
// Every product input and every sum is f32 on the CUDA cores (no TF32).
// The step state (h_a, c_a, h_d, c_d, ctx, alpha, alpha_cum, previous frame,
// gate) is read from global memory at the start of a launch and written
// back by its end, and no sum's order depends on where a step falls in a
// launch, so a decode may be cut into launches anywhere: the same steps give
// the same bits whatever the chunks.
//
// What bounds a step: its 18.19 M weights (72.8 MB in f32 at the published
// widths) exceed every SM's shared memory together and the 50 MB L2, so each
// step streams them from HBM: 21.7 us at 3.35 TB/s, with M and P 22.7 us
// (benchmark/counts/tacotron2.py). Nothing is kept on chip from one step to
// the next. The layout keeps that stream going while the step's short
// dependent chain runs, and the chain is what bounds a step on an H100: ~55
// us at B 8, T_in 161 (scripts/t2_decode_study.py), of which the eight
// grid-wide barriers take ~1.5-2 us each and the phases' own round trips
// through L2 the rest; with no weight bytes at all a step still takes ~47
// us, and the consumers wait for the chain's inputs about half of the time.
// Three roles in each block:
//
// * One persistent block per SM (kBlocks = 128; the wrapper checks that the
//   card holds them all at once), every batch row stepped together. Block j
//   owns units [8 j, 8 j + 8) of BOTH LSTMs: the four gate rows of each
//   unit, so the cell update, the zoneout lerp and c stay in the block.
// * The producer warp streams the block's weight rows from the model's own
//   parameter tensors (no copy) into a ring of shared-memory stages with
//   bulk asynchronous copies (cp.async.bulk, one 512-byte row piece a lane,
//   completing on an mbarrier): a stage is the 32 gate rows x 128 columns
//   of one matrix. A step's stages come in a fixed order (the plan), those
//   whose inputs are known at the step's start first:
//     CA  W_ih_a[:, ctx] ctx(k-1)   HA  W_hh_a h_a(k-1)   HD  W_hh_d h_d(k-1)
//     XA  W_ih_a[:, x] x1(k)        AD  W_ih_d[:, h_a] h_a(k)   CD  W_ih_d[:, ctx] ctx(k)
//   The weights never depend on data, so the ring runs ahead by its depth.
// * The consumer warps (4 at B <= 8, one a gate; 8 at B <= 16) take every
//   stage in order as soon as it has landed and its input is in shared
//   memory (the chain raises `avail` as it stages h_a, ctx, x1, h_d): a warp
//   holds its gate's rows of the block's units x 8 batch rows, 64
//   accumulators in registers, 4 columns a lane. After HA, HD, XA and CD
//   it reduces them over its lanes into shared memory (the attention LSTM's
//   sums after HA, plus those of XA; the decoder's after HD, plus CD's) and
//   raises its flag.
// * The chain warps (7 at B <= 8, 3 at B <= 16) run the step's dependent
//   phases, each ending in a grid-wide barrier (a counter in global memory:
//   a release reduction to arrive, acquire loads to wait):
//     FR  frame(k-1) and its gate logit (blocks 0..R NM)        | barrier
//     P0  pre-net layer 0 (its units over the blocks)            | barrier
//     P1  pre-net layer 1                                         | barrier
//     LA  the attention LSTM's cell update from the flushed sums | barrier
//     Q   the query W_q h_a(k)                                    | barrier
//     E   the energies of each block's (row, position) items      | barrier
//     S   softmax and context of each block's (row, 32 columns)  | barrier
//     LD  the decoder LSTM's cell update                          | barrier
//   Everything a phase reads from device memory that does not depend on the
//   step's data (its weight rows, biases, v, the keys, the mask bias, the
//   dropout draws) is copied into shared memory asynchronously (cp.async) a
//   phase or more ahead, once a step, so the phases wait only for data the
//   other blocks wrote (through L2). The location term of step k + 1 is
//   computed while the consumers finish CD; alpha(k) and alpha_cum(k) are
//   final by then.
// * Every sum is taken in a fixed order: a product's by lane (the stages in
//   stream order), then the lanes' butterfly; the energies by lane and
//   butterfly; the softmax and context by thread, warp and then warps in
//   order; no atomics on floats. Every block that needs a row's softmax
//   computes it from the same inputs in the same order, so all hold the
//   same bits.
//
// The exit rule: each step's gate logit goes to a (B, kMaxChunk) scratch;
// after the launch's last step the block that draws the last ticket of the
// carry's counter (atom.inc wraps it to 0 after every launch) applies
// WhileDecode._gate_rule to the steps in order: a row is active until the
// step, included, whose gate logit is over the threshold, while t < n_steps
// and some row is; its slots after that are zeroed; t, ended, lengths, the
// slot and the done flag are written, and the barrier's counter is zeroed.
#include "common.cuh"

namespace {

using tt::Slice;
using tt::ticket_acq_rel;

constexpr int kBlocks = 128;               // one per SM, all resident at once
constexpr int kWarpsMax = 8;               // chain warps and consumer warps at most
constexpr int kThreads = 12 * 32;          // chain 7 + consumers 4, or 3 + 8; producer 1
constexpr int kMaxUnits = 8;               // units of each LSTM a block owns at most
constexpr int kRows = 4 * kMaxUnits;       // a stage's weight rows: 4 gates
constexpr int kCols = 128;                 // a stage's columns
constexpr int kStageFloats = kRows * kCols;  // 16 KiB
constexpr int kMaxStages = 8;
constexpr int kMaxPlan = 64;               // stages a step
constexpr int kMaxChunk = 64;              // steps a launch
constexpr int kMaxB = 16;
constexpr int kBT = 8;                     // batch rows a consumer warp's accumulators hold
constexpr int kAcc = kMaxUnits * kBT;      // 64
constexpr int kMemQ = 24;                  // memory loads a lane keeps in flight in attend

// The block's warps by role (warps share the SM's four schedulers by their
// index mod 4): at B <= 8 the consumers are warps 0, 1, 4, 5 (two
// schedulers), the chain warps 2, 3, 6, 7 (the other two: the chain's
// first warps, which take the first of every phase's items, never wait
// behind a consumer's stretch of products) and 8, 9, 10; at B <= 16 the
// consumers are 0, 1, 3, 4, 5, 7, 8, 9 and the chain 2, 6, 10. The
// producer is warp 11. g_chain_warp maps a warp to its place in the chain
// (-1: not in it); ctid() is a chain thread's index, 0..nt - 1.
__shared__ int g_chain_warp[kThreads / 32];

__device__ __forceinline__ int ctid() {
  return g_chain_warp[threadIdx.x >> 5] * 32 + (threadIdx.x & 31);
}

// Built with -DTT_T2_CLOCK (scripts/t2_decode_study.py), thread 0 of blocks 0
// and kBlocks - 1 records at kMarks points of every step of the launch the
// SM clock, the global timer (ns) and the stages consumer warp 0 has taken
// into g_t2_clock, and consumer warp 0 of block 0 adds up the SM cycles it
// spends waiting for `avail`, waiting for stages to land, and on the rest
// into g_t2_cons; tt_t2_decode_clock reads both back. Otherwise the marks
// compile to nothing.
#ifdef TT_T2_CLOCK
constexpr int kMarks = 24;
__device__ long long g_t2_clock[2][kMaxChunk][kMarks][3];
__device__ long long g_t2_cons[3];
#define MARK(k, i)                                                                  \
  if ((blockIdx.x == 0 || blockIdx.x == kBlocks - 1) && ctid() == 0) {         \
    long long* m_ = g_t2_clock[blockIdx.x == 0 ? 0 : 1][k][i];                      \
    long long ns_;                                                                  \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));                         \
    m_[0] = clock64();                                                              \
    m_[1] = ns_;                                                                    \
    m_[2] = fl[kFlags];                                                             \
  }
#define CONS_CLOCK(i)                                                               \
  if (blockIdx.x == 0 && cw == 0 && lane == 0) {                                    \
    const long long now_ = clock64();                                               \
    cons_cycles[i] += now_ - cons_last;                                             \
    cons_last = now_;                                                               \
  }
#else
#define MARK(k, i)
#define CONS_CLOCK(i)
#endif

struct W2 {
  const float *p_w0, *p_b0, *p_w1, *p_b1;
  const float *a_wih, *a_whh, *a_bih, *a_bhh;
  const float *q_w, *v, *l_conv, *l_dense;
  const float *d_wih, *d_whh, *d_bih, *d_bhh;
  const float *f_w, *f_b, *g_w, *g_b;
};

// B, T_in, memory width, attention width, n_mels, r, pre-net widths, the
// two LSTMs' widths, location filters and kernel width
struct Dims {
  int B, T, M, A, NM, R, P0, P1, HA, HD, F, KL;
};

// The pre-net's uniform draws of each step: u[2 k] (B, P0), u[2 k + 1]
// (B, P1); a unit is kept where its draw is below keep
struct Masks {
  const float* u[2 * kMaxChunk];
};

// The step state, (B, width) each, read at the start and written by the end
struct State {
  float *h_a, *c_a, *h_d, *c_d, *ctx, *alpha, *alpha_cum, *prev, *gate;
};

// frames (B, slots, R NM) and alignments (B, slots, T): step k of the launch
// goes to slot *Exit::slot + k; a slot past `slots` is not written
struct Out {
  float *frames, *aligns;
  int slots;
};

// The stop gate's carry: t (steps the loop ran), ended (B,), lengths (B,),
// slot, done; a row's gate opens where its logit is over thr
struct Exit {
  long long* t;
  bool* ended;
  long long *lengths, *slot;
  bool* done;
  float thr;
  int n_steps;
};

// Global scratch: the pre-net's outputs, the query, the energies, each
// step's gate logits (B, kMaxChunk); the grid barrier's counter and the
// exit rule's ticket (2 words, 0 between launches)
struct Scratch {
  float *x0, *x1, *q, *energy, *gates;
  unsigned* sync;
};

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int batch_tile(int B) { return B <= kBT ? kBT : 2 * kBT; }

// Stages a step: CA, HA, HD, XA, AD, CD
__host__ __device__ inline int plan_len(const Dims& d) {
  return (2 * d.M + 2 * d.HA + d.P1 + d.HD) / kCols;
}

// Shared memory, in floats: the ring; the product inputs of every batch row
// (rows past B zero): VA h_a, VC ctx, VDX h_d(k - 1) then x1; the block's
// frame row and pre-net rows (HW); the flushed sums of both LSTMs; each
// block's c of both LSTMs and its units of h_d(k - 1); the keys plus
// location term of its items; the small rows (SW: biases, v, the mask bias
// of its items, its dropout draws); the softmax's scratch; the alpha_cum
// row the block keeps (its attend item of columns 0..31, if any); the
// context's scratch. Between their uses as inputs VC holds the block's
// query rows (LA to Q) and the query rows its energies read (E), and VDX
// the location term's staging (its weights,
// each attention unit's row padded to an odd number of 16 bytes, and two
// rows of alpha and alpha_cum with (KL - 1) / 2 zeros a side; E to LD).
struct Layout {
  int va, vc, vdx, hw, red, cs, hd, ks, sw, es, ac, part, floats, bt, lw;
  int rp0, rp1, rq, items;   // the block's pre-net rows, query rows and items at most
  int wf, wp0, wp1;          // in HW: frame row, pre-net rows
  int wc, wl, xr;            // in VDX: the location term's weights and rows
  int ba, bd, pb, fb, vv, mb, mk;  // in SW
  __host__ __device__ Layout(const Dims& d, int stages) {
    bt = batch_tile(d.B);
    rp0 = cdiv(d.P0, kBlocks);
    rp1 = cdiv(d.P1, kBlocks);
    rq = cdiv(d.A, kBlocks);
    items = cdiv(d.B * d.T, kBlocks);
    wf = 0;
    wp0 = up4(d.HD + d.M);
    wp1 = wp0 + up4(rp0 * d.NM);
    const int heads = wp1 + up4(rp1 * d.P0);
    wc = 0;
    wl = up4(d.F * 2 * d.KL);
    lw = d.F / 4 % 2 ? d.F : d.F + 4;  // a row of W_l: 16-byte aligned, an odd number of 16 bytes
    xr = wl + d.A * lw;
    const int loc = xr + 4 * up4(d.T + d.KL - 1);
    int o = stages * kStageFloats;
    va = o;   o += bt * d.HA;
    vc = o;   o += imax(bt * d.M, rq * d.HA);
    vdx = o;  o += imax(imax(bt * d.HD, bt * d.P1), loc);
    hw = o;   o += heads;
    red = o;  o += 2 * kWarpsMax * kAcc;
    cs = o;   o += 2 * kMaxUnits * kMaxB;
    hd = o;   o += kMaxUnits * kMaxB;
    ks = o;   o += items * d.A;
    sw = o;
    ba = 0;
    bd = 8 * kMaxUnits;
    pb = 16 * kMaxUnits;
    fb = pb + up4(rp0 + rp1);
    vv = fb + 4;
    mb = vv + up4(d.A);
    mk = mb + up4(items);
    o += mk + up4((rp0 + rp1) * kMaxB);
    es = o;   o += up4(d.T);
    ac = o;   o += up4(d.T);
    part = o; o += kWarpsMax * 32;
    floats = o;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float) * (size_t)floats; }
};

// A stage of the plan: its matrix at the stage's first column (row pieces
// of gate g, unit j at row g H + block U + j, ld floats apart), and its
// input: row 0's first column in shared memory, rows xld floats apart
struct Stage {
  const float* W;
  int ld, H, x, xld;
};

// The consumers' flags in shared memory: each warp's last step done with
// HD, flushed after XA (the attention LSTM's sums), flushed after CD; after
// them (clock builds) the stages consumer warp 0 has taken
enum { kFlagHD = 0, kFlagA = kWarpsMax, kFlagD = 2 * kWarpsMax, kFlags = 3 * kWarpsMax };

// ---------------------------------------------------------------- primitives

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

// Nanoseconds of the device's global timer
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait longer than this is a fault (a launch's steps take microseconds):
// it traps, so the launch fails with an error instead of hanging the card.
constexpr unsigned long long kHangNs = 2000000000ull;

// Spin-wait bookkeeping: after the first 1024 polls, trap past kHangNs
struct Patience {
  unsigned spins = 0;
  unsigned long long t0 = 0;
  __device__ __forceinline__ void tick() {
    if ((++spins & 1023) == 0) {
      if (t0 == 0) t0 = now_ns();
      else if (now_ns() - t0 > kHangNs) __trap();
    }
  }
};

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  Patience p;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    p.tick();
  }
}

// `bytes` from global memory into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Asynchronous copies of 4 and 16 bytes into shared memory (cp.async), and
// the wait for every copy this thread has issued
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Orders this thread's (and, after a barrier, the block's) generic-proxy
// memory accesses before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// A chain fetch: bulk copies into shared memory completing on the
// mbarrier `bar`, whose current phase is `phase`. Warp 0 issues a fetch:
// lane 0 raises the bytes the barrier expects (after a proxy fence: the
// rows may have been written by other blocks' generic stores, seen through
// the grid barrier, and the buffer by this block's), then its lanes issue
// the copies; every chain thread waits for it.
struct Fetch {
  uint64_t* bar;
  uint32_t phase;
  __device__ __forceinline__ void expect(uint32_t bytes) const {
    if (ctid() == 0) {
      fence_proxy_async();
      mbar_expect_tx(bar, bytes);
    }
    __syncwarp();
  }
  // rows [0, n) of `width` floats, src rows sld floats apart, to dst rows
  // dld floats apart, by warp 0's lanes (after expect)
  __device__ __forceinline__ void rows(float* dst, int dld, const float* src, size_t sld, int n,
                                       int width) const {
    for (int r = ctid(); r < n; r += 32)
      bulk_load(dst + (size_t)r * dld, src + r * sld, width * sizeof(float), bar);
  }
  __device__ __forceinline__ void wait() {
    mbar_wait(bar, phase);
    phase ^= 1;
  }
};

// The chain warps' barrier (the consumer and producer warps never join it)
__device__ __forceinline__ void csync(int nt) {
  asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// torch.lerp's formula: the weight's side decides which end it starts from
__device__ __forceinline__ float lerp_w(float a, float b, float w) {
  return w < 0.5f ? a + w * (b - a) : b - (b - a) * (1.f - w);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One fold of a warp's reduce-scatter: lanes with bit OFF keep the upper
// HALF of v, the others the lower, each adding its partner's copy
template <int HALF, int OFF>
__device__ __forceinline__ void fold(float* v, int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// ---------------------------------------------------------------- the stream

// The plan of a step's stages: CA, HA, HD, XA, AD, CD
__device__ void build_plan(Stage* plan, const Dims& d, const Layout& L, const W2& w) {
  struct Seg {
    const float* W;
    int ld, col0, K, H, x, xld;
  };
  const Seg segs[6] = {
      {w.a_wih, d.P1 + d.M, d.P1, d.M, d.HA, L.vc, d.M},
      {w.a_whh, d.HA, 0, d.HA, d.HA, L.va, d.HA},
      {w.d_whh, d.HD, 0, d.HD, d.HD, L.vdx, d.HD},
      {w.a_wih, d.P1 + d.M, 0, d.P1, d.HA, L.vdx, d.P1},
      {w.d_wih, d.HA + d.M, 0, d.HA, d.HD, L.va, d.HA},
      {w.d_wih, d.HA + d.M, d.HA, d.M, d.HD, L.vc, d.M},
  };
  int n = 0;
  for (int s = 0; s < 6; ++s)
    for (int c = 0; c < segs[s].K; c += kCols)
      plan[n++] = Stage{segs[s].W + segs[s].col0 + c, segs[s].ld, segs[s].H, segs[s].x + c,
                        segs[s].xld};
}

// The producer warp: every stage of the launch in order, each into the
// next ring slot once the consumers have released it
__device__ void produce(const Stage* plan, int S, int total, int ns, float* ring,
                        uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  int i = 0, slot = 0, phase = 0;
  for (int s = 0; s < total; ++s) {
    if (lane == 0 && s >= ns) mbar_wait(&empty[slot], phase ^ 1);
    const Stage st = plan[i];
    const int U = st.H / kBlocks, rows = 4 * U;
    if (lane == 0) mbar_expect_tx(&full[slot], rows * kCols * sizeof(float));
    __syncwarp();
    if (lane < rows) {
      const int g = lane / U, j = lane % U;
      bulk_load(ring + slot * kStageFloats + lane * kCols,
                st.W + (size_t)(g * st.H + blockIdx.x * U + j) * st.ld, kCols * sizeof(float),
                &full[slot]);
    }
    if (++i == S) i = 0;
    if (++slot == ns) {
      slot = 0;
      phase ^= 1;
    }
  }
}

// The warp's accumulators summed over its lanes (lane l ends with outputs
// 2 l and 2 l + 1 of (unit, row) order) into red[0..64), added to what the
// lane wrote there before where `add`, then zeroed
__device__ __forceinline__ void flush(float (&acc)[kAcc], float* red, int lane, bool add) {
  fold<32, 16>(acc, lane);
  fold<16, 8>(acc, lane);
  fold<8, 4>(acc, lane);
  fold<4, 2>(acc, lane);
  fold<2, 1>(acc, lane);
  red[2 * lane] = add ? red[2 * lane] + acc[0] : acc[0];
  red[2 * lane + 1] = add ? red[2 * lane + 1] + acc[1] : acc[1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
}

// A consumer warp (cw: gate cw & 3, batch rows 8 (cw >> 2) ..): every stage
// of the launch in order into acc[u 8 + b] += W[g U + u][c] x[8 bg + b][c]
// over the stage's columns (4 a lane, 32 apart), each once it has landed
// and `avail` passes it; its slot is then released to the producer. The
// rows u >= U of a stage (other gates' rows, or rows past the block's 4 U:
// the stage holds kRows) are summed too and never read, so the loads need
// no branch. After HA the sums go to `red` (the attention LSTM's, 64
// floats a warp), after HD to the decoder's; after XA and after CD they
// are added there; the warp's flag A or D rises to the step's number + 1
// (after HD its HD flag).
__device__ void consume(const Stage* plan, int S, int total, int ns, const float* smem,
                        uint64_t* full, uint64_t* empty, int n_ha, int n_hd, int n_xa,
                        volatile int* avail, volatile int* fl, float* red, int cw) {
  const int lane = threadIdx.x & 31, g = cw & 3, bg = cw >> 2;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  int i = 0, slot = 0, phase = 0, k = 0;
#ifdef TT_T2_CLOCK
  long long cons_cycles[3] = {0, 0, 0}, cons_last = clock64();
#endif
  for (int s = 0; s < total; ++s) {
    if (s >= *avail) {
      Patience p;
      while (s >= *avail) p.tick();
    }
    __threadfence_block();
    CONS_CLOCK(0);
    const Stage st = plan[i];
    const int U = st.H / kBlocks;
    mbar_wait(&full[slot], phase);
    CONS_CLOCK(1);
    const float* w = smem + slot * kStageFloats + g * U * kCols;
    const float* x = smem + st.x + bg * kBT * st.xld;
#pragma unroll
    for (int j = 0; j < kCols / 32; ++j) {
      const int col = 32 * j + lane;
      float xv[kBT];
#pragma unroll
      for (int b = 0; b < kBT; ++b) xv[b] = x[b * st.xld + col];
#pragma unroll
      for (int u = 0; u < kMaxUnits; ++u) {
        const float wv = w[u * kCols + col];
#pragma unroll
        for (int b = 0; b < kBT; ++b) acc[u * kBT + b] = fmaf(wv, xv[b], acc[u * kBT + b]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    // the LSTM whose sums end here (0: attention, 1: decoder), and its flag
    const int lstm = i == n_ha - 1 || i == n_xa - 1 ? 0 : i == n_hd - 1 || i == S - 1 ? 1 : -1;
    if (lstm >= 0) {
      flush(acc, red + lstm * kWarpsMax * kAcc + cw * kAcc, lane, i >= n_xa - 1);
      const int flag = i == n_hd - 1 ? kFlagHD : i == n_xa - 1 ? kFlagA : i == S - 1 ? kFlagD : -1;
      __syncwarp();
      __threadfence_block();
      if (lane == 0 && flag >= 0) fl[flag + cw] = k + 1;
    }
#ifdef TT_T2_CLOCK
    if (cw == 0 && lane == 0) fl[kFlags] = s + 1;
#endif
    CONS_CLOCK(2);
    if (++slot == ns) {
      slot = 0;
      phase ^= 1;
    }
    if (++i == S) {
      i = 0;
      ++k;
    }
  }
#ifdef TT_T2_CLOCK
  if (blockIdx.x == 0 && cw == 0 && lane == 0)
    for (int j = 0; j < 3; ++j) g_t2_cons[j] = cons_cycles[j];
#endif
}

// ---------------------------------------------------------------- the chain

struct Ctx {
  W2 w;
  Dims d;
  Layout L;
  int blk, nt, nw;  // this block; the chain's threads and warps
  float* smem;
};

// The consumers' stream may pass stage `v` (all chain threads call it
// after their stores to the inputs and a csync)
__device__ __forceinline__ void set_avail(volatile int* avail, int v) {
  if (ctid() == 0) {
    __threadfence_block();
    *avail = v;
  }
}

// Wait until every consumer warp's flag `which` has reached `want`
__device__ __forceinline__ void wait_flags(volatile int* fl, int which, int warps, int want,
                                           int nt) {
  if (ctid() == 0) {
    Patience p;
    for (;;) {
      bool ok = true;
      for (int i = 0; i < warps; ++i) ok = ok && fl[which + i] >= want;
      if (ok) break;
      p.tick();
    }
    __threadfence_block();
  }
  csync(nt);
}

// The rows [0, B) of a (B, width) tensor in global memory into a shared
// buffer of `bt` rows by bulk copies, the rows past B zero; every chain
// thread waits for them and syncs. width a multiple of 4.
__device__ __forceinline__ void load_rows(Fetch& f, float* dst, const float* src, int B, int bt,
                                          int width, int nt) {
  if (ctid() < 32) {
    f.expect(B * width * sizeof(float));
    f.rows(dst, width, src, width, B, width);
  }
  for (int i = B * width + ctid(); i < bt * width; i += nt) dst[i] = 0.f;
  f.wait();
  csync(nt);
}

// Grid-wide barrier: every block arrives once per phase on a counter that
// the exit rule's block zeroes at the end of the launch; `passed` counts the
// phases this launch has passed.
struct Grid {
  unsigned* count;
  unsigned passed;
};

__device__ __forceinline__ void grid_arrive(const Grid& g, int nt) {
  csync(nt);  // the block's writes of the phase come first
  if (ctid() == 0) red_release_add(g.count, 1u);
}

__device__ __forceinline__ void grid_wait(Grid& g, int nt) {
  if (ctid() == 0) {
    const unsigned target = (g.passed + 1) * kBlocks;
    Patience p;
    while ((int)(ld_acquire(g.count) - target) < 0) p.tick();
  }
  csync(nt);
  ++g.passed;
}

__device__ __forceinline__ void grid_sync(Grid& g, int nt) {
  grid_arrive(g, nt);
  grid_wait(g, nt);
}

// The block's frame row (or the gate's, block R NM) and pre-net rows into
// HW by bulk copies on `f`, the pre-net and head biases into SW
__device__ __forceinline__ void prefetch_heads(const Ctx& c, const Fetch& f) {
  const Dims& d = c.d;
  const int RN = d.R * d.NM, j = c.blk;
  float* hw = c.smem + c.L.hw;
  float* sw = c.smem + c.L.sw;
  const Slice s0(d.P0, kBlocks, j), s1(d.P1, kBlocks, j);
  const int n0 = (s0.hi - s0.lo) * d.NM, n1 = (s1.hi - s1.lo) * d.P0;
  if (ctid() < 32) {
    f.expect(sizeof(float) * ((j <= RN ? d.HD + d.M : 0) + n0 + n1));
    if (j <= RN)
      f.rows(hw + c.L.wf, 0, j < RN ? c.w.f_w + (size_t)j * (d.HD + d.M) : c.w.g_w, 0, 1,
             d.HD + d.M);
    if (ctid() == 1 && n0 > 0)
      bulk_load(hw + c.L.wp0, c.w.p_w0 + (size_t)s0.lo * d.NM, n0 * sizeof(float), f.bar);
    if (ctid() == 2 && n1 > 0)
      bulk_load(hw + c.L.wp1, c.w.p_w1 + (size_t)s1.lo * d.P0, n1 * sizeof(float), f.bar);
  }
  if (ctid() == 0 && j <= RN) cp4(sw + c.L.fb, j < RN ? c.w.f_b + j : c.w.g_b);
  for (int i = ctid(); i < s0.hi - s0.lo; i += c.nt) cp4(sw + c.L.pb + i, c.w.p_b0 + s0.lo + i);
  for (int i = ctid(); i < s1.hi - s1.lo; i += c.nt)
    cp4(sw + c.L.pb + c.L.rp0 + i, c.w.p_b1 + s1.lo + i);
}

// The dropout draws of the block's pre-net units for one step into SW:
// layer 0's (rows, B), then layer 1's
__device__ __forceinline__ void prefetch_masks(const Ctx& c, const float* u0, const float* u1) {
  const Dims& d = c.d;
  const Slice s0(d.P0, kBlocks, c.blk), s1(d.P1, kBlocks, c.blk);
  float* mk = c.smem + c.L.sw + c.L.mk;
  for (int i = ctid(); i < (s0.hi - s0.lo) * d.B; i += c.nt)
    cp4(mk + i, u0 + (size_t)(i % d.B) * d.P0 + s0.lo + i / d.B);
  for (int i = ctid(); i < (s1.hi - s1.lo) * d.B; i += c.nt)
    cp4(mk + c.L.rp0 * kMaxB + i, u1 + (size_t)(i % d.B) * d.P1 + s1.lo + i / d.B);
}

// The biases of the block's gate rows of one LSTM into SW at `at`: b_ih's
// 4 U rows (gate-major), then b_hh's
__device__ __forceinline__ void prefetch_bias(const Ctx& c, const float* bih, const float* bhh,
                                              int H, int at) {
  const int U = H / kBlocks;
  float* sw = c.smem + c.L.sw + at;
  for (int i = ctid(); i < 8 * U; i += c.nt) {
    const int r = i % (4 * U), row = (r / U) * H + c.blk * U + r % U;
    cp4(sw + i, (i < 4 * U ? bih : bhh) + row);
  }
}

// The block's query rows into VC (free from LA to Q) and v into SW, by bulk
// copies on `f`
__device__ __forceinline__ void prefetch_query(const Ctx& c, const Fetch& f) {
  const Dims& d = c.d;
  const Slice s(d.A, kBlocks, c.blk);
  const int n = (s.hi - s.lo) * d.HA;
  if (ctid() < 32) {
    f.expect(sizeof(float) * (n + d.A));
    if (ctid() == 0 && n > 0)
      bulk_load(c.smem + c.L.vc, c.w.q_w + (size_t)s.lo * d.HA, n * sizeof(float), f.bar);
    if (ctid() == 1) bulk_load(c.smem + c.L.sw + c.L.vv, c.w.v, d.A * sizeof(float), f.bar);
  }
}

// What the location term and the energies of the block's items read and
// no step changes: the filters (as they are) and the keys into VDX and ks
// by bulk copies on `f`, W_l by 16-byte copies of every chain thread, each
// attention unit's row padded to an odd number of 16 bytes (no bank
// conflicts when lane a reads row a 16 bytes at a time); the mask bias into
// SW
__device__ __forceinline__ void prefetch_location(const Ctx& c, const Fetch& f, const float* keys,
                                                  const float* maskbias) {
  const Dims& d = c.d;
  const Slice s(d.B * d.T, kBlocks, c.blk);
  if (ctid() < 32) {
    const int nc = d.F * 2 * d.KL, nk = (s.hi - s.lo) * d.A;
    f.expect(sizeof(float) * (nc + nk));
    if (ctid() == 0) bulk_load(c.smem + c.L.vdx + c.L.wc, c.w.l_conv, nc * sizeof(float), f.bar);
    if (ctid() == 1 && nk > 0)
      bulk_load(c.smem + c.L.ks, keys + (size_t)s.lo * d.A, nk * sizeof(float), f.bar);
  }
  const int q4 = d.F / 4;
  for (int i = ctid(); i < d.A * q4; i += c.nt)
    cp16(c.smem + c.L.vdx + c.L.wl + (i / q4) * c.L.lw + 4 * (i % q4), c.w.l_dense + 4 * i);
  for (int i = ctid(); i < s.hi - s.lo; i += c.nt)
    cp4(c.smem + c.L.sw + c.L.mb + i, maskbias + s.lo + i);
}

// softmax of sc[0..n) in place over the chain's threads: each thread's
// positions in order, then the warps' butterflies, then the warps in order
__device__ __forceinline__ void softmax(float* sc, int n, float* red, int nt, int nw) {
  const int lane = ctid() & 31, warp = ctid() >> 5;
  float m = __int_as_float(0xff800000);  // -inf
  for (int t = ctid(); t < n; t += nt) m = fmaxf(m, sc[t]);
  m = tt::warp_max(m);
  if (lane == 0) red[warp] = m;
  csync(nt);
  float mx = red[0];
  for (int i = 1; i < nw; ++i) mx = fmaxf(mx, red[i]);
  float sum = 0.f;
  for (int t = ctid(); t < n; t += nt) {
    const float e = expf(sc[t] - mx);
    sc[t] = e;
    sum += e;
  }
  sum = tt::warp_sum(sum);
  csync(nt);  // every thread has read the maxima
  if (lane == 0) red[warp] = sum;
  csync(nt);
  sum = red[0];
  for (int i = 1; i < nw; ++i) sum += red[i];
  for (int t = ctid(); t < n; t += nt) sc[t] = sc[t] / sum;
  csync(nt);
}

// The frame (rows 0..R NM - 1) or the gate logit (row R NM) of step k of the
// launch, the block's row of the two heads (in HW), for every batch row:
// W [h_d(k); ctx(k)] + b; h_d(k) from VDX, ctx(k) from VC. The frame goes to
// its slot and its last NM values to the state's previous frame; the gate
// to the state and the rule's scratch.
__device__ __forceinline__ void heads(const Ctx& c, const State& st, const Out& out,
                                      const Scratch& sc, long long slot, int k) {
  const Dims& d = c.d;
  const int RN = d.R * d.NM, j = c.blk;
  if (j > RN) return;
  const int lane = ctid() & 31, warp = ctid() >> 5;
  const float* wrow = c.smem + c.L.hw + c.L.wf;
  const float* vc = c.smem + c.L.vc;
  const float* vd = c.smem + c.L.vdx;
  const float bias = c.smem[c.L.sw + c.L.fb];
  for (int b = warp; b < d.B; b += c.nw) {
    float acc = 0.f;
    for (int i = lane * 4; i < d.HD; i += 128)
      acc = dot4(lds4(wrow + i), lds4(vd + b * d.HD + i), acc);
    for (int i = lane * 4; i < d.M; i += 128)
      acc = dot4(lds4(wrow + d.HD + i), lds4(vc + b * d.M + i), acc);
    const float y = tt::warp_sum(acc) + bias;
    if (lane == 0) {
      if (j < RN) {
        if (slot < out.slots) out.frames[((size_t)b * out.slots + slot) * RN + j] = y;
        if (j >= RN - d.NM) st.prev[b * d.NM + j - (RN - d.NM)] = y;
      } else {
        st.gate[b] = y;
        sc.gates[b * kMaxChunk + k] = y;
      }
    }
  }
}

// A pre-net layer: the block's output units for every row, relu(W x + b)
// (the block's rows W, biases and draws u (rows, B) in shared memory, the
// layer's input x (B, K) read through L2), then dropout where `drop`
__device__ __forceinline__ void prenet(const float* W, const float* bias, const float* u,
                                       const float* x, int K, int P, bool drop, float keep,
                                       float scale, float* y, const Ctx& c) {
  const int lane = ctid() & 31, warp = ctid() >> 5, B = c.d.B;
  const Slice s(P, kBlocks, c.blk);
  for (int p = warp; p < (s.hi - s.lo) * B; p += c.nw) {
    const int r = p / B, b = p % B;
    float acc = 0.f;
#pragma unroll 4
    for (int i = lane; i < K; i += 32) acc = fmaf(W[r * K + i], __ldcg(x + b * K + i), acc);
    float v = fmaxf(tt::warp_sum(acc) + bias[r], 0.f);
    if (drop) v = u[p] < keep ? v * scale : 0.f;
    if (lane == 0) y[b * P + s.lo + r] = v;
  }
}

// The query: the block's attention units (rows in VC), W_q h_a(k) for every
// row (VA)
__device__ __forceinline__ void query(const Ctx& c, float* q) {
  const Dims& d = c.d;
  const int lane = ctid() & 31, warp = ctid() >> 5;
  const Slice s(d.A, kBlocks, c.blk);
  const float* va = c.smem + c.L.va;
  const float* wq = c.smem + c.L.vc;
  for (int p = warp; p < (s.hi - s.lo) * d.B; p += c.nw) {
    const int r = p / d.B, b = p % d.B;
    float acc = 0.f;
    for (int i = lane * 4; i < d.HA; i += 128)
      acc = dot4(lds4(wq + r * d.HA + i), lds4(va + b * d.HA + i), acc);
    acc = tt::warp_sum(acc);
    if (lane == 0) q[b * d.A + s.lo + r] = acc;
  }
}

// The location term of the block's (row, position) items for the next
// step, from alpha and alpha_cum (the state), added to the keys prefetched
// into ks: ks[item][a] += sum_f W_l[a][f] conv_f(t), conv_f(t) = sum over
// the two channels and the KL taps of filter f times [alpha; alpha_cum]
// with (KL - 1) / 2 zeros a side. The rows of alpha and alpha_cum go to VDX
// eight loads a thread at once. A warp takes an item: lane f its filter's
// sum (into `conv`, a warp's 32 floats), then lane a its units' sums over
// the filters in order, four at a time.
__device__ __forceinline__ void location(const Ctx& c, const State& st, float* conv) {
  const Dims& d = c.d;
  const int lane = ctid() & 31, warp = ctid() >> 5;
  const Slice s(d.B * d.T, kBlocks, c.blk);
  const int cw = 2 * d.KL, lw = c.L.lw;
  const float* wc = c.smem + c.L.vdx + c.L.wc;
  const float* wl = c.smem + c.L.vdx + c.L.wl;
  float* xr = c.smem + c.L.vdx + c.L.xr;
  float* ks = c.smem + c.L.ks;
  const int pad = (d.KL - 1) / 2, rs = up4(d.T + d.KL - 1);
  if (s.lo < s.hi) {
    const int b_lo = s.lo / d.T, nrows = (s.hi - 1) / d.T - b_lo + 1, nx = nrows * 2 * rs;
    for (int i0 = ctid(); i0 < nx; i0 += 8 * c.nt) {
      float rx[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * c.nt, row = i / rs, t = i % rs - pad;
        rx[q] = i < nx && t >= 0 && t < d.T
                    ? __ldcg(((row & 1) ? st.alpha_cum : st.alpha) + (size_t)(b_lo + row / 2) * d.T + t)
                    : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (i0 + q * c.nt < nx) xr[i0 + q * c.nt] = rx[q];
    }
    csync(c.nt);
    float* cv = conv + warp * 32;
    for (int it = s.lo + warp; it < s.hi; it += c.nw) {
      const int b = it / d.T, t = it % d.T, il = it - s.lo;
      if (lane < d.F) {
        const float* x0 = xr + (b - b_lo) * 2 * rs + t;
        const float* f0 = wc + lane * cw;
        float c0 = 0.f, c1 = 0.f;
#pragma unroll 8
        for (int j = 0; j < d.KL; ++j) {
          c0 = fmaf(f0[j], x0[j], c0);
          c1 = fmaf(f0[d.KL + j], x0[rs + j], c1);
        }
        cv[lane] = c0 + c1;
      }
      __syncwarp();
      float l[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) l[q] = 0.f;
#pragma unroll 4
      for (int f = 0; f < d.F; f += 4) {
        const float4 cf = lds4(cv + f);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (32 * q < d.A) l[q] = dot4(lds4(wl + (32 * q + lane) * lw + f), cf, l[q]);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (32 * q < d.A) ks[il * d.A + 32 * q + lane] += l[q];
      __syncwarp();
    }
  }
  csync(c.nt);
}

// The energies of the block's items: v . tanh(keys + loc + q) + the mask
// bias; the query rows of the items' batch rows staged in VC first
__device__ __forceinline__ void energies(const Ctx& c, const Scratch& sc) {
  const Dims& d = c.d;
  const int lane = ctid() & 31, warp = ctid() >> 5;
  const Slice s(d.B * d.T, kBlocks, c.blk);
  const float* ks = c.smem + c.L.ks;
  const float* vv = c.smem + c.L.sw + c.L.vv;
  const float* mb = c.smem + c.L.sw + c.L.mb;
  float* qs = c.smem + c.L.vc;
  const int b_lo = s.lo < s.hi ? s.lo / d.T : 0;
  if (s.lo < s.hi) {
    const int n4 = ((s.hi - 1) / d.T - b_lo + 1) * d.A / 4;
    for (int i = ctid(); i < n4; i += c.nt) cp16(qs + 4 * i, sc.q + b_lo * d.A + 4 * i);
  }
  cp_wait_all();
  csync(c.nt);
  for (int it = s.lo + warp; it < s.hi; it += c.nw) {
    const int b = it / d.T, il = it - s.lo;
    float acc = 0.f;
    for (int a = lane; a < d.A; a += 32)
      acc = fmaf(tanhf(ks[il * d.A + a] + qs[(b - b_lo) * d.A + a]), vv[a], acc);
    acc = tt::warp_sum(acc);
    if (lane == 0) sc.energy[it] = acc + mb[il];
  }
}

// The first kMemQ positions a lane reads of the block's first (row, 32
// memory columns) item of attend (positions warp + nw q), into registers,
// a phase before attend
__device__ __forceinline__ void load_memory(const Ctx& c, const float* memory,
                                            float (&mv)[kMemQ]) {
  const Dims& d = c.d;
  const int lane = ctid() & 31, warp = ctid() >> 5;
  const int mcs = d.M / 32;
  const Slice s(d.B * mcs, kBlocks, c.blk);
  const float* col = memory + (size_t)(s.lo / mcs) * d.T * d.M + (s.lo % mcs) * 32 + lane;
#pragma unroll
  for (int q = 0; q < kMemQ; ++q) {
    const int t = warp + c.nw * q;
    mv[q] = s.lo < s.hi && t < d.T ? __ldg(col + (size_t)t * d.M) : 0.f;
  }
}

// Softmax and context of the block's (row, 32 memory columns) items; the
// row's first item also writes the alignment to its slot, the state's
// alpha, and alpha_cum + alpha (the row the block keeps in `ac`, which only
// it writes). A warp's share of the memory column (the
// positions warp + nw q) is loaded before the softmax, kMemQ positions a
// lane at a time; the first item's first ones are `pre` (load_memory).
__device__ __forceinline__ void attend(const Ctx& c, const float* memory, const State& st,
                                       const Out& out, const Scratch& sc, long long slot,
                                       const float (&pre)[kMemQ]) {
  const Dims& d = c.d;
  const int lane = ctid() & 31, warp = ctid() >> 5;
  const int mcs = d.M / 32;
  const Slice s(d.B * mcs, kBlocks, c.blk);
  float* es = c.smem + c.L.es;
  float* part = c.smem + c.L.part;
  for (int it = s.lo; it < s.hi; ++it) {
    const int b = it / mcs, m = (it % mcs) * 32 + lane;
    const float* col = memory + (size_t)b * d.T * d.M + m;
    float acc = 0.f;
    for (int t0 = 0; t0 < d.T; t0 += c.nw * kMemQ) {
      float mv[kMemQ];
#pragma unroll
      for (int q = 0; q < kMemQ; ++q) {
        const int t = t0 + warp + c.nw * q;
        mv[q] = it == s.lo && t0 == 0 ? pre[q] : t < d.T ? __ldg(col + (size_t)t * d.M) : 0.f;
      }
      if (t0 == 0) {
        for (int t = ctid(); t < d.T; t += c.nt) es[t] = __ldcg(sc.energy + b * d.T + t);
        csync(c.nt);
        softmax(es, d.T, part, c.nt, c.nw);
      }
#pragma unroll
      for (int q = 0; q < kMemQ; ++q) {
        const int t = t0 + warp + c.nw * q;
        if (t < d.T) acc = fmaf(es[t], mv[q], acc);
      }
    }
    part[warp * 32 + lane] = acc;
    csync(c.nt);
    if (warp == 0) {
      float sum = 0.f;
      for (int i = 0; i < c.nw; ++i) sum += part[i * 32 + lane];
      st.ctx[b * d.M + m] = sum;
    }
    if (it % mcs == 0) {
      float* ac = c.smem + c.L.ac;
      for (int t = ctid(); t < d.T; t += c.nt) {
        const float a = es[t], cum = ac[t] + a;
        if (slot < out.slots) out.aligns[((size_t)b * out.slots + slot) * d.T + t] = a;
        st.alpha[b * d.T + t] = a;
        st.alpha_cum[b * d.T + t] = cum;
        ac[t] = cum;
      }
    }
    csync(c.nt);
  }
}

// The LSTM cell update of the block's U units for every row, from the
// consumers' flushed sums (red: warp g + 4 bg, 64 floats, (unit, row)
// order): gates i, f, g, o = sums + b_ih + b_hh (bias: the block's b_ih rows
// g U + u, then its b_hh rows); c' = sig(f) c + sig(i) tanh(g), h' = sig(o)
// tanh(c'); zoneout keeps lerp(old, new, zw) of both. c in cs (U, kMaxB);
// h(k - 1) of the block's units from hold (shared, row b at b * ld); h(k)
// to hg (global, (B, H)).
__device__ __forceinline__ void cell_update(const Ctx& c, const float* red, const float* bias,
                                            int H, float* cs, const float* hold, int ld,
                                            float* hg, float zw) {
  const int B = c.d.B, U = H / kBlocks, u0 = c.blk * U;
  for (int i = ctid(); i < U * B; i += c.nt) {
    const int u = i / B, b = i % B;
    const float* r = red + (b / kBT) * 4 * kAcc + u * kBT + b % kBT;
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[g] = r[g * kAcc] + bias[g * U + u] + bias[4 * U + g * U + u];
    float* h = hg + (size_t)b * H + u0 + u;
    const float c_old = cs[u * kMaxB + b], h_old = hold[b * ld + u];
    const float c_new = sigmoid(pre[1]) * c_old + sigmoid(pre[0]) * tanhf(pre[2]);
    const float h_new = sigmoid(pre[3]) * tanhf(c_new);
    cs[u * kMaxB + b] = lerp_w(c_old, c_new, zw);
    *h = lerp_w(h_old, h_new, zw);
  }
}

// WhileDecode._gate_rule over the launch's n steps, by the last block
__device__ __forceinline__ void gate_rule(const Dims& d, const Exit& ex, const Out& out,
                                          const Scratch& sc, int n, long long slot0, int nt) {
  __shared__ unsigned char act[kMaxChunk * kMaxB];
  if (ctid() == 0) {
    long long t = __ldcg(ex.t), len[kMaxB];
    bool ended[kMaxB];
    for (int b = 0; b < d.B; ++b) {
      ended[b] = reinterpret_cast<volatile unsigned char*>(ex.ended)[b] != 0;
      len[b] = __ldcg(ex.lengths + b);
    }
    bool all = true;
    for (int k = 0; k < n; ++k) {
      all = true;
      for (int b = 0; b < d.B; ++b) all = all && ended[b];
      const bool live = !(t >= ex.n_steps || all);
      for (int b = 0; b < d.B; ++b) {
        const bool a = live && !ended[b];
        act[k * kMaxB + b] = a;
        len[b] += a;
        if (a && __ldcg(sc.gates + b * kMaxChunk + k) > ex.thr) ended[b] = true;
      }
      t += live;
    }
    all = true;
    for (int b = 0; b < d.B; ++b) {
      all = all && ended[b];
      ex.ended[b] = ended[b];
      ex.lengths[b] = len[b];
    }
    *ex.t = t;
    *ex.slot = slot0 + n;
    *ex.done = t >= ex.n_steps || all;
    sc.sync[0] = 0;  // every block has passed every barrier of the launch
  }
  csync(nt);
  // the inactive steps' frames and alignments are zero
  const int RN = d.R * d.NM;
  for (int k = 0; k < n; ++k) {
    const long long slot = slot0 + k;
    if (slot >= out.slots) break;
    for (int b = 0; b < d.B; ++b) {
      if (act[k * kMaxB + b]) continue;
      float* fo = out.frames + ((size_t)b * out.slots + slot) * RN;
      float* ao = out.aligns + ((size_t)b * out.slots + slot) * d.T;
      for (int i = ctid(); i < RN; i += nt) fo[i] = 0.f;
      for (int i = ctid(); i < d.T; i += nt) ao[i] = 0.f;
    }
  }
}

// ---------------------------------------------------------------- the kernel

// NBG: batch groups of 8 rows (1 at B <= 8, 2 at B <= 16); the consumers
// have 4 NBG warps, the chain the other 11 - 4 NBG but the producer's (12
// warps: 168 registers a thread)
template <int NBG>
__global__ void __launch_bounds__(kThreads, 1)
t2_decode_kernel(const float* __restrict__ memory, const float* __restrict__ keys,
                 const float* __restrict__ maskbias, W2 w, Dims dm, int n, Masks mk,
                 int dropout, float keep, float scale, float zw, int ns, State st, Out out,
                 Exit ex, Scratch sc) {
  constexpr int kConsWarps = 4 * NBG, kChainWarps = 11 - kConsWarps;
  constexpr int nt = 32 * kChainWarps;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  __shared__ __align__(8) uint64_t cbar[4];  // the chain's fetches: vectors, location, heads, query
  __shared__ Stage plan[kMaxPlan];
  __shared__ int avail_s, fl_s[kFlags + 1];
  volatile int* avail = &avail_s;
  volatile int* fl = fl_s;
  const Layout L(dm, ns);
  const Dims& d = dm;
  const int S = plan_len(dm);
  // a step's stages: CA and HA, HD, XA, AD, CD
  const int n_ha = (d.M + d.HA) / kCols, n_hd = n_ha + d.HD / kCols, n_xa = n_hd + d.P1 / kCols;
  const int n_ad = n_xa + d.HA / kCols;
  if (threadIdx.x == 0) {
    for (int h = 0, c = 0; h < kThreads / 32; ++h) {
      const bool cons = NBG == 1 ? h == 0 || h == 1 || h == 4 || h == 5 : h % 4 != 2 && h < 11;
      g_chain_warp[h] = h < 11 && !cons ? c++ : -1;
    }
    for (int i = 0; i < ns; ++i) {
      mbar_init(&bars[i], 1);
      mbar_init(&bars[kMaxStages + i], kConsWarps);
    }
    for (int i = 0; i < 4; ++i) mbar_init(&cbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    build_plan(plan, dm, L, w);
    avail_s = 0;
    for (int i = 0; i <= kFlags; ++i) fl_s[i] = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == kChainWarps + kConsWarps) {
    produce(plan, S, n * S, ns, smem, bars, bars + kMaxStages);
    return;
  }
  if (g_chain_warp[warp] < 0) {
    // the consumer's place: its warps in order of warp index
    int cw = 0;
    for (int h = 0; h < warp; ++h) cw += g_chain_warp[h] < 0;
    consume(plan, S, n * S, ns, smem, bars, bars + kMaxStages, n_ha, n_hd, n_xa, avail, fl,
            smem + L.red, cw);
    return;
  }

  // the chain
  const Ctx c{w, dm, L, (int)blockIdx.x, nt, kChainWarps, smem};
  const int UA = d.HA / kBlocks, UD = d.HD / kBlocks;
  float* va = smem + L.va;
  float* vc = smem + L.vc;
  float* vdx = smem + L.vdx;
  float* sw = smem + L.sw;
  float* cs = smem + L.cs;  // c_a (kMaxUnits, kMaxB), then c_d
  float* hd = smem + L.hd;  // the block's units of h_d(k - 1), (B, kMaxUnits)
  const long long slot0 = __ldcg(ex.slot);
  Grid g{sc.sync, 0};
  Fetch fv{&cbar[0], 0}, floc{&cbar[1], 0}, fh{&cbar[2], 0}, fq{&cbar[3], 0};
  float mv[kMemQ];

  // the state: h_a(-1) and ctx(-1) for every row, this block's c of both
  // LSTMs, the location term of the first step; the first step's chain
  // weights on their way
  prefetch_location(c, floc, keys, maskbias);
  if (dropout) prefetch_masks(c, mk.u[0], mk.u[1]);
  load_rows(fv, va, st.h_a, d.B, L.bt, d.HA, nt);
  load_rows(fv, vc, st.ctx, d.B, L.bt, d.M, nt);
  for (int i = ctid(); i < UA * d.B; i += nt)
    cs[(i / d.B) * kMaxB + i % d.B] = __ldcg(st.c_a + (size_t)(i % d.B) * d.HA + c.blk * UA + i / d.B);
  for (int i = ctid(); i < UD * d.B; i += nt)
    cs[kMaxUnits * kMaxB + (i / d.B) * kMaxB + i % d.B] =
        __ldcg(st.c_d + (size_t)(i % d.B) * d.HD + c.blk * UD + i / d.B);
  {
    // the alpha_cum row of the block's attend item of columns 0..31
    const int mcs = d.M / 32;
    const Slice s(d.B * mcs, kBlocks, c.blk);
    const int it0 = (s.lo + mcs - 1) / mcs * mcs;
    for (int t = ctid(); t < d.T; t += nt)
      if (it0 < s.hi) smem[L.ac + t] = __ldcg(st.alpha_cum + (it0 / mcs) * d.T + t);
  }
  floc.wait();
  cp_wait_all();
  csync(nt);
  set_avail(avail, n_ha);
  location(c, st, smem + L.part);
  prefetch_heads(c, fh);
  prefetch_bias(c, w.a_bih, w.a_bhh, d.HA, L.ba);

  for (int k = 0; k < n; ++k) {
    const int base = k * S;
    MARK(k, 0);
    // h_d(k - 1) for HD (and the block's own units for LD's cell); the
    // heads' and pre-net's rows
    load_rows(fv, vdx, st.h_d, d.B, L.bt, d.HD, nt);
    MARK(k, 20);
    set_avail(avail, base + n_hd);
    fh.wait();
    cp_wait_all();
    csync(nt);
    MARK(k, 21);
    for (int i = ctid(); i < UD * d.B; i += nt)
      hd[(i / UD) * kMaxUnits + i % UD] = vdx[(i / UD) * d.HD + c.blk * UD + i % UD];
    if (k > 0) {
      heads(c, st, out, sc, slot0 + k - 1, k - 1);
      MARK(k, 1);
      grid_sync(g, nt);
    }
    MARK(k, 2);
    prenet(smem + L.hw + L.wp0, sw + L.pb, sw + L.mk, st.prev, d.NM, d.P0, dropout, keep, scale,
           sc.x0, c);
    MARK(k, 3);
    grid_sync(g, nt);
    MARK(k, 4);
    prenet(smem + L.hw + L.wp1, sw + L.pb + L.rp0, sw + L.mk + L.rp0 * kMaxB, sc.x0, d.P0, d.P1,
           dropout, keep, scale, sc.x1, c);
    MARK(k, 5);
    grid_sync(g, nt);
    MARK(k, 6);
    // the attention LSTM: x1 for XA once HD is done, then the cell from the
    // flushed sums
    wait_flags(fl, kFlagHD, kConsWarps, k + 1, nt);
    load_rows(fv, vdx, sc.x1, d.B, L.bt, d.P1, nt);
    set_avail(avail, base + n_xa);
    wait_flags(fl, kFlagA, kConsWarps, k + 1, nt);
    MARK(k, 7);
    cell_update(c, smem + L.red, sw + L.ba, d.HA, cs, va + c.blk * UA, d.HA, st.h_a, zw);
    MARK(k, 8);
    grid_arrive(g, nt);
    prefetch_query(c, fq);  // VC's ctx(k - 1) is no longer read
    prefetch_bias(c, w.d_bih, w.d_bhh, d.HD, L.bd);
    if (k + 1 < n) prefetch_bias(c, w.a_bih, w.a_bhh, d.HA, L.ba);
    grid_wait(g, nt);
    MARK(k, 9);
    // the query, energies, softmax and context
    load_rows(fv, va, st.h_a, d.B, L.bt, d.HA, nt);  // h_a(k), for Q and AD
    MARK(k, 22);
    set_avail(avail, base + n_ad);
    fq.wait();
    cp_wait_all();
    csync(nt);
    MARK(k, 23);
    load_memory(c, memory, mv);
    query(c, sc.q);
    MARK(k, 10);
    grid_sync(g, nt);
    MARK(k, 11);
    energies(c, sc);
    MARK(k, 12);
    grid_arrive(g, nt);
    if (k + 1 < n) {
      // the next step's location inputs and draws (VDX: XA is done)
      prefetch_location(c, floc, keys, maskbias);
      if (dropout) prefetch_masks(c, mk.u[2 * k + 2], mk.u[2 * k + 3]);
    }
    grid_wait(g, nt);
    MARK(k, 13);
    attend(c, memory, st, out, sc, slot0 + k, mv);
    MARK(k, 14);
    grid_sync(g, nt);
    MARK(k, 15);
    // the decoder LSTM: ctx(k) for CD (and the next step's CA and HA); the
    // next step's location term (alpha(k) and alpha_cum(k) are final) while
    // the consumers finish; then the cell
    load_rows(fv, vc, st.ctx, d.B, L.bt, d.M, nt);
    set_avail(avail, base + S + (k + 1 < n ? n_ha : 0));
    if (k + 1 < n) {
      floc.wait();
      cp_wait_all();
      csync(nt);
      location(c, st, smem + L.part);
    }
    MARK(k, 16);
    wait_flags(fl, kFlagD, kConsWarps, k + 1, nt);
    MARK(k, 17);
    cell_update(c, smem + L.red + kWarpsMax * kAcc, sw + L.bd, d.HD, cs + kMaxUnits * kMaxB, hd,
                kMaxUnits, st.h_d, zw);
    grid_arrive(g, nt);
    prefetch_heads(c, fh);  // for heads(k) and the next step's pre-net
    MARK(k, 18);
    grid_wait(g, nt);
    MARK(k, 19);
  }
  load_rows(fv, vdx, st.h_d, d.B, L.bt, d.HD, nt);
  fh.wait();
  cp_wait_all();
  csync(nt);
  heads(c, st, out, sc, slot0 + n - 1, n - 1);
  // this block's c for the next launch
  for (int i = ctid(); i < UA * d.B; i += nt)
    st.c_a[(size_t)(i % d.B) * d.HA + c.blk * UA + i / d.B] = cs[(i / d.B) * kMaxB + i % d.B];
  for (int i = ctid(); i < UD * d.B; i += nt)
    st.c_d[(size_t)(i % d.B) * d.HD + c.blk * UD + i / d.B] =
        cs[kMaxUnits * kMaxB + (i / d.B) * kMaxB + i % d.B];

  // The exit rule: every block's frames, alignments and gate logits are
  // written and fenced before its ticket (release); the block with the
  // last ticket reads them after it (acquire).
  __shared__ int last;
  csync(nt);
  if (ctid() == 0)
    last = ticket_acq_rel(sc.sync + 1, kBlocks - 1) == (unsigned)(kBlocks - 1);
  csync(nt);
  if (last) gate_rule(d, ex, out, sc, n, slot0, nt);
}

Dims dims_of(const int* d) {
  return Dims{d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9], d[10], d[11]};
}

template <int NBG>
cudaError_t configure(size_t smem) {
  return cudaFuncSetAttribute(t2_decode_kernel<NBG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NBG>
cudaError_t launch(const float* memory, const float* keys, const float* maskbias, const W2& w,
                   const Dims& d, int n, const Masks& mk, int dropout, float keep, float scale,
                   float zw, int ns, const State& st, const Out& out, const Exit& ex,
                   const Scratch& sc, size_t smem, cudaStream_t s) {
  cudaError_t err = configure<NBG>(smem);
  if (err != cudaSuccess) return err;
  t2_decode_kernel<NBG><<<kBlocks, kThreads, smem, s>>>(memory, keys, maskbias, w, d, n, mk,
                                                        dropout, keep, scale, zw, ns, st, out,
                                                        ex, sc);
  return cudaGetLastError();
}

template <int NBG>
cudaError_t resident(size_t smem, int* per_sm) {
  cudaError_t err = configure<NBG>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, t2_decode_kernel<NBG>, kThreads,
                                                       smem);
}

}  // namespace

#ifdef TT_T2_CLOCK
// The clock of the last launch: (2 blocks, kMaxChunk steps, kMarks, 3)
// int64, then consumer warp 0's 3 cycle counts.
extern "C" int tt_t2_decode_clock(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_t2_clock, sizeof(g_t2_clock));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + sizeof(g_t2_clock) / sizeof(long long), g_t2_cons,
                               sizeof(g_t2_cons));
  return (int)err;
}
#endif

// dims: B, T_in, memory width, attention width, n_mels, r, pre-net widths
// (2), attention and decoder LSTM widths, location filters, location
// kernel width. weights: the 20 StepWeights tensors in field order (the
// LSTMs' weight_ih, weight_hh, bias_ih, bias_hh), f32 device pointers. n:
// the launch's steps, 1..64. masks: 2 n pointers (per step the pre-net's
// (B, P0) and (B, P1) uniform draws) when dropout is set. zw: 1 - zoneout.
// stages: the ring's depth, 1..8. state: h_a, c_a, h_d, c_d, ctx, alpha,
// alpha_cum, previous frame, gate. frames (B, slots, r n_mels), aligns (B,
// slots, T_in): step k to slot *exit[3] + k. exit: t (int64), ended (B,
// bool), lengths (B, int64), slot (int64), done (bool). thr: the gate
// logit's threshold. scratch: x0 (B, P0), x1 (B, P1), q (B, A), energies
// (B, T_in), gate logits (B, 64), f32; sync: 2 uint32, zero at first use.
// Returns the CUDA error.
extern "C" int tt_t2_decode_chunk(const float* memory, const float* keys, const float* maskbias,
                                  const void* const* weights, const int* dims, int n,
                                  const void* const* masks, int dropout, float keep, float scale,
                                  float zw, int stages, void* const* state, float* frames,
                                  float* aligns, int slots, void* const* exit, float thr,
                                  int n_steps, void* const* scratch, unsigned* sync,
                                  void* stream) {
  const Dims d = dims_of(dims);
  if (n < 1 || n > kMaxChunk || stages < 1 || stages > kMaxStages || d.B < 1 || d.B > kMaxB ||
      plan_len(d) > kMaxPlan)
    return (int)cudaErrorInvalidValue;
  W2 w;
  const float** f = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < 20; ++i) f[i] = static_cast<const float*>(weights[i]);
  Masks mk = {};
  if (dropout)
    for (int i = 0; i < 2 * n; ++i) mk.u[i] = static_cast<const float*>(masks[i]);
  State st;
  float** sp = reinterpret_cast<float**>(&st);
  for (int i = 0; i < 9; ++i) sp[i] = static_cast<float*>(state[i]);
  Out out{frames, aligns, slots};
  Exit ex{static_cast<long long*>(exit[0]), static_cast<bool*>(exit[1]),
          static_cast<long long*>(exit[2]), static_cast<long long*>(exit[3]),
          static_cast<bool*>(exit[4]), thr, n_steps};
  Scratch sc{static_cast<float*>(scratch[0]), static_cast<float*>(scratch[1]),
             static_cast<float*>(scratch[2]), static_cast<float*>(scratch[3]),
             static_cast<float*>(scratch[4]), sync};
  const size_t smem = Layout(d, stages).bytes();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d.B <= kBT ? launch<1>(memory, keys, maskbias, w, d, n, mk, dropout, keep, scale, zw,
                             stages, st, out, ex, sc, smem, s)
                 : launch<2>(memory, keys, maskbias, w, d, n, mk, dropout, keep, scale, zw,
                             stages, st, out, ex, sc, smem, s);
  return (int)err;
}

// The dynamic shared memory one block needs with a ring of `stages`.
extern "C" long long tt_t2_decode_smem(const int* dims, int stages) {
  return (long long)Layout(dims_of(dims), stages).bytes();
}

// How many of the kernel's blocks the current device holds at once with a
// ring of `stages` (blocks per SM x SMs), written to *out; the launch needs
// kBlocks.
extern "C" int tt_t2_decode_resident(const int* dims, int stages, int* out) {
  const Dims d = dims_of(dims);
  const size_t smem = Layout(d, stages).bytes();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = d.B <= kBT ? resident<1>(smem, &per_sm) : resident<2>(smem, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = sms * per_sm;
  return (int)err;
}
