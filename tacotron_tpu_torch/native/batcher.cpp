// Native batch assembler: the hot host-side loop of the input pipeline.
//
// The port's own copy of the JAX package's native/batcher.cpp, with the same
// C ABI (version 2). Given the packed feature arrays (ljspeech.preprocess
// layout: f16 features + offset index) and a list of utterance ids, it
// assembles the padded batch buffers that are then copied to the device:
// f16->f32 conversion, zero-padding and gather in parallel C++ threads
// instead of per-utterance numpy slicing under the GIL.
//
// Two output modes: f32 (f16->f32 conversion on the host) and raw f16
// (pad+gather only: half the host work and half the host->device bytes;
// the training step casts to f32 on the device). The packed source arrays
// are f16 either way, so the values are the same.
//
// Exposed as a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// f16 -> f32, scalar bit manipulation (no F16C dependency).
inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {        // subnormal: normalize
      int shift = 0;
      while ((mant & 0x400) == 0) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3ff;
      // subnormal value is mant * 2^-24; after `shift` normalizing shifts the
      // implicit leading bit sits at 2^(-15 - shift + 1), i.e. biased 113-shift
      bits = sign | ((127 - 14 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000 | (mant << 13);  // inf/nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

void convert_rows(const uint16_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] = half_to_float(src[i]);
}

}  // namespace

extern "C" {

// Assemble one padded batch.
//  mels/linears: packed (total_frames, n_mels/n_freq) float16
//  texts: packed int32
//  *_off/*_len: per-utterance offsets/lengths (int64), indexed by items[]
//  items: utterance indices for this batch (n_items)
//  out_*: caller-allocated buffers
//    out_mel   (n_items, frame_pad, n_mels) f32, zero-initialised here
//    out_lin   (n_items, frame_pad, n_freq) f32
//    out_text  (n_items, text_pad) i32
//    out_text_len / out_frame_len (n_items) i32
//  n_threads: worker threads (<=0 -> hardware_concurrency)
void assemble_batch(const uint16_t* mels, const uint16_t* linears,
                    const int32_t* texts, const int64_t* text_off,
                    const int64_t* text_len, const int64_t* frame_off,
                    const int64_t* frame_len, const int32_t* items,
                    int32_t n_items, int32_t text_pad, int32_t frame_pad,
                    int32_t n_mels, int32_t n_freq, float* out_mel,
                    float* out_lin, int32_t* out_text, int32_t* out_text_len,
                    int32_t* out_frame_len, int32_t n_threads) {
  if (n_threads <= 0) {
    n_threads = (int32_t)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n_items) n_threads = n_items;

  auto worker = [&](int t0, int t1) {
    for (int j = t0; j < t1; ++j) {
      const int32_t u = items[j];
      const int64_t fl64 = frame_len[u];
      const int32_t fl = (int32_t)(fl64 < frame_pad ? fl64 : frame_pad);
      const int64_t tl64 = text_len[u];
      const int32_t tl = (int32_t)(tl64 < text_pad ? tl64 : text_pad);

      float* mel_dst = out_mel + (int64_t)j * frame_pad * n_mels;
      float* lin_dst = out_lin + (int64_t)j * frame_pad * n_freq;
      std::memset(mel_dst, 0, sizeof(float) * (int64_t)frame_pad * n_mels);
      std::memset(lin_dst, 0, sizeof(float) * (int64_t)frame_pad * n_freq);
      convert_rows(mels + frame_off[u] * n_mels, mel_dst, (int64_t)fl * n_mels);
      convert_rows(linears + frame_off[u] * n_freq, lin_dst,
                   (int64_t)fl * n_freq);

      int32_t* txt_dst = out_text + (int64_t)j * text_pad;
      std::memset(txt_dst, 0, sizeof(int32_t) * text_pad);
      std::memcpy(txt_dst, texts + text_off[u], sizeof(int32_t) * tl);

      out_text_len[j] = tl;
      out_frame_len[j] = fl;
    }
  };

  if (n_threads <= 1) {
    worker(0, n_items);
    return;
  }
  std::vector<std::thread> threads;
  const int per = (n_items + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int a = t * per;
    const int b = a + per < n_items ? a + per : n_items;
    if (a >= b) break;
    threads.emplace_back(worker, a, b);
  }
  for (auto& th : threads) th.join();
}

// f16 passthrough variant: same gather/pad, outputs raw uint16 feature
// buffers (see file comment). Shares the text/length handling.
void assemble_batch_f16(const uint16_t* mels, const uint16_t* linears,
                        const int32_t* texts, const int64_t* text_off,
                        const int64_t* text_len, const int64_t* frame_off,
                        const int64_t* frame_len, const int32_t* items,
                        int32_t n_items, int32_t text_pad, int32_t frame_pad,
                        int32_t n_mels, int32_t n_freq, uint16_t* out_mel,
                        uint16_t* out_lin, int32_t* out_text,
                        int32_t* out_text_len, int32_t* out_frame_len,
                        int32_t n_threads) {
  if (n_threads <= 0) {
    n_threads = (int32_t)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n_items) n_threads = n_items;

  auto worker = [&](int t0, int t1) {
    for (int j = t0; j < t1; ++j) {
      const int32_t u = items[j];
      const int64_t fl64 = frame_len[u];
      const int32_t fl = (int32_t)(fl64 < frame_pad ? fl64 : frame_pad);
      const int64_t tl64 = text_len[u];
      const int32_t tl = (int32_t)(tl64 < text_pad ? tl64 : text_pad);

      uint16_t* mel_dst = out_mel + (int64_t)j * frame_pad * n_mels;
      uint16_t* lin_dst = out_lin + (int64_t)j * frame_pad * n_freq;
      std::memset(mel_dst, 0, sizeof(uint16_t) * (int64_t)frame_pad * n_mels);
      std::memset(lin_dst, 0, sizeof(uint16_t) * (int64_t)frame_pad * n_freq);
      std::memcpy(mel_dst, mels + frame_off[u] * n_mels,
                  sizeof(uint16_t) * (int64_t)fl * n_mels);
      std::memcpy(lin_dst, linears + frame_off[u] * n_freq,
                  sizeof(uint16_t) * (int64_t)fl * n_freq);

      int32_t* txt_dst = out_text + (int64_t)j * text_pad;
      std::memset(txt_dst, 0, sizeof(int32_t) * text_pad);
      std::memcpy(txt_dst, texts + text_off[u], sizeof(int32_t) * tl);

      out_text_len[j] = tl;
      out_frame_len[j] = fl;
    }
  };

  if (n_threads <= 1) {
    worker(0, n_items);
    return;
  }
  std::vector<std::thread> threads;
  const int per = (n_items + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int a = t * per;
    const int b = a + per < n_items ? a + per : n_items;
    if (a >= b) break;
    threads.emplace_back(worker, a, b);
  }
  for (auto& th : threads) th.join();
}

int32_t batcher_abi_version() { return 2; }

}  // extern "C"
