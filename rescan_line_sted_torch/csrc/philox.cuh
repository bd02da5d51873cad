// Philox4x32-10 counter-based generator and the uniforms drawn from it.
//
// Replaces the TPU's hardware PRNG (pltpu.prng_seed / prng_random_bits in
// rescan_line_sted_tpu/kernels/poisson_pallas.py). The key is two 31-bit
// words drawn from the caller's torch.Generator; the counter is built from
// the element's global index and the draw number, so every element's
// stream depends only on the key and its index -- never on the tiling.
//
// Bound on the card: 32-bit integer multiplies (two wide multiplies per
// round, ten rounds per block of four uniforms); the single-draw stream
// spends one block on four elements so no word is drawn and dropped.
#pragma once

#include <cstdint>

namespace rls {

static __device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// Uniform in (0, 1), never exactly 0 or 1: (bits >> 9) * 2^-23 + 2^-24
// (poisson_pallas.py _uniform).
static __device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return static_cast<float>(bits >> 9) * 1.1920928955078125e-7f +
         5.9604644775390625e-8f;
}

static __device__ __forceinline__ uint32_t word_of(uint4 bits, uint32_t word) {
  return word == 0 ? bits.x : word == 1 ? bits.y : word == 2 ? bits.z : bits.w;
}

// The key words: by value, or from device memory where the caller drew
// them on the card under CUDA-graph capture (two int64, _build.key_words:
// a replay draws new ones, with no host-device sync).
static __device__ __forceinline__ uint2 load_key(uint2 key, const long long* key_dev) {
  return key_dev == nullptr ? key
                            : make_uint2(static_cast<uint32_t>(key_dev[0]),
                                         static_cast<uint32_t>(key_dev[1]));
}

// The single-draw stream: element `index` takes word index % 4 of
// Philox(counter = (group lo, group hi, 0, 1)) with group = index / 4, so
// one Philox block serves four neighbouring elements. The tag 1 in the
// last counter word keeps it apart from the multi-draw streams below.
static __device__ __forceinline__ uint4 single_draw_block(unsigned long long group,
                                                          uint2 key) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(group),
                                  static_cast<uint32_t>(group >> 32), 0u, 1u),
                       key);
}

static __device__ __forceinline__ float single_draw(unsigned long long index,
                                                    uint2 key) {
  return bits_to_uniform(word_of(single_draw_block(index >> 2, key),
                                 static_cast<uint32_t>(index & 3)));
}

// The multi-draw stream of one element: draw n comes from word n % 4 of
// Philox(counter = (index lo, index hi, n / 4, 0)).
struct Uniforms {
  uint2 key;
  uint32_t idx_lo, idx_hi, n;
  uint4 bits;

  __device__ __forceinline__ Uniforms(uint2 k, unsigned long long index)
      : key(k), idx_lo(static_cast<uint32_t>(index)),
        idx_hi(static_cast<uint32_t>(index >> 32)), n(0),
        bits(make_uint4(0, 0, 0, 0)) {}

  __device__ __forceinline__ float next() {
    const uint32_t word = n & 3u;
    if (word == 0) bits = philox4x32_10(make_uint4(idx_lo, idx_hi, n >> 2, 0), key);
    ++n;
    return bits_to_uniform(word_of(bits, word));
  }
};

}  // namespace rls
