// K2a: the tiered Poisson sampler as __device__ functions.
//
// Replaces store_poisson_tiered and sample_poisson of
// rescan_line_sted_tpu/kernels/poisson_pallas.py (with _inversion_from_uniform,
// _stirling_lgamma and the _INV_TIERS ladder). Every tier and bound is kept:
//   max <= 0      exact zeros, no random bits;
//   max < 1e-3    one-uniform Bernoulli;
//   max < 10      single-uniform CDF inversion, kmax 3/4/6/8/24 by the max;
//   max >= 10/NaN 24-round Knuth + 10-attempt Hormann PTRS (Stirling lgamma).
// On the TPU the tier came from a sub-block's max; here it comes from the
// max over a group of rates (a warp's 128 in K2b and K2c, four per lane,
// or four warps' 128 in K2c's one-per-thread layout; 32 x 16 in K1 and
// K4), so the branch is uniform across each warp (no divergence) and each
// tier's truncation bound still holds because the max bounds every rate it
// covers.
//
// Bound on the card: integer arithmetic of Philox-10 and one exp per
// element; the Bernoulli and inversion tiers take one Philox word per
// element (a block serves four), the bright tier's loops end once settled:
// ~(rate + 1) / 4 blocks for a Knuth element, 1-2 for a PTRS one.
#pragma once

#include "philox.cuh"

namespace rls {

constexpr float kCut = 10.0f;
constexpr int kKnuthRounds = 24;
constexpr int kPtrsRounds = 10;
constexpr float kHalfLn2Pi = 0.9189385332046727f;

// Rates are clamped at 0 before sampling; NaN stays NaN (fmaxf would drop it).
static __device__ __forceinline__ float clamp_rate(float lam) {
  return lam > 0.0f ? lam : (lam != lam ? lam : 0.0f);
}

static __device__ __forceinline__ float stirling_lgamma(float z) {
  return (z - 0.5f) * logf(z) - z + kHalfLn2Pi + 1.0f / (12.0f * z) -
         1.0f / (360.0f * z * z * z);
}

// Poisson quantile N(u) = #{k < KMAX : u > F(k)} (poisson_pallas.py
// _inversion_from_uniform): exact given the uniform, excess mass on KMAX.
template <int KMAX>
static __device__ __forceinline__ float inversion(float u, float lam) {
  float term = expf(-lam);
  float cdf = term;
  float n = 0.0f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    n += u > cdf ? 1.0f : 0.0f;
    if (k + 1 < KMAX) {
      term = term * (lam * (1.0f / static_cast<float>(k + 1)));
      cdf = cdf + term;
    }
  }
  return n;
}

// Knuth product method below kCut, PTRS transformed rejection at or above
// it (poisson_pallas.py sample_poisson), on element `index`'s multi-draw
// stream (Knuth draws 0-23, PTRS 24-43). lam <= 0 gives 0; NaN gives NaN.
// The TPU evaluated both branches to the end and selected per element;
// here each lane runs only its own branch, and each loop ends once its
// count is settled: Knuth's product only falls, so no later round adds to
// the count once it is under the threshold, and PTRS keeps its first
// acceptance. Each loop reads a prefix of the same draws, so the counts are
// those of the full loops, at ~(lam + 1) / 4 Philox blocks for Knuth and
// 1-2 for PTRS instead of 6 and 5. Kept out of line: K1, K2b, K2c and K4
// call it only on their rare bright warps.
static __device__ __noinline__ float sample_poisson_at(float lam,
                                                       unsigned long long index,
                                                       uint2 key) {
  if (!(lam > 0.0f)) return lam * 0.0f;  // zero for lam <= 0, NaN for NaN
  Uniforms u(key, index);
  if (lam < kCut) {
    const float threshold = expf(-lam);
    float prod = 1.0f, small = 0.0f;
    for (int k = 0; k < kKnuthRounds; ++k) {
      prod *= u.next();
      if (prod < threshold) break;
      small += 1.0f;
    }
    return small;
  }
  u.n = kKnuthRounds;
  const float log_lam = logf(lam);
  const float b = 0.931f + 2.53f * sqrtf(lam);
  const float a = -0.059f + 0.02483f * b;
  const float vr = 0.9277f - 3.6224f / (b - 2.0f);
  const float inv_alpha = 1.1239f + 1.1328f / (b - 3.4f);
  for (int r = 0; r < kPtrsRounds; ++r) {
    const float uu = u.next() - 0.5f;
    const float v = u.next();
    const float us = 0.5f - fabsf(uu);
    const float k = floorf((2.0f * a / us + b) * uu + lam + 0.43f);
    const bool accept_fast = (us >= 0.07f) && (v <= vr);
    const bool reject = (k < 0.0f) || ((us < 0.013f) && (v > us));
    const float safe_us = fmaxf(us, 1e-6f);
    const float lhs = logf(v * inv_alpha / (a / (safe_us * safe_us) + b));
    const float rhs = -lam + k * log_lam - stirling_lgamma(fmaxf(k, 0.0f) + 1.0f);
    if (accept_fast || (!reject && lhs <= rhs)) return k;
  }
  return rintf(lam);  // no acceptance in kPtrsRounds attempts
}

// Clamps N rates in place and returns the max of their bits: non-negative
// floats order like their bits, and any NaN sorts above +inf.
template <int N>
static __device__ __forceinline__ uint32_t clamp_max_bits(float (&lam)[N]) {
  uint32_t mxb = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    lam[i] = clamp_rate(lam[i]);
    mxb = max(mxb, __float_as_uint(lam[i]));
  }
  return mxb;
}

// K2a's tier ladder for N clamped rates, in place, given mxb, the max bits
// (clamp_max_bits) over every rate the tier covers: element i has global
// index index_of(i) and single-draw uniform uniform_of(i) (single_draw of
// that index; asked only where the tier needs it). The caller reduces mxb
// over its group, so every thread of the group takes the same branch. The
// bright tier draws each element with sample_poisson_at.
template <int N, typename Uniform, typename Index>
static __device__ __forceinline__ void tiered_by(uint32_t mxb, float (&lam)[N],
                                                 Uniform uniform_of, Index index_of,
                                                 uint2 key) {
  const float mx = __uint_as_float(mxb);
  if (mxb == 0u) {
#pragma unroll
    for (int i = 0; i < N; ++i) lam[i] = 0.0f;
  } else if (mxb > 0x7f800000u || mx >= kCut) {
#pragma unroll
    for (int i = 0; i < N; ++i) lam[i] = sample_poisson_at(lam[i], index_of(i), key);
  } else if (mx < 1e-3f) {
#pragma unroll
    for (int i = 0; i < N; ++i) lam[i] = uniform_of(i) < lam[i] ? 1.0f : 0.0f;
  } else if (mx < 0.1f) {
#pragma unroll
    for (int i = 0; i < N; ++i) lam[i] = inversion<3>(uniform_of(i), lam[i]);
  } else if (mx < 0.33f) {
#pragma unroll
    for (int i = 0; i < N; ++i) lam[i] = inversion<4>(uniform_of(i), lam[i]);
  } else if (mx < 0.85f) {
#pragma unroll
    for (int i = 0; i < N; ++i) lam[i] = inversion<6>(uniform_of(i), lam[i]);
  } else if (mx < 1.5f) {
#pragma unroll
    for (int i = 0; i < N; ++i) lam[i] = inversion<8>(uniform_of(i), lam[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) lam[i] = inversion<24>(uniform_of(i), lam[i]);
  }
}

// The ladder for N elements per lane, the tier from the max over the
// WARP's 32 x N rates, so EVERY lane of the warp must call this; lanes
// without elements pass rates of 0.
template <int N, typename Uniform, typename Index>
static __device__ __forceinline__ void tiered(float (&lam)[N], Uniform uniform_of,
                                              Index index_of, uint2 key) {
  tiered_by(__reduce_max_sync(0xffffffffu, clamp_max_bits(lam)), lam, uniform_of,
            index_of, key);
}

// The ladder for N elements of consecutive indices index0 + i whose
// uniforms u the caller drew (it may draw four from one Philox block).
template <int N>
static __device__ __forceinline__ void poisson_tiered(float (&lam)[N],
                                                      const float (&u)[N],
                                                      unsigned long long index0,
                                                      uint2 key) {
  tiered(lam, [&](int i) { return u[i]; }, [&](int i) { return index0 + i; }, key);
}

}  // namespace rls
