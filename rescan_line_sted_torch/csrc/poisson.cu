// K2b and K2c: standalone Poisson samplers.
//
// K2b (rls_poisson_rows_tiered) replaces poisson_rows_tiered
// (rescan_line_sted_tpu/kernels/poisson_pallas.py, _poisson_rows_kernel):
// a [rows, cols] sampler whose tier is picked per warp by K2a. A warp covers
// 32 adjacent columns of one row, so a caller that puts bright content in
// few rows (W-major frames) keeps most warps on the cheap tiers.
//
// K2c (rls_poisson_flat) replaces poisson_pallas (_poisson_flat /
// _poisson_kernel): Poisson counts of any-shape rates. The TPU kernel drew
// every element with 24 Knuth rounds and 10 PTRS attempts because its
// vector unit evaluates both branches anyway; on the card that cost is
// optional, so K2c takes K2a's tier ladder. Each thread owns four
// consecutive elements (16-byte loads and stores where aligned), so a warp
// tiers 128 consecutive rates and one single-draw Philox block serves a
// thread's four uniforms: a zero warp costs no draw, the Bernoulli and
// CDF-inversion tiers a quarter block per element. Only warps whose max is
// 10 or more (or NaN) draw Knuth + PTRS on the multi-draw stream, and there
// each loop ends once the count is settled (sample_poisson_settled), which
// gives sample_poisson's counts from the same draws.
//
// Bound on the card: bytes (a rate read and a count written, 8 per
// element) where the rates sit on the single-draw tiers; the Philox blocks
// and inversion terms of those tiers come next, then the bright tier's
// ~(rate + 1) / 4 blocks per Knuth element and 1-2 per PTRS element.
// Neither kernel stages anything in shared memory: each element is
// independent. K2c reads its key words from device memory when the caller
// drew them on the card (no host-device sync).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "poisson.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

__global__ void __launch_bounds__(32 * kRowsPerBlock)
poisson_rows_tiered_kernel(const float* __restrict__ lam,
                           float* __restrict__ out, int rows, int cols,
                           uint2 key) {
  const int col = blockIdx.x * 32 + threadIdx.x;
  // grid-stride over rows; the loop bound is uniform across each warp
  for (int row = blockIdx.y * kRowsPerBlock + threadIdx.y; row < rows;
       row += gridDim.y * kRowsPerBlock) {
    const bool ok = col < cols;
    const long long idx = static_cast<long long>(row) * cols + col;
    const auto index = static_cast<unsigned long long>(idx);
    float v[1] = {ok ? lam[idx] : 0.0f};
    const float u[1] = {rls::single_draw(index, key)};
    rls::poisson_tiered(v, u, index, key);
    if (ok) out[idx] = v[0];
  }
}

constexpr int kFlatThreads = 256;

// sample_poisson (poisson.cuh) with each loop ended once its count is
// settled: Knuth's product only falls, so no later round adds to the count
// once it is under the threshold, and PTRS keeps its first acceptance. The
// same multi-draw stream (Knuth draws 0-23, PTRS 24-43) gives the same
// counts with ~(lam + 1) / 4 Philox blocks for Knuth and 1-2 for PTRS.
__device__ float sample_poisson_settled(float lam, unsigned long long index, uint2 key) {
  if (!(lam > 0.0f)) return lam * 0.0f;  // zero for lam <= 0, NaN for NaN
  rls::Uniforms u(key, index);
  if (lam < rls::kCut) {
    const float threshold = expf(-lam);
    float prod = 1.0f, small = 0.0f;
    for (int k = 0; k < rls::kKnuthRounds; ++k) {
      prod *= u.next();
      if (prod < threshold) break;
      small += 1.0f;
    }
    return small;
  }
  u.n = rls::kKnuthRounds;
  const float log_lam = logf(lam);
  const float b = 0.931f + 2.53f * sqrtf(lam);
  const float a = -0.059f + 0.02483f * b;
  const float vr = 0.9277f - 3.6224f / (b - 2.0f);
  const float inv_alpha = 1.1239f + 1.1328f / (b - 3.4f);
  for (int r = 0; r < rls::kPtrsRounds; ++r) {
    const float uu = u.next() - 0.5f;
    const float v = u.next();
    const float us = 0.5f - fabsf(uu);
    const float k = floorf((2.0f * a / us + b) * uu + lam + 0.43f);
    const bool accept_fast = (us >= 0.07f) && (v <= vr);
    const bool reject = (k < 0.0f) || ((us < 0.013f) && (v > us));
    const float safe_us = fmaxf(us, 1e-6f);
    const float lhs = logf(v * inv_alpha / (a / (safe_us * safe_us) + b));
    const float rhs = -lam + k * log_lam - rls::stirling_lgamma(fmaxf(k, 0.0f) + 1.0f);
    if (accept_fast || (!reject && lhs <= rhs)) return k;
  }
  return rintf(lam);
}

// Four consecutive elements per thread, the tier from the max over the
// warp's 128 rates. The loop bound is uniform across each warp (the tier's
// max needs every lane); lanes past n carry rates of 0. key_dev, when not
// null, holds the two key words (int64) drawn on the card.
__global__ void __launch_bounds__(kFlatThreads)
poisson_flat_kernel(const float* __restrict__ lam, float* __restrict__ out,
                    long long n, uint2 key, const long long* __restrict__ key_dev,
                    bool vec) {
  if (key_dev != nullptr)
    key = make_uint2(static_cast<uint32_t>(key_dev[0]), static_cast<uint32_t>(key_dev[1]));
  const int lane = threadIdx.x & 31;
  const long long groups = (n + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kFlatThreads;
  for (long long warp0 = static_cast<long long>(blockIdx.x) * kFlatThreads + threadIdx.x - lane;
       warp0 < groups; warp0 += stride) {
    const long long g = warp0 + lane;
    const long long i0 = g << 2;
    const bool whole = vec && i0 + 4 <= n;
    float v[4];
    if (whole) {
      const float4 x = *reinterpret_cast<const float4*>(lam + i0);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = i0 + j < n ? lam[i0 + j] : 0.0f;
    }
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    bool drawn = false;
    // element i0 + j takes word j of single-draw block g: the single-draw
    // stream, drawn only where a tier needs it
    rls::tiered_with(
        v,
        [&](int j) {
          if (!drawn) {
            bits = rls::single_draw_block(static_cast<unsigned long long>(g), key);
            drawn = true;
          }
          return rls::bits_to_uniform(rls::word_of(bits, static_cast<uint32_t>(j)));
        },
        [&](int j) { return static_cast<unsigned long long>(i0 + j); },
        [key](float rate, unsigned long long index) {
          return sample_poisson_settled(rate, index, key);
        });
    if (whole) {
      *reinterpret_cast<float4*>(out + i0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j < n) out[i0 + j] = v[j];
    }
  }
}

}  // namespace

extern "C" int rls_poisson_rows_tiered(const float* lam, float* out, int rows,
                                       int cols, unsigned seed0, unsigned seed1,
                                       void* stream) {
  if (rows > 0 && cols > 0) {
    const int gy = std::min((rows + kRowsPerBlock - 1) / kRowsPerBlock, 65535);
    const dim3 grid((cols + 31) / 32, gy);
    const dim3 block(32, kRowsPerBlock);
    poisson_rows_tiered_kernel<<<grid, block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        lam, out, rows, cols, make_uint2(seed0, seed1));
  }
  return static_cast<int>(cudaGetLastError());
}

// K2c. key_dev: null to use (seed0, seed1), else a device pointer to the
// two key words as int64 (drawn on the card, read by the kernel).
extern "C" int rls_poisson_flat(const float* lam, float* out, long long n,
                                unsigned seed0, unsigned seed1, const long long* key_dev,
                                void* stream) {
  if (n > 0) {
    const long long groups = (n + 3) / 4;
    const long long want = (groups + kFlatThreads - 1) / kFlatThreads;
    const int grid = static_cast<int>(std::min(want, 132LL * 64));
    const bool vec = ((reinterpret_cast<uintptr_t>(lam) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
    poisson_flat_kernel<<<grid, kFlatThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        lam, out, n, make_uint2(seed0, seed1), key_dev, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
