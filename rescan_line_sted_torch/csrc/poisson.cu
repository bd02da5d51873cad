// K2b and K2c: standalone Poisson samplers.
//
// K2b (rls_poisson_rows_tiered) replaces poisson_rows_tiered
// (rescan_line_sted_tpu/kernels/poisson_pallas.py, _poisson_rows_kernel):
// a [rows, cols] sampler whose tier is picked per warp of adjacent columns
// of one row, so a caller that puts bright content in few rows (W-major
// frames) keeps most warps on the cheap tiers. The TPU tiered per 32-row x
// <= 512-column sub-chunk; here a warp tiers 128 adjacent columns of a row
// and stops at the row's end.
//
// K2c (rls_poisson_flat) replaces poisson_pallas (_poisson_flat /
// _poisson_kernel): Poisson counts of any-shape rates. The TPU kernel drew
// every element with 24 Knuth rounds and 10 PTRS attempts because its
// vector unit evaluates both branches anyway; on the card that cost is
// optional, so K2c takes K2a's tier ladder per warp of 128 consecutive
// rates.
//
// K2b gives each thread four consecutive elements (16-byte loads and
// stores where aligned, scalar ones on a ragged or misaligned tail), so one
// single-draw Philox block serves a thread's four uniforms (two where a
// row starts off a multiple of four): a zero warp costs no draw, the
// Bernoulli and CDF-inversion tiers a quarter block per element. K2c does
// the same on inputs large enough to fill the card; below that, four per
// thread leaves SMs idle and runs each thread's four bright draws one after
// another, so K2c gives each thread one element and one block (the host
// chooses, kernels/poisson.py flat_layout), the tier still from the max
// over the same 128 consecutive rates, here four warps combined through
// shared memory. Only groups whose max is 10 or more (or NaN) draw Knuth +
// PTRS on the multi-draw stream, each loop ended once its count is settled
// (sample_poisson_at). Element i keeps its single-draw uniform (word i % 4
// of block i / 4, i the flat index) and its multi-draw stream, so the
// counts do not depend on the layout.
//
// Bound on the card: bytes (a rate read and a count written, 8 per
// element) where the rates sit on the single-draw tiers; the Philox blocks
// and inversion terms of those tiers come next, then the bright tier's
// ~(rate + 1) / 4 blocks per Knuth element and 1-2 per PTRS element. On
// small inputs the launch and the host's wrapper bound the call instead:
// the key words come by value, from a CPU generator or from a CUDA
// generator's seed and offset (kernels/_build.py key_words), so no other
// kernel runs first. Under CUDA-graph capture the caller draws them on the
// card and the kernels read them from device memory (key_dev).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "poisson.cuh"

namespace {

constexpr int kRowWarps = 8;  // K2b: warps per block, each on one row at a time

// K2b. A warp takes 128 adjacent columns (four per lane) of one row;
// blocks grid-stride over rows, so each warp's loop bound is uniform (the
// tier's max needs every lane). Lanes past the row's end carry rates of 0.
__global__ void __launch_bounds__(32 * kRowWarps)
poisson_rows_tiered_kernel(const float* __restrict__ lam, float* __restrict__ out,
                           int rows, int cols, uint2 key,
                           const long long* __restrict__ key_dev, bool vec) {
  key = rls::load_key(key, key_dev);
  const int c0 = (blockIdx.x * 32 + threadIdx.x) * 4;
  const int n = min(4, cols - c0);  // this lane's columns in the row (may be <= 0)
  for (int row = blockIdx.y * kRowWarps + threadIdx.y; row < rows;
       row += gridDim.y * kRowWarps) {
    const long long i0 = static_cast<long long>(row) * cols + c0;
    const bool whole = vec && n == 4 && (i0 & 3) == 0;
    float v[4];
    if (whole) {
      const float4 x = *reinterpret_cast<const float4*>(lam + i0);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = j < n ? lam[i0 + j] : 0.0f;
    }
    // element i0 + j takes word (i0 + j) % 4 of single-draw block
    // (i0 + j) / 4: the four straddle two blocks unless i0 % 4 == 0
    const auto g = static_cast<unsigned long long>(i0) >> 2;
    const int k0 = static_cast<int>(i0 & 3);
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    bool drawn = false;
    rls::tiered(
        v,
        [&](int j) {
          if (!drawn) {
            lo = rls::single_draw_block(g, key);
            hi = k0 ? rls::single_draw_block(g + 1, key) : lo;
            drawn = true;
          }
          const int k = k0 + j;
          return rls::bits_to_uniform(rls::word_of(k < 4 ? lo : hi, k & 3));
        },
        [&](int j) { return static_cast<unsigned long long>(i0 + j); }, key);
    if (whole) {
      *reinterpret_cast<float4*>(out + i0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n) out[i0 + j] = v[j];
    }
  }
}

constexpr int kFlatThreads = 256;
constexpr int kFlatWarps = kFlatThreads / 32;

// Four consecutive elements per thread, the tier from the max over the
// warp's 128 rates. The loop bound is uniform across each warp (the tier's
// max needs every lane); lanes past n carry rates of 0. key_dev, when not
// null, holds the two key words (int64) drawn on the card.
__global__ void __launch_bounds__(kFlatThreads)
poisson_flat_kernel(const float* __restrict__ lam, float* __restrict__ out,
                    long long n, uint2 key, const long long* __restrict__ key_dev,
                    bool vec) {
  key = rls::load_key(key, key_dev);
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
    rls::tiered(
        v,
        [&](int j) {
          if (!drawn) {
            bits = rls::single_draw_block(static_cast<unsigned long long>(g), key);
            drawn = true;
          }
          return rls::bits_to_uniform(rls::word_of(bits, static_cast<uint32_t>(j)));
        },
        [&](int j) { return static_cast<unsigned long long>(i0 + j); }, key);
    if (whole) {
      *reinterpret_cast<float4*>(out + i0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j < n) out[i0 + j] = v[j];
    }
  }
}

// One element per thread, for inputs too small to fill the card four per
// thread. A tier still covers 128 consecutive rates, here four warps: each
// warp reduces its max, and the four maxima meet in shared memory. Blocks
// start on multiples of 256, so the groups are those of the four-per-thread
// layout, and the loop bound is uniform across the block (__syncthreads).
// Element i takes word i % 4 of single-draw block i / 4, one block per
// element: the words the four-per-thread layout gives it.
__global__ void __launch_bounds__(kFlatThreads)
poisson_flat_one_kernel(const float* __restrict__ lam, float* __restrict__ out,
                        long long n, uint2 key, const long long* __restrict__ key_dev) {
  __shared__ uint32_t warp_max[kFlatWarps];
  key = rls::load_key(key, key_dev);
  const int warp = threadIdx.x >> 5;
  const int first = warp & ~3;  // the first of this group's four warps
  const long long stride = static_cast<long long>(gridDim.x) * kFlatThreads;
  for (long long b0 = static_cast<long long>(blockIdx.x) * kFlatThreads; b0 < n;
       b0 += stride) {
    const long long i = b0 + threadIdx.x;
    float v[1] = {i < n ? lam[i] : 0.0f};
    const uint32_t mxb = __reduce_max_sync(0xffffffffu, rls::clamp_max_bits(v));
    if ((threadIdx.x & 31) == 0) warp_max[warp] = mxb;
    __syncthreads();
    const uint32_t group_max = max(max(warp_max[first], warp_max[first + 1]),
                                   max(warp_max[first + 2], warp_max[first + 3]));
    __syncthreads();  // warp_max is written again on the next pass
    const auto idx = static_cast<unsigned long long>(i);
    rls::tiered_by(
        group_max, v, [&](int) { return rls::single_draw(idx, key); },
        [&](int) { return idx; }, key);
    if (i < n) out[i] = v[0];
  }
}

}  // namespace

static bool aligned16(const float* a, const float* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15u) == 0;
}

// K2b. key_dev: null to use (seed0, seed1), else a device pointer to the
// two key words as int64 (drawn on the card under CUDA-graph capture).
extern "C" int rls_poisson_rows_tiered(const float* lam, float* out, int rows,
                                       int cols, unsigned seed0, unsigned seed1,
                                       const long long* key_dev, void* stream) {
  if (rows > 0 && cols > 0) {
    const int gy = std::min((rows + kRowWarps - 1) / kRowWarps, 65535);
    const dim3 grid((cols + 127) / 128, gy);
    const dim3 block(32, kRowWarps);
    poisson_rows_tiered_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        lam, out, rows, cols, make_uint2(seed0, seed1), key_dev, aligned16(lam, out));
  }
  return static_cast<int>(cudaGetLastError());
}

// K2c. key_dev as for K2b. per_thread (1 or 4) and blocks: the layout and
// grid the host chose (kernels/poisson.py flat_layout, from the card's SM
// count, rls_sm_count).
extern "C" int rls_poisson_flat(const float* lam, float* out, long long n,
                                unsigned seed0, unsigned seed1, const long long* key_dev,
                                int per_thread, int blocks, void* stream) {
  if ((per_thread != 1 && per_thread != 4) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const uint2 key = make_uint2(seed0, seed1);
    if (per_thread == 1) {
      poisson_flat_one_kernel<<<blocks, kFlatThreads, 0, s>>>(lam, out, n, key, key_dev);
    } else {
      poisson_flat_kernel<<<blocks, kFlatThreads, 0, s>>>(lam, out, n, key, key_dev,
                                                          aligned16(lam, out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The number of SMs of card `device` (read once per card by the caller).
extern "C" int rls_sm_count(int device, int* count) {
  return static_cast<int>(
      cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device));
}
