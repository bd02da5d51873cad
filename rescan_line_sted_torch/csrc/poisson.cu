// K2b and K2c: standalone Poisson samplers.
//
// K2b (rls_poisson_rows_tiered) replaces poisson_rows_tiered
// (rescan_line_sted_tpu/kernels/poisson_pallas.py, _poisson_rows_kernel):
// a [rows, cols] sampler whose tier is picked per warp by K2a. A warp covers
// 32 adjacent columns of one row, so a caller that puts bright content in
// few rows (W-major frames) keeps most warps on the cheap tiers.
//
// K2c (rls_poisson_flat) replaces poisson_pallas (_poisson_flat /
// _poisson_kernel): the flat Knuth + PTRS sampler over any shape, one
// element per thread in a grid-stride loop.
//
// Bound on the card: arithmetic (44 uniforms = 11 Philox-10 blocks per
// element in K2c); memory traffic is 8 bytes per element. Neither kernel
// stages anything in shared memory: each element is independent.
#include <cuda_runtime.h>

#include <algorithm>

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

__global__ void __launch_bounds__(256)
poisson_flat_kernel(const float* __restrict__ lam, float* __restrict__ out,
                    long long n, uint2 key) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    rls::Uniforms u(key, static_cast<unsigned long long>(i));
    out[i] = rls::sample_poisson(rls::clamp_rate(lam[i]), u);
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

extern "C" int rls_poisson_flat(const float* lam, float* out, long long n,
                                unsigned seed0, unsigned seed1, void* stream) {
  if (n > 0) {
    const long long want = (n + 255) / 256;
    const int grid = static_cast<int>(std::min(want, 132LL * 16));
    poisson_flat_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        lam, out, n, make_uint2(seed0, seed1));
  }
  return static_cast<int>(cudaGetLastError());
}
