// K6: microkernels that measure this card's primitive rates, each one
// repeated operation in a minimal kernel, for the composite bound of the
// engine kernels (kernels/primitives.py composite_bound).
//
// Replaces the bodies of scripts/perf_vpu_bound.py (_bench, pallas_call at
// :82): _k_fma, _k_uniform, _k_exp, _k_inv_term, _k_knuth_round,
// _k_roll_add and _k_mxu. Each elementwise body runs one thread per element
// with 16 dependent operations per unrolled step, as the TPU body chained 16
// ops per scratch round trip, and writes its result out so nothing folds.
// The TPU's grid of 64 ran on one core; here each grid fills the 132 SMs
// (the wrapper picks the element count), and a chain's length is the reps
// argument, read at run time.
//
//   fma          x = fmaf(x, 0.999999, 1e-7)                  (fp32 FFMA)
//   uniform      x += single-draw Philox uniform (K2a's, philox.cuh), a
//                fresh index per draw                        (integer Philox)
//   uniform_block
//                x += the four uniforms of one single-draw Philox block, a
//                fresh block per rep (K1 draws four lanes from a block)
//   exp          x = expf(-x) * scale (the TPU body's 0.5)   (MUFU ex2 + FMA)
//   inv_term     one CDF-inversion term as inversion<> of poisson.cuh:
//                n += u > cdf; term *= lam / (k + 1); cdf += term
//   knuth_round  one Knuth round as sample_poisson_at of poisson.cuh: a draw
//                of the multi-draw stream, prod *= u, small += prod >= e^-lam
//   place_add    add a [136, 512] window into a [3080, 512] device canvas at
//                a row offset read from device memory per rep, in order,
//                without atomics (the TPU's 8-aligned base plus roll was a
//                workaround for its tiling and is not carried over)
//   sgemm        [M, K] x [K, N] fp32 on FFMA through a shared-memory
//                register tile (no tensor cores, no TF32), B perturbed by
//                rep * 1e-9 per rep as the TPU body did, so no rep is
//                hoisted
//
// Bound on the card: each is bound by what it measures (FFMA issue, the
// integer multiplier, the special-function unit, L2 read-modify-write);
// the products inside inv_term and knuth_round use __fmul_rn / __fadd_rn so
// the host's float32 transcription reproduces them exactly.
#include <cuda_runtime.h>

#include "poisson.cuh"

namespace {

constexpr int kUnroll = 16;
constexpr int kThreads = 256;
constexpr int kWinRows = 136;      // the TPU body's placement window
constexpr int kCanvasRows = 3080;  // and its canvas
constexpr int kCols = 512;
constexpr int kSlice = 32;         // canvas columns per place_add block
constexpr int kPlaceRows = 8;      // row phases per place_add block

__global__ void __launch_bounds__(kThreads) fma_kernel(float* out, int n, int reps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = 0.5f;
  for (int r = 0; r < reps; r += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) x = fmaf(x, 0.999999f, 1e-7f);
  }
  out[i] = x;
}

__global__ void __launch_bounds__(kThreads)
uniform_kernel(float* out, int n, int reps, uint2 key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = 0.0f;
  for (int r = 0; r < reps; r += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      x = __fadd_rn(x, rls::single_draw(static_cast<unsigned long long>(r + k) * n + i, key));
  }
  out[i] = x;
}

__global__ void __launch_bounds__(kThreads)
uniform_block_kernel(float* out, int n, int reps, uint2 key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = 0.0f;
  for (int r = 0; r < reps; r += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint4 b =
          rls::single_draw_block(static_cast<unsigned long long>(r + k) * n + i, key);
      x = __fadd_rn(x, rls::bits_to_uniform(b.x));
      x = __fadd_rn(x, rls::bits_to_uniform(b.y));
      x = __fadd_rn(x, rls::bits_to_uniform(b.z));
      x = __fadd_rn(x, rls::bits_to_uniform(b.w));
    }
  }
  out[i] = x;
}

__global__ void __launch_bounds__(kThreads)
exp_kernel(float* out, int n, int reps, float scale) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = 0.3f;
  for (int r = 0; r < reps; r += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) x = expf(-x) * scale;
  }
  out[i] = x;
}

__global__ void __launch_bounds__(kThreads)
inv_term_kernel(float* out, int n, int reps, float lam, uint2 key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float u = rls::single_draw(static_cast<unsigned long long>(i), key);
  float term = 0.7f, cdf = 0.7f, cnt = 0.0f;
  for (int r = 0; r < reps; r += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      cnt += u > cdf ? 1.0f : 0.0f;
      term = __fmul_rn(term, __fmul_rn(lam, 1.0f / static_cast<float>(k + 1)));
      cdf = __fadd_rn(cdf, term);
    }
  }
  out[i] = cnt + cdf;
}

__global__ void __launch_bounds__(kThreads)
knuth_round_kernel(float* out, int n, int reps, float threshold, uint2 key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  rls::Uniforms u(key, static_cast<unsigned long long>(i));
  float prod = 1.0f, small = 0.0f;
  for (int r = 0; r < reps; r += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      prod = __fmul_rn(prod, u.next());
      small += prod >= threshold ? 1.0f : 0.0f;
    }
  }
  out[i] = __fadd_rn(small, prod);
}

// Block (kSlice, kPlaceRows) owns kSlice columns of canvas blockIdx.y; a
// warp adds one window row's 32 columns (128 coalesced bytes). Consecutive
// windows overlap rows that other threads of the block add, so a barrier
// keeps the reps in order.
__global__ void __launch_bounds__(kSlice * kPlaceRows)
place_add_kernel(float* canvas, const float* __restrict__ win,
                 const int* __restrict__ offsets, int reps) {
  const int col = blockIdx.x * kSlice + threadIdx.x;
  float* c = canvas + static_cast<long long>(blockIdx.y) * kCanvasRows * kCols + col;
  const float* wcol = win + col;
  for (int i = 0; i < reps; ++i) {
    const int base = offsets[i];
#pragma unroll
    for (int r = threadIdx.y; r < kWinRows; r += kPlaceRows)
      c[(base + r) * kCols] += wcol[r * kCols];
    __syncthreads();
  }
}

constexpr int kBM = 128, kBN = 64, kBK = 8, kTM = 8, kTN = 8;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);  // 128

// C = sum_rep A (B + rep * 1e-9), A [m, k], B [k, n], row-major; each thread
// keeps an 8 x 8 tile of C in registers and sweeps k in shared-memory tiles
// of 8 (A stored transposed, its rows padded by 4 floats against bank
// conflicts).
__global__ void __launch_bounds__(kGemmThreads)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, int m, int n, int k, int reps) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float bs[kBK][kBN];
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;
  const int tid = threadIdx.x, ty = tid / (kBN / kTN), tx = tid % (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    const float pert = static_cast<float>(rep) * 1e-9f;
    for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
      for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
        const int row = e / kBK, kk = e % kBK;
        as[kk][row] = a[static_cast<long long>(bm + row) * k + k0 + kk];
      }
#pragma unroll
      for (int e = tid; e < kBK * kBN; e += kGemmThreads) {
        const int kk = e / kBN, col = e % kBN;
        bs[kk][col] = b[static_cast<long long>(k0 + kk) * n + bn + col] + pert;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kTM], bv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty * kTM + i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx * kTN + j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      c[static_cast<long long>(bm + ty * kTM + i) * n + bn + tx * kTN + j] = acc[i][j];
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Every entry launches on `stream` and returns cudaGetLastError(). The
// elementwise ones take n > 0 elements and reps, a multiple of 16.
extern "C" int rls_prim_fma(float* out, int n, int reps, void* stream) {
  fma_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(out, n, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rls_prim_uniform(float* out, int n, int reps, unsigned seed0, unsigned seed1,
                                void* stream) {
  uniform_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, reps, make_uint2(seed0, seed1));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rls_prim_uniform_block(float* out, int n, int reps, unsigned seed0,
                                      unsigned seed1, void* stream) {
  uniform_block_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, reps, make_uint2(seed0, seed1));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rls_prim_exp(float* out, int n, int reps, float scale, void* stream) {
  exp_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(out, n, reps,
                                                                               scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rls_prim_inv_term(float* out, int n, int reps, float lam, unsigned seed0,
                                 unsigned seed1, void* stream) {
  inv_term_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, reps, lam, make_uint2(seed0, seed1));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rls_prim_knuth_round(float* out, int n, int reps, float threshold,
                                    unsigned seed0, unsigned seed1, void* stream) {
  knuth_round_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, reps, threshold, make_uint2(seed0, seed1));
  return static_cast<int>(cudaGetLastError());
}

// canvas [canvases, 3080, 512], win [136, 512], offsets [reps] in
// [0, 3080 - 136].
extern "C" int rls_prim_place_add(float* canvas, const float* win, const int* offsets,
                                  int canvases, int reps, void* stream) {
  const dim3 grid(kCols / kSlice, canvases), block(kSlice, kPlaceRows);
  place_add_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(canvas, win, offsets,
                                                                           reps);
  return static_cast<int>(cudaGetLastError());
}

// a [m, k], b [k, n], c [m, n]: m % 128 == 0, n % 64 == 0, k % 8 == 0.
extern "C" int rls_prim_sgemm(const float* a, const float* b, float* c, int m, int n, int k,
                              int reps, void* stream) {
  const dim3 grid(n / kBN, m / kBM);
  sgemm_kernel<<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, m, n, k,
                                                                             reps);
  return static_cast<int>(cudaGetLastError());
}
