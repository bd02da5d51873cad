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
//   tf32x3       the same product on the tensor cores in three TF32 passes
//                (mma.sync m16n8k8: hi*hi into one fp32 accumulator, hi*lo
//                + lo*hi into a second; x_hi = x & 0xffffe000, x_lo = (x -
//                x_hi) & 0xffffe000), K1's convolution engine, its tiles
//                resident in shared memory and every operand split per use
//                as K1 splits them: its rate counts the fp32 FMAs of the
//                product, not the three passes
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

constexpr int kTcBM = 64, kTcBN = 64, kTcMaxK = 128;
constexpr int kTcThreads = 128;   // 4 warps, each a 32 x 32 tile of C
constexpr int kTcAs = kTcMaxK + 4, kTcBs = kTcBN + 8;   // padded row strides
constexpr uint32_t kTf32Mask = 0xffffe000u;

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32Mask;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// sgemm's product on the tensor cores, as K1's convolution runs: the CTA's
// A [64, K] and B [K, 64] tiles staged once in shared memory (rows padded
// against bank conflicts), each rep's B perturbed as its fragments are
// read, every operand split per use, each warp a 32 x 32 tile of C as
// 2 x 4 m16n8 fragments, three passes per k-step of 8.
__global__ void __launch_bounds__(kTcThreads)
tf32x3_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int m, int n, int k, int reps) {
  extern __shared__ __align__(16) float tc_smem[];
  float* as = tc_smem;                   // [64][kTcAs]
  float* bs = tc_smem + kTcBM * kTcAs;   // [K][kTcBs]
  const int bm = blockIdx.y * kTcBM, bn = blockIdx.x * kTcBN;
  const int tid = threadIdx.x, warp = tid >> 5, grp = (tid & 31) >> 2, tig = tid & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  for (int e = tid; e < kTcBM * k; e += kTcThreads) {
    const int row = e / k, kk = e % k;
    as[row * kTcAs + kk] = a[static_cast<long long>(bm + row) * k + kk];
  }
  for (int e = tid; e < k * kTcBN; e += kTcThreads) {
    const int kk = e / kTcBN, col = e % kTcBN;
    bs[kk * kTcBs + col] = b[static_cast<long long>(kk) * n + bn + col];
  }
  __syncthreads();
  float big[2][4][4], small[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[i][j][e] = small[i][j][e] = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    const float pert = static_cast<float>(rep) * 1e-9f;
    for (int ks = 0; ks < k; ks += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* r0 = as + (wm + 16 * i + grp) * kTcAs + ks + tig;
        split_tf32(r0[0], ah[i][0], al[i][0]);
        split_tf32(r0[8 * kTcAs], ah[i][1], al[i][1]);
        split_tf32(r0[4], ah[i][2], al[i][2]);
        split_tf32(r0[8 * kTcAs + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* c0 = bs + (ks + tig) * kTcBs + wn + 8 * j + grp;
        uint32_t bh[2], bl[2];
        split_tf32(c0[0] + pert, bh[0], bl[0]);
        split_tf32(c0[4 * kTcBs] + pert, bh[1], bl[1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(small[i][j], ah[i], bl);
          mma_tf32(big[i][j], ah[i], bh);
          mma_tf32(small[i][j], al[i], bh);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = bm + wm + 16 * i + grp, col = bn + wn + 8 * j + 2 * tig;
      c[static_cast<long long>(r) * n + col] = big[i][j][0] + small[i][j][0];
      c[static_cast<long long>(r) * n + col + 1] = big[i][j][1] + small[i][j][1];
      c[static_cast<long long>(r + 8) * n + col] = big[i][j][2] + small[i][j][2];
      c[static_cast<long long>(r + 8) * n + col + 1] = big[i][j][3] + small[i][j][3];
    }
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

// The same product as rls_prim_sgemm on the tensor cores (tf32x3_kernel):
// m % 64 == 0, n % 64 == 0, k % 8 == 0, k <= 128.
extern "C" int rls_prim_tf32x3(const float* a, const float* b, float* c, int m, int n, int k,
                               int reps, void* stream) {
  const size_t bytes = static_cast<size_t>(kTcBM * kTcAs + k * kTcBs) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / kTcBN, m / kTcBM);
  tf32x3_kernel<<<grid, kTcThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a, b, c, m, n,
                                                                               k, reps);
  return static_cast<int>(cudaGetLastError());
}
