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
//   sgemm        [M, K] x [K, N] fp32 on FFMA (no tensor cores, no TF32),
//                B perturbed by rep * 1e-9 per rep as the TPU body did, so
//                no rep is hoisted: 128 x 128 CTA tiles resident in shared
//                memory for every rep, 8 x 8 register tiles fed by 16-byte
//                shared-memory reads
//   tf32x3       the same product on the tensor cores in three TF32 passes
//                (wgmma m64n128k8 on TMA-staged tiles: hi*hi into one set
//                of fp32 accumulators, hi*lo + lo*hi into a second; x_hi =
//                x & 0xffffe000, x_lo = (x - x_hi) & 0xffffe000): the rate
//                K1's convolution is charged at, counting the fp32 FMAs of
//                the product, not the three passes
//
// Bound on the card: each is bound by what it measures (FFMA issue, the
// integer multiplier, the special-function unit, L2 read-modify-write, the
// tensor cores' TF32 rate);
// the products inside inv_term and knuth_round use __fmul_rn / __fadd_rn so
// the host's float32 transcription reproduces them exactly.
#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and card.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel* fn, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// ---- sgemm: fp32 FFMA -----------------------------------------------------
// A CTA owns a 128 x 128 tile of C and keeps its A rows (transposed, [k][128])
// and B columns ([k][128]) resident in shared memory for every rep: K <= 128
// gives at most 128 KB, one CTA per SM, 128 CTAs on the 132 SMs at
// GEMM_SHAPE. B arrives by cp.async; A is transposed through registers once.
// Thread (tx, ty) of 16 x 16 keeps 8 x 8 of C in registers: rows 4ty + i and
// 64 + 4ty + i, columns 4tx + j and 64 + 4tx + j, so each k-step reads its
// operands as four 16-byte loads (A's two broadcast across the warp, B's
// 256 contiguous bytes) and issues 64 FFMA and 8 FADD (B + rep * 1e-9, added
// per rep in registers: no rep is hoisted). The next k-step's operands are
// loaded while this one's FFMAs issue.
constexpr int kSgTile = 128, kSgThreads = 256, kSgMaxK = 128;
constexpr int kSgSmem = 2 * kSgMaxK * kSgTile * 4;

__global__ void __launch_bounds__(kSgThreads, 1)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, int n, int k, int reps) {
  extern __shared__ __align__(16) float sg_smem[];
  float* as = sg_smem;                 // [k][128]: A^T
  float* bs = sg_smem + k * kSgTile;   // [k][128]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bm = blockIdx.y * kSgTile, bn = blockIdx.x * kSgTile;
  for (int e = tid; e < k * (kSgTile / 4); e += kSgThreads) {
    const int row = e >> 5, c4 = e & 31;
    cp_async16(bs + row * kSgTile + 4 * c4, b + static_cast<long long>(row) * n + bn + 4 * c4);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int k4 = k >> 2;
  for (int e = tid; e < kSgTile * k4; e += kSgThreads) {   // a warp: 32 rows, one bank each
    const int row = e & (kSgTile - 1), c4 = e / kSgTile;
    const float4 v =
        *reinterpret_cast<const float4*>(a + static_cast<long long>(bm + row) * k + 4 * c4);
    as[(4 * c4 + 0) * kSgTile + row] = v.x;
    as[(4 * c4 + 1) * kSgTile + row] = v.y;
    as[(4 * c4 + 2) * kSgTile + row] = v.z;
    as[(4 * c4 + 3) * kSgTile + row] = v.w;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float4* as4 = reinterpret_cast<const float4*>(as);
  const float4* bs4 = reinterpret_cast<const float4*>(bs);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float4 a0 = as4[ty], a1 = as4[16 + ty], b0 = bs4[tx], b1 = bs4[16 + tx];
  for (int rep = 0; rep < reps; ++rep) {
    const float pert = __fmul_rn(static_cast<float>(rep), 1e-9f);
    for (int kk = 0; kk < k; kk += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        // the next k-step's operands (after the last, the next rep's first)
        const int nk = u < 7 ? kk + u + 1 : (kk + 8 == k ? 0 : kk + 8);
        const float4 na0 = as4[nk * 32 + ty], na1 = as4[nk * 32 + 16 + ty];
        const float4 nb0 = bs4[nk * 32 + tx], nb1 = bs4[nk * 32 + 16 + tx];
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {__fadd_rn(b0.x, pert), __fadd_rn(b0.y, pert),
                             __fadd_rn(b0.z, pert), __fadd_rn(b0.w, pert),
                             __fadd_rn(b1.x, pert), __fadd_rn(b1.y, pert),
                             __fadd_rn(b1.z, pert), __fadd_rn(b1.w, pert)};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        a0 = na0;
        a1 = na1;
        b0 = nb0;
        b1 = nb1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = c + static_cast<long long>(bm + (i >> 2) * 64 + 4 * ty + (i & 3)) * n + bn;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ---- tf32x3: three TF32 passes on wgmma -----------------------------------
// The product is run transposed, C^T = sum_rep (B + rep * 1e-9)^T A^T, so
// that the operand perturbed every rep is wgmma's A, which may come from
// registers (.tf32 takes only K-major operands, and B [K, N] arrives
// N-major), and the fixed one, A's rows, is wgmma's B, K-major as it lies
// in device memory. A CTA owns 128 columns of C (two consumer warpgroups of
// 64, wgmma's M) by 128 rows of C (wgmma's N = 128, one m64n128k8 per pass
// and k-step). Everything stays resident for all reps (199 KB of shared
// memory, one CTA per SM, 128 CTAs at GEMM_SHAPE), so there is no ring to
// refill and no producer warp: thread 0 issues the TMA loads once.
//   ahi, alo  A's 128 rows, K in slices of 32 floats (128 bytes: one row of
//             the 128-byte swizzle), brought by TMA (cp.async.bulk.tensor,
//             an mbarrier for A and one for B), then split in place: the
//             swizzle permutes whole 16-byte chunks, so hi and lo share
//             one layout and one descriptor form; alo first holds B's raw
//             tile, also by TMA;
//   bt        B's raw tile transposed, [128 columns][K + 4] (the 4 floats
//             of padding put a fragment's 32 reads on 32 banks).
// Per rep and k-step of 8 each thread reads its four fragment values from
// bt, adds the rep's perturbation and splits them (x_hi = x & 0xffffe000,
// x_lo = (x - x_hi) & 0xffffe000), then issues hi*A_hi into one set of 64
// fp32 accumulators and hi*A_lo + lo*A_hi into a second, summed once at
// the end; a k-step's wgmma group runs while the next one's fragments are
// formed (wait_group 1).
constexpr int kXTile = 128, kXThreads = 256, kXSlice = 32, kXMaxSlices = 4;
constexpr int kXBt = kXMaxSlices * kXSlice + 4;            // bt's row stride
constexpr int kXSliceFloats = kXTile * kXSlice;            // 4096: 16 KB
constexpr int kXHalf = kXMaxSlices * kXSliceFloats;        // ahi, alo: 64 KB each
constexpr int kXSmem = (2 * kXHalf + kXTile * kXBt) * 4 + 16 + 1024;   // + barriers, alignment
constexpr uint32_t kTf32Mask = 0xffffe000u;

__device__ __forceinline__ uint32_t tf32_hi(float x) { return __float_as_uint(x) & kTf32Mask; }

__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & kTf32Mask;
}

// Spin on an mbarrier's phase; trap (a launch error, not a hung card) if
// the TMA bytes have not landed within ~2^32 cycles.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - t0 > (1ll << 32)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, uint32_t bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused.
__device__ __forceinline__ uint64_t sw128_desc(const float* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[64] += A (4 registers: rows g, g + 8 and k columns t, t + 4 of the
// warp's 16 rows) x B (the descriptor's 128 x 8 tile), m64n128k8, TF32.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kXThreads, 1)
tf32x3_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              float* __restrict__ c, int n, int slices, int reps) {
  const int k = slices * kXSlice;
  extern __shared__ __align__(16) unsigned char x_smem[];
  float* ahi = reinterpret_cast<float*>(x_smem + ((1024 - (smem_u32(x_smem) & 1023)) & 1023));
  float* alo = ahi + kXHalf;
  float* bt = alo + kXHalf;
  const uint32_t bar_b = smem_u32(bt + kXTile * kXBt), bar_a = bar_b + 8;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kXTile;   // C's columns: wgmma's M
  const int m0 = blockIdx.y * kXTile;   // C's rows: wgmma's N
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_b) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_b),
                 "r"(slices * kXSliceFloats * 4) : "memory");
    for (int s = 0; s < slices; ++s)
      tma_load(alo + s * kXSliceFloats, &map_b, bar_b, n0, s * kXSlice);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_a),
                 "r"(slices * kXSliceFloats * 4) : "memory");
    for (int s = 0; s < slices; ++s)
      tma_load(ahi + s * kXSliceFloats, &map_a, bar_a, s * kXSlice, m0);
  }
  mbar_wait(bar_b, 0);   // B's raw tile [K][128] -> bt [128][K + 4]
  for (int e = tid; e < k * kXTile; e += kXThreads) bt[(e & 127) * kXBt + (e >> 7)] = alo[e];
  __syncthreads();
  mbar_wait(bar_a, 0);   // A's rows, split in place (alo's raw B is read)
  for (int e = tid; e < k * kXTile; e += kXThreads) {
    const float x = ahi[e];
    const uint32_t hi = tf32_hi(x);
    ahi[e] = __uint_as_float(hi);
    alo[e] = __uint_as_float(tf32_lo(x, hi));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
  __syncthreads();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float* f0 = bt + (64 * wg + 16 * warp + g) * kXBt + t;   // fragment row g
  const float* f1 = f0 + 8 * kXBt;                               // and g + 8
  float big[64], small[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) big[i] = small[i] = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    const float pert = __fmul_rn(static_cast<float>(rep), 1e-9f);
    for (int sl = 0; sl < slices; ++sl) {
#pragma unroll
      for (int sub = 0; sub < kXSlice / 8; ++sub) {   // k-steps of 8, 32 bytes apart
        const int kk = sl * kXSlice + 8 * sub;
        const float x[4] = {__fadd_rn(f0[kk], pert), __fadd_rn(f1[kk], pert),
                            __fadd_rn(f0[kk + 4], pert), __fadd_rn(f1[kk + 4], pert)};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          hi[r] = tf32_hi(x[r]);
          lo[r] = tf32_lo(x[r], hi[r]);
        }
        const int off = sl * kXSliceFloats + 8 * sub;
        const uint64_t dhi = sw128_desc(ahi + off), dlo = sw128_desc(alo + off);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_tf32(big, hi, dhi);
        wgmma_tf32(small, hi, dlo);
        wgmma_tf32(small, lo, dhi);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(big);
  fence_acc(small);
  // d[4j + v]: wgmma row g (+ 8 for v >= 2) is C's column, wgmma column
  // 8j + 2t (+ 1 for odd v) C's row
  const int col = n0 + 64 * wg + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float* r0 = c + static_cast<long long>(m0 + 8 * j + 2 * t) * n + col;
    r0[0] = big[4 * j] + small[4 * j];
    r0[n] = big[4 * j + 1] + small[4 * j + 1];
    r0[8] = big[4 * j + 2] + small[4 * j + 2];
    r0[n + 8] = big[4 * j + 3] + small[4 * j + 3];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that the
// library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// A 2-d fp32 tensor map: rows x cols row-major, boxes of box_rows x box_cols.
bool tensor_map(CUtensorMap* map, const float* p, int rows, int cols, int box_rows, int box_cols,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// a [m, k], b [k, n], c [m, n], 16-byte aligned: m % 128 == 0, n % 128 == 0,
// k % 8 == 0, 8 <= k <= 128.
extern "C" int rls_prim_sgemm(const float* a, const float* b, float* c, int m, int n, int k,
                              int reps, void* stream) {
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = opt_in_smem(sgemm_kernel, kSgSmem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / kSgTile, m / kSgTile);
  sgemm_kernel<<<grid, kSgThreads, 2 * k * kSgTile * 4, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, n, k, reps);
  return static_cast<int>(cudaGetLastError());
}

// The same product as rls_prim_sgemm on wgmma (tf32x3_kernel), the same
// alignment: m % 128 == 0, n % 128 == 0, k % 32 == 0, 32 <= k <= 128.
extern "C" int rls_prim_tf32x3(const float* a, const float* b, float* c, int m, int n, int k,
                               int reps, void* stream) {
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = opt_in_smem(tf32x3_kernel, kXSmem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, a, m, k, kXTile, kXSlice, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&map_b, b, k, n, kXSlice, kXTile, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kXTile, m / kXTile);
  tf32x3_kernel<<<grid, kXThreads, kXSmem, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, c, n, k / kXSlice, reps);
  return static_cast<int>(cudaGetLastError());
}
