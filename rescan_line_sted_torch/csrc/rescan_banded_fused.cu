// K1: the whole rescanned line-STED scan on translating band windows.
//
// Replaces rescan_banded_fused / _kernel of
// rescan_line_sted_tpu/kernels/rescan_banded_fused.py, every placement mode.
// Per chunk of C scan positions: the D_in-row window of the extended,
// y-convolved sample times the chunk-invariant conv table gives each
// position's binned camera frame [dob, H/b]; a noisy run draws K2a shot
// noise per frame element; each frame is then placed. Integer and class
// placement adds it into its class canvas at its integer offset, rows below
// the wrap split m0 at sa_lo + r and the rest at sa_hi + r (mod wc). NUFFT
// spreading placement (irrational or q > 8 steps) splits the frame at m0
// first, convolves each part per parity pi of a 2x-oversampled grid with
// the position's n_spread window taps (dob + n_spread - 1 rows) and adds it
// into parity canvas pi at sa_lo[pi] / sa_hi[pi]; the caller merges the two
// parities and deconvolves the window once per image.
//
// Design. One CTA owns kLanes canvas lanes (H/b columns) for the whole
// scan and walks every chunk in order, so the canvas needs no atomics and
// its sums are deterministic. The canvas [q, wc, H/b] stays in device
// memory (50 MB at 2048^2, R = 1.5: it can never sit in shared memory the
// way the TPU kept it in VMEM); each CTA touches only its lanes.
// The conv table of the TPU kernel, swb[c, r, d] = G[r, d] * ill[c, d],
// is kept as its two factors, both resident in shared memory for the whole
// scan: the binned detection window G [dob, D_in] (64 KB at the flagship)
// and the illumination window ill [C, D_in]. Streaming the [C, dob, D_in]
// table itself (2 MB) from L2 for every chunk would cost 17 GB of L2 reads
// per 2048^2 image and bound the kernel. Where G does not fit beside the
// rest (D_in = D_out = 256 at chunk 32 needs 368 KB of the 227 KB a block
// may have), the "wide" layout keeps G as what it is, a Toeplitz matrix
// (a window of the detection circulant, binned: G[d, R] depends on b*R - d
// alone), i.e. as its generator of b*(dob - 1) + D_in values (2 KB there):
// no table is streamed, and the GEMM reads one generator value instead of
// one G value per FMUL. The C entry picks the layout and reports it.
// Per chunk the sample window [D_in, lanes] is staged in shared memory with
// the b-lane binning folded in (the TPU kernel's bcol matmul). Each thread
// holds a 2 frame row x 16 lane register tile: per d it forms G * ill for
// its rows (2 FMUL) and reads the 16 window values (a warp-wide broadcast),
// for 32 FFMA. The frames of a pass (512 frame rows) overlap on
// the canvas; rather than placing them one by one, each canvas row they hit
// is gathered from shared memory and read-modify-written once, in position
// order (deterministic sums, no atomics). In the spreading mode each canvas
// row of either parity gathers its window taps straight from the pass's
// unspread frame rows, so the spread frames are never stored.
//
// Bound on the card: fp32 FFMA (68.7 G FMA per 2048^2 image at D_in = 128,
// 4.3 G more for spreading; no tensor cores, since TF32 would break the
// engine's 1e-5 parity bar), then the Philox draws of the sampler and the
// canvas read-modify-write.
#include <cuda_runtime.h>

#include "poisson.cuh"

namespace {

constexpr int kLanes = 16;                    // canvas lanes per CTA
constexpr int kThreads = 256;
constexpr int kRows = 2;                      // frame rows per thread
constexpr int kPassRows = kRows * kThreads;   // frame rows per pass

struct K1Args {
  const float* g_t;         // [d_in, dob] binned detection window
  const float* ill;         // [C, d_in] illumination window
  const float* sample_ext;  // [W + d_in, H]
  const int* sa_lo;         // [W], or [2, W] per parity when spreading
  const int* sa_hi;         // same shape as sa_lo
  const int* m0;            // [W / C]
  const int* cls;           // [W] (integer and class placement)
  const float* wt;          // [W, 2 * n_spread] window taps (spreading)
  float* out;               // [q, wc, H/b]
  int h, w, chunk, d_in, dob, b, q, wc, n_spread, noisy;
  uint2 key;                 // the key words, unless key_dev holds them
  const long long* key_dev;  // null, or the two key words drawn on the card
};

// acc[i][l] += sum_d G(d, r_i) * ill[c_i][d] * win[d][l] for this thread's
// frame rows (c_i, r_i). G(d, r) is g_s[d * dob + r] when resident, or
// g_s[b * r + d_in - 1 - d] from its generator (kGen). kPair: the two rows
// are one frame's (one ill value), resident ones r, r+1 with r even (one
// float2 read of G).
template <bool kPair, bool kGen>
__device__ __forceinline__ void frame_rows_gemm(float (&acc)[kRows][kLanes],
                                                const float* g_s, const float* i_s,
                                                const float* b_s, int d_in, int dob,
                                                int b, const int (&c)[kRows],
                                                const int (&r)[kRows]) {
  const float* gen0 = g_s + b * r[0] + d_in - 1;
  const float* gen1 = g_s + b * r[1] + d_in - 1;
#pragma unroll 8
  for (int d = 0; d < d_in; ++d) {
    float a[kRows];
    if (kGen) {
      const float il0 = i_s[c[0] * d_in + d];
      a[0] = gen0[-d] * il0;
      a[1] = gen1[-d] * (kPair ? il0 : i_s[c[1] * d_in + d]);
    } else if (kPair) {
      const float2 gg = *reinterpret_cast<const float2*>(g_s + d * dob + r[0]);
      const float il = i_s[c[0] * d_in + d];
      a[0] = gg.x * il;
      a[1] = gg.y * il;
    } else {
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = g_s[d * dob + r[i]] * i_s[c[i] * d_in + d];
    }
    const float4* bv = reinterpret_cast<const float4*>(b_s + d * kLanes);
#pragma unroll
    for (int j4 = 0; j4 < kLanes / 4; ++j4) {
      const float4 bb = bv[j4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        acc[i][4 * j4 + 0] = fmaf(a[i], bb.x, acc[i][4 * j4 + 0]);
        acc[i][4 * j4 + 1] = fmaf(a[i], bb.y, acc[i][4 * j4 + 1]);
        acc[i][4 * j4 + 2] = fmaf(a[i], bb.z, acc[i][4 * j4 + 2]);
        acc[i][4 * j4 + 3] = fmaf(a[i], bb.w, acc[i][4 * j4 + 3]);
      }
    }
  }
}

// dst[0:16] += sum[0:16] on this CTA's canvas lanes
__device__ __forceinline__ void add_row(float* dst, const float (&sum)[kLanes],
                                        bool full_tile, int lanes_left) {
  if (full_tile) {
#pragma unroll
    for (int j4 = 0; j4 < kLanes / 4; ++j4) {
      float4 v = *reinterpret_cast<float4*>(dst + 4 * j4);
      v.x += sum[4 * j4 + 0];
      v.y += sum[4 * j4 + 1];
      v.z += sum[4 * j4 + 2];
      v.w += sum[4 * j4 + 3];
      *reinterpret_cast<float4*>(dst + 4 * j4) = v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      if (j < lanes_left) dst[j] += sum[j];
  }
}

// sum[0:16] += wv * src[0:16] (src 16-byte aligned, in shared memory)
__device__ __forceinline__ void axpy_row(float (&sum)[kLanes], float wv, const float* src) {
#pragma unroll
  for (int j4 = 0; j4 < kLanes / 4; ++j4) {
    const float4 v = *reinterpret_cast<const float4*>(src + 4 * j4);
    sum[4 * j4 + 0] = fmaf(wv, v.x, sum[4 * j4 + 0]);
    sum[4 * j4 + 1] = fmaf(wv, v.y, sum[4 * j4 + 1]);
    sum[4 * j4 + 2] = fmaf(wv, v.z, sum[4 * j4 + 2]);
    sum[4 * j4 + 3] = fmaf(wv, v.w, sum[4 * j4 + 3]);
  }
}

// Length of G's generator (kGen), rounded to 4 floats so what follows
// stays 16-byte aligned.
__host__ __device__ inline int gen_len(int d_in, int dob, int b) {
  return (b * (dob - 1) + d_in + 3) / 4 * 4;
}

template <bool kSpread, bool kGen>
__global__ void __launch_bounds__(kThreads, 1)
rescan_banded_fused_kernel(const K1Args p) {
  const int h = p.h, w = p.w, chunk = p.chunk, d_in = p.d_in, dob = p.dob, b = p.b;
  const uint2 key = rls::load_key(p.key, p.key_dev);
  const int wc = p.wc, n_spread = p.n_spread;
  extern __shared__ __align__(16) float smem[];
  float* f_ring = smem;                      // [2][kPassRows][kLanes] frame rows
  float* b_s = f_ring + 2 * kPassRows * kLanes;  // [d_in][kLanes] window
  float* g_s = b_s + d_in * kLanes;          // G [d_in][dob], or its generator
  float* i_s = g_s + (kGen ? gen_len(d_in, dob, b) : d_in * dob);  // [C][d_in]
  float* w_s = i_s + chunk * d_in;           // [C][2][n_spread] chunk's taps
  const int hb = h / b;
  const int lane0 = blockIdx.x * kLanes;
  const int tid = threadIdx.x;
  const int rows_used = chunk * dob;
  const int n_pass = (rows_used + kPassRows - 1) / kPassRows;
  const bool full_tile = lane0 + kLanes <= hb && hb % 4 == 0;
  const int lanes_left = hb - lane0;

  if (kGen) {
    // generator value k = b*R + d_in - 1 - d, read from one (d, R) of G
    for (int k = tid; k < b * (dob - 1) + d_in; k += kThreads) {
      const int rr = min(k / b, dob - 1);
      g_s[k] = p.g_t[(b * rr + d_in - 1 - k) * dob + rr];
    }
  } else {
    for (int i = tid; i < d_in * dob; i += kThreads) g_s[i] = p.g_t[i];
  }
  for (int i = tid; i < chunk * d_in; i += kThreads) i_s[i] = p.ill[i];
  for (long long i = tid; i < static_cast<long long>(p.q) * wc * kLanes; i += kThreads) {
    const long long row = i / kLanes;
    const int l = static_cast<int>(i % kLanes);
    if (lane0 + l < hb) p.out[row * hb + lane0 + l] = 0.0f;
  }

  const int n_chunks = w / chunk;
  int pass_no = 0;  // passes so far: picks the f_ring slot
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int p0 = ic * chunk;
    __syncthreads();  // canvas zeroed / previous window no longer read
    for (int i = tid; i < d_in * kLanes; i += kThreads) {
      const int d = i / kLanes;
      const int l = i % kLanes;
      float s = 0.0f;
      if (lane0 + l < hb) {
        const float* src = p.sample_ext + static_cast<long long>(p0 + d) * h +
                           static_cast<long long>(lane0 + l) * b;
        for (int j = 0; j < b; ++j) s += src[j];
      }
      b_s[i] = s;
    }
    if (kSpread)
      for (int i = tid; i < chunk * 2 * n_spread; i += kThreads)
        w_s[i] = p.wt[p0 * 2 * n_spread + i];
    __syncthreads();
    const int split = p.m0[ic];

    for (int ps = 0; ps < n_pass; ++ps, ++pass_no) {
      float* f_s = f_ring + (pass_no & 1) * kPassRows * kLanes;
      float acc[kRows][kLanes];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kLanes; ++j) acc[i][j] = 0.0f;
      {
        int c[kRows], r[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int row = min(ps * kPassRows + kRows * tid + i, rows_used - 1);
          c[i] = row / dob;
          r[i] = row - c[i] * dob;
        }
        if (c[0] == c[1] && (kGen || (r[0] % 2 == 0 && dob % 2 == 0)))
          frame_rows_gemm<true, kGen>(acc, g_s, i_s, b_s, d_in, dob, b, c, r);
        else
          frame_rows_gemm<false, kGen>(acc, g_s, i_s, b_s, d_in, dob, b, c, r);
      }

      const int first = ps * kPassRows;
      if (first >= rows_used) continue;  // padding rows only
      const int row0 = first + kRows * tid;
      if (p.noisy) {
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const int row = row0 + rr;
          const bool rok = row < rows_used;
          const int c = rok ? row / dob : 0;
          const int r = rok ? row - c * dob : 0;
          const unsigned long long e0 =
              (static_cast<unsigned long long>(p0 + c) * dob + r) * hb + lane0;
          float u[kLanes];
          if ((e0 & 3) == 0) {  // one Philox block per four lanes
#pragma unroll
            for (int j4 = 0; j4 < kLanes / 4; ++j4) {
              const uint4 bits = rls::single_draw_block((e0 >> 2) + j4, key);
              u[4 * j4 + 0] = rls::bits_to_uniform(bits.x);
              u[4 * j4 + 1] = rls::bits_to_uniform(bits.y);
              u[4 * j4 + 2] = rls::bits_to_uniform(bits.z);
              u[4 * j4 + 3] = rls::bits_to_uniform(bits.w);
            }
          } else {
#pragma unroll
            for (int j = 0; j < kLanes; ++j) u[j] = rls::single_draw(e0 + j, key);
          }
#pragma unroll
          for (int j = 0; j < kLanes; ++j)
            if (!(rok && lane0 + j < hb)) acc[rr][j] = 0.0f;
          rls::poisson_tiered(acc[rr], u, e0, key);
        }
      }

      // Placement. The pass's frame rows go to shared memory; then each
      // canvas row they hit is read, summed over those frames in position
      // order, and written once. Rows below the split belong to this camera
      // period, the rest wrap into the next (placed W/b earlier). The ring
      // has two slots, so one barrier per pass orders everything: every
      // thread passes it only after finishing the previous pass's gather
      // (which read the other slot and wrote canvas rows this gather may
      // read).
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
        for (int j4 = 0; j4 < kLanes / 4; ++j4) {
          *reinterpret_cast<float4*>(f_s + (kRows * tid + rr) * kLanes + 4 * j4) =
              make_float4(acc[rr][4 * j4], acc[rr][4 * j4 + 1],
                          acc[rr][4 * j4 + 2], acc[rr][4 * j4 + 3]);
        }
      }
      __syncthreads();
      const int end = min(first + kPassRows, rows_used);
      const int c_first = first / dob;
      const int c_last = (end - 1) / dob;

      if (kSpread) {
        // Canvas rows of parity pi hit by the pass: the lo placements of
        // its positions cover [base_lo, base_lo + len) (offsets grow with
        // the position), the hi ones the same range W/b earlier. Each row
        // is taken by one thread, once (a row in both ranges with the lo
        // range), and gathers sum_{c2, u} w[c2, pi, u] * f[c2, t - start
        // - u] over both parts, the part decided on the unspread row.
        const int span = dob + n_spread - 1;
        for (int pi = 0; pi < 2; ++pi) {
          const int* slo = p.sa_lo + pi * w + p0;
          const int* shi = p.sa_hi + pi * w + p0;
          const int base_lo = slo[c_first];
          const int base_hi = shi[c_first];
          int diff = slo[c_last] - base_lo;
          if (diff < 0) diff += wc;
          const int len = min(diff + span, wc);
          const int n_cand = split < dob ? 2 * len : len;
          for (int idx = tid; idx < n_cand; idx += kThreads) {
            int t = idx < len ? base_lo + idx : base_hi + (idx - len);
            if (t >= wc) t -= wc;
            if (idx >= len) {
              int rel = t - base_lo;
              if (rel < 0) rel += wc;
              if (rel < len) continue;  // taken with the lo range
            }
            float sum[kLanes];
#pragma unroll
            for (int j = 0; j < kLanes; ++j) sum[j] = 0.0f;
            bool hit = false;
            for (int c2 = c_first; c2 <= c_last; ++c2) {
              const float* wgt = w_s + (c2 * 2 + pi) * n_spread;
              for (int ph = 0; ph < 2; ++ph) {
                int rs = t - (ph ? shi[c2] : slo[c2]);  // spread-frame row
                if (rs < 0) rs += wc;
                for (int u = 0; u < n_spread; ++u) {
                  const int r2 = rs - u;  // frame row before spreading
                  if (r2 < 0 || r2 >= dob || (ph ? r2 < split : r2 >= split)) continue;
                  const int row2 = c2 * dob + r2;
                  if (row2 < first || row2 >= end) continue;
                  hit = true;
                  axpy_row(sum, wgt[u], f_s + (row2 - first) * kLanes);
                }
              }
            }
            if (hit)
              add_row(p.out + (static_cast<long long>(pi) * wc + t) * hb + lane0, sum,
                      full_tile, lanes_left);
          }
        }
        continue;
      }

      // frame row of frame c2 (phase hi or lo) landing on canvas row t,
      // or -1 when that row is not in this pass
      auto frame_row = [&](int c2, bool hi, int t) {
        const int pos2 = p0 + c2;
        const int start = hi ? p.sa_hi[pos2] : p.sa_lo[pos2];
        int r2 = t - start;  // t, start in [0, wc)
        if (r2 < 0) r2 += wc;
        const bool phase_ok = hi ? (r2 >= split && r2 < dob)
                                 : (r2 < split && r2 < dob);
        const int row2 = c2 * dob + r2;
        return phase_ok && row2 >= first && row2 < end ? row2 : -1;
      };
      for (int rr = 0; rr < kRows; ++rr) {
        const int row = row0 + rr;
        if (row >= end) continue;
        const int c = row / dob;
        const int r = row - c * dob;
        const bool hi = r >= split;
        const int k = p.cls[p0 + c];
        int t = (hi ? p.sa_hi[p0 + c] : p.sa_lo[p0 + c]) + r;  // r < dob < wc
        if (t >= wc) t -= wc;
        // the first frame row that hits canvas row t writes it
        bool owner = true;
        for (int c2 = c_first; c2 <= c && owner; ++c2) {
          if (p.cls[p0 + c2] != k) continue;
          if (frame_row(c2, false, t) >= 0 && (c2 < c || hi)) owner = false;
          if (c2 < c && frame_row(c2, true, t) >= 0) owner = false;
        }
        if (!owner) continue;
        float sum[kLanes];
#pragma unroll
        for (int j = 0; j < kLanes; ++j) sum[j] = 0.0f;
        for (int c2 = c; c2 <= c_last; ++c2) {
          if (p.cls[p0 + c2] != k) continue;
          for (int ph = 0; ph < 2; ++ph) {
            const int row2 = frame_row(c2, ph == 1, t);
            if (row2 >= 0) axpy_row(sum, 1.0f, f_s + (row2 - first) * kLanes);
          }
        }
        add_row(p.out + (static_cast<long long>(k) * wc + t) * hb + lane0, sum,
                full_tile, lanes_left);
      }
    }
  }
}

// Dynamic shared memory of one CTA: the two-slot frame-row ring, the
// sample window, G (resident, or its generator), ill and the chunk's taps.
size_t banded_smem_bytes(bool gen, int d_in, int dob, int chunk, int b,
                         int n_spread) {
  const size_t g = gen ? static_cast<size_t>(gen_len(d_in, dob, b))
                       : static_cast<size_t>(d_in) * dob;
  return (static_cast<size_t>(2 * kPassRows + d_in) * kLanes + g +
          static_cast<size_t>(chunk) * (d_in + 2 * n_spread)) * sizeof(float);
}

template <bool kSpread, bool kGen>
cudaError_t launch(const K1Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = rescan_banded_fused_kernel<kSpread, kGen>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.h / a.b + kLanes - 1) / kLanes;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The bytes of both layouts, bytes[0] resident and bytes[1] generator, so
// that the host's bound (kernels/rescan_banded_fused.py banded_fits) can be
// held to this file's formula. Launches nothing; returns 0.
extern "C" int rls_rescan_banded_fused_smem(int d_in, int dob, int chunk, int b,
                                            int n_spread, long long* bytes) {
  bytes[0] = static_cast<long long>(banded_smem_bytes(false, d_in, dob, chunk, b, n_spread));
  bytes[1] = static_cast<long long>(banded_smem_bytes(true, d_in, dob, chunk, b, n_spread));
  return 0;
}

// Launches K1. *variant reports the shared-memory layout it took: 0 with G
// resident, 1 with G as its Toeplitz generator (band windows too wide for
// the resident layout), -1 when neither fits (nothing is launched; the
// rescan engine's host bound banded_fits keeps such windows away).
// n_spread > 0 selects NUFFT spreading placement (q must be 2).
extern "C" int rls_rescan_banded_fused(const float* g_t, const float* ill,
                                       const float* sample_ext, const int* sa_lo,
                                       const int* sa_hi, const int* m0,
                                       const int* cls, const float* wt, float* out,
                                       int h, int w, int chunk, int d_in, int dob,
                                       int b, int q, int wc, int n_spread, int noisy,
                                       unsigned seed0, unsigned seed1,
                                       const long long* key_dev, void* stream,
                                       int* variant) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t resident = banded_smem_bytes(false, d_in, dob, chunk, b, n_spread);
  const size_t gen = banded_smem_bytes(true, d_in, dob, chunk, b, n_spread);
  const size_t limit = static_cast<size_t>(optin);
  *variant = resident <= limit ? 0 : gen <= limit ? 1 : -1;
  if (*variant < 0) return 0;
  const K1Args a{g_t, ill, sample_ext, sa_lo, sa_hi, m0, cls, wt, out,
                 h, w, chunk, d_in, dob, b, q, wc, n_spread, noisy,
                 make_uint2(seed0, seed1), key_dev};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_spread)
    err = *variant ? launch<true, true>(a, gen, s) : launch<true, false>(a, resident, s);
  else
    err = *variant ? launch<false, true>(a, gen, s) : launch<false, false>(a, resident, s);
  return static_cast<int>(err);
}
