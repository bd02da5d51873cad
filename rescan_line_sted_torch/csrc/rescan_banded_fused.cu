// K1: the whole rescanned line-STED scan on translating band windows.
//
// Replaces rescan_banded_fused / _kernel of
// rescan_line_sted_tpu/kernels/rescan_banded_fused.py (integer and class
// placement; its NUFFT spreading mode is not ported yet). Per chunk of C
// scan positions: the D_in-row window of the extended, y-convolved sample
// times the chunk-invariant conv table gives each position's binned camera
// frame [dob, H/b]; a noisy run draws K2a shot noise per frame element;
// each frame is added into its class canvas at its integer offset, rows
// below the wrap split m0 at sa_lo + r and the rest at sa_hi + r (mod wc).
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
// per 2048^2 image and bound the kernel.
// Per chunk the sample window [D_in, lanes] is staged in shared memory with
// the b-lane binning folded in (the TPU kernel's bcol matmul). Each thread
// holds a 2 frame row x 16 lane register tile: per d it forms G * ill for
// its rows (2 FMUL) and reads the 16 window values (a warp-wide broadcast),
// for 32 FFMA. The frames of a pass (512 frame rows) overlap on
// the canvas; rather than placing them one by one, each canvas row they hit
// is gathered from shared memory and read-modify-written once, in position
// order (deterministic sums, no atomics).
//
// Bound on the card: fp32 FFMA (68.7 G FMA per 2048^2 image at D_in = 128;
// no tensor cores, since TF32 would break the engine's 1e-5 parity bar),
// then the Philox draws of the sampler and the canvas read-modify-write.
#include <cuda_runtime.h>

#include "poisson.cuh"

namespace {

constexpr int kLanes = 16;                    // canvas lanes per CTA
constexpr int kThreads = 256;
constexpr int kRows = 2;                      // frame rows per thread
constexpr int kPassRows = kRows * kThreads;   // frame rows per pass

// acc[i][l] += sum_d g[d][r_i] * ill[c_i][d] * win[d][l] for this thread's
// frame rows (c_i, r_i); kPair when they are one frame's rows r, r+1 with
// r even (one float2 read of the detection factor)
template <bool kPair>
__device__ __forceinline__ void frame_rows_gemm(float (&acc)[kRows][kLanes],
                                                const float* g_s, const float* i_s,
                                                const float* b_s, int d_in, int dob,
                                                const int (&c)[kRows],
                                                const int (&r)[kRows]) {
#pragma unroll 8
  for (int d = 0; d < d_in; ++d) {
    float a[kRows];
    if (kPair) {
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

__global__ void __launch_bounds__(kThreads, 1)
rescan_banded_fused_kernel(const float* __restrict__ g_t,         // [d_in, dob]
                           const float* __restrict__ ill,         // [C, d_in]
                           const float* __restrict__ sample_ext,  // [W + d_in, H]
                           const int* __restrict__ sa_lo,         // [W]
                           const int* __restrict__ sa_hi,         // [W]
                           const int* __restrict__ m0,            // [W / C]
                           const int* __restrict__ cls,           // [W]
                           float* __restrict__ out,               // [q, wc, H/b]
                           int h, int w, int chunk, int d_in, int dob, int b,
                           int q, int wc, int noisy, uint2 key) {
  extern __shared__ __align__(16) float smem[];
  float* f_ring = smem;                      // [2][kPassRows][kLanes] frame rows
  float* b_s = f_ring + 2 * kPassRows * kLanes;  // [d_in][kLanes] window
  float* g_s = b_s + d_in * kLanes;          // [d_in][dob] detection factor
  float* i_s = g_s + d_in * dob;             // [C][d_in] illumination factor
  const int hb = h / b;
  const int lane0 = blockIdx.x * kLanes;
  const int tid = threadIdx.x;
  const int rows_used = chunk * dob;
  const int n_pass = (rows_used + kPassRows - 1) / kPassRows;
  const bool full_tile = lane0 + kLanes <= hb && hb % 4 == 0;

  for (int i = tid; i < d_in * dob; i += kThreads) g_s[i] = g_t[i];
  for (int i = tid; i < chunk * d_in; i += kThreads) i_s[i] = ill[i];
  for (long long i = tid; i < static_cast<long long>(q) * wc * kLanes; i += kThreads) {
    const long long row = i / kLanes;
    const int l = static_cast<int>(i % kLanes);
    if (lane0 + l < hb) out[row * hb + lane0 + l] = 0.0f;
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
        const float* src = sample_ext + static_cast<long long>(p0 + d) * h +
                           static_cast<long long>(lane0 + l) * b;
        for (int j = 0; j < b; ++j) s += src[j];
      }
      b_s[i] = s;
    }
    __syncthreads();
    const int split = m0[ic];

    for (int p = 0; p < n_pass; ++p, ++pass_no) {
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
          const int row = min(p * kPassRows + kRows * tid + i, rows_used - 1);
          c[i] = row / dob;
          r[i] = row - c[i] * dob;
        }
        if (c[0] == c[1] && r[0] % 2 == 0 && dob % 2 == 0)
          frame_rows_gemm<true>(acc, g_s, i_s, b_s, d_in, dob, c, r);
        else
          frame_rows_gemm<false>(acc, g_s, i_s, b_s, d_in, dob, c, r);
      }

      const int first = p * kPassRows;
      if (first >= rows_used) continue;  // padding rows only
      const int row0 = first + kRows * tid;
      if (noisy) {
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
      // order, and written once, by the thread of the first frame row that
      // hits it. Rows below the split belong to this camera period, the
      // rest wrap into the next (placed W/b earlier). The ring has two
      // slots, so one barrier per pass orders everything: every thread
      // passes it only after finishing the previous pass's gather (which
      // read the other slot and wrote canvas rows this gather may read).
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
      // frame row of frame c2 (phase hi or lo) landing on canvas row t,
      // or -1 when that row is not in this pass
      auto frame_row = [&](int c2, bool hi, int t) {
        const int pos2 = p0 + c2;
        const int start = hi ? sa_hi[pos2] : sa_lo[pos2];
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
        const int k = cls[p0 + c];
        int t = (hi ? sa_hi[p0 + c] : sa_lo[p0 + c]) + r;  // r < dob < wc
        if (t >= wc) t -= wc;
        bool owner = true;
        for (int c2 = c_first; c2 <= c && owner; ++c2) {
          if (cls[p0 + c2] != k) continue;
          if (frame_row(c2, false, t) >= 0 && (c2 < c || hi)) owner = false;
          if (c2 < c && frame_row(c2, true, t) >= 0) owner = false;
        }
        if (!owner) continue;
        float sum[kLanes];
#pragma unroll
        for (int j = 0; j < kLanes; ++j) sum[j] = 0.0f;
        for (int c2 = c; c2 <= c_last; ++c2) {
          if (cls[p0 + c2] != k) continue;
          for (int ph = 0; ph < 2; ++ph) {
            const int row2 = frame_row(c2, ph == 1, t);
            if (row2 < 0) continue;
            const float* src = f_s + (row2 - first) * kLanes;
#pragma unroll
            for (int j4 = 0; j4 < kLanes / 4; ++j4) {
              const float4 v = *reinterpret_cast<const float4*>(src + 4 * j4);
              sum[4 * j4 + 0] += v.x;
              sum[4 * j4 + 1] += v.y;
              sum[4 * j4 + 2] += v.z;
              sum[4 * j4 + 3] += v.w;
            }
          }
        }
        float* dst = out + (static_cast<long long>(k) * wc + t) * hb + lane0;
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
            if (lane0 + j < hb) dst[j] += sum[j];
        }
      }
    }
  }
}

// Dynamic shared memory of one CTA: the two-slot frame-row ring, the
// sample window and the two resident conv-table factors.
size_t banded_smem_bytes(int d_in, int dob, int chunk) {
  return (static_cast<size_t>(2 * kPassRows + d_in) * kLanes +
          static_cast<size_t>(d_in) * (dob + chunk)) * sizeof(float);
}

}  // namespace

// Shared memory K1 needs for these band windows (*need) and what one block
// of `device` may opt in to (*limit), so the caller can refuse windows that
// do not fit before it builds any table.
extern "C" int rls_rescan_banded_fused_smem(int device, int d_in, int dob,
                                            int chunk, long long* need,
                                            long long* limit) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *need = static_cast<long long>(banded_smem_bytes(d_in, dob, chunk));
  *limit = optin;
  return static_cast<int>(err);
}

extern "C" int rls_rescan_banded_fused(const float* g_t, const float* ill,
                                       const float* sample_ext, const int* sa_lo,
                                       const int* sa_hi, const int* m0,
                                       const int* cls, float* out, int h, int w,
                                       int chunk, int d_in, int dob, int b, int q,
                                       int wc, int noisy, unsigned seed0,
                                       unsigned seed1, void* stream) {
  const int hb = h / b;
  const size_t smem = banded_smem_bytes(d_in, dob, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      rescan_banded_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (hb + kLanes - 1) / kLanes;
  rescan_banded_fused_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      g_t, ill, sample_ext, sa_lo, sa_hi, m0, cls, out, h, w, chunk, d_in, dob,
      b, q, wc, noisy, make_uint2(seed0, seed1));
  return static_cast<int>(cudaGetLastError());
}
