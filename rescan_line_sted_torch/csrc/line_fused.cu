// K3: the whole descanned line-STED scan with per-frame shot noise.
//
// Replaces line_sted_fused / _line_kernel of
// rescan_line_sted_tpu/kernels/line_fused.py. At scan position pos the
// camera frame is cam[x, y] = sum_a gx(x - a) eff(a - pos) s_y(a, y); the
// slit reads the frame rows r = x - pos it covers, Poisson-sampling the
// rows inside the sampled window and taking the mean of the rest, and sums
// them into out[y, pos]. With d = a - pos,
//     cam[pos + r, y] = sum_d gx(r - d) eff(d) s_y(pos + d, y),
// and K_r(d) = gx(r - d) eff(d) does not depend on pos: the whole scan is,
// per slit row r, one circular correlation of s_y along x with K_r. Rows
// outside the slit are multiplied by 0 and never reach the output, so only
// the slit's rows (9 at slit_halfwidth 4) are computed.
//
// Design. The TPU formed the full [W, W] x [W, L] product per position,
// which its matrix unit makes cheap: 2048^4 = 17.6 T FMA per 2048^2 image.
// Here the work is the slit rows' correlations over their nonzero taps:
// gx and eff underflow to 0 in float32 a few dozen columns from their
// centres, so K_r is nonzero on a short run of offsets. The wrapper finds
// the shortest circular run of offsets j0 .. j0 + n_taps - 1 (centred
// index j = d + W/2) that holds every nonzero tap of every computed row,
// and the kernel sweeps only it: 9 rows x 63 taps at the line settings
// (depletion 8) instead of 9 x W. Skipping a zero tap is exact for finite samples, since
// fma(0, x, acc) = acc.
// One CTA owns kPositions scan positions x kLanes camera lanes. It keeps
// eff and gx resident in shared memory (2 W floats, 16 KB at W = 2048, no
// [W, W] circulant) and the kLanes sample rows it reads, as columns
// (p0 - W/2 + j0 + t) mod W for t < kPositions + n_taps (no modular index
// in the inner loop). Per slit row it forms K_r over the run in shared
// memory, then each thread sweeps the run for its kPer consecutive
// positions of one lane: per 16 taps it reads 31 staged sample values (a
// sliding window: position e at tap m reads column e + m) and 16 K_r
// values (a broadcast, as float4), for 256 FFMA. After the sweep a row
// inside the sampled window is drawn with K2a's Knuth + PTRS sampler
// (sample_poisson, Philox keyed by the global index (pos * n_rows + k) * H
// + y of the element) and weighted; a row outside it adds its weighted
// mean. Each thread writes its out[y, pos] once: no atomics, and the sums
// run in a fixed order.
//
// Bound on the card: fp32 FFMA over the taps (no tensor cores: TF32 would
// break the engine's 1e-5 parity bar) and the sampler's Philox rounds (5-6
// blocks per drawn element). A row's correlation re-reads the staged
// sample from shared memory, not from device memory.
//
// Frame rows outside the slit's span are skipped, where the TPU kernel
// multiplied them by 0: a skipped row that overflowed to infinity gave NaN
// there. Likewise a non-finite sample value reaches only the outputs whose
// tap run covers it, where on the TPU it reached every output of its lane.
#include <cuda_runtime.h>

#include "poisson.cuh"

namespace {

constexpr int kLanes = 8;                     // camera lanes (y) per CTA
constexpr int kGroups = 16;                   // position groups per CTA
constexpr int kPer = 16;                      // consecutive positions per thread
constexpr int kThreads = kLanes * kGroups;
constexpr int kPositions = kGroups * kPer;    // scan positions per CTA

struct K3Args {
  const float* s;     // [h, w] y-convolved sample
  const float* eff;   // [w] brightness-scaled effective line, centered
  const float* gx;    // [w] detection x-profile, centered
  const float* ws;    // [n_rows] weight of each row's Poisson draw
  const float* wm;    // [n_rows] weight of each row's mean
  float* out;         // [h, w] image
  int h, w, i0, n_rows, j0, n_taps, noisy;
  uint2 key;                 // the key words, unless key_dev holds them
  const long long* key_dev;  // null, or the two key words drawn on the card
};

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// staged sample columns per lane: the CTA's positions plus the tap run
__host__ __device__ __forceinline__ int span(int n_taps) {
  return kPositions + round16(n_taps);
}

// Staged column t of lane y. Eight lanes per column, plus one 8-float step
// per 16 columns: the four position groups of a warp read columns 16 apart,
// which this skew puts on four different bank octets (conflict-free).
__device__ __forceinline__ int saddr(int t, int y) {
  return t * kLanes + y + kLanes * (t >> 4);
}

// Bytes of dynamic shared memory: K_r, the staged sample, gx and eff.
size_t line_smem_bytes(int w, int n_taps) {
  const size_t t = static_cast<size_t>(span(n_taps));
  return (static_cast<size_t>(round16(n_taps)) + kLanes * t + kLanes * ((t + 15) / 16) +
          2 * static_cast<size_t>(w)) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
line_sted_fused_kernel(const K3Args a) {
  extern __shared__ __align__(16) float smem[];
  const uint2 key = rls::load_key(a.key, a.key_dev);
  const int w = a.w, tp = round16(a.n_taps), t_len = span(a.n_taps);
  float* krow = smem;                                  // [tp], zero-padded
  float* sbuf = krow + tp;                             // skewed [t_len][kLanes]
  float* gx = sbuf + kLanes * t_len + kLanes * ((t_len + 15) / 16);
  float* eff = gx + w;
  const int tid = threadIdx.x;
  const int yl = tid % kLanes, g = tid / kLanes;
  const int y = blockIdx.y * kLanes + yl;
  const int p0 = blockIdx.x * kPositions;
  const int pos0 = p0 + g * kPer;                      // this thread's first position

  for (int i = tid; i < w; i += kThreads) {
    gx[i] = a.gx[i];
    eff[i] = a.eff[i];
  }
  for (int idx = tid; idx < kLanes * t_len; idx += kThreads) {
    const int l = idx / t_len, t = idx - l * t_len;
    const int yy = blockIdx.y * kLanes + l;
    const int col = (p0 - w / 2 + a.j0 + t + w) % w;
    sbuf[saddr(t, l)] = yy < a.h ? a.s[static_cast<long long>(yy) * w + col] : 0.0f;
  }

  float res[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) res[e] = 0.0f;
  for (int k = 0; k < a.n_rows; ++k) {
    __syncthreads();  // staging done / the previous row's K_r read
    const int c = (a.i0 + k + w / 2) % w;  // K_r(j) = gx[(c - j) mod w] * eff[j]
    for (int m = tid; m < tp; m += kThreads) {
      float v = 0.0f;
      if (m < a.n_taps) {
        const int j = a.j0 + m < w ? a.j0 + m : a.j0 + m - w;
        v = gx[c >= j ? c - j : c - j + w] * eff[j];
      }
      krow[m] = v;
    }
    __syncthreads();
    float acc[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[e] = 0.0f;
    const int tb = g * kPer;
    for (int jb = 0; jb < tp; jb += 16) {
      float win[2 * kPer - 1];
#pragma unroll
      for (int c2 = 0; c2 < 2 * kPer - 1; ++c2) win[c2] = sbuf[saddr(tb + jb + c2, yl)];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + jb + 4 * q4);
        const float kk[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int e = 0; e < kPer; ++e)
            acc[e] = fmaf(kk[jj], win[e + 4 * q4 + jj], acc[e]);
        }
      }
    }
    // acc[e]: frame row i0 + k of position pos0 + e, lane y
    const float wsk = a.ws[k], wmk = a.wm[k];
    if (a.noisy && wsk != 0.0f) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int pos = pos0 + e;
        if (y < a.h && pos < w) {
          const unsigned long long index =
              (static_cast<unsigned long long>(pos) * a.n_rows + k) * a.h + y;
          res[e] += wsk * rls::sample_poisson_at(acc[e], index, key) + wmk * acc[e];
        }
      }
    } else {
      const float wt = a.noisy ? wmk : wsk + wmk;
#pragma unroll
      for (int e = 0; e < kPer; ++e) res[e] += wt * acc[e];
    }
  }
  if (y < a.h) {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (pos0 + e < w) a.out[static_cast<long long>(y) * w + pos0 + e] = res[e];
  }
}

}  // namespace

// Launches K3 over all w scan positions, sweeping the n_taps offsets from
// j0 (mod w); returns a cudaError_t code. smem[0] gets the bytes of shared
// memory a block needs and smem[1] the most this device allows: when the
// need exceeds it, nothing is launched (and 0 is returned).
extern "C" int rls_line_sted_fused(const float* s, const float* eff, const float* gx,
                                   const float* ws, const float* wm, float* out,
                                   int h, int w, int i0, int n_rows, int j0, int n_taps,
                                   int noisy, unsigned seed0, unsigned seed1,
                                   const long long* key_dev, void* stream, int* smem) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t need = line_smem_bytes(w, n_taps);
  smem[0] = static_cast<int>(need < 0x7fffffff ? need : 0x7fffffff);
  smem[1] = optin;
  if (need > static_cast<size_t>(optin)) return 0;
  err = cudaFuncSetAttribute(line_sted_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(need));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h > 0 && w > 0) {
    const K3Args a{s, eff, gx, ws, wm, out, h, w, i0, n_rows, j0, n_taps, noisy,
                   make_uint2(seed0, seed1), key_dev};
    const dim3 grid((w + kPositions - 1) / kPositions, (h + kLanes - 1) / kLanes);
    line_sted_fused_kernel<<<grid, kThreads, need, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
