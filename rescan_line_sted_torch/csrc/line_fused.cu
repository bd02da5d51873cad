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
// centres, so K_r is nonzero on a short run of offsets. The host finds,
// once per set of profiles (the line engine caches it per params, width
// and window: no host round trip per image), the shortest circular run of
// offsets j0 .. j0 + n_taps - 1 (centred index j = d + W/2) that holds
// every nonzero tap of every computed row, and the kernel sweeps only it:
// 9 rows x 63 taps at the line settings (depletion 8) instead of 9 x W.
// Skipping a zero tap is exact for finite samples, since
// fma(0, x, acc) = acc.
// A CTA owns P scan positions (16 per thread x its position groups) x
// kLanes camera lanes. It first forms K_r for every computed row over the
// run, [n_rows, n_taps rounded to 16], from only the gx and eff values the
// run reads, and stages the kLanes sample rows it reads, as columns
// (p0 - W/2 + j0 + t) mod W for t < P + n_taps; then ONE barrier, and the
// row loop runs with no barrier and no modular index: each thread sweeps
// the run for its 16 consecutive positions of one lane, per 16 taps 31
// staged sample values (a sliding window: position e at tap m reads column
// e + m) and 16 K_r values (broadcast float4s), for 256 FFMA. After a
// row's sweep a row inside the sampled window is drawn with K2a's Knuth +
// PTRS sampler (sample_poisson_at, its Knuth branch inline; Philox keyed
// by the global index (pos * n_rows + k) * H + y of the element) and
// weighted; a row outside it adds
// its weighted mean. Each thread writes its out[y, pos] once: no atomics,
// and the sums run in a fixed order. The C entry asks the occupancy API,
// for 16, 8 and 4 position groups per CTA, how many CTAs an SM runs, and
// takes the one whose last wave is fullest (the larger CTA on a tie).
//
// Bound on the card: fp32 FFMA over the taps (2.21 G FMA at 2048^2: 0.066
// ms at 67 TFLOP/s; no tensor cores, K3 is small) and the sampler's Philox
// rounds (a quarter block per Knuth round, its loop ending once the count
// is settled). A row's correlation re-reads the staged sample from shared
// memory, not from device memory.
//
// Frame rows outside the slit's span are skipped, where the TPU kernel
// multiplied them by 0: a skipped row that overflowed to infinity gave NaN
// there. Likewise a non-finite sample value reaches only the outputs whose
// tap run covers it, where on the TPU it reached every output of its lane.
#include <cuda_runtime.h>

#include "poisson.cuh"

namespace {

constexpr int kLanes = 8;                     // camera lanes (y) per CTA
constexpr int kPer = 16;                      // consecutive positions per thread
constexpr int kMaxGroups = 16;                // position groups per CTA, at most
constexpr int kGroupChoices[3] = {16, 8, 4};

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
__host__ __device__ __forceinline__ int span(int positions, int n_taps) {
  return positions + round16(n_taps);
}

// Staged column t of lane y. Eight lanes per column, plus one 8-float step
// per 16 columns: the four position groups of a warp read columns 16 apart,
// which this skew puts on four different bank octets (conflict-free).
__device__ __forceinline__ int saddr(int t, int y) {
  return t * kLanes + y + kLanes * (t >> 4);
}

// Bytes of dynamic shared memory: K_r of every row, and the staged sample.
size_t line_smem_bytes(int positions, int n_rows, int n_taps) {
  const size_t t = static_cast<size_t>(span(positions, n_taps));
  return (static_cast<size_t>(n_rows) * round16(n_taps) + kLanes * t +
          kLanes * ((t + 15) / 16)) * sizeof(float);
}

// One draw of K2a's Knuth + PTRS sampler, as sample_poisson_at draws it:
// the Knuth branch (every rate below the cut) inline, on the element's
// multi-draw stream, so that no call saves the row loop's registers;
// brighter rates, zeros and NaN call the sampler.
__device__ __forceinline__ float draw(float lam, unsigned long long index, uint2 key) {
  if (!(lam > 0.0f) || !(lam < rls::kCut)) return rls::sample_poisson_at(lam, index, key);
  rls::Uniforms u(key, index);
  const float threshold = expf(-lam);
  float prod = 1.0f, small = 0.0f;
  for (int k = 0; k < rls::kKnuthRounds; ++k) {
    prod *= u.next();
    if (prod < threshold) break;
    small += 1.0f;
  }
  return small;
}

__global__ void __launch_bounds__(kLanes * kMaxGroups)
line_sted_fused_kernel(const K3Args a) {
  extern __shared__ __align__(16) float smem[];
  const uint2 key = rls::load_key(a.key, a.key_dev);
  const int w = a.w, tp = round16(a.n_taps);
  const int n_threads = blockDim.x, positions = (n_threads / kLanes) * kPer;
  const int t_len = span(positions, a.n_taps);
  float* kr = smem;                                    // [n_rows][tp], zero-padded
  float* sbuf = kr + a.n_rows * tp;                    // skewed [t_len][kLanes]
  const int tid = threadIdx.x;
  const int yl = tid % kLanes, g = tid / kLanes;
  const int y = blockIdx.y * kLanes + yl;
  const int p0 = blockIdx.x * positions;
  const int pos0 = p0 + g * kPer;                      // this thread's first position

  // K_r(j) = gx[(c_r - j) mod w] * eff[j] over the run, c_r = i0 + r + w/2
  for (int idx = tid; idx < a.n_rows * tp; idx += n_threads) {
    const int k = idx / tp, m = idx - k * tp;
    float v = 0.0f;
    if (m < a.n_taps) {
      const int j = a.j0 + m < w ? a.j0 + m : a.j0 + m - w;
      const int c = (a.i0 + k + w / 2) % w;
      v = a.gx[c >= j ? c - j : c - j + w] * a.eff[j];
    }
    kr[idx] = v;
  }
  for (int idx = tid; idx < kLanes * t_len; idx += n_threads) {
    const int l = idx / t_len, t = idx - l * t_len;
    const int yy = blockIdx.y * kLanes + l;
    const int col = (p0 - w / 2 + a.j0 + t + w) % w;
    sbuf[saddr(t, l)] = yy < a.h ? a.s[static_cast<long long>(yy) * w + col] : 0.0f;
  }
  __syncthreads();

  float res[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) res[e] = 0.0f;
  const int tb = g * kPer;
  for (int k = 0; k < a.n_rows; ++k) {
    const float* krow = kr + k * tp;
    float acc[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[e] = 0.0f;
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
          res[e] += wsk * draw(acc[e], index, key) + wmk * acc[e];
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
// j0 (mod w); returns a cudaError_t code. info[0] gets the bytes of shared
// memory a block needs and info[1] the most this device allows: when the
// need exceeds it, nothing is launched (and 0 is returned). info[2] gets
// the threads per CTA, info[3] the CTAs, info[4] the CTAs an SM runs,
// info[5] the positions per thread.
extern "C" int rls_line_sted_fused(const float* s, const float* eff, const float* gx,
                                   const float* ws, const float* wm, float* out,
                                   int h, int w, int i0, int n_rows, int j0, int n_taps,
                                   int noisy, unsigned seed0, unsigned seed1,
                                   const long long* key_dev, void* stream, int* info) {
  int device = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the fewest groups need the least shared memory: the limit check
  const size_t least = line_smem_bytes(4 * kPer, n_rows, n_taps);
  info[0] = static_cast<int>(least < 0x7fffffff ? least : 0x7fffffff);
  info[1] = optin;
  info[2] = info[3] = info[4] = 0;
  info[5] = kPer;
  if (least > static_cast<size_t>(optin)) return 0;
  const int lane_tiles = (h + kLanes - 1) / kLanes;
  double best = -1.0;
  int groups = 0, per_sm = 0;
  size_t need = least;
  for (int choice : kGroupChoices) {   // the fullest last wave, larger CTAs first
    const size_t bytes = line_smem_bytes(choice * kPer, n_rows, n_taps);
    if (bytes > static_cast<size_t>(optin)) continue;
    err = cudaFuncSetAttribute(line_sted_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, line_sted_fused_kernel,
                                                        kLanes * choice, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit < 1) continue;
    const long long ctas =
        static_cast<long long>((w + choice * kPer - 1) / (choice * kPer)) * lane_tiles;
    const long long slots = static_cast<long long>(fit) * sms;
    const long long waves = (ctas + slots - 1) / slots;
    const double full = static_cast<double>(ctas) / static_cast<double>(waves * slots);
    if (full > best + 1e-9) {
      best = full;
      groups = choice;
      per_sm = fit;
      need = bytes;
    }
  }
  if (groups == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(line_sted_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(need));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + groups * kPer - 1) / (groups * kPer), lane_tiles);
  info[0] = static_cast<int>(need);
  info[2] = kLanes * groups;
  info[3] = static_cast<int>(grid.x * grid.y);
  info[4] = per_sm;
  if (h > 0 && w > 0) {
    const K3Args a{s, eff, gx, ws, wm, out, h, w, i0, n_rows, j0, n_taps, noisy,
                   make_uint2(seed0, seed1), key_dev};
    line_sted_fused_kernel<<<grid, kLanes * groups, need,
                             static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
