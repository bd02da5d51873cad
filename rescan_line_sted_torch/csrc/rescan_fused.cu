// K4: the full-frame rescanned line-STED scan, one camera frame per scan
// position, with per-frame shot noise.
//
// Replaces rescan_fused / _fused_kernel of
// rescan_line_sted_tpu/kernels/rescan_fused.py. At scan position p the
// camera frame is
//     cam_p[y, x] = sum_a s[y, a] eff[(a - p + W/2) mod W] gx[(x - a + W/2) mod W],
// binned b x b, optionally Poisson-sampled, and added into the canvas at
// columns (offsets[p] + X) mod wc, X the binned camera column.
//
// Design. The TPU formed the whole frame [W, W] x [W, H] at every position,
// which its matrix unit makes cheap (17.6 T FMA per 2048^2 image). Here
// eff and gx underflow to exactly 0 in float32 a few dozen columns from
// their centres, so the wrapper finds the shortest circular run of nonzero
// taps of each (eff: e0 .. e0 + ne - 1, gx: g0 .. g0 + ng - 1, centred
// indices) and the kernel sums only those: with i the eff tap and r the
// frame column relative to the run's start xa_p = (p + e0 + g0) mod W,
//     cam_p[y, xa_p + r] = sum_i em_p[y, i] gx[g0 + r - i],
//     em_p[y, i] = s[y, p + e0 + i - W/2] eff[e0 + i],
// a full convolution of two runs (ne * ng FMA per row and position, about
// 30 G FMA at the 2048^2 cell). Skipping a zero tap is exact for finite
// samples (fma(0, x, acc) = acc, Poisson(0) = 0). A run of W taps (a
// model with full support) makes the same kernel do the dense work; frame
// columns past W fold back onto the frame before binning.
//
// Ownership. One CTA owns rb binned canvas rows (rb * b sample rows) for
// the whole scan and walks the positions in chunks of kP, in order:
//   1. stage each sample row's window of the chunk once (kP + ne columns:
//      the chunk's positions read it at shifts 0 .. kP - 1) and plan the
//      chunk's placement;
//   2. convolve: a warp takes 16 consecutive frame columns r of 16
//      positions x 2 sample rows, one (position, row) per lane, and sweeps
//      the eff taps in blocks of 16 against a 31-value window of the
//      zero-padded gx run (broadcast loads): 256 FFMA per 16 x 2 + 31
//      loads; em is formed as it is read (exact zeros past the eff run, so
//      a non-finite sample reaches only the frames of the positions whose
//      eff run covers it);
//   3. place: a thread owns one canvas column of a strip of them and sums
//      the chunk's binned (and drawn) frame values that land there in
//      position order before one read-modify-write. A frame window that
//      wraps the camera columns (its binned columns xab .. wb - 1, then
//      0 .. ) is two unwrapped pieces; the chunk then places the head
//      pieces as one strip and, after a barrier, the tail pieces as a
//      second, each in position order. A strip wider than the canvas
//      (scattered offsets) covers each canvas column once. No atomics,
//      and every canvas sum runs in a fixed order, so the result is
//      deterministic.
//
// Draws. Each binned element (p, Y, X) takes one uniform of the
// single-draw Philox stream, keyed by its canvas column c = (offsets[p] +
// X) mod wc, which is one-to-one with X for a fixed p (W/b <= wc): index
// ((Y * wc + c) * wq) * 4 + p, wq = ceil(W / 4). A strip thread's kP = 16
// positions of one column are then 4 whole Philox blocks, each serving
// four of its elements. The tier comes from the max over the warp's 32
// columns x 16 positions (K2a); a bright warp draws Knuth / PTRS on the
// element's multi-draw stream.
//
// Bound on the card: fp32 FFMA over the runs (no tensor cores: TF32 would
// break the 1e-5 parity bar), the sampler's Philox rounds (a quarter block
// per drawn element), and the canvas rows' read-modify-write (L2-resident:
// each CTA's rows are its own). The kernel never forms the [W, W]
// circulant. The C entry picks the rows per CTA from the occupancy API so
// that the last wave of CTAs is not mostly empty.
#include <cuda_runtime.h>

#include "poisson.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kP = 16;                    // scan positions per chunk
constexpr int kRowsPerWarp = 32 / kP;     // sample rows of a warp's conv task
constexpr int kGOff = 32;                 // zero taps before the gx run
constexpr int kRbs[] = {8, 4, 2, 1};      // binned rows per CTA, tried in order

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }
// the least stride >= n that is 1 mod 32: successive rows start on successive banks
__host__ __device__ __forceinline__ int bank_stride(int n) { return round_up(n - 1, 32) + 1; }

// Shared-memory layout (offsets in floats) for rb binned rows per CTA.
struct Layout {
  int rs;     // sample rows per CTA
  int ne_pad; // eff taps rounded up to 16
  int wl;     // columns of a row's staged window, ne_pad + kP
  int ws;     // its row stride, 16 mod 32: a warp's two rows on disjoint banks
  int l;      // frame columns of the runs' convolution, ne + ng - 1
  int lx;     // of them distinct camera columns, min(l, w)
  int lpad;   // l rounded up to 16
  int ls;     // row stride of the convolved frames
  int lb;     // binned columns per frame window
  int gpad, win, fr, total;
};

__host__ __device__ __forceinline__ Layout layout(int w, int b, int ne, int ng, int rb) {
  Layout q;
  q.rs = rb * b;
  q.ne_pad = round_up(ne, 16);
  q.wl = q.ne_pad + kP;
  q.ws = round_up(q.wl - 16, 32) + 16;
  q.l = ne + ng - 1;
  q.lx = imin(q.l, w);
  q.lpad = round_up(q.l, 16);
  q.ls = bank_stride(q.lpad);
  q.lb = imin(w / b, (q.l + 2 * b - 2) / b);  // ceil((b - 1 + l) / b)
  q.gpad = q.ne_pad;                          // effr first, zero past ne
  q.win = q.gpad + round_up(ng + 2 * kGOff, 4);
  q.fr = q.win + q.rs * q.ws;
  q.total = q.fr + kP * q.rs * q.ls;
  return q;
}

// The binned value of frame window column xl, row yb of chunk position pl:
// the sum of its b x b camera pixels, frame columns past w folded back
// (the run starts d camera columns into its first binned column; d = 0 at
// b = 1). B > 0 is the binning known at compile time, B = 0 reads b.
template <int B>
__device__ __forceinline__ float binned(const float* fr, const Layout& q, int pl, int yb,
                                        int xl, int d, int b, int w, bool fold) {
  if (B == 1) {
    const float* frow = fr + (pl + kP * yb) * q.ls;
    return fold && xl + w < q.l ? frow[xl] + frow[xl + w] : frow[xl];
  }
  float v = 0.0f;
  for (int j = 0; j < b; ++j) {
    const float* frow = fr + (pl + kP * (yb * b + j)) * q.ls;
    for (int k = 0; k < b; ++k) {
      int rr = xl * b + k - d;
      if (rr < 0) rr += w;
      if (rr < q.lx) {
        v += frow[rr];
        if (fold && rr + w < q.l) v += frow[rr + w];
      }
    }
  }
  return v;
}

// One strip of a chunk's placement (shared memory): strip column j is
// canvas column (base + j) mod wc, j < S; position pl's piece covers
// window columns xo[pl] .. xo[pl] + cnt[pl] - 1 from strip column
// start[pl] on (mod wc; cnt 0 for a position past w or without a piece).
struct Strip {
  int base, S;
  int start[kP], xo[kP], cnt[kP];
};

struct K4Args {
  const float* s;       // [h, w] y-convolved sample
  const float* eff;     // [w] brightness-scaled effective line, centred
  const float* gx;      // [w] detection x-profile, centred
  const int* offsets;   // [w] canvas offsets in [0, wc)
  float* out;           // [h / b, wc] canvas, zeroed
  int h, w, b, wc, e0, ne, g0, ng, rb, noisy;
  uint2 key;                 // the key words, unless key_dev holds them
  const long long* key_dev;  // null, or the two key words drawn on the card
};

// Place one strip: each thread sums its canvas column's values over the
// chunk's positions in order, draws them (noisy) and adds the sum once. A
// warp takes 32 strip columns of one row, so its loops are uniform.
template <int B>
__device__ __forceinline__ void place(const K4Args& a, const Layout& q, const Strip& st,
                                      const float* fr, const int* d, int p0, int row0,
                                      int hb, int wq, bool fold, uint2 key) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = B > 0 ? B : a.b, wc = a.wc;
  const int nj = (st.S + 31) / 32;
  for (int t = warp; t < a.rb * nj; t += kWarps) {
    const int yb = t / nj, j = (t - yb * nj) * 32 + lane, row = row0 + yb;
    const bool ok = j < st.S && row < hb;
    int c = st.base + j;
    c -= c >= wc ? wc : 0;
    float* dst = a.out + static_cast<long long>(row) * wc + c;
    const float old = ok ? *dst : 0.0f;  // issued before the sums need it
    float v[kP];
#pragma unroll
    for (int pl = 0; pl < kP; ++pl) {
      int x = j - st.start[pl];
      x += x < 0 ? wc : 0;
      v[pl] = ok && x < st.cnt[pl]
                  ? binned<B>(fr, q, pl, yb, st.xo[pl] + x, B == 1 ? 0 : d[pl], b, a.w, fold)
                  : 0.0f;
    }
    if (a.noisy) {
      // positions p0 + 4k .. p0 + 4k + 3 of (row, c) are single-draw block
      // g + k: four blocks, drawn when the warp's tier first needs them
      const unsigned long long g =
          (static_cast<unsigned long long>(row) * wc + c) * wq + (p0 >> 2);
      uint4 b0 = make_uint4(0u, 0u, 0u, 0u), b1 = b0, b2 = b0, b3 = b0;
      bool drawn = false;
      rls::tiered(
          v,
          [&](int pl) {
            if (!drawn) {
              b0 = rls::single_draw_block(g, key);
              b1 = rls::single_draw_block(g + 1, key);
              b2 = rls::single_draw_block(g + 2, key);
              b3 = rls::single_draw_block(g + 3, key);
              drawn = true;
            }
            const int k = pl >> 2;
            const uint4 bits = k == 0 ? b0 : k == 1 ? b1 : k == 2 ? b2 : b3;
            return rls::bits_to_uniform(rls::word_of(bits, pl & 3));
          },
          [&](int pl) { return 4 * g + pl; }, key);
    }
    float acc = 0.0f;
#pragma unroll
    for (int pl = 0; pl < kP; ++pl) acc += v[pl];
    if (ok) *dst = old + acc;
  }
}

// Position pl's lane (warp 0) plans its pieces: the head xl < cnt_a at
// canvas column cs_a, the tail (a wrapped window) at cs_b. Each strip
// spans its pieces' canvas columns (relative to position 0's, signed), or
// the whole canvas when they spread wider.
__device__ __forceinline__ void plan_strip(Strip& st, int lane, int cs, int xo, int cnt,
                                           int wc) {
  const int ref = __shfl_sync(0xffffffffu, cs, 0);
  int r = cs - ref;
  r += r < 0 ? wc : 0;
  r -= 2 * r > wc ? wc : 0;
  const int lo = __reduce_min_sync(0xffffffffu, cnt > 0 ? r : 0x7fffffff);
  const int hi = __reduce_max_sync(0xffffffffu, cnt > 0 ? r + cnt : -0x7fffffff);
  int base = 0, S = 0;
  if (hi > lo) {
    S = hi - lo;
    if (S > wc) {
      S = wc;
    } else {
      base = (ref + lo) % wc;
      base += base < 0 ? wc : 0;
    }
  }
  if (lane < kP) {
    int start = cs - base;
    start += start < 0 ? wc : 0;
    st.start[lane] = start;
    st.xo[lane] = xo;
    st.cnt[lane] = cnt;
  }
  if (lane == 0) {
    st.base = base;
    st.S = S;
  }
}

template <int B>
__global__ void __launch_bounds__(kThreads)
rescan_fused_kernel(const K4Args a) {
  extern __shared__ __align__(16) float smem[];
  const Layout q = layout(a.w, a.b, a.ne, a.ng, a.rb);
  float* effr = smem;
  float* gpad = smem + q.gpad;
  float* win = smem + q.win;
  float* fr = smem + q.fr;
  const int w = a.w, b = B > 0 ? B : a.b, wb = w / b, hb = a.h / b;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * a.rb;  // first binned canvas row of the CTA
  const int srow0 = row0 * b;
  const int wq = (w + 3) / 4;
  const uint2 key = rls::load_key(a.key, a.key_dev);
  for (int i = tid; i < q.ne_pad; i += kThreads)
    effr[i] = i < a.ne ? a.eff[(a.e0 + i) % w] : 0.0f;
  for (int i = tid; i < a.ng + 2 * kGOff; i += kThreads) {
    const int t = i - kGOff;
    gpad[i] = (t >= 0 && t < a.ng) ? a.gx[(a.g0 + t) % w] : 0.0f;
  }
  const int n_rb = q.lpad / 16;
  const int n_tasks = n_rb * ((q.rs + kRowsPerWarp - 1) / kRowsPerWarp);
  const bool fold = q.l > w;  // the runs' frame is wider than the camera

  // the chunk's two strips (heads, wrapped tails) and each position's
  // offset of the run start in its first binned column
  __shared__ Strip strips[2];
  __shared__ int d[kP];
  __shared__ bool split;
  for (int p0 = 0; p0 < w; p0 += kP) {
    __syncthreads();  // profiles staged / the previous chunk's buffers read
    if (warp == 0) {
      const int pl = lane & (kP - 1), p = p0 + pl;
      const bool live = lane < kP && p < w;
      const int xa = (p + a.e0 + a.g0) % w, xab = xa / b;
      const int off = live ? a.offsets[p] : 0;
      const int n_head = live ? imin(q.lb, wb - xab) : 0;
      const int n_tail = live ? q.lb - n_head : 0;
      int cs = off + xab;
      cs -= cs >= a.wc ? a.wc : 0;
      plan_strip(strips[0], lane, cs, 0, n_head, a.wc);
      plan_strip(strips[1], lane, off, n_head, n_tail, a.wc);
      const bool any_tail = __any_sync(0xffffffffu, n_tail > 0);
      if (lane < kP) d[lane] = xa - xab * b;
      if (lane == 0) split = any_tail;
    }
    // 1. stage win[y][t] = s[y, p0 + e0 - W/2 + t] for the CTA's rows
    for (int y = warp; y < q.rs; y += kWarps) {
      const int srow = srow0 + y;
      const bool ok = srow < a.h;
      const float* srow_p = a.s + static_cast<long long>(ok ? srow : 0) * w;
      for (int t = lane; t < q.wl; t += 32) {
        int col = (p0 + a.e0 + t + w - w / 2) % w;
        win[y * q.ws + t] = ok ? srow_p[col] : 0.0f;
      }
    }
    __syncthreads();
    // 2. the runs' convolution, frame columns r0 .. r0 + 15 per task;
    //    em_p[y][i] = win[y][pl + i] * effr[i], zero past the eff run
    for (int task = warp; task < n_tasks; task += kWarps) {
      const int r0 = (task % n_rb) * 16;
      const int pl = lane % kP;
      const int yl = (task / n_rb) * kRowsPerWarp + lane / kP;
      const float* wrow = win + imin(yl, q.rs - 1) * q.ws + pl;
      const int ilo = imax(0, r0 - a.ng + 1) & ~15;
      const int ihi = imin(a.ne - 1, r0 + 15);
      float acc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
      for (int i0 = ilo; i0 <= ihi; i0 += 16) {
        float e[16], g[31];
#pragma unroll
        for (int c = 0; c < 16; ++c) e[c] = wrow[i0 + c] * effr[i0 + c];
        if (i0 + 16 > a.ne) {  // the last block: exact zeros past the run
#pragma unroll
          for (int c = 0; c < 16; ++c) e[c] = i0 + c < a.ne ? e[c] : 0.0f;
        }
        const float* gp = gpad + kGOff + r0 - i0 - 15;
#pragma unroll
        for (int c = 0; c < 31; ++c) g[c] = gp[c];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
#pragma unroll
          for (int k = 0; k < 16; ++k) acc[k] = fmaf(e[c], g[k - c + 15], acc[k]);
        }
      }
      if (yl < q.rs) {
        float* fo = fr + (pl + kP * yl) * q.ls + r0;
#pragma unroll
        for (int k = 0; k < 16; ++k) fo[k] = acc[k];
      }
    }
    __syncthreads();
    // 3. the chunk's placement: the heads' strip, then the wrapped tails'
    place<B>(a, q, strips[0], fr, d, p0, row0, hb, wq, fold, key);
    if (split) {
      __syncthreads();  // a canvas column of both strips: heads first
      place<B>(a, q, strips[1], fr, d, p0, row0, hb, wq, fold, key);
    }
  }
}

}  // namespace

// Launches K4 over all w scan positions, summing the eff taps e0 .. e0 +
// ne - 1 and the gx taps g0 .. g0 + ng - 1 (mod w; ne, ng >= 1) into the
// zeroed canvas out [h / b, wc] (wc >= w / b, offsets in [0, wc)). key_dev:
// null to use (seed0, seed1), else a device pointer to the two key words
// as int64. Returns a cudaError_t code. info[0] gets the bytes of shared
// memory a block needs, info[1] the most this device allows it, info[2] the
// binned rows per CTA (rb), info[3] the CTAs, info[4] the CTAs an SM runs
// at once. rb is the one of kRbs whose layout fits and whose waves of
// CTAs times rb (the rows an SM slot walks) is least, the larger rb on a
// tie (its convolution keeps more lanes busy). When even one row per CTA
// does not fit, nothing is launched (info[2] = 0, and 0 is returned).
extern "C" int rls_rescan_fused(const float* s, const float* eff, const float* gx,
                                const int* offsets, float* out, int h, int w, int b,
                                int wc, int e0, int ne, int g0, int ng, int noisy,
                                unsigned seed0, unsigned seed1, const long long* key_dev,
                                void* stream, int* info) {
  int device = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // b = 1 (the common case) has its own instance; others read b at run time
  auto kernel = b == 1 ? rescan_fused_kernel<1> : rescan_fused_kernel<0>;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  const int limit = optin - static_cast<int>(attr.sharedSizeBytes);  // dynamic bytes
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hb = h / b;
  int rb = 0, ctas = 0, per_sm = 0;
  size_t need = static_cast<size_t>(layout(w, b, ne, ng, 1).total) * sizeof(float);
  long long best = 0;
  for (int cand : kRbs) {
    if (cand > 1 && cand > hb) continue;
    const size_t bytes = static_cast<size_t>(layout(w, b, ne, ng, cand).total) * sizeof(float);
    if (bytes > static_cast<size_t>(limit)) continue;
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit < 1) continue;
    const int n = (hb + cand - 1) / cand;
    const long long slots = static_cast<long long>(fit) * sms;
    const long long cost = (n + slots - 1) / slots * cand;
    if (rb == 0 || cost < best) {
      rb = cand, ctas = n, per_sm = fit, need = bytes, best = cost;
    }
  }
  info[0] = static_cast<int>(need < 0x7fffffff ? need : 0x7fffffff);
  info[1] = limit;
  info[2] = rb;
  info[3] = ctas;
  info[4] = per_sm;
  if (rb == 0) return 0;
  if (hb > 0 && w > 0) {
    const K4Args a{s, eff, gx, offsets, out, h, w, b, wc, e0, ne, g0, ng, rb, noisy,
                   make_uint2(seed0, seed1), key_dev};
    kernel<<<ctas, kThreads, need, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
