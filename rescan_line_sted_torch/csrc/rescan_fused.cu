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
//   1. stage em_p for the chunk's positions in shared memory (exact zeros
//      past the eff run, so a non-finite sample reaches only the frames of
//      the positions whose eff run covers it);
//   2. convolve: a warp takes 16 consecutive frame columns r of 16
//      positions x 2 sample rows, one (position, row) per lane, and sweeps
//      the eff taps in blocks of 16 against a 31-value window of the
//      zero-padded gx run (broadcast loads): 256 FFMA per 16 + 31 loads;
//   3. bin b x b, fold, draw each binned element with K2a's tiered sampler
//      (tier from the warp's max, one uniform per element on the
//      single-draw Philox stream keyed by (p * H/b + Y) * W/b + X), and
//      add it into the CTA's canvas rows in device memory. When the
//      chunk's frame windows lie in one short unwrapped run of canvas
//      columns (monotone offsets, as the engine's), a thread owns each
//      column of that strip and sums its frames in position order before
//      one read-modify-write; otherwise the positions are placed one
//      after another with a barrier between them. No atomics, and every
//      canvas sum runs in a fixed order, so the result is deterministic.
//
// Bound on the card: fp32 FFMA over the runs (no tensor cores: TF32 would
// break the 1e-5 parity bar), the sampler's Philox rounds, and the canvas
// rows' read-modify-write (L2-resident: each CTA's rows are its own).
// The kernel never forms the [W, W] circulant.
#include <cuda_runtime.h>

#include "poisson.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kP = 16;                    // scan positions per chunk
constexpr int kRowsPerWarp = 32 / kP;     // sample rows of a warp's conv task
constexpr int kGOff = 32;                 // zero taps before the gx run

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }
// the least stride >= n that is 1 mod 32: successive rows start on successive banks
__host__ __device__ __forceinline__ int bank_stride(int n) { return round_up(n - 1, 32) + 1; }

// Shared-memory layout (offsets in floats) for rb binned rows per CTA.
struct Layout {
  int rs;     // sample rows per CTA
  int ne_pad; // eff taps rounded up to 16
  int ems;    // row stride of em
  int l;      // frame columns of the runs' convolution, ne + ng - 1
  int lx;     // of them distinct camera columns, min(l, w)
  int lpad;   // l rounded up to 16
  int ls;     // row stride of the convolved frames
  int lb;     // binned columns per frame window
  int gpad, em, fr, total;
};

__host__ __device__ __forceinline__ Layout layout(int w, int b, int ne, int ng, int rb) {
  Layout q;
  q.rs = rb * b;
  q.ne_pad = round_up(ne, 16);
  q.ems = bank_stride(q.ne_pad);
  q.l = ne + ng - 1;
  q.lx = imin(q.l, w);
  q.lpad = round_up(q.l, 16);
  q.ls = bank_stride(q.lpad);
  q.lb = imin(w / b, (q.l + 2 * b - 2) / b);  // ceil((b - 1 + l) / b)
  q.gpad = round_up(ne, 4);                   // effr first
  q.em = q.gpad + round_up(ng + 2 * kGOff, 4);
  q.fr = q.em + kP * q.rs * q.ems;
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

struct K4Args {
  const float* s;       // [h, w] y-convolved sample
  const float* eff;     // [w] brightness-scaled effective line, centred
  const float* gx;      // [w] detection x-profile, centred
  const int* offsets;   // [w] canvas offsets in [0, wc)
  float* out;           // [h / b, wc] canvas, zeroed
  int h, w, b, wc, e0, ne, g0, ng, rb, noisy;
  uint2 key;
};

template <int B>
__global__ void __launch_bounds__(kThreads)
rescan_fused_kernel(const K4Args a) {
  extern __shared__ __align__(16) float smem[];
  const Layout q = layout(a.w, a.b, a.ne, a.ng, a.rb);
  float* effr = smem;
  float* gpad = smem + q.gpad;
  float* em = smem + q.em;
  float* fr = smem + q.fr;
  const int w = a.w, b = B > 0 ? B : a.b, wb = w / b, hb = a.h / b;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * a.rb;  // first binned canvas row of the CTA
  const int srow0 = row0 * b;
  for (int i = tid; i < a.ne; i += kThreads) effr[i] = a.eff[(a.e0 + i) % w];
  for (int i = tid; i < a.ng + 2 * kGOff; i += kThreads) {
    const int t = i - kGOff;
    gpad[i] = (t >= 0 && t < a.ng) ? a.gx[(a.g0 + t) % w] : 0.0f;
  }
  const int n_rb = q.lpad / 16;
  const int n_tasks = n_rb * ((q.rs + kRowsPerWarp - 1) / kRowsPerWarp);
  const int frame_el = a.rb * q.lb;
  const bool fold = q.l > w;  // the runs' frame is wider than the camera

  // per position of a chunk: the frame window's first binned column, the
  // run start's offset in it, and its canvas start relative to position 0's
  __shared__ int xab[kP], d[kP], rel[kP];
  for (int p0 = 0; p0 < w; p0 += kP) {
    __syncthreads();  // profiles staged / the previous chunk's buffers read
    const int c00 = a.offsets[p0] + (p0 + a.e0 + a.g0) % w / b;
    if (tid < kP && p0 + tid < w) {
      const int p = p0 + tid, xa = (p + a.e0 + a.g0) % w;
      xab[tid] = xa / b;
      d[tid] = xa - xa / b * b;
      int r = (a.offsets[p] + xa / b - c00) % a.wc;  // signed, in (-wc/2, wc/2]
      if (r < 0) r += a.wc;
      rel[tid] = 2 * r > a.wc ? r - a.wc : r;
    }
    // 1. em[pl + kP * y][i] for the chunk's positions and the CTA's rows,
    //    one (position, row) per warp at a time
    for (int py = warp; py < kP * q.rs; py += kWarps) {
      const int pl = py % kP, y = py / kP;
      const int p = p0 + pl, srow = srow0 + y;
      const bool ok = p < w && srow < a.h;
      const float* srow_p = a.s + static_cast<long long>(ok ? srow : 0) * w;
      for (int i = lane; i < q.ne_pad; i += 32) {
        float v = 0.0f;
        if (ok && i < a.ne) {
          int col = p + a.e0 + i + w - w / 2;  // < 3 w
          col -= col >= w ? w : 0;
          col -= col >= w ? w : 0;
          v = srow_p[col] * effr[i];
        }
        em[py * q.ems + i] = v;
      }
    }
    __syncthreads();
    // 2. the runs' convolution, frame columns r0 .. r0 + 15 per task
    for (int task = warp; task < n_tasks; task += kWarps) {
      const int r0 = (task % n_rb) * 16;
      const int pl = lane % kP;
      const int yl = (task / n_rb) * kRowsPerWarp + lane / kP;
      const float* erow = em + (pl + kP * imin(yl, q.rs - 1)) * q.ems;
      const int ilo = imax(0, r0 - a.ng + 1) & ~15;
      const int ihi = imin(a.ne - 1, r0 + 15);
      float acc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
      for (int i0 = ilo; i0 <= ihi; i0 += 16) {
        float e[16], g[31];
#pragma unroll
        for (int c = 0; c < 16; ++c) e[c] = erow[i0 + c];
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
    // 3. the chunk's placement: a strip of canvas columns when every frame
    //    window lies in one short unwrapped run of them, else per position
    int rmin = 0x7fffffff, rmax = -0x7fffffff;
    bool strip = true;
    for (int pl = 0; pl < kP && p0 + pl < w; ++pl) {
      rmin = imin(rmin, rel[pl]);
      rmax = imax(rmax, rel[pl]);
      strip = strip && xab[pl] + q.lb <= wb;
    }
    const int span = rmax - rmin + q.lb;
    if (strip && span <= imin(a.wc, 2 * q.lb)) {
      // one thread per canvas element of the strip sums its frames'
      // binned (and drawn) values in position order, then adds once; a
      // warp takes 32 strip columns of one row (its loops are uniform)
      int start[kP];  // each position's first strip column
#pragma unroll
      for (int pl = 0; pl < kP; ++pl) start[pl] = rel[pl] - rmin;
      const int nj = (span + 31) / 32;
      for (int t = warp; t < a.rb * nj; t += kWarps) {
        const int yb = t / nj, j = (t - yb * nj) * 32 + lane, row = row0 + yb;
        const bool ok = j < span && row < hb;
        float acc = 0.0f;
        if (!a.noisy) {
#pragma unroll
          for (int pl = 0; pl < kP; ++pl) {
            const int xl = j - start[pl];
            if (ok && p0 + pl < w && static_cast<unsigned>(xl) < static_cast<unsigned>(q.lb))
              acc += binned<B>(fr, q, pl, yb, xl, B == 1 ? 0 : d[pl], b, w, fold);
          }
        } else {
          // the column's kP frame values drawn together (one tier per
          // warp), each keyed by its own (p, Y, X)
          float v[kP];
#pragma unroll
          for (int pl = 0; pl < kP; ++pl) {
            const int xl = j - start[pl];
            v[pl] = ok && p0 + pl < w &&
                            static_cast<unsigned>(xl) < static_cast<unsigned>(q.lb)
                        ? binned<B>(fr, q, pl, yb, xl, B == 1 ? 0 : d[pl], b, w, fold)
                        : 0.0f;
          }
          rls::poisson_tiered_at(
              v,
              [&](int pl) {
                return (static_cast<unsigned long long>(p0 + pl) * hb + row) * wb +
                       xab[pl] + j - start[pl];
              },
              a.key);
#pragma unroll
          for (int pl = 0; pl < kP; ++pl) acc += v[pl];
        }
        if (ok) {
          int c = (c00 + rmin + j) % a.wc;
          if (c < 0) c += a.wc;
          a.out[static_cast<long long>(row) * a.wc + c] += acc;
        }
      }
      continue;
    }
    // else bin, draw and place one position after another (a barrier
    // between them); a warp's loop is uniform
    for (int pl = 0; pl < kP && p0 + pl < w; ++pl) {
      const int p = p0 + pl, off = a.offsets[p];
      for (int base = warp * 32; base < frame_el; base += kThreads) {
        const int e = base + lane;
        const int yb = e / q.lb, xl = e - yb * q.lb, row = row0 + yb;
        const bool ok = e < frame_el && row < hb;
        float v[1] = {0.0f};
        unsigned long long index = 0;
        int x = xab[pl] + xl;
        if (x >= wb) x -= wb;
        if (ok) {
          v[0] = binned<B>(fr, q, pl, yb, xl, B == 1 ? 0 : d[pl], b, w, fold);
          index = (static_cast<unsigned long long>(p) * hb + row) * wb + x;
        }
        if (a.noisy) {
          const float u[1] = {rls::single_draw(index, a.key)};
          rls::poisson_tiered(v, u, index, a.key);
        }
        if (ok) {
          int c = off + x;
          if (c >= a.wc) c -= a.wc;
          a.out[static_cast<long long>(row) * a.wc + c] += v[0];
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Launches K4 over all w scan positions, summing the eff taps e0 .. e0 +
// ne - 1 and the gx taps g0 .. g0 + ng - 1 (mod w; ne, ng >= 1) into the
// zeroed canvas out [h / b, wc] (wc >= w / b, offsets in [0, wc)). Returns
// a cudaError_t code. info[0] gets the bytes of shared memory a block
// needs, info[1] the most this device allows and info[2] the binned rows
// per CTA; when even one row per CTA does not fit, nothing is launched
// (info[2] = 0, and 0 is returned).
extern "C" int rls_rescan_fused(const float* s, const float* eff, const float* gx,
                                const int* offsets, float* out, int h, int w, int b,
                                int wc, int e0, int ne, int g0, int ng, int noisy,
                                unsigned seed0, unsigned seed1, void* stream, int* info) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hb = h / b;
  int rb = 0;
  size_t need = 0;
  for (int cand = 4; cand >= 1; cand /= 2) {
    if (cand > 1 && cand > hb) continue;
    need = static_cast<size_t>(layout(w, b, ne, ng, cand).total) * sizeof(float);
    if (need <= static_cast<size_t>(optin)) {
      rb = cand;
      break;
    }
  }
  info[0] = static_cast<int>(need < 0x7fffffff ? need : 0x7fffffff);
  info[1] = optin;
  info[2] = rb;
  if (rb == 0) return 0;
  // b = 1 (the common case) has its own instance; others read b at run time
  auto kernel = b == 1 ? rescan_fused_kernel<1> : rescan_fused_kernel<0>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(need));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hb > 0 && w > 0) {
    const K4Args a{s, eff, gx, offsets, out, h, w, b, wc, e0, ne, g0, ng, rb, noisy,
                   make_uint2(seed0, seed1)};
    kernel<<<(hb + rb - 1) / rb, kThreads, need, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
