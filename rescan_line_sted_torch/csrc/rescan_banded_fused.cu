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
// Design. One CTA owns kLanes = 16 canvas lanes (H/b columns) for the whole
// scan and walks every chunk in order, so the canvas needs no atomics and
// its sums are deterministic; the canvas [q, wc, H/b] stays in device
// memory (50 MB at 2048^2, R = 1.5), each CTA touching only its lanes.
// The conv table swb[c, r, d] = G[r, d] * ill[c, d] is never formed or
// streamed: frame c is F_c^T = (win ⊙ ill[c]) G^T, a [16 lanes, D_in] x
// [D_in, dob] product on the tensor cores (mma.sync m16n8k8, TF32). The
// binned detection window G stays in shared memory for the whole scan,
// resident [D_in, dob] or, where that does not fit (D_in = D_out = 256 at
// chunk 32), as its Toeplitz generator (G[d, R] depends on b*R - d alone:
// b*(dob - 1) + D_in values); the illumination window ill [C, D_in] too.
// A single TF32 pass keeps 11 significant bits and would miss the 1e-5
// parity bar, so each operand x splits into x_hi = x & 0xffffe000 and
// x_lo = (x - x_hi) & 0xffffe000 (exact bit masks, no cvt) and the product
// takes three passes, hi*hi into one fp32 accumulator and hi*lo + lo*hi
// into a second, summed once at the end (the products of two TF32 values
// are exact; the dropped lo*lo is ~2^-21 of the product; the small terms
// accumulate apart from the large ones, so the tensor cores' rounding of
// the sums costs ~1e-6 at D_in = 256, where one accumulator for all three
// would cost several times that).
// The band. Position c lights only the window columns within s_exc of its
// centre s_in + c, and G[d, u] is nonzero only within s_det of its diagonal
// (|u - s_out - d + s_in| <= s_det): the supports (K1Args s_exc, s_det, in
// window columns; -1 for the whole window) that imaging/rescan.py sizes the
// windows by before rounding them up to 128. So a warp's 32 rows multiply
// only over the 8-aligned run of columns that both reach (band_run): 560
// of 2048 group-k-steps a chunk at the flagship (17.5 of 64 a position).
// What it leaves out is below both profiles' supports: in float64 at most
// 8.3e-16 of the conv table's peak at the flagship (9.0e-13 at sigma_exc =
// 8), eight orders under float32's resolution.
// A warp takes 32 frame rows (four n8 tiles) of one frame: per k-step of 8
// it forms its A fragment (four window values times two ill values, split)
// once for the four tiles, and each tile's B fragment (two G values,
// split): 12 mma per 66 issued instructions. 16 warps (512 threads) run
// on each SM, one CTA per SM (the occupancy API in the C entry confirms
// it). (Measured on the card against this layout: a third accumulator, the
// next k-step's operands read ahead, or 8 warps of 255 registers were each
// slower: spills, or fewer warps in flight.)
// Staging is asynchronous: while a chunk computes, cp.async brings the next
// chunk's sample window (b*16 raw columns a row; the b-lane binning is
// summed in shared memory) and its placement scalars (sa_lo, sa_hi, cls,
// m0 and, in NUFFT mode, its taps) into a second buffer, so placement reads
// only shared memory. The frames of a pass (512 frame rows, whole 32-row
// groups: dob is padded to a multiple of 32 with rows nobody places) land
// in a two-slot ring in shared memory, rows 20 floats apart where the
// layout has room (the gathers' 16-byte reads of consecutive rows then
// fall on different banks: 16 floats apart they collide 16-fold, which
// cost the spreading placement a quarter of its time). In a noisy run the
// warp that computed a group then draws its 32 rows, one a lane (16 lanes,
// four per Philox block, the tier from the warp's max), with no barrier
// between, so one warp's draws overlap another's products. After one
// barrier each canvas row the pass hits is gathered from the ring and
// read-modify-written once, in position order. In the spreading mode each
// canvas row of either parity gathers its window taps straight from the
// pass's unspread frame rows (only the taps that land in the pass's rows).
// An item there is three consecutive canvas rows of one parity and one
// float4 of lanes, both parities' rows in one sweep (~45 blocks of three
// rows of each parity a pass at the irrational flagship, ~360 items, so 12
// of the 16 warps place, three to a scheduler): each frame row it needs is
// read once for the taps of all three rows (6 reads, not 12, for 4 taps
// of 3 rows), without a branch, and each
// frame's starts and row bounds are tabled once a pass in shared memory
// before the barrier (the synchronous layout computes them where it reads
// them). Measured (K1 alone, noisy, at the irrational flagship) against
// one thread a row, a parity at a time (~132 threads, a quarter of the
// warps): 4.59 ms; one thread a row and lane quad, 4.96; items of one, two,
// three or five rows read unbranched, 4.94 / 4.51 / 4.26 / 4.43 (five
// spill); three rows with a branch around each read, 4.51; the entries
// computed where they are read in every layout instead of tabled, 4.37
// against 4.25 (noise-free 3.27 against 3.13; at D_in = 256, generator
// layout, 8.85 against 8.83, parent 8.74); with the groups also rotated
// in this mode (pass_group keeps them in task order here), 3.89.
// (Measured on the card: placing a pass while the next one convolves,
// whether by the same warps or by a second half of them through named
// barriers, gained nothing: both phases are issue-bound, so their
// instructions add up whichever warps issue them. A wgmma engine, m64n16k8
// with A formed in registers per k-step and the window's TF32 halves in
// shared memory, ran the convolution slower, 3.3 ms against 2.6 at the
// flagship: at N = 16 lanes each k-step's small wgmma group waits on the
// A fragments formed between them.)
// Windows whose double-buffered staging does not fit beside the generator
// (D_in above ~600 at chunk 32) take a third layout with the same engine
// and the footprint of the FFMA engine before it: one binned window staged
// synchronously, placement scalars read from device memory. The host bound
// (kernels/rescan_banded_fused.py banded_fits) is that layout's bytes.
//
// Bound on the card: the three TF32 passes on the tensor cores over the
// band (27% of the whole windows' 68.7 G FMA per 2048^2 image at D_in =
// dob = 128: 3 x 18.8 G, 0.23 ms at 495 TFLOP/s, against 0.56 ms for the
// same product in fp32 FFMA), the spreading taps in FFMA (4.3 G), the
// Philox draws of the sampler and the canvas read-modify-write
// (L2-resident).
#include <cuda_runtime.h>
#include <stdint.h>

#include "poisson.cuh"

namespace {

constexpr int kLanes = 16;                  // canvas lanes per CTA: the mma's M
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPassRows = 512;              // frame rows per pass (one ring slot)
constexpr int kGroupRows = 32;              // frame rows per warp task
constexpr int kTiles = kGroupRows / 8;      // n8 tiles per warp task
constexpr int kSpreadRows = 3;              // canvas rows of a spreading item
constexpr int kTapGroup = 4;                // taps a spreading item loads for at once
constexpr uint32_t kTf32Mask = 0xffffe000u;

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
  int s_exc, s_det;          // the band's half-widths (band_run), -1: whole window
  uint2 key;                 // the key words, unless key_dev holds them
  const long long* key_dev;  // null, or the two key words drawn on the card
};

// Offsets (floats) of one layout's shared-memory arrays. variant 0: G
// resident, asynchronous staging; 1: G as its generator, asynchronous;
// 2: generator, synchronous (one binned window, scalars in device memory).
struct Layout {
  int variant, dobp, fs, gs, ws, rs;   // dob padded to 32; strides of ring, G, window, raw
  int raw0, raw1, bin, g, ill, scal0, scal1, taps0, taps1, tab, floats;
};

// G's row stride when resident: dob rounded up to 8 (mod 32), so that the
// four k-rows of a B fragment fall on four bank octets.
__host__ __device__ inline int resident_stride(int dob) {
  return dob + ((8 - dob % 32) + 32) % 32;
}

// Length of G's generator, rounded to 4 floats.
__host__ __device__ inline int gen_len(int d_in, int dob, int b) {
  return (b * (dob - 1) + d_in + 3) / 4 * 4;
}

// Ints of one slot of the spreading placement's frame table (spread_frame):
// two int4 per (frame, parity) for the most frames a pass can hold.
__host__ __device__ inline int spread_tab_ints(int dobp, int chunk) {
  const int frames = (kPassRows - 1) / dobp + 2;
  return 16 * (frames < chunk ? frames : chunk);
}

__host__ __device__ inline Layout make_layout(int variant, int d_in, int dob, int chunk, int b,
                                              int n_spread) {
  Layout L{};
  L.variant = variant;
  L.dobp = (dob + kGroupRows - 1) / kGroupRows * kGroupRows;
  L.gs = resident_stride(dob);
  const bool async = variant != 2;
  L.rs = 16 * b + 8;            // raw window row: 16 lanes x b columns, padded
  L.ws = async ? 24 : 16;       // binned window row (24: conflict-free A reads)
  // ring rows of 20 floats where the async layouts have room: the gathers'
  // 16-byte reads of consecutive rows then miss each other's banks
  L.fs = async ? 20 : kLanes;
  int at = 2 * kPassRows * L.fs;
  if (async) {
    L.raw0 = at;
    at += d_in * L.rs;
    L.raw1 = at;
    at += d_in * L.rs;
    if (b > 1) {
      L.bin = at;
      at += d_in * L.ws;
    } else {
      L.bin = -1;                 // the raw window is already binned
    }
  } else {
    L.raw0 = L.raw1 = -1;
    L.bin = at;
    at += d_in * L.ws;
  }
  L.g = at;
  at += variant == 0 ? d_in * L.gs : gen_len(d_in, dob, b);
  L.ill = at;
  at += chunk * d_in;
  const int scal = 5 * chunk + 4;   // lo[2C], hi[2C], cls[C], m0
  const int taps = chunk * 2 * n_spread;
  if (async) {
    L.scal0 = at;
    at += scal;
    L.scal1 = at;
    at += scal;
    L.taps0 = at;
    at += taps;
    L.taps1 = at;
    at += taps;
  } else {
    L.scal0 = L.scal1 = -1;
    L.taps0 = L.taps1 = at;
    at += taps;
  }
  // the spreading placement's frame table, one slot per ring slot (the
  // synchronous layout computes its entries where it reads them)
  L.tab = -1;
  if (n_spread && async) {
    L.tab = at;
    at += 2 * spread_tab_ints(L.dobp, chunk);
  }
  L.floats = at;
  return L;
}

size_t layout_bytes(const Layout& L) { return static_cast<size_t>(L.floats) * sizeof(float); }

__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n"); }

// x = hi + lo, both TF32 (low 13 bits zero): exact masks, no rounding.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32Mask;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The raw operands of one k-step of 8 of a warp's 32 frame rows: four
// window values (lanes grp, grp + 8; d = k0 + tig, k0 + tig + 4), their two
// ill values, and per tile t the two G values of its column grp. kTail: d
// may pass d_in (a clamped read, its ill taken as 0).
struct KOperands {
  float w[4], i[2], g[kTiles][2];
};

template <bool kGen, bool kTail>
__device__ __forceinline__ void k_load(KOperands& o, const float* win, int ws, const float* il,
                                       const float* const (&gcol)[kTiles], int gs, int k0,
                                       int d_in, int grp, int tig) {
  int d0 = k0 + tig, d1 = d0 + 4;
  bool ok0 = true, ok1 = true;
  if (kTail) {
    ok0 = d0 < d_in;
    ok1 = d1 < d_in;
    d0 = min(d0, d_in - 1);
    d1 = min(d1, d_in - 1);
  }
  o.i[0] = ok0 ? il[d0] : 0.0f;
  o.i[1] = ok1 ? il[d1] : 0.0f;
  o.w[0] = win[d0 * ws + grp];
  o.w[1] = win[d0 * ws + grp + 8];
  o.w[2] = win[d1 * ws + grp];
  o.w[3] = win[d1 * ws + grp + 8];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    o.g[t][0] = kGen ? gcol[t][-d0] : gcol[t][d0 * gs];
    o.g[t][1] = kGen ? gcol[t][-d1] : gcol[t][d1 * gs];
  }
}

// The k-step's three passes: A[lane, d] = win[d, lane] * ill[d], B[d, r] =
// G(d, r); hi*hi into acc[0], the two cross terms into acc[1], issued
// apart so that they do not wait on each other.
__device__ __forceinline__ void k_mma(float (&acc)[2][kTiles][4], const KOperands& o) {
  uint32_t ah[4], al[4];
  split_tf32(o.w[0] * o.i[0], ah[0], al[0]);
  split_tf32(o.w[1] * o.i[0], ah[1], al[1]);
  split_tf32(o.w[2] * o.i[1], ah[2], al[2]);
  split_tf32(o.w[3] * o.i[1], ah[3], al[3]);
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    uint32_t bh[2], bl[2];
    split_tf32(o.g[t][0], bh[0], bl[0]);
    split_tf32(o.g[t][1], bh[1], bl[1]);
    mma_tf32(acc[1][t], ah, bl);
    mma_tf32(acc[0][t], ah, bh);
    mma_tf32(acc[1][t], al, bh);
  }
}

// The band of frame c's binned rows r0 .. r1: the 8-aligned run [k_lo,
// k_hi) of window columns d that c lights (|d - s_in - c| <= s_exc) and
// that one of those rows detects (unbinned rows u = b r0 .. b r1 + b - 1,
// |u - s_out - d + s_in| <= s_det); a half-width of -1 takes the whole
// window. An empty band gives k_lo = k_hi = 0. The host's band_runs
// (kernels/rescan_banded_fused.py) is this formula.
__device__ __forceinline__ void band_run(const K1Args& p, int c, int r0, int r1, int& k_lo,
                                         int& k_hi) {
  const int s_in = (p.d_in - p.chunk) / 2;
  const int diag = s_in - (p.dob * p.b - p.chunk) / 2;  // s_in - s_out
  int lo = 0, hi = p.d_in - 1;
  if (p.s_exc >= 0) {
    lo = max(lo, s_in + c - p.s_exc);
    hi = min(hi, s_in + c + p.s_exc);
  }
  if (p.s_det >= 0) {
    lo = max(lo, p.b * r0 + diag - p.s_det);
    hi = min(hi, p.b * r1 + p.b - 1 + diag + p.s_det);
  }
  k_lo = lo > hi ? 0 : lo & ~7;
  k_hi = lo > hi ? 0 : min((hi | 7) + 1, p.d_in);
}

// The warp's 32 frame rows r0 .. r0 + 31 of one frame (illumination il)
// into the ring rows f (16 lanes each, fs floats apart), in three TF32
// passes over the band's k-steps [k_lo, k_hi) (k_lo a multiple of 8);
// the products outside it are left out.
template <bool kGen>
__device__ __forceinline__ void group_mma(float* f, int fs, const float* win, int ws,
                                          const float* il, const float* g_s, int gs, int d_in,
                                          int dob, int b, int r0, int k_lo, int k_hi, int grp,
                                          int tig) {
  float acc[2][kTiles][4];
  const float* gcol[kTiles];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int r = min(r0 + 8 * t + grp, dob - 1);  // padding rows read row dob - 1
    gcol[t] = kGen ? g_s + b * r + d_in - 1 : g_s + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[0][t][j] = acc[1][t][j] = 0.0f;
  }
  const int d_full = d_in & ~7;
  const int k_full = min(k_hi, d_full);
  KOperands cur;
#pragma unroll 2
  for (int k0 = k_lo; k0 < k_full; k0 += 8) {
    k_load<kGen, false>(cur, win, ws, il, gcol, gs, k0, d_in, grp, tig);
    k_mma(acc, cur);
  }
  if (d_full < k_hi) {
    k_load<kGen, true>(cur, win, ws, il, gcol, gs, d_full, d_in, grp, tig);
    k_mma(acc, cur);
  }
  // C fragment: rows (lanes) grp, grp + 8; columns (frame rows) 2 tig, 2 tig + 1
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    float* row = f + (8 * t + 2 * tig) * fs;
    row[grp] = acc[0][t][0] + acc[1][t][0];
    row[fs + grp] = acc[0][t][1] + acc[1][t][1];
    row[grp + 8] = acc[0][t][2] + acc[1][t][2];
    row[fs + grp + 8] = acc[0][t][3] + acc[1][t][3];
  }
}

// The 32-row group of the pass that warp task `task` takes. The band's
// length follows a group's depth in its frame (at the flagship 2.5, 6.5,
// 6 and 2.5 k-steps on average), and a pass's warps w share scheduler
// w % 4; with frames of four groups (dobp = 128) task order would give
// each scheduler one depth, so there each block of four is rotated by its
// index and each scheduler takes all four (a last partial block as is).
// Frames of other depths already mix depths on each scheduler. Class
// placement only: in the spreading mode the rotation measured slower
// (4.76 against 4.47 ms at the irrational flagship, noisy).
template <bool kSpread>
__device__ __forceinline__ int pass_group(int task, int n_groups, int dobp) {
  const bool rotate = !kSpread && dobp == 4 * kGroupRows && (task | 3) < n_groups;
  return rotate ? (task & ~3) | ((task + (task >> 2)) & 3) : task;
}

// K2a's draws on one frame row of the ring (16 lanes, in place): element
// (position p0 + c, frame row r, lane) takes single-draw index ((p0 + c) *
// dob + r) * hb + lane, four lanes per Philox block; the tier comes from
// the warp's 32 rows. Every lane of the warp calls it; rows that are not
// frame rows (rok false) draw zeros and are not written.
__device__ __forceinline__ void draw_row(float* fr, bool rok, int p0, int c, int r, int dob,
                                         int hb, int lane0, uint2 key) {
  if (!rok) c = r = 0;
  float lam[kLanes];
#pragma unroll
  for (int j4 = 0; j4 < kLanes / 4; ++j4) {
    const float4 v = *reinterpret_cast<const float4*>(fr + 4 * j4);
    lam[4 * j4 + 0] = v.x;
    lam[4 * j4 + 1] = v.y;
    lam[4 * j4 + 2] = v.z;
    lam[4 * j4 + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    if (!(rok && lane0 + j < hb)) lam[j] = 0.0f;
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
  rls::poisson_tiered(lam, u, e0, key);
  if (rok) {
#pragma unroll
    for (int j4 = 0; j4 < kLanes / 4; ++j4)
      *reinterpret_cast<float4*>(fr + 4 * j4) =
          make_float4(lam[4 * j4], lam[4 * j4 + 1], lam[4 * j4 + 2], lam[4 * j4 + 3]);
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

// One part (frame rows lo_r .. hm_r) of one frame into a spreading item's
// kSpreadRows consecutive canvas rows, whose first is spread-frame row rs
// of the part (its canvas row minus the part's start, mod wc): row m adds
// w[u] * f[rs + m - u], taps u ascending (f2: the frame's row 0 in the ring,
// at the item's lane quad; f_lo .. f_hm: the frame's rows in the pass).
// Each frame row is read once for all the taps and rows it feeds, without a
// branch: a row outside the part is read clamped and weighted 0, which adds
// an exact zero where the frame is finite (the sums start at +0, so never
// -0). A non-finite frame value (an Inf or NaN sample) therefore also
// reaches the item's neighbouring rows that a skipped read would leave
// finite: the sums equal a row-by-row gather's only for finite frames.
// hit[m] records that a tap landed on row m.
__device__ __forceinline__ void spread_part(float4 (&acc)[kSpreadRows],
                                            bool (&hit)[kSpreadRows], const float* f2, int fs,
                                            const float* wgt, int n_spread, int rs, int lo_r,
                                            int hm_r, int f_lo, int f_hm, int wc) {
  if (rs < 0) rs += wc;
  if (rs > wc - kSpreadRows) rs -= wc;  // the rows straddle the part's start
  if (rs + kSpreadRows - 1 < lo_r || rs - (n_spread - 1) > hm_r) return;
#pragma unroll
  for (int m = 0; m < kSpreadRows; ++m)
    hit[m] = hit[m] || max(0, rs + m - hm_r) <= min(n_spread - 1, rs + m - lo_r);
  constexpr int kLoads = kSpreadRows + kTapGroup - 1;
  for (int u0 = 0; u0 < n_spread; u0 += kTapGroup) {
    float w[kTapGroup];
#pragma unroll
    for (int uu = 0; uu < kTapGroup; ++uu) w[uu] = u0 + uu < n_spread ? wgt[u0 + uu] : 0.0f;
    // frame row r2 (j ascending) feeds row m with tap u0 + j + m - (kSpreadRows - 1)
    float4 v[kLoads];
    bool ok[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int r2 = rs - u0 + kSpreadRows - 1 - j;
      ok[j] = r2 >= lo_r && r2 <= hm_r;
      v[j] = *reinterpret_cast<const float4*>(f2 + min(max(r2, f_lo), f_hm) * fs);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
#pragma unroll
      for (int m = 0; m < kSpreadRows; ++m) {
        const int uu = j + m - (kSpreadRows - 1);
        if (uu < 0 || uu >= kTapGroup) continue;
        const float wv = ok[j] ? w[uu] : 0.0f;
        acc[m].x = fmaf(wv, v[j].x, acc[m].x);
        acc[m].y = fmaf(wv, v[j].y, acc[m].y);
        acc[m].z = fmaf(wv, v[j].z, acc[m].z);
        acc[m].w = fmaf(wv, v[j].w, acc[m].w);
      }
    }
  }
}

// The canvas rows of one parity that a spreading pass (positions c_first ..
// c_last, canvas starts slo / shi) hits: the lo placements cover [base_lo,
// base_lo + len) (offsets grow with the position), the hi ones the same
// range W/b earlier when the chunk wraps (split < dob). A row in both
// ranges is taken with the lo range, so the hi range adds the rows rel =
// t - base_lo (mod wc) in [max(o, len), min(o + len, wc)), o = base_hi -
// base_lo (mod wc). Returns {base_lo, len, that first rel, rows}; the
// host's spread_busy (kernels/rescan_banded_fused.py) is this formula.
__device__ __forceinline__ int4 spread_rows(const int* slo, const int* shi, int c_first,
                                            int c_last, int split, int dob, int span, int wc) {
  const int base_lo = slo[c_first];
  int diff = slo[c_last] - base_lo;
  if (diff < 0) diff += wc;
  const int len = min(diff + span, wc);
  int o = shi[c_first] - base_lo;
  if (o < 0) o += wc;
  const int rel_hi = max(o, len);
  const int n_hi = split < dob ? max(0, min(o + len, wc) - rel_hi) : 0;
  return make_int4(base_lo, len, rel_hi, len + n_hi);
}

// The spreading placement's table entry of frame c2, parity pi, in the pass
// [first, end): a = {its lo part's canvas start, its hi part's, the ring
// offset of its row 0, the offset of its parity's taps}; r = {the first and
// last frame row of its lo part in the pass (rows below the split), of its
// hi part} (an empty part ends before it starts).
__device__ __forceinline__ void spread_frame(int4& a, int4& r, const int* lo, const int* hi,
                                             int pstride, int c2, int pi, int first, int end,
                                             int dobp, int dob, int split, int fs,
                                             int n_spread) {
  const int f_lo = max(0, first - c2 * dobp), f_hi = min(dob, end - c2 * dobp);
  a = make_int4(lo[pi * pstride + c2], hi[pi * pstride + c2], (c2 * dobp - first) * fs,
                (c2 * 2 + pi) * n_spread);
  r = make_int4(f_lo, min(f_hi, split) - 1, max(f_lo, split), f_hi - 1);
}

// Chunk ic's raw sample window and placement scalars into buffer `buf`
// (asynchronous layouts), one cp.async group.
__device__ __forceinline__ void stage_async(const K1Args& p, const Layout& L, float* smem,
                                            int ic, int buf, int lane0, int tid) {
  const int h = p.h, b = p.b, d_in = p.d_in, chunk = p.chunk, hb = h / b;
  const int p0 = ic * chunk;
  float* raw = smem + (buf ? L.raw1 : L.raw0);
  const int cols = kLanes * b;                    // raw columns of the tile
  const float* src0 = p.sample_ext + static_cast<long long>(lane0) * b;
  if (h % 4 == 0 && lane0 + kLanes <= hb) {       // whole 16-byte pieces
    const int per_row = cols / 4;
    for (int i = tid; i < d_in * per_row; i += kThreads) {
      const int d = i / per_row, k = i - d * per_row;
      cp_async16(raw + d * L.rs + 4 * k, src0 + static_cast<long long>(p0 + d) * h + 4 * k);
    }
  } else {                                        // ragged tile: zero past the lanes
    for (int i = tid; i < d_in * cols; i += kThreads) {
      const int d = i / cols, k = i - d * cols;
      const bool ok = lane0 + k / b < hb;
      cp_async4(raw + d * L.rs + k,
                ok ? src0 + static_cast<long long>(p0 + d) * h + k : p.sample_ext, ok);
    }
  }
  int* sc = reinterpret_cast<int*>(smem + (buf ? L.scal1 : L.scal0));
  const int parities = p.n_spread ? 2 : 1;
  for (int i = tid; i < parities * chunk; i += kThreads) {
    const int pi = i / chunk, c = i - pi * chunk;
    cp_async4(reinterpret_cast<float*>(sc + i), p.sa_lo + pi * p.w + p0 + c, true);
    cp_async4(reinterpret_cast<float*>(sc + 2 * chunk + i), p.sa_hi + pi * p.w + p0 + c, true);
  }
  for (int c = tid; c < chunk; c += kThreads)
    cp_async4(reinterpret_cast<float*>(sc + 4 * chunk + c), p.cls + p0 + c, true);
  if (tid == 0) cp_async4(reinterpret_cast<float*>(sc + 5 * chunk), p.m0 + ic, true);
  if (p.n_spread) {
    float* taps = smem + (buf ? L.taps1 : L.taps0);
    const int n = chunk * 2 * p.n_spread;
    for (int i = tid; i < n; i += kThreads)
      cp_async4(taps + i, p.wt + static_cast<long long>(p0) * 2 * p.n_spread + i, true);
  }
  cp_async_commit();
}

template <bool kSpread, bool kGen, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1)
rescan_banded_fused_kernel(const K1Args p, const Layout L) {
  const int h = p.h, w = p.w, chunk = p.chunk, d_in = p.d_in, dob = p.dob, b = p.b;
  const uint2 key = rls::load_key(p.key, p.key_dev);
  const int wc = p.wc, n_spread = p.n_spread;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                        // [2][kPassRows][fs] frame rows
  const int fs = L.fs;
  float* g_s = smem + L.g;                   // G [d_in][gs], or its generator
  float* i_s = smem + L.ill;                 // [C][d_in]
  const int hb = h / b;
  const int lane0 = blockIdx.x * kLanes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, grp = (tid & 31) >> 2, tig = tid & 3;
  const int dobp = L.dobp;
  const int rows_used = chunk * dobp;
  const int n_pass = (rows_used + kPassRows - 1) / kPassRows;
  const bool full_tile = lane0 + kLanes <= hb && hb % 4 == 0;
  const int lanes_left = hb - lane0;
  const int n_chunks = w / chunk;

  if (kAsync) stage_async(p, L, smem, 0, 0, lane0, tid);
  if (kGen) {
    // generator value k = b*R + d_in - 1 - d, read from one (d, R) of G
    for (int k = tid; k < b * (dob - 1) + d_in; k += kThreads) {
      const int rr = min(k / b, dob - 1);
      g_s[k] = p.g_t[(b * rr + d_in - 1 - k) * dob + rr];
    }
  } else {
    for (int i = tid; i < d_in * dob; i += kThreads) {
      const int d = i / dob;
      g_s[d * L.gs + i - d * dob] = p.g_t[i];
    }
  }
  for (int i = tid; i < chunk * d_in; i += kThreads) i_s[i] = p.ill[i];
  for (long long i = tid; i < static_cast<long long>(p.q) * wc * kLanes; i += kThreads) {
    const long long row = i / kLanes;
    const int l = static_cast<int>(i % kLanes);
    if (lane0 + l < hb) p.out[row * hb + lane0 + l] = 0.0f;
  }

  int pass_no = 0;  // passes so far: picks the ring slot
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int p0 = ic * chunk;
    const int cur = ic & 1;
    // [phase staging]
    if (kAsync) cp_async_wait_all();
    __syncthreads();  // this chunk's window landed / the previous chunk is done
    if (kAsync) {
      if (ic + 1 < n_chunks) stage_async(p, L, smem, ic + 1, cur ^ 1, lane0, tid);
      if (b > 1) {    // bin the raw window: b adjacent columns per lane, in order
        const float* raw = smem + (cur ? L.raw1 : L.raw0);
        for (int i = tid; i < d_in * kLanes; i += kThreads) {
          const int d = i / kLanes, l = i - d * kLanes;
          float s = 0.0f;
          for (int j = 0; j < b; ++j) s += raw[d * L.rs + l * b + j];
          smem[L.bin + d * L.ws + l] = s;
        }
        __syncthreads();
      }
    } else {
      float* win = smem + L.bin;
      for (int i = tid; i < d_in * kLanes; i += kThreads) {
        const int d = i / kLanes, l = i - d * kLanes;
        float s = 0.0f;
        if (lane0 + l < hb) {
          const float* src = p.sample_ext + static_cast<long long>(p0 + d) * h +
                             static_cast<long long>(lane0 + l) * b;
          for (int j = 0; j < b; ++j) s += src[j];
        }
        win[d * L.ws + l] = s;
      }
      if (kSpread)
        for (int i = tid; i < chunk * 2 * n_spread; i += kThreads)
          smem[L.taps0 + i] = p.wt[static_cast<long long>(p0) * 2 * n_spread + i];
      __syncthreads();
    }
    // [end staging]
    const float* win = smem + (kAsync && b == 1 ? (cur ? L.raw1 : L.raw0) : L.bin);
    // placement scalars of the chunk: shared memory, or device memory
    const int* sc = reinterpret_cast<const int*>(smem + (cur ? L.scal1 : L.scal0));
    const int* lo = kAsync ? sc : p.sa_lo + p0;
    const int* hi = kAsync ? sc + 2 * chunk : p.sa_hi + p0;
    const int* cls = kAsync ? sc + 4 * chunk : p.cls + p0;
    const int pstride = kAsync ? chunk : w;     // between the parities' scalars
    const float* w_s = smem + (kAsync && cur ? L.taps1 : L.taps0);
    const int split = kAsync ? sc[5 * chunk] : p.m0[ic];

    // Places the chunk's frame rows [first, end), held in ring slot f_s.
    // Each canvas row they hit is read, summed over those frame rows in
    // position order, and written once. Rows below the split belong to this
    // camera period, the rest wrap into the next (placed W/b earlier). The
    // ring has two slots, so the one barrier after the next pass's
    // convolution orders this gather (which reads this slot and writes
    // canvas rows) before that pass's gather, and before the slot is
    // written again.
    auto place = [&](const int first, const int end, const float* f_s) {
      // [phase placement]
      const int c_first = first / dobp;
      const int c_last = (end - 1) / dobp;
      if (kSpread) {
        // Items (parity, kSpreadRows consecutive canvas rows, lane quad):
        // both parities' rows (spread_rows) in one sweep, the lo range's and
        // the hi range's each in blocks of kSpreadRows, a warp 8 blocks x 4
        // quads, quad-major (a quarter-warp's 16-byte ring reads, rows 3
        // apart, then fall on distinct banks). An item's rows gather
        // sum_{c2, u} w[c2, pi, u] * f[c2, t - start - u] over both parts
        // (frames ascending, lo part before hi, taps ascending) and are added
        // to the canvas once.
        const int span = dob + n_spread - 1;
        const int4 h0 = spread_rows(lo, hi, c_first, c_last, split, dob, span, wc);
        const int4 h1 =
            spread_rows(lo + pstride, hi + pstride, c_first, c_last, split, dob, span, wc);
        constexpr int R = kSpreadRows;
        const int nl0 = (h0.y + R - 1) / R, nb0 = nl0 + (h0.w - h0.y + R - 1) / R;
        const int nl1 = (h1.y + R - 1) / R, blocks = nb0 + nl1 + (h1.w - h1.y + R - 1) / R;
        const int nf = c_last - c_first + 1;
        const int4* tab = kAsync ? reinterpret_cast<const int4*>(
                                       smem + L.tab + (pass_no & 1) * spread_tab_ints(dobp, chunk))
                                 : nullptr;
        for (int i = tid; i < 32 * ((blocks + 7) >> 3); i += kThreads) {
          const int bi = ((i >> 5) << 3) | (i & 7), qd = (i >> 3) & 3;
          if (bi >= blocks) continue;
          const int pi = bi >= nb0;
          const int4 hd = pi ? h1 : h0;
          const int nl = pi ? nl1 : nl0, bj = pi ? bi - nb0 : bi;
          const bool in_lo = bj < nl;
          const int row0 = (in_lo ? bj : bj - nl) * R;  // within its range
          const int n_rows = min(R, (in_lo ? hd.y : hd.w - hd.y) - row0);
          int t0 = hd.x + (in_lo ? row0 : hd.z + row0);
          if (t0 >= wc) t0 -= wc;
          float* dst[R];
          float4 acc[R], old[R];
          bool hit[R];
#pragma unroll
          for (int m = 0; m < R; ++m) {
            int t = t0 + m;
            if (t >= wc) t -= wc;
            dst[m] = p.out + (static_cast<long long>(pi) * wc + t) * hb + lane0 + 4 * qd;
            old[m] = full_tile && m < n_rows ? *reinterpret_cast<const float4*>(dst[m])
                                             : float4{};
            acc[m] = float4{};
            hit[m] = false;
          }
          for (int k = 0; k < nf; ++k) {
            int4 a, r;
            if (kAsync) {
              a = tab[4 * k + 2 * pi];
              r = tab[4 * k + 2 * pi + 1];
            } else {
              spread_frame(a, r, lo, hi, pstride, c_first + k, pi, first, end, dobp, dob, split,
                           fs, n_spread);
            }
            const float* f2 = f_s + a.z + 4 * qd;
            spread_part(acc, hit, f2, fs, w_s + a.w, n_spread, t0 - a.x, r.x, r.y, r.x, r.w, wc);
            spread_part(acc, hit, f2, fs, w_s + a.w, n_spread, t0 - a.y, r.z, r.w, r.x, r.w, wc);
          }
#pragma unroll
          for (int m = 0; m < R; ++m) {
            if (m >= n_rows || !hit[m]) continue;
            if (full_tile) {
              old[m].x += acc[m].x;
              old[m].y += acc[m].y;
              old[m].z += acc[m].z;
              old[m].w += acc[m].w;
              *reinterpret_cast<float4*>(dst[m]) = old[m];
            } else {
              const float sum[4] = {acc[m].x, acc[m].y, acc[m].z, acc[m].w};
#pragma unroll
              for (int l = 0; l < 4; ++l)
                if (4 * qd + l < lanes_left) dst[m][l] += sum[l];
            }
          }
        }
      } else {
        // frame row of frame c2 (phase hi or lo) landing on canvas row t,
        // or -1 when that row is not in this pass
        auto frame_row = [&](int c2, bool ph_hi, int t) {
          const int start = ph_hi ? hi[c2] : lo[c2];
          int r2 = t - start;  // t, start in [0, wc)
          if (r2 < 0) r2 += wc;
          const bool phase_ok = ph_hi ? (r2 >= split && r2 < dob) : (r2 < split && r2 < dob);
          const int row2 = c2 * dobp + r2;
          return phase_ok && row2 >= first && row2 < end ? row2 : -1;
        };
        for (int i = tid; i < end - first; i += kThreads) {
          const int row = first + i;
          const int c = row / dobp;
          const int r = row - c * dobp;
          if (r >= dob) continue;  // padding row
          const bool is_hi = r >= split;
          const int k = cls[c];
          int t = (is_hi ? hi[c] : lo[c]) + r;  // r < dob < wc
          if (t >= wc) t -= wc;
          // the first frame row that hits canvas row t writes it
          bool owner = true;
          for (int c2 = c_first; c2 <= c && owner; ++c2) {
            if (cls[c2] != k) continue;
            if (frame_row(c2, false, t) >= 0 && (c2 < c || is_hi)) owner = false;
            if (c2 < c && frame_row(c2, true, t) >= 0) owner = false;
          }
          if (!owner) continue;
          float sum[kLanes];
#pragma unroll
          for (int j = 0; j < kLanes; ++j) sum[j] = 0.0f;
          for (int c2 = c; c2 <= c_last; ++c2) {
            if (cls[c2] != k) continue;
            for (int ph = 0; ph < 2; ++ph) {
              const int row2 = frame_row(c2, ph == 1, t);
              if (row2 >= 0) axpy_row(sum, 1.0f, f_s + (row2 - first) * fs);
            }
          }
          add_row(p.out + (static_cast<long long>(k) * wc + t) * hb + lane0, sum, full_tile,
                  lanes_left);
        }
      }
      // [end placement]
    };

    for (int ps = 0; ps < n_pass; ++ps, ++pass_no) {
      float* f_s = ring + (pass_no & 1) * kPassRows * fs;
      const int first = ps * kPassRows;
      const int end = min(first + kPassRows, rows_used);
      if (kSpread && kAsync) {
        // the pass's spreading table, in the slot its placement reads after
        // the barrier (the slot's last reader placed two passes ago)
        int4* tab = reinterpret_cast<int4*>(smem + L.tab +
                                            (pass_no & 1) * spread_tab_ints(dobp, chunk));
        const int c_first = first / dobp;
        for (int i = tid; i < 2 * ((end - 1) / dobp - c_first + 1); i += kThreads)
          spread_frame(tab[2 * i], tab[2 * i + 1], lo, hi, pstride, c_first + (i >> 1), i & 1,
                       first, end, dobp, dob, split, fs, n_spread);
      }
      // Each warp convolves whole 32-row groups and, in a noisy run, draws
      // their rows itself (one row a lane), so no barrier parts the two.
      const int n_groups = (end - first) / kGroupRows;
      for (int task = warp; task < n_groups; task += kWarps) {
        const int g = pass_group<kSpread>(task, n_groups, dobp);
        const int row = first + g * kGroupRows;
        const int c = row / dobp;
        const int r0 = row - c * dobp;
        float* f = f_s + g * kGroupRows * fs;
        // [phase convolution]
        int k_lo, k_hi;
        band_run(p, c, r0, min(r0 + kGroupRows, dob) - 1, k_lo, k_hi);
        group_mma<kGen>(f, fs, win, L.ws, i_s + c * d_in, g_s, L.gs, d_in, dob, b, r0, k_lo,
                        k_hi, grp, tig);
        // [end convolution]
        // [phase draws]
        if (p.noisy) {
          __syncwarp();
          const int r = row - c * dobp + (tid & 31);
          draw_row(f + (tid & 31) * fs, r < dob, p0, c, r, dob, hb, lane0, key);
        }
        // [end draws]
      }
      __syncthreads();
      place(first, end, f_s);
    }
  }
}

template <bool kSpread, bool kGen, bool kAsync>
cudaError_t launch(const K1Args& a, const Layout& L, cudaStream_t stream, int* info) {
  auto kernel = rescan_banded_fused_kernel<kSpread, kGen, kAsync>;
  const size_t bytes = layout_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = (a.h / a.b + kLanes - 1) / kLanes;
  info[2] = grid;
  info[3] = per_sm;
  kernel<<<grid, kThreads, bytes, stream>>>(a, L);
  return cudaGetLastError();
}

}  // namespace

// The bytes of K1's three layouts, bytes[0] G resident, bytes[1] generator,
// bytes[2] generator with synchronous staging (the smallest), so that the
// host's bound (kernels/rescan_banded_fused.py banded_fits) can be held to
// this file's formula. Launches nothing; returns 0.
extern "C" int rls_rescan_banded_fused_smem(int d_in, int dob, int chunk, int b,
                                            int n_spread, long long* bytes) {
  for (int v = 0; v < 3; ++v)
    bytes[v] = static_cast<long long>(layout_bytes(make_layout(v, d_in, dob, chunk, b, n_spread)));
  return 0;
}

// Launches K1. info[0] reports the shared-memory layout it took: 0 with G
// resident, 1 with G as its Toeplitz generator (band windows too wide for
// the resident layout), 2 the generator with synchronous staging (wider
// still), -1 when none fits (nothing is launched; the rescan engine's host
// bound banded_fits keeps such windows away); info[1] its bytes of shared
// memory per CTA, info[2] the CTAs, info[3] the CTAs an SM runs at once,
// info[4] the threads per CTA. n_spread > 0 selects NUFFT spreading
// placement (q must be 2). s_exc / s_det: the band's half-widths in window
// columns (band_run), -1 for the whole window.
extern "C" int rls_rescan_banded_fused(const float* g_t, const float* ill,
                                       const float* sample_ext, const int* sa_lo,
                                       const int* sa_hi, const int* m0,
                                       const int* cls, const float* wt, float* out,
                                       int h, int w, int chunk, int d_in, int dob,
                                       int b, int q, int wc, int n_spread, int noisy,
                                       int s_exc, int s_det, unsigned seed0, unsigned seed1,
                                       const long long* key_dev, void* stream, int* info) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t limit = static_cast<size_t>(optin);
  info[0] = -1;
  info[1] = info[2] = info[3] = 0;
  info[4] = kThreads;
  Layout L{};
  for (int v = 0; v < 3; ++v) {
    L = make_layout(v, d_in, dob, chunk, b, n_spread);
    if (layout_bytes(L) <= limit) {
      info[0] = v;
      break;
    }
  }
  if (info[0] < 0) return 0;
  info[1] = static_cast<int>(layout_bytes(L));
  const K1Args a{g_t, ill, sample_ext, sa_lo, sa_hi, m0, cls, wt, out,
                 h, w, chunk, d_in, dob, b, q, wc, n_spread, noisy, s_exc, s_det,
                 make_uint2(seed0, seed1), key_dev};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_spread) {
    err = info[0] == 0   ? launch<true, false, true>(a, L, s, info)
          : info[0] == 1 ? launch<true, true, true>(a, L, s, info)
                         : launch<true, true, false>(a, L, s, info);
  } else {
    err = info[0] == 0   ? launch<false, false, true>(a, L, s, info)
          : info[0] == 1 ? launch<false, true, true>(a, L, s, info)
                         : launch<false, true, false>(a, L, s, info);
  }
  return static_cast<int>(err);
}
