// K5: scatter-add of camera frames into the rescan canvas.
//
// Replaces rescan_accumulate / _pallas_delta / _accumulate_kernel of
// rescan_line_sted_tpu/kernels/rescan_accumulate.py. Frame n [H, w] adds
// column x into canvas column (offsets[n] + x) mod wc; duplicate targets
// accumulate, and a frame wider than the canvas wraps onto it several
// times.
//
// Design: owner computes, no atomics. One thread owns one canvas column c
// of kRows rows and walks the frames in order: frame n reaches it through
// the columns x = ((c - offsets[n]) mod wc) + k wc < w, k = 0, 1, ... So
// every sum runs in one fixed order (the canvas value first, then frame 0,
// 1, ...) and the result is deterministic. Neighbouring threads own
// neighbouring columns, so a frame's columns are read coalesced. The TPU
// kernel padded the canvas by one frame width and folded the tail back,
// which needed w + 8 <= wc; here any width works.
//
// Bound on the card: bytes (each frame element read once, the canvas read
// and written once: 37.7 MB, 11 us at 3.35 TB/s, for 32 frames [512, 512]
// into [512, 1024]). A thread that walks the frames one dependent step at a
// time keeps one load in flight and reaches a third of that rate, so each
// thread issues the loads of kBatch frames x kRows rows before it adds them
// in frame order (latency hidden, no sum reordered). The offsets of a pass
// are reduced mod wc as they are staged in shared memory (int32 or int64,
// negative included: the wrapper runs no op before the launch), and one
// warp compacts, in order, the frames whose columns [off, off + w) mod wc
// meet the CTA's columns: a test uniform across the CTA, so a frame that
// misses them costs it nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // canvas columns per CTA
constexpr int kRows = 4;               // canvas rows per thread
constexpr int kBatch = 8;              // frames loaded before they are added
constexpr int kOffsetsPerPass = 1024;  // offsets staged in shared memory at once

template <typename Off>
__global__ void __launch_bounds__(kThreads)
rescan_accumulate_kernel(const float* __restrict__ canvas, const float* __restrict__ frames,
                         const Off* __restrict__ offsets, float* __restrict__ out, int h,
                         int wc, int n, int w) {
  __shared__ int staged[kOffsetsPerPass];  // reduced offset, or -1 for a frame that misses
  __shared__ int frame_of[kOffsetsPerPass];  // frames that reach this CTA, in order
  __shared__ int off_of[kOffsetsPerPass];    // and their reduced offsets
  __shared__ int count_s;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kThreads;
  const int c = c0 + tid;
  const int span = min(kThreads, wc - c0);   // this CTA's canvas columns
  const int y0 = blockIdx.y * kRows;
  const bool own = c < wc;
  const long long frame_stride = static_cast<long long>(h) * w;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    acc[r] = own && y0 + r < h ? canvas[static_cast<long long>(y0 + r) * wc + c] : 0.0f;
  for (int n0 = 0; n0 < n; n0 += kOffsetsPerPass) {
    const int m = min(kOffsetsPerPass, n - n0);
    __syncthreads();  // the previous pass's tables are no longer read
    for (int i = tid; i < m; i += kThreads) {
      long long o = static_cast<long long>(offsets[n0 + i]) % wc;
      if (o < 0) o += wc;
      const int off = static_cast<int>(o);
      int d = c0 - off;            // the CTA's first column in frame coordinates
      if (d < 0) d += wc;
      staged[i] = d < w || wc - d < span ? off : -1;
    }
    __syncthreads();
    if (tid < 32) {                // one warp compacts the frames that hit
      int count = 0;
      for (int i0 = 0; i0 < m; i0 += 32) {
        const int i = i0 + tid;
        const int off = i < m ? staged[i] : -1;
        const unsigned hits = __ballot_sync(0xffffffffu, off >= 0);
        if (off >= 0) {
          const int at = count + __popc(hits & ((1u << tid) - 1u));
          frame_of[at] = n0 + i;
          off_of[at] = off;
        }
        count += __popc(hits);
      }
      if (tid == 0) count_s = count;
    }
    __syncthreads();
    const int count = count_s;
    if (w <= wc) {                 // a frame reaches a canvas column at most once
      for (int j0 = 0; j0 < count; j0 += kBatch) {
        float v[kBatch][kRows];
        bool hit[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          hit[j] = false;
          if (j0 + j < count) {
            int x = c - off_of[j0 + j];
            if (x < 0) x += wc;
            hit[j] = own && x < w;
            const float* f = frames + frame_of[j0 + j] * frame_stride +
                             static_cast<long long>(y0) * w + x;
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              v[j][r] = hit[j] && y0 + r < h ? f[static_cast<long long>(r) * w] : 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (hit[j]) acc[r] += v[j][r];
      }
    } else if (own) {              // wide frames wrap onto the canvas
      for (int j = 0; j < count; ++j) {
        int x = c - off_of[j];
        if (x < 0) x += wc;
        const float* f = frames + frame_of[j] * frame_stride + static_cast<long long>(y0) * w;
        for (; x < w; x += wc)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (y0 + r < h) acc[r] += f[static_cast<long long>(r) * w + x];
      }
    }
  }
  if (own) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (y0 + r < h) out[static_cast<long long>(y0 + r) * wc + c] = acc[r];
  }
}

}  // namespace

// out = canvas [h, wc] plus frames [n, h, w] added at columns (offsets[i] +
// x) mod wc; offsets of any value, int64 when off64 else int32. Returns a
// cudaError_t code.
extern "C" int rls_rescan_accumulate(const float* canvas, const float* frames,
                                     const void* offsets, float* out, int h, int wc,
                                     int n, int w, int off64, void* stream) {
  if (h > 0 && wc > 0) {
    const dim3 grid((wc + kThreads - 1) / kThreads, (h + kRows - 1) / kRows);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (off64)
      rescan_accumulate_kernel<<<grid, kThreads, 0, s>>>(
          canvas, frames, static_cast<const long long*>(offsets), out, h, wc, n, w);
    else
      rescan_accumulate_kernel<<<grid, kThreads, 0, s>>>(
          canvas, frames, static_cast<const int*>(offsets), out, h, wc, n, w);
  }
  return static_cast<int>(cudaGetLastError());
}
