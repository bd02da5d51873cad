// K5: scatter-add of camera frames into the rescan canvas.
//
// Replaces rescan_accumulate / _pallas_delta / _accumulate_kernel of
// rescan_line_sted_tpu/kernels/rescan_accumulate.py. Frame n [H, w] adds
// column x into canvas column (offsets[n] + x) mod wc; duplicate targets
// accumulate, and a frame wider than the canvas wraps onto it several
// times.
//
// Design: owner computes, no atomics. One thread owns one canvas element
// (y, c) and walks the frames in order: frame n reaches it through the
// columns x = ((c - offsets[n]) mod wc) + k wc < w, k = 0, 1, ... So every
// sum runs in one fixed order (the canvas value first, then frame 0, 1,
// ...) and the result is deterministic. Neighbouring threads own
// neighbouring columns, so a frame's columns are read coalesced. The TPU
// kernel padded the canvas by one frame width and folded the tail back,
// which needed w + 8 <= wc; here any width works.
//
// Bound on the card: bytes (each frame element read once and the canvas
// read and written once) where frames are dense on the canvas; the
// offsets live in shared memory, one check per frame per element.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOffsetsPerPass = 2048;   // offsets staged in shared memory at once

__global__ void __launch_bounds__(kThreads)
rescan_accumulate_kernel(const float* __restrict__ canvas, const float* __restrict__ frames,
                         const int* __restrict__ offsets, float* __restrict__ out, int h,
                         int wc, int n, int w) {
  __shared__ int offs[kOffsetsPerPass];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const bool own = c < wc;
  const long long row = static_cast<long long>(y) * w;
  const long long frame_stride = static_cast<long long>(h) * w;
  float acc = own ? canvas[static_cast<long long>(y) * wc + c] : 0.0f;
  for (int n0 = 0; n0 < n; n0 += kOffsetsPerPass) {
    const int m = min(kOffsetsPerPass, n - n0);
    __syncthreads();  // the previous pass's offsets are no longer read
    for (int i = threadIdx.x; i < m; i += kThreads) offs[i] = offsets[n0 + i];
    __syncthreads();
    if (!own) continue;
    for (int i = 0; i < m; ++i) {
      int x = c - offs[i];  // offsets are reduced to [0, wc) by the wrapper
      if (x < 0) x += wc;
      const float* f = frames + (n0 + i) * frame_stride + row;
      for (; x < w; x += wc) acc += f[x];
    }
  }
  if (own) out[static_cast<long long>(y) * wc + c] = acc;
}

}  // namespace

// out = canvas [h, wc] plus frames [n, h, w] added at columns (offsets[i] +
// x) mod wc; offsets must lie in [0, wc). Returns a cudaError_t code.
extern "C" int rls_rescan_accumulate(const float* canvas, const float* frames,
                                     const int* offsets, float* out, int h, int wc,
                                     int n, int w, void* stream) {
  if (h > 0 && wc > 0) {
    const dim3 grid((wc + kThreads - 1) / kThreads, h);
    rescan_accumulate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        canvas, frames, offsets, out, h, wc, n, w);
  }
  return static_cast<int>(cudaGetLastError());
}
