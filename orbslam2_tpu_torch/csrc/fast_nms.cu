// K1: dense FAST-9 corner score + 3x3 non-maximum suppression.
//
// Replaces orbslam2_tpu/ops/pallas_kernels.py::fast_score_nms_pallas
// (_fast_nms_kernel), which streams 32-row strips through VMEM.  The result
// equals the plain version, ops/fast.py nms3x3(fast_score(x)), exactly:
//   score(p) = max(0, max over the 16 circular 9-arcs of
//                 max(min_arc(I[n] - I[p]), min_arc(-(I[n] - I[p]))))
//   in the 3-px border score = 0;
//   keep p iff score(p) >= every in-image neighbour, and no neighbour that
//   precedes p in raster order is itself a maximum of its own 3x3 window.
// Only f32 subtraction, negation, min and max are used, so no rounding can
// differ; build without fast-math.
//
// What bounds it on an H100: the 8 pyramid levels of a 640x480 frame are
// about 1.3 MB in and 1.3 MB out, under a microsecond of HBM time each, so
// the kernel is bound by its launch and by latency, not bandwidth.
//
// Design: one block per 32x8 output tile.  The tile plus a 5-px halo of
// the image is staged in shared memory (0 outside the image); scores are
// computed for the tile plus a 2-px ring, local-maximum flags for the tile
// plus a 1-px ring (the raster tie-break reads the flags of neighbours),
// and each thread then writes its outputs.  Everything between the image
// read and the output write stays on chip.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;          // output tile width
constexpr int TH = 8;           // output tile height
constexpr int HALO = 5;         // 3 (circle) + 1 (flags ring) + 1 (NMS ring)
constexpr int IW = TW + 2 * HALO;
constexpr int IH = TH + 2 * HALO;
constexpr int SW = TW + 4;      // score region: tile + 2-px ring
constexpr int SH = TH + 4;
constexpr int FW = TW + 2;      // flag region: tile + 1-px ring
constexpr int FH = TH + 2;

__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                                int h, int w) {
  __shared__ float s_img[IH][IW];
  __shared__ float s_score[SH][SW];
  __shared__ bool s_max[FH][FW];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthreads = TW * TH;

  for (int i = tid; i < IH * IW; i += nthreads) {
    const int ly = i / IW, lx = i % IW;
    const int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
    s_img[ly][lx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx] : 0.0f;
  }
  __syncthreads();

  // Scores on the tile + 2-px ring; -inf marks pixels outside the image so
  // they never win a comparison (the plain version pads its windows so).
  for (int i = tid; i < SH * SW; i += nthreads) {
    const int ly = i / SW, lx = i % SW;
    const int gy = y0 - 2 + ly, gx = x0 - 2 + lx;
    float s;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) {
      s = -INFINITY;
    } else if (gy < 3 || gy >= h - 3 || gx < 3 || gx >= w - 3) {
      s = 0.0f;
    } else {
      const int cy = ly + 3, cx = lx + 3;  // position in s_img
      const float c = s_img[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[cy + kCircleDy[k]][cx + kCircleDx[k]] - c;
      float best = -INFINITY;
#pragma unroll
      for (int st = 0; st < 16; ++st) {
        float bright = d[st];
        float dark = -d[st];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          const float v = d[(st + j) & 15];
          bright = fminf(bright, v);
          dark = fminf(dark, -v);
        }
        best = fmaxf(best, fmaxf(bright, dark));
      }
      s = fmaxf(best, 0.0f);
    }
    s_score[ly][lx] = s;
  }
  __syncthreads();

  // Local-maximum flags on the tile + 1-px ring.
  for (int i = tid; i < FH * FW; i += nthreads) {
    const int ly = i / FW, lx = i % FW;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    bool is_max = false;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const float s = s_score[ly + 1][lx + 1];
      is_max = true;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
          is_max = is_max && (s >= s_score[ly + 1 + dy][lx + 1 + dx]);
    }
    s_max[ly][lx] = is_max;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x;
  const int gy = y0 + threadIdx.y;
  if (gx >= w || gy >= h) return;
  const int fy = threadIdx.y + 1, fx = threadIdx.x + 1;
  // First raster-order maximum: no earlier neighbour (the row above, or
  // the left neighbour) may itself be a maximum of its window.
  const bool keep = s_max[fy][fx] && !s_max[fy - 1][fx - 1] && !s_max[fy - 1][fx] &&
                    !s_max[fy - 1][fx + 1] && !s_max[fy][fx - 1];
  out[gy * w + gx] = keep ? s_score[fy + 1][fx + 1] : 0.0f;
}

}  // namespace

extern "C" int fast_score_nms_launch(const void* img, void* out, int h, int w, void* stream) {
  const dim3 block(TW, TH);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
