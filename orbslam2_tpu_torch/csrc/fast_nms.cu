// K1: dense FAST-9 corner score + 3x3 non-maximum suppression, for all the
// levels of an image pyramid in one launch.
//
// Replaces orbslam2_tpu/ops/pallas_kernels.py::fast_score_nms_pallas
// (_fast_nms_kernel), which streams 32-row strips of one level through
// VMEM.  Each level's result equals the plain version,
// ops/fast.py nms3x3(fast_score(x)), exactly, then thresholded as the
// extractor thresholds it (score >= min_th, else 0; min_th = 0 changes
// nothing):
//   score(p) = max(0, max over the 16 circular 9-arcs of
//                 max(min_arc(I[n] - I[p]), min_arc(-(I[n] - I[p]))))
//   in the 3-px border score = 0;
//   keep p iff score(p) >= every in-image neighbour, and no neighbour that
//   precedes p in raster order is itself a maximum of its own 3x3 window.
// Only f32 subtraction, negation, min and max are used, so no rounding can
// differ; build without fast-math.
//
// What bounds it on an H100: operations.  The 8 levels of a 640x480 frame
// are ~0.95 M pixels, 7.6 MB in and out (2.3 us at 3.35 TB/s).  Each pixel
// takes ~173 min / max / compare operations, at 64 per SM and clock (CUDA
// C++ Programming Guide, compute capability 9.0): 160 for the arcs, the
// rest for the clamp, the NMS and the threshold; ~10 us over 132 SMs at
// 1.98 GHz (chip_smoke.py counts it from the shapes).  The kernel this one
// replaced lost its time elsewhere: 8 launches an image, small levels that
// filled few SMs, 256 min/neg operations a pixel for the arcs and a 32x8
// tile that loaded 756 pixels and scored 432 for 256 outputs.
//
// Design.  One launch per image: the level pointers and shapes and the
// prefix of the levels' tile counts travel in a struct passed by value (no
// copy to the device, no read on the host); blockIdx.x maps to (level,
// tile).  One block of 256 threads per 64x32 output tile, 512 blocks for
// the 8 levels of a 640x480 frame, a single wave at 4 blocks an SM:
//   - the tile plus a 5-px halo is staged in shared memory (0 outside the
//     image; 3108 loads for 2048 outputs), all of a thread's loads in
//     flight together;
//   - scores for the tile plus a 2-px ring (2448 for 2048), with the
//     log-depth arc tree of the Pallas kernel (pairs, quads, octets, then
//     the ninth: 64 min and 64 max over the 16 starts) on the raw circle
//     values: rounding is monotone, so min and max over an arc of
//     I[n] - I[p] are those of I[n], less I[p], and two subtractions
//     replace sixteen;
//   - local-maximum flags for the tile plus a 1-px ring (the raster
//     tie-break reads the flags of neighbours) as s >= the 3x3 max, taken
//     as a max of three row maxima;
//   - each thread writes eight outputs, thresholded.
// Tiles whose staged window lies inside the image skip the bounds tests of
// every phase.  Everything between the image read and the output write
// stays on chip.  The tile was chosen on the card among 32x32 to 64x40
// tiles, 128 to 512 threads and grid-stride variants with double-buffered
// cp.async copies, which were slower.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;  // ops/fast.py and kernels.py: FAST_MAX_LEVELS
constexpr int TW = 64;          // output tile width
constexpr int TH = 32;          // output tile height
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;   // blocks an SM holds at once (caps registers)
constexpr int HALO = 5;         // 3 (circle) + 1 (flags ring) + 1 (NMS ring)
constexpr int IW = TW + 2 * HALO;
constexpr int IH = TH + 2 * HALO;
constexpr int SW = TW + 4;      // score region: tile + 2-px ring
constexpr int SH = TH + 4;
constexpr int FW = TW + 2;      // flag region: tile + 1-px ring
constexpr int FH = TH + 2;

struct Levels {
  const float* img[MAX_LEVELS];
  float* out[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];
  int first_tile[MAX_LEVELS + 1];  // prefix of the levels' tile counts
  int n_levels;
  float min_th;
};

// The FAST-9 score of the interior pixel at p (a row stride of IW).  The
// plain version takes min and max over the arcs of the differences
// I[n] - I[p]; rounding is monotone, so those are the min and max over
// the arcs of I[n], less I[p]: the same numbers, with two subtractions
// instead of sixteen.  -max_arc(I[n] - I[p]) is c - max_arc(I[n]) rounded,
// the dark arc's min.
__device__ __forceinline__ float fast_score(const float* p) {
  const float c = p[0];
  // The Bresenham circle of radius 3, clockwise from 12 o'clock, as
  // ops/fast.py CIRCLE_OFFSETS (dy, dx).
  const float v[16] = {
      p[-3 * IW], p[-3 * IW + 1], p[-2 * IW + 2], p[-IW + 3], p[3],  p[IW + 3],
      p[2 * IW + 2], p[3 * IW + 1], p[3 * IW], p[3 * IW - 1], p[2 * IW - 2], p[IW - 3],
      p[-3], p[-IW - 3], p[-2 * IW - 2], p[-3 * IW - 1]};
  // min and max over the arcs of 2 and 4 starting at each s, then of 8
  // and 9.
  float lo2[16], hi2[16], lo4[16], hi4[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    lo2[s] = fminf(v[s], v[(s + 1) & 15]);
    hi2[s] = fmaxf(v[s], v[(s + 1) & 15]);
  }
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    lo4[s] = fminf(lo2[s], lo2[(s + 2) & 15]);
    hi4[s] = fmaxf(hi2[s], hi2[(s + 2) & 15]);
  }
  float lo = -INFINITY, hi = INFINITY;  // max over s of the arc min, min of the arc max
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    lo = fmaxf(lo, fminf(fminf(lo4[s], lo4[(s + 4) & 15]), v[(s + 8) & 15]));
    hi = fminf(hi, fmaxf(fmaxf(hi4[s], hi4[(s + 4) & 15]), v[(s + 8) & 15]));
  }
  return fmaxf(fmaxf(__fsub_rn(lo, c), __fsub_rn(c, hi)), 0.0f);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fast_nms_kernel(const Levels L) {
  __shared__ float s_img[IH][IW];
  __shared__ float s_score[SH][SW];
  __shared__ bool s_max[FH][FW];
  __shared__ float s_row[SH][FW];

  int lv = 0;
  while (lv + 1 < L.n_levels && static_cast<int>(blockIdx.x) >= L.first_tile[lv + 1]) ++lv;
  const int t = blockIdx.x - L.first_tile[lv];
  const int h = L.h[lv], w = L.w[lv];
  const int x0 = (t % L.tiles_x[lv]) * TW;
  const int y0 = (t / L.tiles_x[lv]) * TH;
  const float* __restrict__ img = L.img[lv];
  const int tid = threadIdx.x;

  // Tiles whose staged window lies in the image (most of them) skip the
  // bounds tests of every phase: their score ring, 3 px in from the window's
  // edge, then also lies inside the 3-px border.
  const bool inside = y0 - HALO >= 0 && y0 + TH + HALO <= h && x0 - HALO >= 0 &&
                      x0 + TW + HALO <= w;

  // A fixed trip count: the loop unrolls and a thread's image loads are
  // all in flight together.
  if (inside) {
    const float* __restrict__ src = img + static_cast<int64_t>(y0 - HALO) * w + (x0 - HALO);
#pragma unroll
    for (int k = 0; k < (IH * IW + THREADS - 1) / THREADS; ++k) {
      const int i = tid + k * THREADS;
      if (i < IH * IW) {
        const int ly = i / IW, lx = i - ly * IW;
        s_img[ly][lx] = __ldg(src + ly * w + lx);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < (IH * IW + THREADS - 1) / THREADS; ++k) {
      const int i = tid + k * THREADS;
      if (i < IH * IW) {
        const int ly = i / IW, lx = i - ly * IW;
        const int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
        s_img[ly][lx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                            ? __ldg(img + static_cast<int64_t>(gy) * w + gx)
                            : 0.0f;
      }
    }
  }
  __syncthreads();

  // Scores on the tile + 2-px ring; -inf marks pixels outside the image so
  // they never win a comparison (the plain version pads its windows so).
  if (inside) {
#pragma unroll 1
    for (int i = tid; i < SH * SW; i += THREADS) {
      const int ly = i / SW, lx = i - ly * SW;
      s_score[ly][lx] = fast_score(&s_img[ly + 3][lx + 3]);
    }
  } else {
#pragma unroll 1
    for (int i = tid; i < SH * SW; i += THREADS) {
      const int ly = i / SW, lx = i - ly * SW;
      const int gy = y0 - 2 + ly, gx = x0 - 2 + lx;
      float s;
      if (gy < 0 || gy >= h || gx < 0 || gx >= w) {
        s = -INFINITY;
      } else if (gy < 3 || gy >= h - 3 || gx < 3 || gx >= w - 3) {
        s = 0.0f;
      } else {
        s = fast_score(&s_img[ly + 3][lx + 3]);
      }
      s_score[ly][lx] = s;
    }
  }
  __syncthreads();

  // Local-maximum flags on the tile + 1-px ring: the 3x3 max as a max over
  // three rows of s_row, the max of three neighbours in a row.
  for (int i = tid; i < SH * FW; i += THREADS) {
    const int ly = i / FW, lx = i - ly * FW;
    s_row[ly][lx] = fmaxf(fmaxf(s_score[ly][lx], s_score[ly][lx + 1]), s_score[ly][lx + 2]);
  }
  __syncthreads();
  for (int i = tid; i < FH * FW; i += THREADS) {
    const int ly = i / FW, lx = i - ly * FW;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    const float m = fmaxf(fmaxf(s_row[ly][lx], s_row[ly + 1][lx]), s_row[ly + 2][lx]);
    s_max[ly][lx] = (inside || (gy >= 0 && gy < h && gx >= 0 && gx < w)) &&
                    s_score[ly + 1][lx + 1] >= m;
  }
  __syncthreads();

  float* __restrict__ out = L.out[lv];
  const float min_th = L.min_th;
#pragma unroll
  for (int k = 0; k < (TH * TW + THREADS - 1) / THREADS; ++k) {
    const int i = tid + k * THREADS;
    const int ly = i / TW, lx = i - ly * TW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (i < TH * TW && (inside || (gy < h && gx < w))) {
      const int fy = ly + 1, fx = lx + 1;
      // First raster-order maximum: no earlier neighbour (the row above,
      // or the left neighbour) may itself be a maximum of its window.  A
      // bitwise & reads all five flags without branches.
      const bool keep = s_max[fy][fx] & !s_max[fy - 1][fx - 1] & !s_max[fy - 1][fx] &
                        !s_max[fy - 1][fx + 1] & !s_max[fy][fx - 1];
      const float s = s_score[fy + 1][fx + 1];
      out[static_cast<int64_t>(gy) * w + gx] = (keep && s >= min_th) ? s : 0.0f;
    }
  }
}

}  // namespace

// imgs / outs: n device pointers, hs / ws: n shapes, all host arrays; the
// launch copies them into its argument.  Returns cudaErrorInvalidValue for
// n outside [1, MAX_LEVELS] or an empty level.
extern "C" int fast_score_nms_levels_launch(const void* const* imgs, void* const* outs,
                                            const int* hs, const int* ws, int n, float min_th,
                                            void* stream) {
  if (n < 1 || n > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  Levels L = {};
  L.n_levels = n;
  L.min_th = min_th;
  L.first_tile[0] = 0;
  for (int i = 0; i < n; ++i) {
    if (hs[i] < 1 || ws[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    L.img[i] = static_cast<const float*>(imgs[i]);
    L.out[i] = static_cast<float*>(outs[i]);
    L.h[i] = hs[i];
    L.w[i] = ws[i];
    L.tiles_x[i] = (ws[i] + TW - 1) / TW;
    L.first_tile[i + 1] = L.first_tile[i] + L.tiles_x[i] * ((hs[i] + TH - 1) / TH);
  }
  fast_nms_kernel<<<L.first_tile[n], THREADS, 0, static_cast<cudaStream_t>(stream)>>>(L);
  return static_cast<int>(cudaGetLastError());
}
