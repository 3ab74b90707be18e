// K3: fused projection best-2, the SearchByProjection core.
//
// Replaces orbslam2_tpu/ops/pallas_kernels.py::projection_best2_pallas
// (_proj_best2_kernel).  For each source row i it returns the first
// column of minimum distance, the best and the second-best Hamming
// distance over the targets j with
//   (u_i - x_j)^2 + (v_i - y_j)^2 <= rr2_i,  the octave gate,
//   valid_a[i] and valid_b[j];
// masked pairs count as INVALID (10000), so a row without a candidate gives
// (0, 10000, 10000), as masked_best2(hamming_matrix(a, b), mask) in
// ops/matcher.py::_projection_best2_plain.  The octave gate is
// |l_j - l_i| <= level_band, or, when level_dir points at an int32 d != 0,
// l_j - l_i >= 0 (d > 0) or <= 0 (d < 0): the motion-model gate, which the
// Pallas kernel never took.  level_dir is a device pointer (or null) so the
// caller never reads it on the host.  Levels are compared as integers (the
// Pallas kernel compared floats).  Any na, nb >= 1.
//
// d2 is rounded as the plain version rounds it: two products, then their
// sum.  __fmul_rn / __fadd_rn keep nvcc from contracting the sum into an
// FMA, which rounds once and moves d2 <= rr2 on boundary pairs.
//
// What bounds it on an H100: operations.  The inputs are ~49 bytes a row
// (~0.3 MB at 4096 x 2048) and the outputs 16 bytes a row; the mask test of
// every pair and the XOR/popcount of each candidate are ~75 M operations at
// 4096 x 2048, about 1 us at the float32 rate.  The K2 route wrote and read
// back the whole (na, nb) int32 matrix (32 MiB at 4096 x 2048).
//
// Design (simple first): one thread per source row, ROWS rows per block.
// The block walks the targets in tiles of COLS staged in shared memory
// (descriptor words, x, y, level, valid), each thread loading one target.
// A thread keeps its row's 8 words in registers and scans the tile's
// columns in ascending order, skipping masked pairs: `<` keeps the first
// minimum, `else if (d < second)` takes a tie as the second.  Invalid and
// out-of-range rows take part in the tile loads and skip the scan.  Later
// work: split the columns across blocks (the Pallas grid's strict-< merge)
// so that na = 4096 fills more than 32 of the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;
constexpr int COLS = 128;
constexpr int WORDS = 8;
constexpr int INVALID = 10000;

__global__ void __launch_bounds__(ROWS) projection_best2_kernel(
    const uint32_t* __restrict__ desc_a, const float* __restrict__ uv,
    const float* __restrict__ rr2, const int32_t* __restrict__ level_a,
    const uint8_t* __restrict__ valid_a, const uint32_t* __restrict__ desc_b,
    const float* __restrict__ xy, const int32_t* __restrict__ level_b,
    const uint8_t* __restrict__ valid_b, const int32_t* __restrict__ level_dir, int na,
    int nb, int level_band, int64_t* __restrict__ out_idx, int32_t* __restrict__ out_best,
    int32_t* __restrict__ out_second) {
  __shared__ uint32_t s_desc[COLS][WORDS];
  __shared__ float s_x[COLS];
  __shared__ float s_y[COLS];
  __shared__ int32_t s_level[COLS];
  __shared__ uint8_t s_valid[COLS];

  const int t = threadIdx.x;
  const int row = blockIdx.x * ROWS + t;
  const bool active = row < na && valid_a[row] != 0;

  uint32_t aw[WORDS];
  float u = 0.f, v = 0.f, r2 = 0.f;
  int la = 0;
  if (active) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) aw[k] = desc_a[static_cast<int64_t>(row) * WORDS + k];
    u = uv[2 * static_cast<int64_t>(row)];
    v = uv[2 * static_cast<int64_t>(row) + 1];
    r2 = rr2[row];
    la = level_a[row];
  }
  // 0: symmetric band; +1: target octave >= source; -1: <=.
  int dir = 0;
  if (level_dir != nullptr) {
    const int d = *level_dir;
    dir = d > 0 ? 1 : (d < 0 ? -1 : 0);
  }

  int best = INVALID, second = INVALID;
  int64_t idx = 0;
  for (int col0 = 0; col0 < nb; col0 += COLS) {
    const int c = col0 + t;
    if (c < nb) {
#pragma unroll
      for (int k = 0; k < WORDS; ++k) s_desc[t][k] = desc_b[static_cast<int64_t>(c) * WORDS + k];
      s_x[t] = xy[2 * static_cast<int64_t>(c)];
      s_y[t] = xy[2 * static_cast<int64_t>(c) + 1];
      s_level[t] = level_b[c];
      s_valid[t] = valid_b[c];
    }
    __syncthreads();
    if (active) {
      const int n = min(COLS, nb - col0);
      for (int j = 0; j < n; ++j) {
        if (!s_valid[j]) continue;
        const int dl = s_level[j] - la;
        const bool lvl_ok = dir > 0 ? dl >= 0 : (dir < 0 ? dl <= 0 : abs(dl) <= level_band);
        if (!lvl_ok) continue;
        const float du = __fsub_rn(u, s_x[j]);
        const float dv = __fsub_rn(v, s_y[j]);
        const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
        if (!(d2 <= r2)) continue;
        int d = 0;
#pragma unroll
        for (int k = 0; k < WORDS; ++k) d += __popc(aw[k] ^ s_desc[j][k]);
        if (d < best) {
          second = best;
          best = d;
          idx = col0 + j;
        } else if (d < second) {
          second = d;
        }
      }
    }
    __syncthreads();
  }
  if (row < na) {
    out_idx[row] = idx;
    out_best[row] = best;
    out_second[row] = second;
  }
}

}  // namespace

extern "C" int projection_best2_launch(const void* desc_a, const void* uv, const void* rr2,
                                       const void* level_a, const void* valid_a,
                                       const void* desc_b, const void* xy, const void* level_b,
                                       const void* valid_b, const void* level_dir, int na, int nb,
                                       int level_band, void* out_idx, void* out_best,
                                       void* out_second, void* stream) {
  const dim3 grid((na + ROWS - 1) / ROWS);
  projection_best2_kernel<<<grid, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(desc_a), static_cast<const float*>(uv),
      static_cast<const float*>(rr2), static_cast<const int32_t*>(level_a),
      static_cast<const uint8_t*>(valid_a), static_cast<const uint32_t*>(desc_b),
      static_cast<const float*>(xy), static_cast<const int32_t*>(level_b),
      static_cast<const uint8_t*>(valid_b), static_cast<const int32_t*>(level_dir), na, nb,
      level_band, static_cast<int64_t*>(out_idx), static_cast<int32_t*>(out_best),
      static_cast<int32_t*>(out_second));
  return static_cast<int>(cudaGetLastError());
}
