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
// sum.  __fsub_rn / __fmul_rn / __fadd_rn keep nvcc from contracting the
// sum into an FMA, which rounds once and moves d2 <= rr2 on boundary pairs.
//
// What bounds it on an H100: operations, and few of them.  The inputs are
// ~49 bytes a source and ~45 a target (0.3 MB at 4096 x 2048).  Counted at
// each class's rate per SM and clock (CUDA C++ Programming Guide, compute
// capability 9.0: 64 for integer and compare operations, 128 for float32
// add and multiply, 16 for popcount), the mask tests of every live pair
// and the 8 XOR + 8 popcount + 8 add of each candidate come to under a
// microsecond at 4096 x 1024 (chip_smoke.py counts them from the inputs).
// So the time goes to latency and to filling the card: the searches have
// 1024-4096 sources, each scanning 1024-2048 targets, of which a handful
// pass the window.
//
// Design.  One warp per source row; the lanes split the targets: lane l
// scans the columns l, l + 32, ... of each tile in ascending order and
// keeps a partial (best, idx, second) (`<` keeps its first minimum, a tie
// becomes the second).  Five __shfl_xor_sync steps merge the partials:
// best by the pair (distance, column), lowest first, and second =
// min(max(b1, b2), s1, s2), the Pallas grid's merge for interleaved
// columns.  An empty partial is (10000, 0, 10000); 10000 never ties with a
// real distance (<= 256), so an empty row ends as (10000, 0, 10000).  The
// WARPS rows of a block share the targets, staged in shared memory in tiles
// of COLS with descriptors word-major ([WORDS][COLS + 4]: neighbouring lanes
// read neighbouring banks, and the 4 words of padding spread the staging
// writes), and the next tile is copied with cp.async while the current one
// is scanned (two buffers).  The launch picks 16, 8 or 4 rows a block, the
// most that still gives one block per SM: 256 blocks at 4096 sources (16
// rows) and at 1024 (4 rows).  Invalid and out-of-range rows take part in
// the tile copies and skip the scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 256;
constexpr int WORDS = 8;
constexpr int INVALID = 10000;
// The target valid bytes of a tile, copied as the aligned 4-byte words
// that hold them: up to 3 bytes before and after the tile's COLS.
constexpr int VALID_WORDS = COLS / 4 + 2;

struct Tile {
  uint32_t desc[WORDS][COLS + 4];
  float xy[2 * COLS];
  int32_t level[COLS];
  uint32_t valid[VALID_WORDS];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// All threads of the block copy the targets [col0, col0 + n) into `s`.
template <int THREADS>
__device__ __forceinline__ void load_tile(Tile& s, const uint32_t* __restrict__ desc_b,
                                          const float* __restrict__ xy,
                                          const int32_t* __restrict__ level_b,
                                          const uint32_t* valid_words, int voff, int col0,
                                          int n) {
  const int tid = threadIdx.x;
  const uint32_t* d = desc_b + static_cast<int64_t>(col0) * WORDS;
  for (int i = tid; i < n * WORDS; i += THREADS) cp_async4(&s.desc[i % WORDS][i / WORDS], d + i);
  const float* p = xy + 2 * static_cast<int64_t>(col0);
  for (int i = tid; i < 2 * n; i += THREADS) cp_async4(&s.xy[i], p + i);
  for (int i = tid; i < n; i += THREADS) cp_async4(&s.level[i], level_b + col0 + i);
  // col0 is a multiple of 4, so every tile's bytes start at offset voff.
  const uint32_t* v = valid_words + col0 / 4;
  for (int i = tid; i < (voff + n + 3) / 4; i += THREADS) cp_async4(&s.valid[i], v + i);
}

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32) projection_best2_kernel(
    const uint32_t* __restrict__ desc_a, const float* __restrict__ uv,
    const float* __restrict__ rr2, const int32_t* __restrict__ level_a,
    const uint8_t* __restrict__ valid_a, const uint32_t* __restrict__ desc_b,
    const float* __restrict__ xy, const int32_t* __restrict__ level_b,
    const uint8_t* __restrict__ valid_b, const int32_t* __restrict__ level_dir, int na,
    int nb, int level_band, int64_t* __restrict__ out_idx, int32_t* __restrict__ out_best,
    int32_t* __restrict__ out_second) {
  __shared__ Tile tiles[2];

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool active = row < na && valid_a[row] != 0;

  // The row's operands, the same address in every lane (one broadcast).
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

  const uintptr_t vaddr = reinterpret_cast<uintptr_t>(valid_b);
  const int voff = static_cast<int>(vaddr & 3);
  const uint32_t* valid_words = reinterpret_cast<const uint32_t*>(vaddr - voff);

  int best = INVALID, second = INVALID, idx = 0;
  const int ntiles = (nb + COLS - 1) / COLS;
  load_tile<WARPS * 32>(tiles[0], desc_b, xy, level_b, valid_words, voff, 0, min(COLS, nb));
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int c1 = (t + 1) * COLS;
      load_tile<WARPS * 32>(tiles[(t + 1) & 1], desc_b, xy, level_b, valid_words, voff, c1,
                            min(COLS, nb - c1));
    }
    cp_async_commit();  // possibly empty: tile t is then the older group
    cp_async_wait_one();
    __syncthreads();
    if (active) {
      const Tile& s = tiles[t & 1];
      const int col0 = t * COLS;
      const int n = min(COLS, nb - col0);
      const uint8_t* vb = reinterpret_cast<const uint8_t*>(s.valid) + voff;
      for (int j = lane; j < n; j += 32) {
        if (!vb[j]) continue;
        const int dl = s.level[j] - la;
        const bool lvl_ok = dir > 0 ? dl >= 0 : (dir < 0 ? dl <= 0 : abs(dl) <= level_band);
        if (!lvl_ok) continue;
        const float du = __fsub_rn(u, s.xy[2 * j]);
        const float dv = __fsub_rn(v, s.xy[2 * j + 1]);
        const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
        if (!(d2 <= r2)) continue;
        int d = 0;
#pragma unroll
        for (int k = 0; k < WORDS; ++k) d += __popc(aw[k] ^ s.desc[k][j]);
        if (d < best) {
          second = best;
          best = d;
          idx = col0 + j;
        } else if (d < second) {
          second = d;
        }
      }
    }
    __syncthreads();  // the buffer of tile t is refilled in the next iteration
  }

#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, best, m);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, m);
    const int os = __shfl_xor_sync(0xffffffffu, second, m);
    second = min(max(best, ob), min(second, os));
    if (ob < best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (lane == 0 && row < na) {
    out_idx[row] = idx;
    out_best[row] = best;
    out_second[row] = second;
  }
}

template <int WARPS>
void launch(const void* desc_a, const void* uv, const void* rr2, const void* level_a,
            const void* valid_a, const void* desc_b, const void* xy, const void* level_b,
            const void* valid_b, const void* level_dir, int na, int nb, int level_band,
            void* out_idx, void* out_best, void* out_second, cudaStream_t stream) {
  const dim3 grid((na + WARPS - 1) / WARPS);
  projection_best2_kernel<WARPS><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const uint32_t*>(desc_a), static_cast<const float*>(uv),
      static_cast<const float*>(rr2), static_cast<const int32_t*>(level_a),
      static_cast<const uint8_t*>(valid_a), static_cast<const uint32_t*>(desc_b),
      static_cast<const float*>(xy), static_cast<const int32_t*>(level_b),
      static_cast<const uint8_t*>(valid_b), static_cast<const int32_t*>(level_dir), na, nb,
      level_band, static_cast<int64_t*>(out_idx), static_cast<int32_t*>(out_best),
      static_cast<int32_t*>(out_second));
}

}  // namespace

extern "C" int projection_best2_launch(const void* desc_a, const void* uv, const void* rr2,
                                       const void* level_a, const void* valid_a,
                                       const void* desc_b, const void* xy, const void* level_b,
                                       const void* valid_b, const void* level_dir, int na, int nb,
                                       int level_band, void* out_idx, void* out_best,
                                       void* out_second, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The most rows a block that still gives every SM a block.
  if ((na + 15) / 16 >= sms) {
    launch<16>(desc_a, uv, rr2, level_a, valid_a, desc_b, xy, level_b, valid_b, level_dir, na,
               nb, level_band, out_idx, out_best, out_second, s);
  } else if ((na + 7) / 8 >= sms) {
    launch<8>(desc_a, uv, rr2, level_a, valid_a, desc_b, xy, level_b, valid_b, level_dir, na,
              nb, level_band, out_idx, out_best, out_second, s);
  } else {
    launch<4>(desc_a, uv, rr2, level_a, valid_a, desc_b, xy, level_b, valid_b, level_dir, na,
              nb, level_band, out_idx, out_best, out_second, s);
  }
  return static_cast<int>(cudaGetLastError());
}
