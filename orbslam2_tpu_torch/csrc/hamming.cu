// K2: packed 256-bit Hamming distance matrix.
//
// Replaces orbslam2_tpu/ops/pallas_kernels.py::hamming_matrix_pallas
// (_hamming_kernel), which tiles 128x128 outputs through VMEM and needs
// 128-multiple sizes.  Computes out[i, j] = sum over the 8 words of
// popcount(a[i, k] ^ b[j, k]) for descriptors held as int32 words with the
// bits of the reference's uint32 words; any Na, Nb >= 1.
//
// What bounds it on an H100: the int32 output.  At 4096 x 1024 that is
// 16 MiB written against 160 KiB of descriptors read, about 5 us of HBM
// time; the XOR/popcount work (16 ops per output) is far below the ALU
// limit.  The projection searches, which fuse the mask and the best-2
// reduction, go through K3 (projection_best2.cu) and never write it.
//
// Design: one block per 32x32 output tile, 32x8 threads.  The tile's 32
// rows of A and 32 rows of B (32 bytes each) are staged in shared memory;
// each thread keeps its column's 8 words of B in registers and computes 4
// rows, so a warp writes 32 consecutive int32 (128 bytes) per row.
// Ragged edges are masked on load and on store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS_PER_THREAD = 4;
constexpr int WORDS = 8;

__global__ void hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                               int32_t* __restrict__ out, int na, int nb) {
  __shared__ uint32_t s_a[TILE][WORDS];
  __shared__ uint32_t s_b[TILE][WORDS + 1];  // +1: conflict-free column reads

  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;

  // 256 threads load 32 rows x 8 words of each operand.
  {
    const int r = tid / WORDS, k = tid % WORDS;
    s_a[r][k] = (row0 + r < na) ? a[(row0 + r) * WORDS + k] : 0u;
    s_b[r][k] = (col0 + r < nb) ? b[(col0 + r) * WORDS + k] : 0u;
  }
  __syncthreads();

  const int col = col0 + threadIdx.x;
  if (col >= nb) return;
  uint32_t bw[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) bw[k] = s_b[threadIdx.x][k];

#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int lr = threadIdx.y + i * (TILE / ROWS_PER_THREAD);
    const int row = row0 + lr;
    if (row < na) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < WORDS; ++k) acc += __popc(s_a[lr][k] ^ bw[k]);
      out[static_cast<int64_t>(row) * nb + col] = acc;
    }
  }
}

}  // namespace

extern "C" int hamming_matrix_launch(const void* a, const void* b, void* out, int na, int nb,
                                     void* stream) {
  const dim3 block(TILE, TILE / ROWS_PER_THREAD);
  const dim3 grid((nb + TILE - 1) / TILE, (na + TILE - 1) / TILE);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), na, nb);
  return static_cast<int>(cudaGetLastError());
}
