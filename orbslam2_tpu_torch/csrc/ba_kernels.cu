// K4 and K5: the bundle-adjustment reprojection pipeline of one LM step.
//
// K4 (ba_normal_equations) replaces
// orbslam2_tpu/solvers/ba_kernels.py::ba_normal_equations (_ne_kernel), K5
// (ba_chi2) replaces ba_kernels.py::ba_chi2 (_chi2_kernel).  For camera c
// and observation n (X, uv N-minor, as the reference lays them out) both
// project the point, form the residual (predicted - observed; a stereo row
// only where ur >= 0) and chi2 = |r|^2 inv_s2, replaced by a 1e9 sentinel
// where the point is behind the camera (z <= 1e-6).  K4 also weights the
// observation (w = inv_s2 * mask * !behind, times the Huber factor
// min(1, delta / max(sqrt(chi2 + 1e-12), 1e-12)) when robust, delta =
// sqrt(5.991) mono or sqrt(7.815) stereo) and writes
//   per observation, rows of a (C, 32, N) pack: 0-5 H_pp upper triangle,
//     6-8 b_p, 9-26 G (6x3 row-major), 27 chi2 (sentinel), 28 w, 29-31 0;
//   per camera: H_cc (6x6, full symmetric), b_c (6), sum of mask * chi2.
// K5 writes chi2 (C, N) and the per-camera sum of mask * chi2.  The sums
// include the 1e9 sentinels: the LM accept test relies on that.
//
// What bounds them on an H100.  Per observation K4 reads 29 bytes (7
// float32 + a bool) and writes 128, and does ~450 float32 adds and
// multiplies; K5 reads the same and writes 4.  At the main path's local-BA
// windows (C = 16 cameras while the map has at most 8 keyframes, 48 after;
// N = 1024 observations a camera for RGB-D, 2048 for stereo) that is
// 2.6 MB and 7 M operations for K4 at C = 16, N = 1024: 0.77 us at 3.35
// TB/s, about 0.2 us at 128 float32 operations per SM and clock.  K5's
// bytes take 0.16 us.  Both are so small that the time is set by how many
// SMs take part and by how long one thread's chain of observations is.
//
// Why not one block per camera.  The first version gave each camera one
// block of 256 threads striding over N: at C = 16 that is 16 of the card's
// 132 SMs (88% of the card idle), each thread walking 4 observations in
// series (8 for stereo), so in the main path K4 took ~6 us a launch at
// N = 1024 and ~11 us at N = 2048, K5 ~4 and ~7 us: nearly twice as long
// for twice the N.
//
// Design: each camera's observations are split over a thread-block cluster
// of S blocks (S = kernels.ba_split(C, N), 1, 2, 4 or 8: the smallest S
// with C * S >= 128 blocks, at most N).  The grid is (S, C) blocks of 128
// threads, the cluster (S, 1, 1); block r of camera c takes observations
// [r N / S, (r + 1) N / S), its threads striding over them, so neighbouring
// threads read and write neighbouring addresses of every N-minor row.  At
// C = 16, N = 1024 that is 128 blocks and one observation a thread.  Each
// thread keeps its camera partial sums in registers; the block reduces them
// in a fixed order (a shuffle tree inside each warp, done for K4's 28 sums
// as one reduce-scatter, then the warps in order through shared memory);
// each block sends its totals into its row of the first block's shared
// memory through distributed shared memory (st.async, counted by an
// mbarrier there), and the first block, once the mbarrier completes, adds
// the rows in rank order and writes the camera's sums (ClusterSum).  No
// atomics, no global scratch, one launch: the result depends on (C, N) and
// the inputs only, the same bits on every run.  Built without fast-math:
// division and square root are IEEE.
//
// Why st.async and not a cluster barrier around the exchange: a barrier's
// release arrive waits until each thread's earlier stores, the pack and
// chi2 rows included, are performed, so it added the write-back latency
// to the critical path, which for K5 is most of its time.  st.async
// orders only the total it carries.  One relaxed cluster arrive at the
// start, waited on before the send, makes sure the first block's
// mbarrier is set up before anyone writes to it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SPLIT = 8;  // the portable cluster size
constexpr int N_OBS_ROWS = 32;
constexpr int N_CAM_SUMS = 28;  // 21 H_cc (upper) + 6 b_c + chi2
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;

struct Intrinsics {
  float fx, fy, cx, cy, bf;
};

struct Projection {
  float x, y, z, zi, ru, rv, rw, chi2, chi2_out;
  bool behind, has_ur;
};

// The shared prologue (the reference's _project).
__device__ __forceinline__ Projection project(const float (&R)[9], const float (&t)[3],
                                              float Xx, float Xy, float Xz, float u_obs,
                                              float v_obs, float ur_obs, float inv_s2,
                                              const Intrinsics& k) {
  Projection p;
  p.x = R[0] * Xx + R[1] * Xy + R[2] * Xz + t[0];
  p.y = R[3] * Xx + R[4] * Xy + R[5] * Xz + t[1];
  p.z = R[6] * Xx + R[7] * Xy + R[8] * Xz + t[2];
  p.behind = p.z <= 1e-6f;
  p.zi = 1.0f / fmaxf(p.z, 1e-6f);
  const float u = k.fx * p.x * p.zi + k.cx;
  const float v = k.fy * p.y * p.zi + k.cy;
  p.has_ur = ur_obs >= 0.0f;
  p.ru = u - u_obs;
  p.rv = v - v_obs;
  p.rw = p.has_ur ? (u - k.bf * p.zi) - ur_obs : 0.0f;
  p.chi2 = (p.ru * p.ru + p.rv * p.rv + p.rw * p.rw) * inv_s2;
  p.chi2_out = p.behind ? 1e9f : p.chi2;
  return p;
}

__device__ __forceinline__ void load_pose(const float* __restrict__ poses, int c, float (&R)[9],
                                          float (&t)[3]) {
  const float* T = poses + c * 16;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = T[i * 4 + j];
    t[i] = T[i * 4 + 3];
  }
}

// This block's chunk of a camera's N observations: [lo, hi) for cluster
// rank r of S, r N / S rounded down at both ends (empty only when N < S).
__device__ __forceinline__ void chunk(int N, unsigned r, unsigned S, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<int64_t>(r) * N / S);
  hi = static_cast<int>(static_cast<int64_t>(r + 1) * N / S);
}

// One step of the reduce-scatter: lanes that differ in bit W swap halves
// of a[0..2W) and each adds its partner's copy of the half it keeps.
template <int W>
__device__ __forceinline__ void scatter_step(float (&a)[32], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float keep = upper ? a[W + i] : a[i];
    const float send = upper ? a[i] : a[W + i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Sums v[0..K) over the warp into s_warp[k] (K <= 32), each by the tree of
// a shuffle-down reduction (lane l + lane l + 16, then + 8, ...).  For
// K > 1 as a reduce-scatter: at each of the five steps a lane keeps half of
// its values and adds its partner's copy of that half (xor 16, 8, 4, 2,
// 1), 31 shuffles instead of 5 K, after which lane l holds the sum of value
// l.  The pairs are the shuffle-down tree's and a + b == b + a, so the
// sums are the same bits.
template <int K>
__device__ __forceinline__ void warp_sums(float (&v)[K], float* s_warp) {
  const int lane = threadIdx.x & 31;
  if constexpr (K == 1) {
    float s = v[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) s_warp[0] = s;
  } else {
    static_assert(K <= 32, "one value a lane");
    float a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a[i] = i < K ? v[i] : 0.0f;
    scatter_step<16>(a, lane);
    scatter_step<8>(a, lane);
    scatter_step<4>(a, lane);
    scatter_step<2>(a, lane);
    scatter_step<1>(a, lane);
    if (lane < K) s_warp[lane] = a[0];
  }
}

// Shared-memory address of p, as PTX's .shared state space takes it.
__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address in the cluster's shared-memory window of the same variable
// in the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t smem_of_rank(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem(p)), "r"(rank));
  return out;
}

// The exchange of per-block totals, through the first block's (rank 0)
// shared memory: part[MAX_SPLIT][K] and an mbarrier that completes when the
// S - 1 other blocks' totals have arrived.  Every thread of every block
// calls begin() first and publish() after its observations.
template <int K>
struct ClusterSum {
  float part[MAX_SPLIT * K];
  float warp[(THREADS / 32) * K];
  alignas(8) uint64_t full;

  // The first block sets up the mbarrier to expect (S - 1) K floats; the
  // release fence and the cluster arrive publish it; publish() waits for
  // the arrive of every block before writing to the first block.
  __device__ __forceinline__ void begin(uint32_t rank, uint32_t S) {
    if (rank == 0 && threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(&full)) : "memory");
      asm volatile(
          "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
          ::"r"(smem(&full)), "r"(static_cast<uint32_t>((S - 1) * K * sizeof(float)))
          : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  // Sums v[0..K) over the cluster in a fixed order: a shuffle tree inside
  // each warp (warp_sums), the warps in order, then the blocks in rank
  // order.  Each block's threads k < K send its totals to row `rank` of
  // the first block's part with st.async, which counts the bytes on the
  // first block's mbarrier; the first block's threads k < K wait for it
  // (acquire, cluster scope) and return the camera's sum k.  The other
  // blocks return 0 and may exit: no block reads their shared memory, and
  // the first block outlives every store to its own.
  __device__ __forceinline__ float publish(float (&v)[K], uint32_t rank, uint32_t S) {
    warp_sums<K>(v, warp + (threadIdx.x >> 5) * K);
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (threadIdx.x >= K) return 0.0f;
    float total = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) total += warp[w * K + threadIdx.x];
    if (rank != 0) {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
          ::"r"(smem_of_rank(&part[rank * K + threadIdx.x], 0)), "r"(__float_as_uint(total)),
          "r"(smem_of_rank(&full, 0))
          : "memory");
      return 0.0f;
    }
    part[threadIdx.x] = total;
    asm volatile(
        "{\n .reg .pred done;\n WAIT:\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], 0;\n"
        " @!done bra WAIT;\n}\n" ::"r"(smem(&full))
        : "memory");
    float s = 0.0f;
    for (uint32_t r = 0; r < S; ++r) s += part[r * K + threadIdx.x];
    return s;
  }
};

__global__ void __launch_bounds__(THREADS)
ba_normal_equations_kernel(const float* __restrict__ poses, const float* __restrict__ X,
                           const float* __restrict__ uv, const float* __restrict__ ur,
                           const float* __restrict__ inv_s2, const uint8_t* __restrict__ mask,
                           float* __restrict__ out_obs, float* __restrict__ out_H,
                           float* __restrict__ out_b, float* __restrict__ out_chi2, int N,
                           Intrinsics k, int robust) {
  __shared__ ClusterSum<N_CAM_SUMS> sum;
  const uint32_t rank = cg::this_cluster().block_rank(), S = cg::this_cluster().num_blocks();
  sum.begin(rank, S);
  const int c = blockIdx.y;
  int lo, hi;
  chunk(N, rank, S, lo, hi);
  float R[9], t[3];
  load_pose(poses, c, R, t);
  const float* Xc = X + static_cast<int64_t>(c) * 3 * N;
  const float* uvc = uv + static_cast<int64_t>(c) * 2 * N;
  float* oc = out_obs + static_cast<int64_t>(c) * N_OBS_ROWS * N;
  const int64_t cn = static_cast<int64_t>(c) * N;

  float acc[N_CAM_SUMS];
#pragma unroll
  for (int i = 0; i < N_CAM_SUMS; ++i) acc[i] = 0.0f;

  // Threads past the chunk's end add nothing and go on to the barriers.
  for (int n = lo + threadIdx.x; n < hi; n += THREADS) {
    const float is2 = inv_s2[cn + n];
    const float m = mask[cn + n] ? 1.0f : 0.0f;
    const Projection p = project(R, t, Xc[n], Xc[N + n], Xc[2 * N + n], uvc[n], uvc[N + n],
                                 ur[cn + n], is2, k);
    const float zi2 = p.zi * p.zi;
    float w = is2 * m * (p.behind ? 0.0f : 1.0f);
    if (robust) {
      const float delta = sqrtf(p.has_ur ? CHI2_STEREO : CHI2_MONO);
      const float rn = sqrtf(p.chi2 + 1e-12f);
      w = w * fminf(1.0f, delta / fmaxf(rn, 1e-12f));
    }
    // Rows of the projection Jacobian (vs the camera-frame point): u-row
    // [a0, 0, a2], v-row [0, b1, b2], stereo row [c0, 0, c2] (0 if mono).
    const float a0 = k.fx * p.zi;
    const float a2 = -k.fx * p.x * zi2;
    const float b1 = k.fy * p.zi;
    const float b2 = -k.fy * p.y * zi2;
    const float hw = p.has_ur ? 1.0f : 0.0f;
    const float c0 = a0 * hw;
    const float c2 = (-k.fx * p.x + k.bf) * zi2 * hw;
    // Camera side: J_proj [I3 | -hat(pc)] (translation first).
    const float Ju[6] = {a0, 0.0f, a2, a2 * p.y, a0 * p.z - a2 * p.x, -a0 * p.y};
    const float Jv[6] = {0.0f, b1, b2, -b1 * p.z + b2 * p.y, -b2 * p.x, b1 * p.x};
    const float Jw[6] = {c0, 0.0f, c2, c2 * p.y, c0 * p.z - c2 * p.x, -c0 * p.y};
    // Point side: J_proj R.
    float Pu[3], Pv[3], Pw[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      Pu[q] = a0 * R[q] + a2 * R[6 + q];
      Pv[q] = b1 * R[3 + q] + b2 * R[6 + q];
      Pw[q] = c0 * R[q] + c2 * R[6 + q];
    }

    int row = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = i; j < 3; ++j) {
        oc[row++ * N + n] = w * (Pu[i] * Pu[j] + Pv[i] * Pv[j] + Pw[i] * Pw[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) oc[row++ * N + n] = w * (Pu[i] * p.ru + Pv[i] * p.rv + Pw[i] * p.rw);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        oc[row++ * N + n] = w * (Ju[i] * Pu[j] + Jv[i] * Pv[j] + Jw[i] * Pw[j]);
      }
    }
    oc[27 * N + n] = p.chi2_out;
    oc[28 * N + n] = w;
    oc[29 * N + n] = 0.0f;
    oc[30 * N + n] = 0.0f;
    oc[31 * N + n] = 0.0f;

    int s = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) acc[s++] += w * (Ju[i] * Ju[j] + Jv[i] * Jv[j] + Jw[i] * Jw[j]);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[s++] += w * (Ju[i] * p.ru + Jv[i] * p.rv + Jw[i] * p.rw);
    acc[s] += m * p.chi2_out;
  }

  const float total = sum.publish(acc, rank, S);
  const int q = threadIdx.x;
  if (rank != 0 || q >= N_CAM_SUMS) return;
  if (q < 21) {  // H_cc (i, j) and (j, i), upper triangle row-major
    int i = 0, j = q;
    while (j >= 6 - i) j -= 6 - i++;
    j += i;
    out_H[c * 36 + i * 6 + j] = total;
    out_H[c * 36 + j * 6 + i] = total;
  } else if (q < 27) {
    out_b[c * 6 + (q - 21)] = total;
  } else {
    out_chi2[c] = total;
  }
}

__global__ void __launch_bounds__(THREADS)
ba_chi2_kernel(const float* __restrict__ poses, const float* __restrict__ X,
               const float* __restrict__ uv, const float* __restrict__ ur,
               const float* __restrict__ inv_s2, const uint8_t* __restrict__ mask,
               float* __restrict__ out_obs, float* __restrict__ out_sum, int N, Intrinsics k) {
  __shared__ ClusterSum<1> sum;
  const uint32_t rank = cg::this_cluster().block_rank(), S = cg::this_cluster().num_blocks();
  sum.begin(rank, S);
  const int c = blockIdx.y;
  int lo, hi;
  chunk(N, rank, S, lo, hi);
  float R[9], t[3];
  load_pose(poses, c, R, t);
  const float* Xc = X + static_cast<int64_t>(c) * 3 * N;
  const float* uvc = uv + static_cast<int64_t>(c) * 2 * N;
  const int64_t cn = static_cast<int64_t>(c) * N;

  float acc[1] = {0.0f};
  for (int n = lo + threadIdx.x; n < hi; n += THREADS) {
    const Projection p = project(R, t, Xc[n], Xc[N + n], Xc[2 * N + n], uvc[n], uvc[N + n],
                                 ur[cn + n], inv_s2[cn + n], k);
    out_obs[cn + n] = p.chi2_out;
    acc[0] += (mask[cn + n] ? 1.0f : 0.0f) * p.chi2_out;
  }
  const float total = sum.publish(acc, rank, S);
  if (rank == 0 && threadIdx.x == 0) out_sum[c] = total;
}

// One launch of a grid of (S, C) blocks in clusters of (S, 1, 1).
template <typename... Params, typename... Args>
cudaError_t launch_split(void (*kernel)(Params...), int S, int C, void* stream, Args... args) {
  if ((S != 1 && S != 2 && S != 4 && S != MAX_SPLIT) || C < 1 || C > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, C, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" int ba_normal_equations_launch(const void* poses, const void* X, const void* uv,
                                          const void* ur, const void* inv_s2, const void* mask,
                                          void* out_obs, void* out_H, void* out_b,
                                          void* out_chi2, int C, int N, int S, float fx,
                                          float fy, float cx, float cy, float bf, int robust,
                                          void* stream) {
  const Intrinsics k{fx, fy, cx, cy, bf};
  return static_cast<int>(launch_split(
      ba_normal_equations_kernel, S, C, stream, static_cast<const float*>(poses),
      static_cast<const float*>(X), static_cast<const float*>(uv), static_cast<const float*>(ur),
      static_cast<const float*>(inv_s2), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out_obs), static_cast<float*>(out_H), static_cast<float*>(out_b),
      static_cast<float*>(out_chi2), N, k, robust));
}

extern "C" int ba_chi2_launch(const void* poses, const void* X, const void* uv, const void* ur,
                              const void* inv_s2, const void* mask, void* out_obs,
                              void* out_sum, int C, int N, int S, float fx, float fy, float cx,
                              float cy, float bf, void* stream) {
  const Intrinsics k{fx, fy, cx, cy, bf};
  return static_cast<int>(launch_split(
      ba_chi2_kernel, S, C, stream, static_cast<const float*>(poses),
      static_cast<const float*>(X), static_cast<const float*>(uv), static_cast<const float*>(ur),
      static_cast<const float*>(inv_s2), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out_obs), static_cast<float*>(out_sum), N, k));
}
