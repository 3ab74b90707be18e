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
// What bounds them on an H100: memory.  Per observation K4 reads 29 bytes
// (7 float32 + a bool) and writes 128; at C = 48, N = 1024 that is 7.7 MB,
// about 2.3 us at 3.35 TB/s, against some 450 float32 adds and multiplies
// per observation (22 M, 0.7 us at 128 per SM and clock, CUDA C++
// Programming Guide, compute capability 9.0).  K5 writes 4 bytes per
// observation.
//
// Design: one block per camera (the TPU kernel's grid step), 256 threads
// striding over N, so neighbouring threads read and write neighbouring
// addresses of every N-minor row.  Each thread keeps its camera partial
// sums in registers; the block reduces them in a fixed order (a shuffle
// tree inside each warp, then the warps in order through shared memory),
// so the result is the same from run to run.  No atomics.  Built without
// fast-math: division and square root are IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
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

// Sums v[0..K) over the block into tot[0..K) (shared memory), in a fixed
// order.  Every thread of the block must call it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* s_warp, float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) s_warp[warp * K + k] = s;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += s_warp[w * K + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
ba_normal_equations_kernel(const float* __restrict__ poses, const float* __restrict__ X,
                           const float* __restrict__ uv, const float* __restrict__ ur,
                           const float* __restrict__ inv_s2, const uint8_t* __restrict__ mask,
                           float* __restrict__ out_obs, float* __restrict__ out_H,
                           float* __restrict__ out_b, float* __restrict__ out_chi2, int N,
                           Intrinsics k, int robust) {
  __shared__ float s_warp[WARPS * N_CAM_SUMS];
  __shared__ float s_tot[N_CAM_SUMS];
  const int c = blockIdx.x;
  float R[9], t[3];
  load_pose(poses, c, R, t);
  const float* Xc = X + static_cast<int64_t>(c) * 3 * N;
  const float* uvc = uv + static_cast<int64_t>(c) * 2 * N;
  float* oc = out_obs + static_cast<int64_t>(c) * N_OBS_ROWS * N;
  const int64_t cn = static_cast<int64_t>(c) * N;

  float acc[N_CAM_SUMS];
#pragma unroll
  for (int i = 0; i < N_CAM_SUMS; ++i) acc[i] = 0.0f;

  for (int n = threadIdx.x; n < N; n += THREADS) {
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

  block_sum<N_CAM_SUMS>(acc, s_warp, s_tot);
  const int tid = threadIdx.x;
  if (tid < 36) {
    const int i = min(tid / 6, tid % 6), j = max(tid / 6, tid % 6);
    out_H[c * 36 + tid] = s_tot[i * 6 - i * (i - 1) / 2 + (j - i)];
  } else if (tid < 42) {
    out_b[c * 6 + (tid - 36)] = s_tot[21 + (tid - 36)];
  } else if (tid == 42) {
    out_chi2[c] = s_tot[27];
  }
}

__global__ void __launch_bounds__(THREADS)
ba_chi2_kernel(const float* __restrict__ poses, const float* __restrict__ X,
               const float* __restrict__ uv, const float* __restrict__ ur,
               const float* __restrict__ inv_s2, const uint8_t* __restrict__ mask,
               float* __restrict__ out_obs, float* __restrict__ out_sum, int N, Intrinsics k) {
  __shared__ float s_warp[WARPS];
  __shared__ float s_tot[1];
  const int c = blockIdx.x;
  float R[9], t[3];
  load_pose(poses, c, R, t);
  const float* Xc = X + static_cast<int64_t>(c) * 3 * N;
  const float* uvc = uv + static_cast<int64_t>(c) * 2 * N;
  const int64_t cn = static_cast<int64_t>(c) * N;

  float acc[1] = {0.0f};
  for (int n = threadIdx.x; n < N; n += THREADS) {
    const Projection p = project(R, t, Xc[n], Xc[N + n], Xc[2 * N + n], uvc[n], uvc[N + n],
                                 ur[cn + n], inv_s2[cn + n], k);
    out_obs[cn + n] = p.chi2_out;
    acc[0] += (mask[cn + n] ? 1.0f : 0.0f) * p.chi2_out;
  }
  block_sum<1>(acc, s_warp, s_tot);
  if (threadIdx.x == 0) out_sum[c] = s_tot[0];
}

}  // namespace

extern "C" int ba_normal_equations_launch(const void* poses, const void* X, const void* uv,
                                          const void* ur, const void* inv_s2, const void* mask,
                                          void* out_obs, void* out_H, void* out_b,
                                          void* out_chi2, int C, int N, float fx, float fy,
                                          float cx, float cy, float bf, int robust,
                                          void* stream) {
  const Intrinsics k{fx, fy, cx, cy, bf};
  ba_normal_equations_kernel<<<C, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(poses), static_cast<const float*>(X),
      static_cast<const float*>(uv), static_cast<const float*>(ur),
      static_cast<const float*>(inv_s2), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out_obs), static_cast<float*>(out_H), static_cast<float*>(out_b),
      static_cast<float*>(out_chi2), N, k, robust);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ba_chi2_launch(const void* poses, const void* X, const void* uv, const void* ur,
                              const void* inv_s2, const void* mask, void* out_obs,
                              void* out_sum, int C, int N, float fx, float fy, float cx,
                              float cy, float bf, void* stream) {
  const Intrinsics k{fx, fy, cx, cy, bf};
  ba_chi2_kernel<<<C, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(poses), static_cast<const float*>(X),
      static_cast<const float*>(uv), static_cast<const float*>(ur),
      static_cast<const float*>(inv_s2), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out_obs), static_cast<float*>(out_sum), N, k);
  return static_cast<int>(cudaGetLastError());
}
