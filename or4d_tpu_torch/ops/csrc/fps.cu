// Furthest point sampling, with optional per-chunk ball-query hit counts.
//
// Replaces the TPU kernels `furthest_point_sample_pallas` and
// `furthest_point_sample_with_counts` (or4d_tpu/ops/pallas_fps.py:200 and
// :156). Semantics of pallas_fps.py:36-75 and :86-152:
//   * index 0 is selected first;
//   * points with |p|^2 <= 1e-3 start at -1 in the running min-distance, so
//     they never update it past -1 and never win;
//   * running min = min(mind, d2); ties go to the lowest index;
//   * with radii: for the query selected at step j, the number of points
//     with d2 < r^2 in every 512-wide scan-order chunk, per radius — the
//     distances the next step computes anyway, plus one last pass for the
//     final query.
// Distances are rounded like the TPU kernels: (dx*dx + dy*dy) + dz*dz with
// every product and sum rounded on its own (no FMA contraction), so indices
// and counts are bit-exact.
//
// What bounds it on the H100: the npoint steps are sequential; each step is
// one pass over the cloud plus a block-wide argmax, so at the main path's
// shapes (8000 points, 512 steps) it is latency-bound by the two block
// barriers per step, far from both the memory and the FP32 roofline.
// Design: one 512-thread block per cloud (clouds are independent, so the
// grid fills the card at serving batch sizes); the cloud's coordinates and
// running min-distances live in registers (PPT points per thread, point
// i = tid + k*512), so the loop never touches device memory except for the
// selected point's coordinates (an L1 hit). Because the block is 512 wide,
// a thread's k-th point lies in chunk k: per-chunk counts are one warp
// ballot + popcount per (chunk, radius) and a 16-way sum after the barrier
// the argmax needs anyway.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 512;  // == the 512-point chunk width of the counts
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadii = 4;
constexpr int kMaxPPT = 16;    // N <= 8192
constexpr float kMagEps = 1e-3f;

struct Radii {
  float r2[kMaxRadii];
  int n;
};

__device__ __forceinline__ float sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// (d, i) beats (bd, bi): larger distance, ties to the lower index
__device__ __forceinline__ void take_better(float& bd, int& bi, float d, int i) {
  if (d > bd || (d == bd && i < bi)) {
    bd = d;
    bi = i;
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz, int N, int npoint, Radii radii, int nch,
           int* __restrict__ idx_out, float* __restrict__ counts_out, int B) {
  __shared__ float s_d[kWarps];
  __shared__ int s_i[kWarps];
  __shared__ int s_sel;
  __shared__ int s_cnt[kWarps][kMaxRadii * kMaxPPT];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + (size_t)b * N * 3;

  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * kThreads;
    if (i < N) {
      px[k] = p[3 * i];
      py[k] = p[3 * i + 1];
      pz[k] = p[3 * i + 2];
      md[k] = sqdist(px[k], py[k], pz[k]) > kMagEps ? CUDART_INF_F : -1.0f;
    } else {
      px[k] = py[k] = pz[k] = 0.0f;
      md[k] = -CUDART_INF_F;
    }
  }
  if (tid == 0) idx_out[(size_t)b * npoint] = 0;

  const bool with_counts = radii.n > 0;
  const int steps = npoint + (with_counts ? 1 : 0);
  int sel = 0;
  for (int j = 1; j < steps; ++j) {
    const bool last = j == npoint;  // counts only, for the final query
    const float sx = p[3 * sel], sy = p[3 * sel + 1], sz = p[3 * sel + 2];
    float bd = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * kThreads;
      const bool in = i < N;
      const float d2 = sqdist(px[k] - sx, py[k] - sy, pz[k] - sz);
      if (with_counts && k < nch) {
        for (int s = 0; s < radii.n; ++s) {
          const unsigned m = __ballot_sync(0xffffffffu, in && d2 < radii.r2[s]);
          if (lane == 0) s_cnt[warp][s * nch + k] = __popc(m);
        }
      }
      if (in && !last) {
        md[k] = fminf(md[k], d2);
        take_better(bd, bi, md[k], i);
      }
    }
    if (!last) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        take_better(bd, bi, od, oi);
      }
      if (lane == 0) {
        s_d[warp] = bd;
        s_i[warp] = bi;
      }
    }
    __syncthreads();
    if (with_counts && tid < radii.n * nch) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += s_cnt[w][tid];
      const int s = tid / nch, k = tid % nch;
      counts_out[(((size_t)s * B + b) * npoint + (j - 1)) * nch + k] = (float)c;
    }
    if (last) break;
    if (warp == 0) {
      bd = lane < kWarps ? s_d[lane] : -CUDART_INF_F;
      bi = lane < kWarps ? s_i[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        take_better(bd, bi, od, oi);
      }
      if (lane == 0) {
        s_sel = bi;
        idx_out[(size_t)b * npoint + j] = bi;
      }
    }
    __syncthreads();
    sel = s_sel;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int B, int N, int npoint, Radii radii, int* idx, float* counts,
                   cudaStream_t stream) {
  const int nch = (N + kThreads - 1) / kThreads;
  fps_kernel<PPT><<<B, kThreads, 0, stream>>>(xyz, N, npoint, radii, nch, idx, counts, B);
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) f32 -> idx (B, npoint) i32 and, when nradii > 0, counts
// (nradii, B, npoint, ceil(N/512)) f32. r2: host array of nradii squared
// radii, already rounded to f32. Returns the CUDA error of the launch.
extern "C" int or4d_fps(const float* xyz, int B, int N, int npoint, int nradii, const float* r2,
                        int* idx, float* counts, void* stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || N > kThreads * kMaxPPT || nradii < 0 || nradii > kMaxRadii ||
      (nradii > 0 && counts == nullptr))
    return (int)cudaErrorInvalidValue;
  Radii radii{};
  radii.n = nradii;
  for (int s = 0; s < nradii; ++s) radii.r2[s] = r2[s];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= kThreads) err = launch<1>(xyz, B, N, npoint, radii, idx, counts, st);
  else if (N <= 2 * kThreads) err = launch<2>(xyz, B, N, npoint, radii, idx, counts, st);
  else if (N <= 4 * kThreads) err = launch<4>(xyz, B, N, npoint, radii, idx, counts, st);
  else if (N <= 8 * kThreads) err = launch<8>(xyz, B, N, npoint, radii, idx, counts, st);
  else err = launch<16>(xyz, B, N, npoint, radii, idx, counts, st);
  return (int)err;
}
