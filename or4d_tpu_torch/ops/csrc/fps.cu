// Furthest point sampling, with optional per-chunk ball-query hit counts, or
// with the search bound those counts give.
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
// With bounds (the main path), the counts never leave the kernel: per radius
// and query it writes need = #{chunks whose running count is below thr} + 1,
// thr = min(nsample, total), which is `counts_to_bounds`
// (or4d_tpu/ops/pallas_ball_query.py:587-602) on the same integer counts.
// Distances are rounded like the TPU kernels: (dx*dx + dy*dy) + dz*dz with
// every product and sum rounded on its own (no FMA contraction), so indices,
// counts and bounds are bit-exact.
//
// What bounds it on the H100: the npoint steps are sequential; each step is
// one pass over the cloud (8 rounded operations per distance, a min, an
// argmax compare and a compare and add per radius) plus a block-wide argmax,
// so it is issue- and latency-bound, far from both the memory and the FP32
// roofline. Design:
//  - One block per cloud, one warp per 512-point chunk (16 points a lane:
//    lane l of warp w owns points w*512 + l + 32k). The cloud is staged in
//    shared memory (padded to whole chunks with +inf: never a hit, never
//    selected) and read there every step, three conflict-free loads a
//    point; the running min-distances live in registers. About 60
//    registers a thread let two 8000-point clouds share an SM, so one
//    block's barrier and reductions overlap the other's distance pass
//    (with the coordinates in registers too, ~100 registers held one block
//    per SM, and each step's serial tail left the SM idle).
//  - Counts: a lane counts its hits per radius in an integer; one
//    `redux.sync` add per radius gives the warp's chunk count. No ballots
//    and no shared memory per point.
//  - Argmax: the distance as an order-preserving integer key; `redux.sync`
//    max of the keys, then min of the indices holding it (lowest-index
//    ties), per warp and then across the warps.
//  - One block barrier per step: the per-warp candidates (and, with bounds,
//    chunk counts) are double-buffered by step parity, and every warp
//    reduces the candidates itself. The winner's coordinates come from the
//    staged cloud, not from device memory.
//  - Bounds: after the barrier one warp (rotating with the step) scans the
//    chunk counts per radius with shuffles and writes need (int32).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kChunk = 512;    // the chunk width of the counts, one warp's points
constexpr int kPPT = kChunk / 32;
constexpr int kMaxWarps = 16;  // N <= 8192
constexpr int kMaxRadii = 4;
constexpr float kMagEps = 1e-3f;

struct Radii {
  float r2[kMaxRadii];
  int ns[kMaxRadii];
  int* need[kMaxRadii];  // with bounds: per radius (B, npoint) int32
};

__device__ __forceinline__ float sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// a float's order as an unsigned integer (no NaN; -0 never occurs here)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// NR radii; BOUNDS: need per radius (radii.need), else counts (NR, B,
// npoint, nch) f32 when NR > 0
template <int NR, bool BOUNDS>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
fps_kernel(const float* __restrict__ xyz, int N, int npoint, Radii radii, int* __restrict__ idx_out,
           float* __restrict__ counts_out, int B) {
  extern __shared__ float s_xyz[];  // the cloud, (nw * 512, 3), +inf past N
  __shared__ unsigned s_key[2][kMaxWarps];
  __shared__ int s_idx[2][kMaxWarps];
  __shared__ int s_cnt[2][NR > 0 ? NR : 1][kMaxWarps];

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;  // == the number of chunks
  const float* p = xyz + (size_t)b * N * 3;
  for (int i = tid; i < 3 * nw * kChunk; i += blockDim.x) s_xyz[i] = i < 3 * N ? p[i] : CUDART_INF_F;
  __syncthreads();

  const int base = warp * kChunk + lane;
  float md[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int i = base + 32 * k;
    md[k] = i < N ? (sqdist(s_xyz[3 * i], s_xyz[3 * i + 1], s_xyz[3 * i + 2]) > kMagEps ? CUDART_INF_F : -1.0f)
                  : -CUDART_INF_F;
  }
  if (tid == 0) idx_out[(size_t)b * npoint] = 0;

  float sx = s_xyz[0], sy = s_xyz[1], sz = s_xyz[2];
  const int steps = npoint + (NR > 0 ? 1 : 0);
  for (int j = 1; j < steps; ++j) {
    const int par = j & 1;
    const bool last = j == npoint;  // counts only, for the final query
    float bd = -CUDART_INF_F;
    int bk = 0;
    int cnt[NR > 0 ? NR : 1];
#pragma unroll
    for (int s = 0; s < NR; ++s) cnt[s] = 0;
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int i = base + 32 * k;
      const float d2 = sqdist(s_xyz[3 * i] - sx, s_xyz[3 * i + 1] - sy, s_xyz[3 * i + 2] - sz);
#pragma unroll
      for (int s = 0; s < NR; ++s) cnt[s] += d2 < radii.r2[s] ? 1 : 0;
      md[k] = fminf(md[k], d2);
      if (md[k] > bd) {  // a lane's points rise with k: the first maximum is the lowest index
        bd = md[k];
        bk = k;
      }
    }
    // query j-1's hits in this warp's chunk, per radius
    int cw[NR > 0 ? NR : 1];
#pragma unroll
    for (int s = 0; s < NR; ++s) cw[s] = __reduce_add_sync(0xffffffffu, cnt[s]);
    if (!BOUNDS && NR > 0 && lane == 0) {
      const int nch = nw;
#pragma unroll
      for (int s = 0; s < NR; ++s)
        counts_out[(((size_t)s * B + b) * npoint + (j - 1)) * nch + warp] = (float)cw[s];
    }
    if (!BOUNDS && last) break;

    // this warp's candidate: the largest running distance, lowest index
    const unsigned key = order_key(bd);
    const unsigned kmax = __reduce_max_sync(0xffffffffu, key);
    const int imin = __reduce_min_sync(0xffffffffu, key == kmax ? base + 32 * bk : 0x7fffffff);
    if (lane == 0) {
      s_key[par][warp] = kmax;
      s_idx[par][warp] = imin;
#pragma unroll
      for (int s = 0; s < NR; ++s) s_cnt[par][s][warp] = cw[s];
    }
    __syncthreads();

    if (BOUNDS && warp == j % nw) {
      // per radius: inclusive scan of the chunk counts, thr = min(ns,
      // total), need = chunks with a running count below thr, plus one
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        int v = lane < nw ? s_cnt[par][s][lane] : 0;
#pragma unroll
        for (int off = 1; off < kMaxWarps; off <<= 1) {
          const int n = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += n;
        }
        const int total = __shfl_sync(0xffffffffu, v, nw - 1);
        const int thr = min(radii.ns[s], total);
        const unsigned below = __ballot_sync(0xffffffffu, lane < nw && v < thr);
        if (lane == 0) radii.need[s][(size_t)b * npoint + (j - 1)] = __popc(below) + 1;
      }
    }
    if (last) break;

    // the block's winner, reduced by every warp from the candidates
    const unsigned ck = lane < nw ? s_key[par][lane] : 0u;
    const int ci = lane < nw ? s_idx[par][lane] : 0x7fffffff;
    const unsigned bmax = __reduce_max_sync(0xffffffffu, ck);
    const int sel = __reduce_min_sync(0xffffffffu, ck == bmax ? ci : 0x7fffffff);
    if (tid == 0) idx_out[(size_t)b * npoint + j] = sel;
    sx = s_xyz[3 * sel];
    sy = s_xyz[3 * sel + 1];
    sz = s_xyz[3 * sel + 2];
  }
}

template <int NR, bool BOUNDS>
cudaError_t launch(const float* xyz, int B, int N, int npoint, const Radii& radii, int* idx, float* counts,
                   cudaStream_t stream) {
  const int nw = (N + kChunk - 1) / kChunk;
  const size_t smem = (size_t)nw * kChunk * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<NR, BOUNDS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<NR, BOUNDS><<<B, nw * 32, smem, stream>>>(xyz, N, npoint, radii, idx, counts, B);
  return cudaGetLastError();
}

template <bool BOUNDS>
cudaError_t launch_nr(int nradii, const float* xyz, int B, int N, int npoint, const Radii& radii, int* idx,
                      float* counts, cudaStream_t stream) {
  switch (nradii) {
    case 1: return launch<1, BOUNDS>(xyz, B, N, npoint, radii, idx, counts, stream);
    case 2: return launch<2, BOUNDS>(xyz, B, N, npoint, radii, idx, counts, stream);
    case 3: return launch<3, BOUNDS>(xyz, B, N, npoint, radii, idx, counts, stream);
    default: return launch<4, BOUNDS>(xyz, B, N, npoint, radii, idx, counts, stream);
  }
}

}  // namespace

// xyz (B, N, 3) f32 -> idx (B, npoint) i32 and, when nradii > 0, either
// counts (nradii, B, npoint, ceil(N/512)) f32 or, with need != null, the
// search bounds: need is a host array of nradii device pointers, each to a
// (B, npoint) i32 output (counts null). r2: host array of nradii squared
// radii, already rounded to f32; ns: host array of their nsamples (read
// with need only). Returns the CUDA error of the launch.
extern "C" int or4d_fps(const float* xyz, int B, int N, int npoint, int nradii, const float* r2, const int* ns,
                        int* idx, float* counts, int* const* need, void* stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || N > kChunk * kMaxWarps || nradii < 0 || nradii > kMaxRadii ||
      (nradii > 0) != (counts != nullptr || need != nullptr) || (counts != nullptr && need != nullptr))
    return (int)cudaErrorInvalidValue;
  Radii radii{};
  for (int s = 0; s < nradii; ++s) {
    radii.r2[s] = r2[s];
    if (need != nullptr) {
      if (need[s] == nullptr) return (int)cudaErrorInvalidValue;
      radii.ns[s] = ns[s];
      radii.need[s] = need[s];
    }
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (nradii == 0) return (int)launch<0, false>(xyz, B, N, npoint, radii, idx, nullptr, st);
  if (need != nullptr) return (int)launch_nr<true>(nradii, xyz, B, N, npoint, radii, idx, nullptr, st);
  return (int)launch_nr<false>(nradii, xyz, B, N, npoint, radii, idx, counts, st);
}
