// Bounds pre-pass: per query and (radius, nsample) scale, the number of
// support points within the radius (`total`) and the number of 512-point
// scan-order chunks that hold its first min(nsample, total) hits (`need`; 1
// for a query with no hit), both float32.
//
// Replaces the TPU kernel `ball_query_bounds_pallas`
// (or4d_tpu/ops/pallas_ball_query.py:498; kernel `_make_bounds_kernel` :425,
// pallas_call :534), whose arithmetic for need is :481-492: with the
// inclusive per-chunk cumulative counts cum_c and thr = min(nsample, total),
// need = #{c : cum_c < thr} + 1. Online, that is the chunk (1-based) where
// the running count first reaches nsample; when total < nsample, the last
// chunk with a hit; 1 when total == 0.
//
// Distances are the port's direct difference, (dx*dx + dy*dy) + dz*dz with
// every operation rounded on its own (no FMA contraction) and r2 the f32 of
// r*r from the host, as in the FPS kernel's counts (fps.cu); so on FPS
// centroids `need` equals the need that counts_to_bounds derives from the FPS
// kernel's counts, and `total` their sum. The TPU kernel's MXU norm
// expansion, its poison padding and its Hillis-Steele prefix over chunks are
// TPU speed devices and are not carried over.
//
// What bounds it on the H100, and the design: no early stop is possible
// (`total` needs every point), so it is a distance-and-count pass over
// B*M*N query-point pairs at about 8 + 2*scales FP32-pipe operations each;
// the bytes (the points once, the queries once, 2 floats per query and scale
// out) are small beside them. One thread per query, 128 queries of one cloud
// per block; each 512-point chunk of the cloud is staged in shared memory as
// float4 (8 KB), so a point costs every thread one broadcast 16-byte shared
// load; per scale the thread keeps its running count, the chunk that reached
// nsample and the last chunk with a hit in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;
constexpr int kThreads = 128;
constexpr int kMaxScales = 4;

struct Scales {
  float r2[kMaxScales];
  int ns[kMaxScales];
};

__device__ __forceinline__ float sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// out (S, 2, B, M): [s][0] need, [s][1] total
template <int S>
__global__ void __launch_bounds__(kThreads)
bounds_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz, int B, int N, int M, Scales sc,
              float* __restrict__ out) {
  __shared__ float4 s_p[kChunk];
  const int tiles = (M + kThreads - 1) / kThreads;
  const int b = blockIdx.x / tiles;
  const int q = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  const bool active = q < M;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* qp = new_xyz + ((size_t)b * M + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  int cnt[S], full[S], last[S];
#pragma unroll
  for (int s = 0; s < S; ++s) cnt[s] = 0, full[s] = -1, last[s] = -1;

  const float* p = xyz + (size_t)b * N * 3;
  const int nch = (N + kChunk - 1) / kChunk;
  for (int ch = 0; ch < nch; ++ch) {
    const int n0 = ch * kChunk;
    const int len = min(kChunk, N - n0);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float* pi = p + (size_t)(n0 + i) * 3;
      s_p[i] = make_float4(pi[0], pi[1], pi[2], 0.0f);
    }
    __syncthreads();
    int c[S];
#pragma unroll
    for (int s = 0; s < S; ++s) c[s] = 0;
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      const float4 v = s_p[i];
      const float d2 = sqdist(qx - v.x, qy - v.y, qz - v.z);
#pragma unroll
      for (int s = 0; s < S; ++s) c[s] += d2 < sc.r2[s] ? 1 : 0;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (c[s] > 0) last[s] = ch;
      cnt[s] += c[s];
      if (full[s] < 0 && cnt[s] >= sc.ns[s]) full[s] = ch;
    }
  }
  if (!active) return;
  const size_t plane = (size_t)B * M, at = (size_t)b * M + q;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int need = full[s] >= 0 ? full[s] + 1 : (last[s] >= 0 ? last[s] + 1 : 1);
    out[(2 * s) * plane + at] = (float)need;
    out[(2 * s + 1) * plane + at] = (float)cnt[s];
  }
}

template <int S>
cudaError_t launch(const float* xyz, const float* new_xyz, int B, int N, int M, const Scales& sc, float* out,
                   cudaStream_t stream) {
  const long long blocks = (long long)((M + kThreads - 1) / kThreads) * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bounds_kernel<S><<<(unsigned)blocks, kThreads, 0, stream>>>(xyz, new_xyz, B, N, M, sc, out);
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3), new_xyz (B, M, 3) float32; r2 and ns: S <= 4 scales (r2 the
// f32 of r*r, ns >= 1). Writes out (S, 2, B, M) float32: need, total per
// scale. Returns the CUDA error of the launch.
extern "C" int or4d_ball_query_bounds(const float* xyz, const float* new_xyz, int B, int N, int M, int S,
                                      const float* r2, const int* ns, float* out, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || S <= 0 || S > kMaxScales) return (int)cudaErrorInvalidValue;
  Scales sc{};
  for (int s = 0; s < S; ++s) {
    if (ns[s] < 1) return (int)cudaErrorInvalidValue;
    sc.r2[s] = r2[s];
    sc.ns[s] = ns[s];
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return (int)launch<1>(xyz, new_xyz, B, N, M, sc, out, st);
    case 2: return (int)launch<2>(xyz, new_xyz, B, N, M, sc, out, st);
    case 3: return (int)launch<3>(xyz, new_xyz, B, N, M, sc, out, st);
    default: return (int)launch<4>(xyz, new_xyz, B, N, M, sc, out, st);
  }
}
