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
// chunk with a hit; 1 when total == 0. So at the end of chunk c a scale
// whose count was below nsample and rose in c sets need = c + 1.
//
// Distances are the port's direct difference, (dx*dx + dy*dy) + dz*dz with
// every operation rounded on its own (no FMA contraction) and r2 the f32 of
// r*r from the host, as in the FPS kernel's counts (fps.cu); so on FPS
// centroids `need` equals the need that counts_to_bounds derives from the FPS
// kernel's counts, and `total` their sum. The TPU kernel's MXU norm
// expansion, its poison padding and its Hillis-Steele prefix over chunks are
// TPU speed devices and are not carried over.
//
// What bounds it on the H100: instruction issue. No early stop is possible
// (`total` needs every point), so it is a distance-and-count pass over
// B*M*N query-point pairs; the bytes (the points once, the queries once, 2
// floats per query and scale out) are small beside them. A pair needs 8
// rounded FP32 operations (3 sub, 3 mul, 2 add: no FMA may fuse them) and,
// per scale, a hit test and a count: 8 + 2*S instructions at one warp
// instruction a clock on each of the 528 SM sub-partitions.
//
// Design:
// - Blocks of 128 threads. A thread keeps Q queries (4, 2 or 1) in
//   registers, with per scale the chunk's count, the running count and
//   `need`; a point is read once a block as a broadcast (four points from
//   three 16-byte shared loads) and serves Q pairs. Per-chunk bookkeeping
//   runs once per 512 points. A smaller Q is for calls too small to give
//   every SM 16 warps at a larger one.
// - The hit test and the count are two instructions a scale: the sign bit
//   of __fsub_rn(d2, r2), added to the count (FADD on the FP32 pipe, LEA.HI
//   on the integer pipe). For finite d2, r2 >= 0 the sign is d2 < r2 exactly:
//   a nonzero difference never rounds to zero (gradual underflow), and
//   d2 == r2 gives +0; d2 = inf gives +inf, a NaN the card's canonical
//   positive NaN: no hit, as d2 < r2.
// - The cloud's xyz is staged with `ball_search::stage_points` (16-byte
//   cp.async) in windows of whole 512-point chunks: the whole cloud where the
//   plan's shared memory holds it, else two windows in a ring, the copy of the
//   next one in flight while the current one is counted, one barrier a
//   window. Points past the cloud's end in its last 4-point group are staged
//   as +inf (no hit at any radius).
// - The plan (ops/ball_query_bounds.py `bounds_plan`) picks Q and the
//   window; the launch recomputes its shared memory (`window_smem`) and
//   refuses a plan that disagrees.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ball_search.cuh"

namespace {

constexpr int kChunk = 512;
constexpr int kMaxScales = 4;
constexpr int kThreads = 128;        // threads a block
constexpr int kMinBlocks = 5;        // resident blocks an SM (__launch_bounds__): 96 registers a thread
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can have

struct Scales {
  float r2[kMaxScales];
  int ns[kMaxScales];
};

// The block's dynamic shared memory (ops/ball_query_bounds.py `_window_smem`
// computes the same): one window of `window` points (12 bytes each) where it
// holds the whole cloud, else two.
inline size_t window_smem(int N, int window) {
  return (size_t)(window >= N ? 1 : 2) * 12 * (size_t)window;
}

__device__ __forceinline__ unsigned below(float d2, float r2) {
  return __float_as_uint(__fsub_rn(d2, r2)) >> 31;
}

// Starts staging window w (points [w*window, min(N, (w+1)*window)) of the
// cloud) into buf, with the points past the cloud's end in its last 4-point
// group set to +inf.
__device__ __forceinline__ void stage_window(float* buf, const float* cloud, int N, int window, int w, int tid,
                                             int nthr) {
  const int n0 = w * window, lim = min(window, N - n0);
  ball_search::stage_points(buf, cloud + 3 * (size_t)n0, lim, tid, nthr);
  asm volatile("cp.async.commit_group;\n" ::);
  const int pad = 3 * (((lim + 3) & ~3) - lim);
  if (tid < pad) buf[3 * lim + tid] = __int_as_float(0x7f800000);
}

// out (S, 2, B, M): [s][0] need, [s][1] total. Block: `tiles` blocks a
// cloud, each over T*Q queries (thread t takes queries t, t + T, ...).
template <int S, int Q>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bounds_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz, int B, int N, int M, int tiles,
              int window, Scales sc, float* __restrict__ out) {
  constexpr int kUnroll = 8 / Q;  // 8 points' pairs an iteration
  extern __shared__ __align__(16) float s_buf[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * T * Q + tid;
  const float* cloud = xyz + (size_t)b * N * 3;
  const int nwin = (N + window - 1) / window;

  stage_window(s_buf, cloud, N, window, 0, tid, T);
  float qx[Q], qy[Q], qz[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int q = min(q0 + k * T, M - 1);  // a query past M repeats the last one and is not written
    const float* qp = new_xyz + ((size_t)b * M + q) * 3;
    qx[k] = qp[0];
    qy[k] = qp[1];
    qz[k] = qp[2];
  }
  unsigned c[Q][S];
  int cnt[Q][S], need[Q][S];
#pragma unroll
  for (int k = 0; k < Q; ++k)
#pragma unroll
    for (int s = 0; s < S; ++s) cnt[k][s] = 0, need[k][s] = 1;

  for (int w = 0; w < nwin; ++w) {
    // window w landed, and every thread is done with window w - 1's buffer
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    if (w + 1 < nwin) stage_window(s_buf + ((w + 1) & 1) * 3 * window, cloud, N, window, w + 1, tid, T);
    const float* buf = s_buf + (w & 1) * 3 * window;
    const int n0 = w * window, lim = min(window, N - n0);
    for (int j = 0; j * kChunk < lim; ++j) {
      const float4* v = reinterpret_cast<const float4*>(buf + 3 * j * kChunk);
      const int groups = (min(kChunk, lim - j * kChunk) + 3) >> 2;
#pragma unroll
      for (int k = 0; k < Q; ++k)
#pragma unroll
        for (int s = 0; s < S; ++s) c[k][s] = 0;
#pragma unroll kUnroll
      for (int g = 0; g < groups; ++g) {
        const float4 p0 = v[3 * g], p1 = v[3 * g + 1], p2 = v[3 * g + 2];
        const float px[4] = {p0.x, p0.w, p1.z, p2.y}, py[4] = {p0.y, p1.x, p1.w, p2.z},
                    pz[4] = {p0.z, p1.y, p2.x, p2.w};
#pragma unroll
        for (int k = 0; k < Q; ++k)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float d2 = ball_search::sqdist(qx[k] - px[t], qy[k] - py[t], qz[k] - pz[t]);
#pragma unroll
            for (int s = 0; s < S; ++s) c[k][s] += below(d2, sc.r2[s]);
          }
      }
      const int ch = n0 / kChunk + j;
#pragma unroll
      for (int k = 0; k < Q; ++k)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (cnt[k][s] < sc.ns[s] && c[k][s] > 0) need[k][s] = ch + 1;
          cnt[k][s] += (int)c[k][s];
        }
    }
  }
  const size_t plane = (size_t)B * M;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int q = q0 + k * T;
    if (q >= M) continue;
    const size_t at = (size_t)b * M + q;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      out[(2 * s) * plane + at] = (float)need[k][s];
      out[(2 * s + 1) * plane + at] = (float)cnt[k][s];
    }
  }
}

template <int S, int Q>
cudaError_t launch(const float* xyz, const float* new_xyz, int B, int N, int M, const Scales& sc, float* out,
                   int window, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bounds_kernel<S, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kThreads * Q - 1) / (kThreads * Q);
  const long long blocks = (long long)tiles * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bounds_kernel<S, Q><<<(unsigned)blocks, kThreads, smem, stream>>>(xyz, new_xyz, B, N, M, tiles, window, sc, out);
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3), new_xyz (B, M, 3) float32; r2 and ns: S <= 4 scales (r2 the
// f32 of r*r, ns >= 1). Writes out (S, 2, B, M) float32: need, total per
// scale. queries (per thread), window and smem_bytes are the wrapper's plan
// (`bounds_plan`): queries 1, 2 (or 4 for at most two scales), window a
// multiple of 512 points; a plan whose bytes disagree with `window_smem`, or
// over 227 KB, is refused. Returns the CUDA error of the launch.
extern "C" int or4d_ball_query_bounds(const float* xyz, const float* new_xyz, int B, int N, int M, int S,
                                      const float* r2, const int* ns, float* out, int queries,
                                      int window, long long smem_bytes, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || S <= 0 || S > kMaxScales) return (int)cudaErrorInvalidValue;
  if (!(queries == 1 || queries == 2 || (queries == 4 && S <= 2)) || window <= 0 || window % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = window_smem(N, window);
  if (smem != (size_t)smem_bytes || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  Scales sc{};
  for (int s = 0; s < S; ++s) {
    if (ns[s] < 1) return (int)cudaErrorInvalidValue;
    sc.r2[s] = r2[s];
    sc.ns[s] = ns[s];
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int code = 10 * S + queries;
  switch (code) {
    case 11: return (int)launch<1, 1>(xyz, new_xyz, B, N, M, sc, out, window, smem, st);
    case 12: return (int)launch<1, 2>(xyz, new_xyz, B, N, M, sc, out, window, smem, st);
    case 14: return (int)launch<1, 4>(xyz, new_xyz, B, N, M, sc, out, window, smem, st);
    case 21: return (int)launch<2, 1>(xyz, new_xyz, B, N, M, sc, out, window, smem, st);
    case 22: return (int)launch<2, 2>(xyz, new_xyz, B, N, M, sc, out, window, smem, st);
    case 24: return (int)launch<2, 4>(xyz, new_xyz, B, N, M, sc, out, window, smem, st);
    case 31: return (int)launch<3, 1>(xyz, new_xyz, B, N, M, sc, out, window, smem, st);
    case 32: return (int)launch<3, 2>(xyz, new_xyz, B, N, M, sc, out, window, smem, st);
    case 41: return (int)launch<4, 1>(xyz, new_xyz, B, N, M, sc, out, window, smem, st);
    default: return (int)launch<4, 2>(xyz, new_xyz, B, N, M, sc, out, window, smem, st);
  }
}
