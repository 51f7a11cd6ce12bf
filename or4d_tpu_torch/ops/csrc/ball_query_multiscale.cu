// Multi-scale index ball query: for every query, per (radius, nsample)
// scale, the first `ns` support indices in scan order with |q - p|^2 < r^2;
// empty slots repeat the first hit, and a query with no hit gets index 0 in
// every slot.
//
// Replaces the TPU kernel `ball_query_multiscale_pallas`
// (or4d_tpu/ops/pallas_ball_query.py:139, kernel :96, call :173), which the
// serving cache build runs once per fixed eval set. Rounding matches it:
// d2 = (dx*dx + dy*dy) + dz*dz with each op rounded alone (no FMA
// contraction) and the strict test d2 < r2, r2 the f32 of r*r (rounded on the
// host).
//
// What bounds it on the H100: one distance per scanned point (9 FP32 ops)
// plus a compare per scale; with first-hit stops most queries scan far fewer
// than N points, but a query short of `ns` hits at its widest scale scans the
// whole cloud. The search is latency-bound (a dependent ballot per 32
// points). Design: one warp per query, 8 warps per block on consecutive
// queries (mostly one cloud, whose points then stay in L1); each step every
// lane computes one distance once for all scales, and each scale still
// short of its `ns` hits takes one __ballot_sync and __popc ranks to place
// its hits straight into the output row. The warp stops when every scale
// has its `ns` hits and fills the rest of each row with that scale's first
// hit. No prefix sums, tiles or padding.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxScales = 4;
constexpr int kMaxNs = 1024;

struct BQArgs {
  const float* xyz;      // (B, N, 3)
  const float* new_xyz;  // (B, M, 3)
  int B, N, M, S;
  float r2[kMaxScales];
  int ns[kMaxScales];
  int* out[kMaxScales];  // (B, M, ns[s]) each
};

__device__ __forceinline__ float sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kWarps * 32) ball_query_multiscale_kernel(BQArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kWarps + warp;  // query over B*M
  if (q >= (long long)a.B * a.M) return;  // whole warp
  const int b = (int)(q / a.M);
  const float* xyz = a.xyz + (size_t)b * a.N * 3;
  const float qx = a.new_xyz[3 * q], qy = a.new_xyz[3 * q + 1], qz = a.new_xyz[3 * q + 2];

  int cnt[kMaxScales], first[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    cnt[s] = 0;
    first[s] = -1;
  }
  // cnt and first come from ballots, so every branch on them is warp-uniform
  bool open = true;
  for (int base = 0; base < a.N && open; base += 32) {
    const int i = base + lane;
    float d2 = CUDART_INF_F;
    if (i < a.N) d2 = sqdist(qx - xyz[3 * i], qy - xyz[3 * i + 1], qz - xyz[3 * i + 2]);
    open = false;
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) {
      if (s < a.S && cnt[s] < a.ns[s]) {
        const bool hit = d2 < a.r2[s];
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (m != 0u) {
          if (first[s] < 0) first[s] = base + __ffs(m) - 1;
          if (hit) {
            const int r = cnt[s] + __popc(m & ((1u << lane) - 1u));
            if (r < a.ns[s]) a.out[s][q * a.ns[s] + r] = i;
          }
          cnt[s] += __popc(m);
        }
        open = open || cnt[s] < a.ns[s];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s < a.S) {
      const int fill = first[s] < 0 ? 0 : first[s];
      int* row = a.out[s] + q * a.ns[s];
      for (int k = min(cnt[s], a.ns[s]) + lane; k < a.ns[s]; k += 32) row[k] = fill;
    }
  }
}

}  // namespace

// S scales (1..4): r2[s] (f32 of r*r) and ns[s] (1..1024), out[s] (B, M,
// ns[s]) int32. Returns the CUDA error of the launch.
extern "C" int or4d_ball_query_multiscale(const float* xyz, const float* new_xyz, int B, int N, int M, int S,
                                          const float* r2, const int* ns, int* const* out, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || S < 1 || S > kMaxScales) return (int)cudaErrorInvalidValue;
  BQArgs a{};
  a.xyz = xyz;
  a.new_xyz = new_xyz;
  a.B = B;
  a.N = N;
  a.M = M;
  a.S = S;
  for (int s = 0; s < S; ++s) {
    if (ns[s] < 1 || ns[s] > kMaxNs || out[s] == nullptr) return (int)cudaErrorInvalidValue;
    a.r2[s] = r2[s];
    a.ns[s] = ns[s];
    a.out[s] = out[s];
  }
  const long long blocks = ((long long)B * M + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ball_query_multiscale_kernel<<<(unsigned)blocks, kWarps * 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
