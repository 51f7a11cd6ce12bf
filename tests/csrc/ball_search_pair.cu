// The scan-order searches of ops/csrc/ball_search.cuh on the same queries,
// for tests/test_torch_cuda.py, which builds this file with nvcc and holds
// their hit lists equal: `search` (the fused eval SA kernel's) against
// `search_x4` (the train grouping kernels'), and `search_multi_x4` (the
// multi-scale ball query's, every scale at once) against its one-scale
// instance `search_x4` run once per scale. One warp per query; the searches read the cloud from
// global memory (the kernels read the same layout from shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ball_search.cuh"

__global__ void search_pair_kernel(const float* xyz, const float* new_xyz, int B, int N, int M, const int* limit,
                                   float r2, int ns, int vec, int* idx_a, int* cnt_a, int* idx_b, int* cnt_b) {
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= (long long)B * M) return;  // whole warps: blockDim is a multiple of 32
  const float* pts = xyz + (q / M) * (long long)N * 3;
  const float* p = new_xyz + 3 * q;
  const int lim = limit ? min(limit[q], N) : N;
  const bool aligned = !(reinterpret_cast<uintptr_t>(pts) & 15);
  const int a = ball_search::search(pts, lim, p[0], p[1], p[2], r2, ns, idx_a + q * ns, lane);
  const int b = ball_search::search_x4(pts, vec && aligned, lim, p[0], p[1], p[2], r2, ns, idx_b + q * ns, lane);
  if (lane == 0) {
    cnt_a[q] = a;
    cnt_b[q] = b;
  }
}

// xyz (B, N, 3), new_xyz (B, M, 3) f32; limit (B*M) points to scan or null;
// idx_a/idx_b (B*M, ns) and cnt_a/cnt_b (B*M) int32 outputs (slots past a
// query's hits are left as they were). Returns the launch's CUDA error.
extern "C" int or4d_search_pair(const float* xyz, const float* new_xyz, int B, int N, int M, const int* limit,
                                float r2, int ns, int vec, int* idx_a, int* cnt_a, int* idx_b, int* cnt_b,
                                void* stream) {
  const long long threads = (long long)B * M * 32;
  search_pair_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, B, N, M, limit, r2, ns, vec, idx_a, cnt_a, idx_b, cnt_b);
  return (int)cudaGetLastError();
}

constexpr int kMaxScales = 4;

struct MultiArgs {
  const float* xyz;
  const float* new_xyz;
  int B, N, M;
  float r2[kMaxScales];
  int ns[kMaxScales];
  int* idx_multi[kMaxScales];  // (B*M, ns[s]) each
  int* cnt_multi[kMaxScales];  // (B*M) each
  int* idx_x4[kMaxScales];
  int* cnt_x4[kMaxScales];
  int vec;
};

template <int S>
__global__ void search_multi_kernel(MultiArgs a) {
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= (long long)a.B * a.M) return;
  const float* pts = a.xyz + (q / a.M) * (long long)a.N * 3;
  const float* p = a.new_xyz + 3 * q;
  const bool vec = a.vec && !(reinterpret_cast<uintptr_t>(pts) & 15);
  float r2[S];
  int ns[S], cnt[S];
  int* lists[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    r2[s] = a.r2[s];
    ns[s] = a.ns[s];
    lists[s] = a.idx_multi[s] + q * ns[s];
  }
  ball_search::search_multi_x4<S>(pts, vec, a.N, p[0], p[1], p[2], r2, ns, lists, cnt, lane);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = ball_search::search_x4(pts, vec, a.N, p[0], p[1], p[2], r2[s], ns[s], a.idx_x4[s] + q * ns[s], lane);
    if (lane == 0) {
      a.cnt_multi[s][q] = cnt[s];
      a.cnt_x4[s][q] = c;
    }
  }
}

// S scales (1..4): r2/ns host arrays; idx_multi/cnt_multi/idx_x4/cnt_x4 host
// arrays of S device pointers, each (B*M, ns[s]) or (B*M) int32 (slots past
// a query's hits are left as they were). Returns the launch's CUDA error.
extern "C" int or4d_search_multi(const float* xyz, const float* new_xyz, int B, int N, int M, int S, const float* r2,
                                 const int* ns, int vec, int* const* idx_multi, int* const* cnt_multi,
                                 int* const* idx_x4, int* const* cnt_x4, void* stream) {
  if (S < 1 || S > kMaxScales) return (int)cudaErrorInvalidValue;
  MultiArgs a{};
  a.xyz = xyz;
  a.new_xyz = new_xyz;
  a.B = B;
  a.N = N;
  a.M = M;
  a.vec = vec;
  for (int s = 0; s < S; ++s) {
    a.r2[s] = r2[s];
    a.ns[s] = ns[s];
    a.idx_multi[s] = idx_multi[s];
    a.cnt_multi[s] = cnt_multi[s];
    a.idx_x4[s] = idx_x4[s];
    a.cnt_x4[s] = cnt_x4[s];
  }
  const long long threads = (long long)B * M * 32;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: search_multi_kernel<1><<<blocks, 256, 0, st>>>(a); break;
    case 2: search_multi_kernel<2><<<blocks, 256, 0, st>>>(a); break;
    case 3: search_multi_kernel<3><<<blocks, 256, 0, st>>>(a); break;
    default: search_multi_kernel<4><<<blocks, 256, 0, st>>>(a); break;
  }
  return (int)cudaGetLastError();
}
