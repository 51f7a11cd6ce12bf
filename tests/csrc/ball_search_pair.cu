// Both scan-order searches of ops/csrc/ball_search.cuh on the same queries:
// `search` (the fused eval SA kernel's) and `search_x4` (the train grouping
// kernels'), for tests/test_torch_cuda.py, which builds this file with nvcc
// and holds the two hit lists equal. One warp per query; the searches read
// the cloud from global memory (the kernels read the same layout from
// shared memory).

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
