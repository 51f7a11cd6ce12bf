// The scan-order ball-query search of one query by one warp, and the staging
// of a cloud's xyz in shared memory that feeds it. Shared by the fused eval
// SA kernel (sa_group_mlp.cu, rows 3 and 4: `search`) and the train grouping
// kernels (ball_query_group.cu, rows 5, 6 and 9: `search_x4`, the same
// selection with fewer instructions a point), so both select the same hits.
//
// Selection: the first `ns` support points with d2 < r2 in scan order,
// d2 = (dx*dx + dy*dy) + dz*dz with each operation rounded on its own (no
// FMA contraction) and r2 the f32 of r*r, as the TPU kernels compute it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ball_search {

__device__ __forceinline__ float sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The first `ns` hits of query (qx, qy, qz) among pts[0, limit) in scan
// order into s_idx, 64 points per step (two independent distances a lane,
// ranked in scan order by two ballots); returns the hit count (may exceed
// ns).
__device__ __forceinline__ int search(const float* pts, int limit, float qx, float qy, float qz, float r2, int ns,
                                      int* s_idx, int lane) {
  int cnt = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < limit && cnt < ns; base += 64) {
    const int i0 = base + lane, i1 = i0 + 32;
    bool hit0 = false, hit1 = false;
    if (i0 < limit) hit0 = sqdist(qx - pts[3 * i0], qy - pts[3 * i0 + 1], qz - pts[3 * i0 + 2]) < r2;
    if (i1 < limit) hit1 = sqdist(qx - pts[3 * i1], qy - pts[3 * i1 + 1], qz - pts[3 * i1 + 2]) < r2;
    const unsigned m0 = __ballot_sync(0xffffffffu, hit0), m1 = __ballot_sync(0xffffffffu, hit1);
    const int r0 = cnt + __popc(m0 & below), r1 = cnt + __popc(m0) + __popc(m1 & below);
    if (hit0 && r0 < ns) s_idx[r0] = i0;
    if (hit1 && r1 < ns) s_idx[r1] = i1;
    cnt += __popc(m0) + __popc(m1);
  }
  return cnt;
}

// The same selection as `search`, 128 points per step: lane l tests points
// base + 4l .. base + 4l + 3, read as three 16-byte loads where `vec` (pts
// 16-byte aligned: a quarter-warp's 48-byte-strided loads fall in distinct
// banks). Most steps hold no hit, and one vote skips them. A step with hits
// ranks them in scan order from three ballots of the bits of each lane's
// hit count (3 population counts where four ballots take 8: POPC runs at
// a quarter of the FP32 rate), and lane 31's running rank is the new count.
__device__ __forceinline__ int search_x4(const float* pts, bool vec, int limit, float qx, float qy, float qz, float r2,
                                         int ns, int* s_idx, int lane) {
  int cnt = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < limit && cnt < ns; base += 128) {
    const int i = base + 4 * lane;
    bool h[4];
    if (vec && i + 3 < limit) {
      const float4* v = reinterpret_cast<const float4*>(pts + 3 * i);
      const float4 a = v[0], b = v[1], c = v[2];
      h[0] = sqdist(qx - a.x, qy - a.y, qz - a.z) < r2;
      h[1] = sqdist(qx - a.w, qy - b.x, qz - b.y) < r2;
      h[2] = sqdist(qx - b.z, qy - b.w, qz - c.x) < r2;
      h[3] = sqdist(qx - c.y, qy - c.z, qz - c.w) < r2;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* pt = pts + 3 * (i + t);
        h[t] = i + t < limit && sqdist(qx - pt[0], qy - pt[1], qz - pt[2]) < r2;
      }
    }
    const int nh = h[0] + h[1] + h[2] + h[3];
    if (!__any_sync(0xffffffffu, nh)) continue;
    const unsigned b0 = __ballot_sync(0xffffffffu, nh & 1), b1 = __ballot_sync(0xffffffffu, nh & 2),
                   b2 = __ballot_sync(0xffffffffu, nh & 4);
    int r = cnt + __popc(b0 & below) + 2 * __popc(b1 & below) + 4 * __popc(b2 & below);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (h[t] && r < ns) s_idx[r] = i + t;
      r += h[t];
    }
    cnt = __shfl_sync(0xffffffffu, r, 31);
  }
  return cnt;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Starts copying the cloud's points pts[0, lim) (12-byte rows: a warp's 32
// strided reads of a search step fall in 32 distinct banks) into s_xyz with
// cp.async; the block waits (`cp.async.wait_all`, then a barrier) before
// any search reads them.
__device__ __forceinline__ void stage_points(float* s_xyz, const float* pts, int lim, int tid, int nthr) {
  for (int i = tid; i < 3 * lim; i += nthr) cp_async4(s_xyz + i, pts + i);
}

}  // namespace ball_search
