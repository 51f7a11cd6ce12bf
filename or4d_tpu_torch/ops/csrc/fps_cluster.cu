// Furthest point sampling of clouds over 8192 points: one thread-block
// cluster a cloud, with the same optional per-chunk hit counts or search
// bounds as fps.cu.
//
// Replaces `furthest_point_sample_pallas` and
// `furthest_point_sample_with_counts` (or4d_tpu/ops/pallas_fps.py:200 and
// :156) for N > 8192, where fps.cu's one block cannot hold the cloud (16
// warps of 512 points; 20,000 points of f32 xyz are 240 KB, over a block's
// 227 KB). The contract is fps.cu's, bit for bit: index 0 first; points with
// |p|^2 <= 1e-3 start at -1 and never win; distances (dx*dx + dy*dy) + dz*dz
// rounded op by op; running min; ties to the lowest index; with radii the
// hit counts of each selected query over 512-point scan-order chunks, or
// the bound need = #{chunks whose running count is below min(ns, total)} + 1.
//
// What bounds it on the H100: as fps.cu, the npoint steps are sequential,
// each a pass over the cloud plus an argmax across the whole cloud, so it
// is latency-bound: a cluster barrier and a candidate exchange a step.
// Design:
//  - One cluster of C CTAs a cloud. A CTA owns `share` whole 512-point
//    chunks in scan order (CTA r: chunks r*share ...), so a chunk's count is
//    one warp's `redux.sync`, as in fps.cu.
//  - Staged (N <= 65,536): C = ceil(chunks / 16) <= 8 (a portable cluster),
//    one warp a chunk; a CTA stages its share of the cloud in shared memory
//    (+inf past N) and keeps the running minima in registers.
//  - Streamed (N > 65,536): C = 8, 16 warps a CTA, each warp walks its
//    chunks; the points come from device memory (L2) every step and the
//    running minima live in a device scratch (B, N) f32.
//  - The step: each warp writes its candidate (order key, index) into every
//    CTA's candidate slots through distributed shared memory (slots
//    double-buffered by step parity), then one
//    `barrier.cluster.arrive.release` / `wait.acquire`; every warp reduces
//    the C * warps candidates itself (lowest index among the largest key).
//    The staged variant reads the winner's coordinates from the owning CTA's
//    shared memory over DSMEM, the streamed one from device memory.
//  - Bounds: each chunk's counts go to a device scratch (B, 2, NR, chunks)
//    int32, by parity; after the barrier one warp, rotating over the CTAs
//    and their warps with the step, scans them in chunk order (L2 reads)
//    and writes need.
//  - One more cluster barrier before any CTA exits, so no CTA leaves while
//    another may still read its shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

// fps.cu's constants, magnitude test, rounded distance and argmax key, as
// they are there (fps.cu keeps its own copies, unchanged)
constexpr int kChunk = 512;  // the chunk width of the counts
constexpr int kPPT = kChunk / 32;
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

constexpr int kWarps = 16;       // warps a CTA at most
constexpr int kMaxCluster = 8;   // a portable cluster
constexpr int kSingleMaxN = kChunk * kWarps;               // fps.cu's clouds
constexpr int kStagedMaxN = kChunk * kWarps * kMaxCluster;  // 65,536
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the cluster plan: CTAs a cloud, chunks a CTA, warps a CTA
struct Plan {
  int C, share, warps;
  bool stream;
};

__host__ __device__ inline Plan plan_for(int N) {
  const int nch = (N + kChunk - 1) / kChunk;
  if (N <= kStagedMaxN) {
    const int C = (nch + kWarps - 1) / kWarps;
    const int share = (nch + C - 1) / C;
    return {C, share, share, false};
  }
  return {kMaxCluster, (nch + kMaxCluster - 1) / kMaxCluster, kWarps, true};
}

// a warp's chunk counts: to the bounds scratch (B, 2, NR, nch) or the
// counts output (NR, B, npoint, nch)
template <int NR, bool BOUNDS>
__device__ __forceinline__ void put_counts(const int (&cnt)[NR > 0 ? NR : 1], int lane, int c, int nch, int b,
                                           int B, int par, int j, int npoint, int* __restrict__ cnt_g,
                                           float* __restrict__ counts_out) {
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    const int cw = __reduce_add_sync(kFull, cnt[s]);
    if (lane == 0 && c < nch) {
      if (BOUNDS)
        cnt_g[(((size_t)b * 2 + par) * NR + s) * nch + c] = cw;
      else
        counts_out[(((size_t)s * B + b) * npoint + (j - 1)) * nch + c] = (float)cw;
    }
  }
}

// NR radii; BOUNDS: need per radius (radii.need), else counts (NR, B,
// npoint, nch) f32 when NR > 0; STREAM: the streamed variant
template <int NR, bool BOUNDS, bool STREAM>
__global__ void __launch_bounds__(kWarps * 32, 1)
fps_cluster_kernel(const float* __restrict__ xyz, int N, int npoint, int share, Radii radii,
                   int* __restrict__ idx_out, float* __restrict__ counts_out, int B, float* __restrict__ md_g,
                   int* __restrict__ cnt_g) {
  extern __shared__ float s_xyz[];  // staged: the CTA's share, (share * 512, 3), +inf past N
  __shared__ unsigned s_key[2][kMaxCluster * kWarps];
  __shared__ int s_idx[2][kMaxCluster * kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int nch = (N + kChunk - 1) / kChunk;
  const int ch0 = rank * share, ch1 = min(ch0 + share, nch);  // the CTA's chunks
  const int p0 = ch0 * kChunk;
  const float* p = xyz + (size_t)b * N * 3;
  float* md_b = STREAM ? md_g + (size_t)b * N : nullptr;

  float md[STREAM ? 1 : kPPT];
  if (!STREAM) {
    for (int i = tid; i < 3 * share * kChunk; i += blockDim.x) s_xyz[i] = 3 * p0 + i < 3 * N ? p[3 * p0 + i] : CUDART_INF_F;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int li = warp * kChunk + lane + 32 * k;
      md[k] = p0 + li < N ? (sqdist(s_xyz[3 * li], s_xyz[3 * li + 1], s_xyz[3 * li + 2]) > kMagEps ? CUDART_INF_F
                                                                                                  : -1.0f)
                          : -CUDART_INF_F;
    }
  } else {
    for (int c = ch0 + warp; c < ch1; c += nw)
#pragma unroll 4
      for (int k = 0; k < kPPT; ++k) {
        const int i = c * kChunk + lane + 32 * k;
        if (i < N) md_b[i] = sqdist(p[3 * i], p[3 * i + 1], p[3 * i + 2]) > kMagEps ? CUDART_INF_F : -1.0f;
      }
  }
  if (rank == 0 && tid == 0) idx_out[(size_t)b * npoint] = 0;
  float sx = p[0], sy = p[1], sz = p[2];
  cluster_barrier();  // every CTA of the cluster runs and has staged its share

  const int steps = npoint + (NR > 0 ? 1 : 0);
  const int slots = C * nw;
  for (int j = 1; j < steps; ++j) {
    const int par = j & 1;
    const bool last = j == npoint;  // counts only, for the final query
    float bd = -CUDART_INF_F;
    int bi = 0x7fffffff;
    if (!STREAM) {
      int cnt[NR > 0 ? NR : 1];
#pragma unroll
      for (int s = 0; s < NR; ++s) cnt[s] = 0;
      int bk = 0;
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int li = warp * kChunk + lane + 32 * k;
        const float d2 = sqdist(s_xyz[3 * li] - sx, s_xyz[3 * li + 1] - sy, s_xyz[3 * li + 2] - sz);
#pragma unroll
        for (int s = 0; s < NR; ++s) cnt[s] += d2 < radii.r2[s] ? 1 : 0;
        md[k] = fminf(md[k], d2);
        if (md[k] > bd) {  // a lane's points rise with k: the first maximum is the lowest index
          bd = md[k];
          bk = k;
        }
      }
      bi = p0 + warp * kChunk + lane + 32 * bk;
      put_counts<NR, BOUNDS>(cnt, lane, ch0 + warp, nch, b, B, par, j, npoint, cnt_g, counts_out);
    } else {
      for (int c = ch0 + warp; c < ch1; c += nw) {  // a lane's points rise with c and k
        int cnt[NR > 0 ? NR : 1];
#pragma unroll
        for (int s = 0; s < NR; ++s) cnt[s] = 0;
#pragma unroll 4
        for (int k = 0; k < kPPT; ++k) {
          const int i = c * kChunk + lane + 32 * k;
          if (i < N) {
            const float d2 = sqdist(__ldg(p + 3 * i) - sx, __ldg(p + 3 * i + 1) - sy, __ldg(p + 3 * i + 2) - sz);
#pragma unroll
            for (int s = 0; s < NR; ++s) cnt[s] += d2 < radii.r2[s] ? 1 : 0;
            const float m = fminf(md_b[i], d2);
            md_b[i] = m;
            if (m > bd) {
              bd = m;
              bi = i;
            }
          }
        }
        put_counts<NR, BOUNDS>(cnt, lane, c, nch, b, B, par, j, npoint, cnt_g, counts_out);
      }
    }
    if (!BOUNDS && last) break;

    // this warp's candidate, into every CTA's slots for this parity
    const unsigned key = order_key(bd);
    const unsigned kmax = __reduce_max_sync(kFull, key);
    const int imin = __reduce_min_sync(kFull, key == kmax ? bi : 0x7fffffff);
    if (lane < C) {
      unsigned* rk = cluster.map_shared_rank(&s_key[par][0], lane);
      int* ri = cluster.map_shared_rank(&s_idx[par][0], lane);
      rk[rank * nw + warp] = kmax;
      ri[rank * nw + warp] = imin;
    }
    cluster_barrier();

    if (BOUNDS && rank == j % C && warp == (j / C) % nw) {
      // per radius: thr = min(ns, total), need = chunks with a running
      // count below thr, plus one; the counts of step j are this parity's
      const int* cb = cnt_g + ((size_t)b * 2 + par) * NR * nch;
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        const int* cs = cb + (size_t)s * nch;
        int total = 0;
        for (int c0 = 0; c0 < nch; c0 += 32) total += __reduce_add_sync(kFull, c0 + lane < nch ? __ldcg(cs + c0 + lane) : 0);
        const int thr = min(radii.ns[s], total);
        int run = 0, below = 0;
        for (int c0 = 0; c0 < nch && run < thr; c0 += 32) {
          int v = c0 + lane < nch ? __ldcg(cs + c0 + lane) : 0;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int n = __shfl_up_sync(kFull, v, off);
            if (lane >= off) v += n;
          }
          below += __popc(__ballot_sync(kFull, c0 + lane < nch && run + v < thr));
          run += __shfl_sync(kFull, v, 31);
        }
        if (lane == 0) radii.need[s][(size_t)b * npoint + (j - 1)] = below + 1;
      }
    }
    if (last) break;

    // the cloud's winner, reduced by every warp from the candidates
    unsigned ck = 0u;
    int ci = 0x7fffffff;
    for (int e = lane; e < slots; e += 32) {
      const unsigned k2 = s_key[par][e];
      const int i2 = s_idx[par][e];
      if (k2 > ck || (k2 == ck && i2 < ci)) {
        ck = k2;
        ci = i2;
      }
    }
    const unsigned bmax = __reduce_max_sync(kFull, ck);
    const int sel = __reduce_min_sync(kFull, ck == bmax ? ci : 0x7fffffff);
    if (rank == 0 && tid == 0) idx_out[(size_t)b * npoint + j] = sel;
    if (STREAM) {
      sx = __ldg(p + 3 * sel);
      sy = __ldg(p + 3 * sel + 1);
      sz = __ldg(p + 3 * sel + 2);
    } else {
      const int owner = sel / (share * kChunk);
      const float* q = cluster.map_shared_rank(s_xyz, owner) + 3 * (sel - owner * share * kChunk);
      sx = q[0];
      sy = q[1];
      sz = q[2];
    }
  }
  cluster_barrier();  // no CTA leaves while another may read its shared memory
}

template <int NR, bool BOUNDS, bool STREAM>
cudaError_t launch(const float* xyz, int B, int N, int npoint, const Plan& pl, const Radii& radii, int* idx,
                   float* counts, float* md, int* cnt, cudaStream_t stream) {
  auto kern = fps_cluster_kernel<NR, BOUNDS, STREAM>;
  const size_t smem = STREAM ? 0 : (size_t)pl.share * kChunk * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * pl.C);
  cfg.blockDim = dim3(pl.warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, xyz, N, npoint, pl.share, radii, idx, counts, B, md, cnt);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool BOUNDS, bool STREAM>
cudaError_t launch_nr(int nradii, const float* xyz, int B, int N, int npoint, const Plan& pl, const Radii& radii,
                      int* idx, float* counts, float* md, int* cnt, cudaStream_t stream) {
  switch (nradii) {
    case 0: return launch<0, false, STREAM>(xyz, B, N, npoint, pl, radii, idx, nullptr, md, nullptr, stream);
    case 1: return launch<1, BOUNDS, STREAM>(xyz, B, N, npoint, pl, radii, idx, counts, md, cnt, stream);
    case 2: return launch<2, BOUNDS, STREAM>(xyz, B, N, npoint, pl, radii, idx, counts, md, cnt, stream);
    case 3: return launch<3, BOUNDS, STREAM>(xyz, B, N, npoint, pl, radii, idx, counts, md, cnt, stream);
    default: return launch<4, BOUNDS, STREAM>(xyz, B, N, npoint, pl, radii, idx, counts, md, cnt, stream);
  }
}

}  // namespace

// xyz (B, N, 3) f32 with N > 8192 -> idx (B, npoint) i32 and, as or4d_fps
// (fps.cu), with nradii > 0 either counts (nradii, B, npoint, ceil(N/512))
// f32 or, with need != null, the bounds (need: a host array of nradii
// device pointers to (B, npoint) i32; ns their nsamples). The caller's plan
// (C CTAs a cloud, share chunks a CTA, streamed or not) must be this file's
// `plan_for(N)`. Scratch the caller allocates: md (B, N) f32 when streamed,
// cnt (B, 2, nradii, ceil(N/512)) i32 with bounds; null otherwise. Returns
// the CUDA error of the launch (cudaErrorInvalidValue for a refused call).
extern "C" int or4d_fps_cluster(const float* xyz, int B, int N, int npoint, int nradii, const float* r2,
                                const int* ns, int* idx, float* counts, int* const* need, int C, int share,
                                int stream_pts, float* md, int* cnt, void* stream) {
  if (B <= 0 || N <= kSingleMaxN || npoint <= 0 || nradii < 0 || nradii > kMaxRadii ||
      (nradii > 0) != (counts != nullptr || need != nullptr) || (counts != nullptr && need != nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan_for(N);
  if (pl.C != C || pl.share != share || (int)pl.stream != stream_pts || (pl.stream && md == nullptr) ||
      (need != nullptr && cnt == nullptr))
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
  const bool bounds = need != nullptr;
  if (pl.stream)
    return bounds ? (int)launch_nr<true, true>(nradii, xyz, B, N, npoint, pl, radii, idx, nullptr, md, cnt, st)
                  : (int)launch_nr<false, true>(nradii, xyz, B, N, npoint, pl, radii, idx, counts, md, nullptr, st);
  return bounds ? (int)launch_nr<true, false>(nradii, xyz, B, N, npoint, pl, radii, idx, nullptr, nullptr, cnt, st)
                : (int)launch_nr<false, false>(nradii, xyz, B, N, npoint, pl, radii, idx, counts, nullptr, nullptr, st);
}
