// Train-path grouping: ball query + grouped layer-1 rows (forward) and the
// two backward passes, for one (radius, nsample) scale per call.
//
// Replaces the TPU kernels
//   * `ball_query_group_pallas` (or4d_tpu/ops/pallas_ball_query.py:295;
//     fwd kernel :194, bwd kernel :236) and `ball_query_group_pallas_gated`
//     (pallas_ball_query.py:1563; fwd :1591, pallas_call :1641; bwd :1656,
//     pallas_call :1699): plane mode. Forward copies rows of a precomputed
//     layer-1 plane A (B, N, C), the gated one within the FPS counts' bound
//     `need`; backward scatter-adds the cotangent into dA (B, N, C), summed
//     in f32 and rounded to g's dtype.
//   * `ball_query_group_pallas_gated_raw` (pallas_ball_query.py:1743; fwd
//     kernel :1215 with from_raw, bwd kernel :1406 with from_raw): raw mode.
//     Forward builds each grouped row in-kernel as
//     A = round_T(sum_i raw[i, p] * W0[i, :]) (f32 accumulation, an fmaf
//     chain over i = 0..C0-1 in order) from the channel-major raw
//     [xyz|features] plane (B, C0, N); backward returns
//     dW0 = sum over slots of raw[:, p] (x) g[slot] in f32, rounded to W0's
//     dtype. raw, xyz and new_xyz get no gradient (their values are model
//     inputs on this path).
//
// Selection (both modes; ball_search.cuh, the fused eval SA kernel's
// search): per query, the first `ns` support points with d2 < r2 in scan
// order; slots past the last hit repeat the first hit (first-hit fill); a
// query with no hit gets zero rows and passes no gradient. With `need`
// (B, M) (chunk counts from the FPS kernel: raw mode, and the gated plane
// mode) the search stops at need*512 points, an exact bound. Outputs are
// query-major (B, M, ns, C); the TPU's slot-major and slot-pair packed
// layouts, query sort and sub-tile gates change only speed on a TPU and are
// not carried over.
//
// Autograd residual: the forward saves the hit indices (B, M, ns) int32 with
// the fill applied and -1 in every slot of a query with no hit (4 bytes per
// slot: 75 MB for an S=8 train step at paper shapes) instead of rerunning
// the search in the backward as the TPU kernels do. Filled slots point at the
// first hit, so the backward routes their cotangents to it by construction.
//
// What bounds each kernel on the H100, and the design:
//   * forward: bytes (ns * C values written per query, 4.6 GB for an S=8
//     f32 step's raw-mode calls) and, ahead of them on the H100, the
//     scan-order search's instructions (2.4 G point tests a step: the
//     search reads 2600-4000 of a relation crop's 8000 points per query).
//     Blocks of 16 warps take `block_queries` queries of one cloud
//     (ops/ball_query_group.py `group_plan`, whose shared-memory layout
//     `fwd_smem` below repeats; the launch refuses a plan whose bytes
//     disagree) and stage the cloud's xyz up to the block's largest search
//     bound in shared memory with cp.async, where it fits in 227 KB (two
//     blocks an SM at 8000 points). A warp takes one query at a time from a
//     shared counter and searches it with `search_x4` (ball_search.cuh:
//     the one-scale `search_multi_x4`, four points a lane per step, three
//     16-byte loads, one vote for the steps without a hit), into a per-warp
//     hit list. Then the rows, lanes
//     owning adjacent channel pairs, one 8-byte (f32) or 4-byte (bf16) store
//     a lane per row. Raw mode: 16 slots at a time, lanes fetch the slots'
//     raw columns (all loads in flight at once) into a per-warp buffer; each
//     row reads its column back as two broadcast loads and multiplies it by
//     W0's column pairs (staged as f32 in shared memory and loaded into
//     registers after the search, which they would otherwise crowd); the
//     fmaf chain over i = 0..C0-1 keeps the rows bit-equal to the plain
//     version. Plane mode: 32 slots at a time, four rows loaded ahead of
//     their stores.
//   * plane backward: bytes (g read once, dA written once), read as rows
//     gathered from all over the cotangent. Deterministic, no atomics in the
//     sums; two kernels planned by `bwd_plan` (ops/ball_query_group.py),
//     which the launch checks. A filled slot holds its query's first hit, so
//     every slot of a query with a hit has one target point, and a point's
//     slots in slot order are the order of a sequential scatter over the
//     flattened slots. `group_bwd_build`, a block per cloud, inverts the
//     saved indices into a CSR in global memory (int32 scratch, 64 MB for
//     the S=8 step's largest call): counts by shared-memory atomics, a scan,
//     then warps that place the slots 32 at a time in order (one a cloud
//     where many clouds fill the card; 8, each a run of the cloud's slots,
//     for the 96-cloud calls), so no list needs a sort. `group_bwd_sum`
//     sums each point's list in order: a warp takes the points whose lists
//     start in one run of 32 CSR entries, so a first hit that collects
//     hundreds of filled slots holds up one warp, not the 31 other points
//     of a fixed tile (SA2's longest lists hold 431 entries, SA1's points
//     about two); eight rows in flight, lanes on channel pairs. The first
//     design kept a cloud's lists in shared memory (131.6 KB for SA1: one
//     block an SM, nothing streaming during the build; 0.38 of its bound on
//     SA1).
//   * raw backward: bytes (g read once; the C0 x C products per slot are
//     ~0.25 ms of FP32-pipe work at S=8). The queries are cut into tiles of
//     32 of one cloud, and each block of 8 warps takes `tiles_per_block`
//     consecutive tiles (`raw_bwd_plan`, which `raw_bwd_smem` repeats), so
//     even the 96-cloud object call fills the card. A warp loads a query's
//     indices coalesced, fetches its real hits' raw columns lane-parallel
//     into a per-warp buffer, and streams the query's cotangent rows eight
//     at a time (all loads first): slot 0's and the filled slots' rows,
//     which share the first hit's column, are summed before one outer
//     product; each other row is multiplied by its slot's column (two
//     broadcast loads) into a (C0, C) f32 tile in registers (lanes own
//     channel pairs). The warps' tiles are summed in warp order into one
//     partial per block; a second kernel sums the partials in a fixed order
//     (32 interleaved runs, then the runs in order) and rounds to W0's
//     dtype. Deterministic, no atomics; no dA plane exists.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ball_search.cuh"

namespace {

constexpr int kMaxC = 256;     // plane mode: C <= 256
constexpr int kMaxRawC = 128;  // raw mode: C <= 128
constexpr int kMaxNs = 127;
constexpr int kMaxC0 = 8;
constexpr int kChunk = 512;
constexpr int kBwdBuildThreads = 256;  // plane backward's CSR build: threads per cloud
constexpr int kBwdBuildAhead = 4;      // plane backward's CSR build: chunks of 32 slots loaded a batch ahead
constexpr int kBwdSumWarps = 8;        // plane backward's sum: warps (runs of the CSR) per block
constexpr int kBwdRun = 32;            // plane backward's sum: CSR entries whose lists a warp starts (a run)
constexpr int kBwdInFlight = 8;        // plane backward's sum: cotangent rows loaded ahead of their adds
constexpr int kFwdWarps = 16;     // forward: warps per block
constexpr int kFwdMinBlocks = 2;  // forward: resident blocks an SM (__launch_bounds__), 64 registers a thread
constexpr int kFwdInFlight = 4;   // plane forward: rows loaded ahead of their stores
constexpr int kRawSlots = 16;     // raw forward: slots whose raw columns a warp buffers at once
constexpr int kRawBwdWarps = 8;   // raw backward: warps per block
constexpr int kRawBwdTile = 32;   // raw backward: queries per tile
constexpr int kRawBwdInFlight = 8;  // raw backward: cotangent rows loaded ahead of their products
constexpr int kReduceWarps = 32;  // raw backward's reduce: interleaved runs of partials
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can have
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// two adjacent channels of a row, loaded or stored as one value
template <typename T> struct PairOf;
template <> struct PairOf<float> { using type = float2; };
template <> struct PairOf<__nv_bfloat16> { using type = __nv_bfloat162; };

template <typename T>
__device__ __forceinline__ bool pair_aligned(const void* p) {
  return !(reinterpret_cast<uintptr_t>(p) & (sizeof(typename PairOf<T>::type) - 1));
}

// row[c], row[c+1] (c < C; row[c+1] only below C): one pair access where
// `vec` (C even, row pair-aligned), else two scalar ones
template <typename T>
__device__ __forceinline__ typename PairOf<T>::type load2(const T* row, int c, int C, bool vec) {
  using P2 = typename PairOf<T>::type;
  if (vec) return *reinterpret_cast<const P2*>(row + c);
  P2 v;
  v.x = row[c];
  v.y = c + 1 < C ? row[c + 1] : from_f<T>(0.0f);
  return v;
}

template <typename T>
__device__ __forceinline__ void store2(T* row, int c, int C, bool vec, typename PairOf<T>::type v) {
  using P2 = typename PairOf<T>::type;
  if (vec) {
    *reinterpret_cast<P2*>(row + c) = v;
  } else {
    row[c] = v.x;
    if (c + 1 < C) row[c + 1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ typename PairOf<T>::type pair_of(float v0, float v1) {
  typename PairOf<T>::type v;
  v.x = from_f<T>(v0);
  v.y = from_f<T>(v1);
  return v;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// plane backward: the CSR build's dynamic shared memory, a count (then a
// cursor) per placing warp and point (ops/ball_query_group.py `bwd_plan`
// computes the same)
inline size_t bwd_build_smem(int N, int segs) { return align16((size_t)N * segs * 4); }

struct BwdArgs {
  const int* idx;  // (B, M, ns)
  int B, N, Mns, C, segs, R;
  unsigned sum_blocks;
  size_t build_smem;
  int *off, *ent, *rfirst;
};

// The forward's dynamic shared memory (ops/ball_query_group.py
// `_fwd_smem_bytes` computes the same): per warp its hit list, a 16-byte
// control word, in raw mode W0 as f32 (C0, C rounded up to even), then the
// staged xyz. In raw mode a warp's list is followed by its buffer of
// kRawSlots slots' raw columns.
__host__ __device__ inline size_t fwd_warp_bytes(int ns, bool raw) {
  return align16((size_t)ns * 4) + (raw ? sizeof(float) * kRawSlots * kMaxC0 : 0);
}
__host__ __device__ inline size_t fwd_w0_bytes(int C0, int C) { return align16((size_t)C0 * (C + (C & 1)) * 4); }
__host__ __device__ inline size_t fwd_smem(int N, int ns, int C0, int C, bool stage_xyz) {
  return kFwdWarps * fwd_warp_bytes(ns, C0 > 0) + 16 + fwd_w0_bytes(C0, C) + (stage_xyz ? align16((size_t)N * 12) : 0);
}

// raw backward: one (C0, C) f32 tile per warp, summed in warp order, then
// per warp a buffer of 32 slots' raw columns
__host__ __device__ inline size_t raw_bwd_red_bytes(int C0, int C) {
  return align16((size_t)kRawBwdWarps * C0 * C * 4);
}
__host__ __device__ inline size_t raw_bwd_smem(int C0, int C) {
  return raw_bwd_red_bytes(C0, C) + (size_t)kRawBwdWarps * 32 * kMaxC0 * 4;
}

struct FwdArgs {
  const float* xyz;      // (B, N, 3)
  const float* new_xyz;  // (B, M, 3)
  int B, N, M;
  float r2;
  int ns;
  const int* need;  // (B, M) chunk bound, or null
  const void* A;    // plane mode: (B, N, C)
  const void* raw;  // raw mode: (B, C0, N)
  const void* W0;   // raw mode: (C0, C)
  int C0, C;
  void* out;  // (B, M, ns, C)
  int* idx;   // (B, M, ns)
  int qb;     // queries per block
  int stage_xyz;
};

// JP channel pairs per lane: lane l owns channels 2*(l + 32*j) and the one
// after, j < JP (C <= 64 * JP)
template <typename T, bool RAW, int JP>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdMinBlocks) group_fwd_kernel(FwdArgs a) {
  using P2 = typename PairOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = a.ns, N = a.N, M = a.M, C = a.C, C0 = a.C0;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const size_t warps_bytes = kFwdWarps * fwd_warp_bytes(ns, RAW);
  int* s_idx = reinterpret_cast<int*>(smem + warp * fwd_warp_bytes(ns, RAW));
  float* s_rv = reinterpret_cast<float*>(s_idx) + align16((size_t)ns * 4) / 4;  // raw mode: (kRawSlots, kMaxC0)
  int* s_ctl = reinterpret_cast<int*>(smem + warps_bytes);  // [next query, search bound]
  float* s_w0 = reinterpret_cast<float*>(smem + warps_bytes + 16);  // raw mode: (C0, Ce)
  const int Ce = C + (C & 1);

  const int blocks_per_cloud = (M + a.qb - 1) / a.qb;
  const int b = blockIdx.x / blocks_per_cloud;
  const int q0 = (blockIdx.x % blocks_per_cloud) * a.qb;
  const int nq = min(a.qb, M - q0);

  if (tid == 0) s_ctl[0] = s_ctl[1] = 0;
  __syncthreads();
  int lim = 0;
  for (int i = tid; i < nq; i += nthr)
    lim = max(lim, a.need != nullptr ? min(N, max(a.need[(size_t)b * M + q0 + i], 0) * kChunk) : N);
  if (lim > 0) atomicMax(&s_ctl[1], lim);
  if constexpr (RAW) {  // W0 as f32, rows padded to an even width
    const T* W0 = static_cast<const T*>(a.W0);
    for (int e = tid; e < C0 * Ce; e += nthr) {
      const int i = e / Ce, c = e - i * Ce;
      s_w0[e] = c < C ? to_f(W0[i * C + c]) : 0.0f;
    }
  }
  __syncthreads();
  lim = s_ctl[1];

  // the cloud's xyz up to the block's search bound
  const float* pts = a.xyz + (size_t)b * N * 3;
  if (a.stage_xyz) {
    float* s_xyz = reinterpret_cast<float*>(smem + warps_bytes + 16 + fwd_w0_bytes(C0, C));
    ball_search::stage_points(s_xyz, pts, lim, tid, nthr);
    pts = s_xyz;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const T* rawb = RAW ? static_cast<const T*>(a.raw) + (size_t)b * C0 * N : nullptr;
  const T* Ab = RAW ? nullptr : static_cast<const T*>(a.A) + (size_t)b * N * C;
  const bool vec = !(C & 1) && pair_aligned<T>(a.out) && (RAW || pair_aligned<T>(a.A));

  while (true) {
    int qi = 0;
    if (lane == 0) qi = atomicAdd(&s_ctl[0], 1);
    qi = __shfl_sync(kFull, qi, 0);
    if (qi >= nq) break;
    const size_t row = (size_t)b * M + q0 + qi;
    const float qx = a.new_xyz[3 * row], qy = a.new_xyz[3 * row + 1], qz = a.new_xyz[3 * row + 2];
    const int limit = a.need != nullptr ? min(N, max(a.need[row], 0) * kChunk) : N;
    const int nreal = min(ball_search::search_x4(pts, a.stage_xyz != 0, limit, qx, qy, qz, a.r2, ns, s_idx, lane), ns);
    __syncwarp();

    int* idx = a.idx + row * ns;
    for (int k = lane; k < ns; k += 32) idx[k] = nreal > 0 ? s_idx[k < nreal ? k : 0] : -1;
    T* out = static_cast<T*>(a.out) + row * ns * (size_t)C;
    if (nreal == 0) {  // no hit: zero rows
      for (int e = lane; e < ns * C; e += 32) out[e] = from_f<T>(0.0f);
    }
    if constexpr (RAW) {
      // W0's rows at this lane's channel pairs, loaded after the search so
      // that they hold no registers during it
      float2 w[kMaxC0][JP];
#pragma unroll
      for (int i = 0; i < kMaxC0; ++i)
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const int c = 2 * (lane + 32 * j);
          w[i][j] = make_float2(0.0f, 0.0f);
          if (i < C0 && c < C) w[i][j] = *reinterpret_cast<const float2*>(s_w0 + i * Ce + c);
        }
      for (int k0 = 0; nreal > 0 && k0 < ns; k0 += kRawSlots) {
        // the group's raw columns to the warp's buffer, every load in flight
        // at once: lane l fetches channels 4 * (l / 16) + 0..3 of slot
        // k0 + l % 16 (a filled slot: the first hit's)
        const int k = k0 + (lane & 15), i0 = 4 * (lane >> 4);
        const int p = s_idx[k < nreal ? k : 0];
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = i0 + u < C0 && k < ns ? to_f(rawb[(size_t)(i0 + u) * N + p]) : 0.0f;
        *reinterpret_cast<float4*>(s_rv + (lane & 15) * kMaxC0 + i0) = make_float4(v[0], v[1], v[2], v[3]);
        __syncwarp();
        const int cnt = min(kRawSlots, ns - k0);
        for (int kk = 0; kk < cnt; ++kk) {
          // slot kk's row: its raw column read back as two broadcast loads
          const float4 xa = *reinterpret_cast<const float4*>(s_rv + kk * kMaxC0);
          const float4 xb = *reinterpret_cast<const float4*>(s_rv + kk * kMaxC0 + 4);
          const float x[kMaxC0] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
          float acc[JP][2];
#pragma unroll
          for (int j = 0; j < JP; ++j) acc[j][0] = acc[j][1] = 0.0f;
#pragma unroll
          for (int i = 0; i < kMaxC0; ++i) {
            if (i >= C0) continue;
#pragma unroll
            for (int j = 0; j < JP; ++j) {
              acc[j][0] = fmaf(x[i], w[i][j].x, acc[j][0]);
              acc[j][1] = fmaf(x[i], w[i][j].y, acc[j][1]);
            }
          }
          T* o = out + (size_t)(k0 + kk) * C;
#pragma unroll
          for (int j = 0; j < JP; ++j) {
            const int c = 2 * (lane + 32 * j);
            if (c < C) store2<T>(o, c, C, vec, pair_of<T>(acc[j][0], acc[j][1]));
          }
        }
        __syncwarp();
      }
    } else {
      for (int k0 = 0; nreal > 0 && k0 < ns; k0 += 32) {
        const int cnt = min(32, ns - k0), k = k0 + lane;
        const int p = s_idx[k < nreal ? k : 0];  // this lane's slot (filled: the first hit)
        for (int kk0 = 0; kk0 < cnt; kk0 += kFwdInFlight) {
          P2 v[kFwdInFlight][JP];
#pragma unroll
          for (int u = 0; u < kFwdInFlight; ++u) {
            const int kk = kk0 + u;
            const T* Arow = Ab + (size_t)__shfl_sync(kFull, p, kk & 31) * C;
#pragma unroll
            for (int j = 0; j < JP; ++j) {
              const int c = 2 * (lane + 32 * j);
              if (kk < cnt && c < C) v[u][j] = load2<T>(Arow, c, C, vec);
            }
          }
#pragma unroll
          for (int u = 0; u < kFwdInFlight; ++u) {
            const int kk = kk0 + u;
            T* o = out + (size_t)(k0 + kk) * C;
#pragma unroll
            for (int j = 0; j < JP; ++j) {
              const int c = 2 * (lane + 32 * j);
              if (kk < cnt && c < C) store2<T>(o, c, C, vec, v[u][j]);
            }
          }
        }
      }
    }
    __syncwarp();
  }
}

// The plane backward's inverse of one cloud's saved indices, as a CSR in
// global memory: off (N + 1) list starts and ent (M * ns) slot numbers
// (m * ns + k), each point's list in ascending slot order. A slot's target
// is its saved index (a filled slot holds the first hit, -1 a query with no
// hit), so every slot of a query with a hit is on exactly one list, and a
// point's list in slot order is the order of a sequential scatter over the
// flattened slots. The slots are cut into `segs` runs of seg_len (a
// multiple of 32), one placing warp each: counts per run and point by
// shared-memory atomics (integers: the same in any order), an exclusive
// scan over the points' totals into off, each run's cursor at a point
// starting after the earlier runs' entries; then each placing warp places
// its run 32 slots at a time in order, lanes with the same target ranked
// among themselves (__match_any_sync) and their leader advancing the
// target's cursor, so each list is filled in slot order with no sort. Also
// writes rfirst (R): for each run of E = kBwdRun entries of the CSR that
// the sum takes, the first point whose list starts at or after the run's start
// (N where none does). Shared memory: segs * N ints.
__global__ void __launch_bounds__(kBwdBuildThreads)
group_bwd_build(const int* __restrict__ idx, int N, int Mns, int segs, int R, int* __restrict__ off,
                int* __restrict__ ent, int* __restrict__ rfirst) {
  constexpr int E = kBwdRun;
  extern __shared__ __align__(16) unsigned char smem[];
  int* cnt = reinterpret_cast<int*>(smem);  // [segs][N]: counts, then cursors
  __shared__ int s_warp[kBwdBuildThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* I = idx + (size_t)b * Mns;
  int* ob = off + (size_t)b * (N + 1);
  int* eb = ent + (size_t)b * Mns;
  int* fb = rfirst + (size_t)b * R;
  const int seg_len = ((Mns + segs - 1) / segs + 31) & ~31;
  for (int i = tid; i < segs * N; i += blockDim.x) cnt[i] = 0;
  for (int k = tid; k < R; k += blockDim.x) fb[k] = N;
  __syncthreads();
  for (int e = tid; e < Mns; e += blockDim.x) {
    const int p = I[e];
    if ((unsigned)p < (unsigned)N) atomicAdd(&cnt[(e / seg_len) * N + p], 1);
  }
  __syncthreads();
  // exclusive scan of the points' totals into off, a tile of blockDim points
  // at a time (a point a thread: no bank conflicts); each run's cursor at a
  // point starts after the earlier runs' entries
  int carry = 0;
  for (int t0 = 0; t0 < N; t0 += blockDim.x) {
    const int i = t0 + tid;
    int v = 0;
    if (i < N)
      for (int s = 0; s < segs; ++s) v += cnt[s * N + i];
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = carry, tile = 0;
    for (int w = 0; w < kBwdBuildThreads / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      tile += s_warp[w];
    }
    if (i < N) {
      int c = before + incl - v;
      ob[i] = c;
      for (int s = 0; s < segs; ++s) {
        const int n = cnt[s * N + i];
        cnt[s * N + i] = c;
        c += n;
      }
    }
    carry += tile;
    __syncthreads();
  }
  if (tid == 0) ob[N] = carry;
  // rfirst[k] = i for the runs k whose start k * E lies in (off[i - 1], off[i]]
  // (run 0's cursors are the list starts)
  for (int i = tid; i < N; i += blockDim.x) {
    const int prev = i > 0 ? cnt[i - 1] : -1, start = cnt[i];
    for (int k = prev < 0 ? 0 : prev / E + 1; k <= start / E && k < R; ++k) fb[k] = i;
  }
  __syncthreads();
  if (warp >= segs) return;
  int* cur = cnt + warp * N;  // this warp's cursors
  const int e_lo = warp * seg_len, e_hi = min(Mns, e_lo + seg_len);
  const unsigned below = (1u << lane) - 1u;
  int p[kBwdBuildAhead];  // the next chunks' targets, loaded a batch ahead
#pragma unroll
  for (int u = 0; u < kBwdBuildAhead; ++u) {
    const int e = e_lo + 32 * u + lane;
    p[u] = e < e_hi ? I[e] : -1;
  }
  for (int e0 = e_lo; e0 < e_hi; e0 += 32 * kBwdBuildAhead) {
    int key[kBwdBuildAhead];
    unsigned grp[kBwdBuildAhead];
#pragma unroll
    for (int u = 0; u < kBwdBuildAhead; ++u) {
      key[u] = (unsigned)p[u] < (unsigned)N ? p[u] : -1;
      grp[u] = __match_any_sync(kFull, key[u]);
      const int e = e0 + 32 * (kBwdBuildAhead + u) + lane;
      p[u] = e < e_hi ? I[e] : -1;
    }
#pragma unroll
    for (int u = 0; u < kBwdBuildAhead; ++u) {
      const int leader = __ffs(grp[u]) - 1;
      int pos = 0;
      if (key[u] >= 0 && lane == leader) {
        pos = cur[key[u]];
        cur[key[u]] = pos + __popc(grp[u]);
      }
      __syncwarp();
      pos = __shfl_sync(kFull, pos, leader);
      if (key[u] >= 0) eb[pos + __popc(grp[u] & below)] = e0 + 32 * u + lane;
    }
  }
}

// dA (B, N, C) from the CSR: the sum, in f32 and in list (slot) order, of
// the cotangent rows on each point's list, rounded once to T. A warp takes
// the points whose lists start in one run of kBwdRun entries of the CSR
// (`rfirst`), so each warp starts about as much work whatever the lists'
// lengths (a first hit collects every filled slot of its queries), and
// streams their lists, one contiguous stretch of the CSR, to the end of its
// last point's list: kBwdInFlight rows loaded ahead of their adds, lanes on
// channel pairs (JP pairs a lane, C <= 64 * JP); a point with an empty list
// gets a zero row.
template <typename T, int JP>
__global__ void __launch_bounds__(kBwdSumWarps * 32)
group_bwd_sum(const int* __restrict__ off, const int* __restrict__ ent, const int* __restrict__ rfirst,
              const T* __restrict__ g, int B, int N, int Mns, int C, int R, T* __restrict__ dA) {
  using P2 = typename PairOf<T>::type;
  const int lane = threadIdx.x & 31;
  const long long run = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (run >= (long long)B * R) return;
  const int b = (int)(run / R), k = (int)(run - (long long)b * R);
  const int lo = rfirst[(size_t)b * R + k], hi = k + 1 < R ? rfirst[(size_t)b * R + k + 1] : N;
  if (lo >= hi) return;
  const int* ob = off + (size_t)b * (N + 1);
  const int* eb = ent + (size_t)b * Mns;
  const T* gb = g + (size_t)b * Mns * C;
  T* db = dA + (size_t)b * N * C;
  const bool vec = !(C & 1) && pair_aligned<T>(g) && pair_aligned<T>(dA);
  const int E0 = ob[lo], E1 = ob[hi];
  float acc[JP][2];
#pragma unroll
  for (int j = 0; j < JP; ++j) acc[j][0] = acc[j][1] = 0.0f;
  // the list ends of points wbase .. wbase + 31, one a lane
  int cur = lo, wbase = lo;
  int win = wbase + lane < N ? ob[wbase + lane + 1] : 0x7fffffff;
  int cur_end = __shfl_sync(kFull, win, 0);
  auto finish = [&]() {  // point cur's row out; the next point's sum starts at 0
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int c = 2 * (lane + 32 * j);
      if (c < C) store2<T>(db + (size_t)cur * C, c, C, vec, pair_of<T>(acc[j][0], acc[j][1]));
      acc[j][0] = acc[j][1] = 0.0f;
    }
    if (++cur - wbase >= 32) {
      wbase = cur;
      win = wbase + lane < N ? ob[wbase + lane + 1] : 0x7fffffff;
    }
    cur_end = __shfl_sync(kFull, win, cur - wbase);
  };
  for (int c0 = E0; c0 < E1; c0 += 32) {
    const int cnt = min(32, E1 - c0);
    const int e_lane = lane < cnt ? eb[c0 + lane] : 0;  // slot numbers, coalesced
    for (int u0 = 0; u0 < cnt; u0 += kBwdInFlight) {
      P2 v[kBwdInFlight][JP];
#pragma unroll
      for (int u = 0; u < kBwdInFlight; ++u) {
        const T* row = gb + (size_t)__shfl_sync(kFull, e_lane, (u0 + u) & 31) * C;
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const int c = 2 * (lane + 32 * j);
          if (u0 + u < cnt && c < C) v[u][j] = load2<T>(row, c, C, vec);
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdInFlight; ++u) {
        if (u0 + u >= cnt) break;
        while (c0 + u0 + u >= cur_end) finish();  // warp-uniform: past the end of point cur's list
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const int c = 2 * (lane + 32 * j);
          if (c < C) {
            acc[j][0] += to_f(v[u][j].x);
            acc[j][1] += to_f(v[u][j].y);
          }
        }
      }
    }
  }
  while (cur < hi) finish();  // the last list's point and any empty lists after it
}

// partial[blk] (C0, C) = sum over the slots of tiles
// [blk * tiles_per_block, (blk + 1) * tiles_per_block) of raw[b, :, p] (x) g[slot];
// a tile is kRawBwdTile queries of one cloud. JP as in the forward.
template <typename T, int JP>
__global__ void __launch_bounds__(kRawBwdWarps * 32)
group_raw_bwd_partial(const int* __restrict__ idx, const T* __restrict__ g, const T* __restrict__ raw, int B, int N,
                      int M, int ns, int C0, int C, int tiles_per_block, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_red = reinterpret_cast<float*>(smem);  // [warp][C0][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_rv = reinterpret_cast<float*>(smem + raw_bwd_red_bytes(C0, C)) + warp * 32 * kMaxC0;  // [slot][kMaxC0]
  const int tiles_per_cloud = (M + kRawBwdTile - 1) / kRawBwdTile;
  const int t0 = blockIdx.x * tiles_per_block, t1 = min(B * tiles_per_cloud, t0 + tiles_per_block);
  const bool vec = !(C & 1) && pair_aligned<T>(g);
  float acc[kMaxC0][JP][2];
#pragma unroll
  for (int i = 0; i < kMaxC0; ++i)
#pragma unroll
    for (int j = 0; j < JP; ++j) acc[i][j][0] = acc[i][j][1] = 0.0f;

  for (int t = t0; t < t1; ++t) {
    const int b = t / tiles_per_cloud;
    const T* rb = raw + (size_t)b * C0 * N;
    for (int qi = warp; qi < kRawBwdTile; qi += kRawBwdWarps) {
      const int q = (t - b * tiles_per_cloud) * kRawBwdTile + qi;
      if (q >= M) break;
      const size_t row = (size_t)b * M + q;
      const int* iq = idx + row * ns;
      const T* gq = g + row * ns * (size_t)C;
      const int p0 = iq[0];
      if (p0 < 0) continue;  // no hit: no gradient
      float gs[JP][2];  // slot 0's and the filled slots' rows, summed in slot order
#pragma unroll
      for (int j = 0; j < JP; ++j) gs[j][0] = gs[j][1] = 0.0f;
      for (int k0 = 0; k0 < ns; k0 += 32) {
        const int cnt = min(32, ns - k0), k = k0 + lane;
        const int p = k < ns ? iq[k] : p0;
        const bool real = k > 0 && p != p0;  // filled slots repeat the first hit
        const unsigned mr = __ballot_sync(kFull, real);
        // a real slot's raw column to the warp's buffer, every lane's loads
        // in flight at once
        float rv[kMaxC0];
#pragma unroll
        for (int i = 0; i < kMaxC0; ++i) rv[i] = real && i < C0 ? to_f(rb[(size_t)i * N + p]) : 0.0f;
        *reinterpret_cast<float4*>(s_rv + lane * kMaxC0) = make_float4(rv[0], rv[1], rv[2], rv[3]);
        *reinterpret_cast<float4*>(s_rv + lane * kMaxC0 + 4) = make_float4(rv[4], rv[5], rv[6], rv[7]);
        __syncwarp();
        for (int kb = 0; kb < cnt; kb += kRawBwdInFlight) {
          float v[kRawBwdInFlight][JP][2];  // the batch's rows, all loads first
#pragma unroll
          for (int u = 0; u < kRawBwdInFlight; ++u)
#pragma unroll
            for (int j = 0; j < JP; ++j) {
              const int c = 2 * (lane + 32 * j);
              v[u][j][0] = v[u][j][1] = 0.0f;
              if (kb + u < cnt && c < C) {
                const typename PairOf<T>::type r = load2<T>(gq + (size_t)(k0 + kb + u) * C, c, C, vec);
                v[u][j][0] = to_f(r.x);
                v[u][j][1] = to_f(r.y);
              }
            }
#pragma unroll
          for (int u = 0; u < kRawBwdInFlight; ++u) {
            const int kk = kb + u;
            if (kk >= cnt) break;
            if (mr >> kk & 1u) {
              // its raw column as two broadcast loads
              const float4 xa = *reinterpret_cast<const float4*>(s_rv + kk * kMaxC0);
              const float4 xb = *reinterpret_cast<const float4*>(s_rv + kk * kMaxC0 + 4);
              const float x[kMaxC0] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
              for (int i = 0; i < kMaxC0; ++i) {
                if (i >= C0) continue;
#pragma unroll
                for (int j = 0; j < JP; ++j) {
                  acc[i][j][0] = fmaf(x[i], v[u][j][0], acc[i][j][0]);
                  acc[i][j][1] = fmaf(x[i], v[u][j][1], acc[i][j][1]);
                }
              }
            } else {  // slot 0 or a filled slot
#pragma unroll
              for (int j = 0; j < JP; ++j) {
                gs[j][0] += v[u][j][0];
                gs[j][1] += v[u][j][1];
              }
            }
          }
        }
        __syncwarp();
      }
      // the first hit's raw column times slot 0's and the filled slots' rows
#pragma unroll
      for (int i = 0; i < kMaxC0; ++i) {
        if (i >= C0) continue;
        const float x = to_f(rb[(size_t)i * N + p0]);
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          acc[i][j][0] = fmaf(x, gs[j][0], acc[i][j][0]);
          acc[i][j][1] = fmaf(x, gs[j][1], acc[i][j][1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxC0; ++i)
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int c = 2 * (lane + 32 * j);
      if (i < C0 && c < C) s_red[(warp * C0 + i) * C + c] = acc[i][j][0];
      if (i < C0 && c + 1 < C) s_red[(warp * C0 + i) * C + c + 1] = acc[i][j][1];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < C0 * C; e += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kRawBwdWarps; ++w) s += s_red[w * C0 * C + e];
    partial[(size_t)blockIdx.x * C0 * C + e] = s;
  }
}

// dW0[e] = the P partials' sum at e, in a fixed order: warp w sums partials
// w, w + 32, ... in turn, then the 32 runs are added in warp order.
template <typename T>
__global__ void __launch_bounds__(kReduceWarps * 32)
group_raw_bwd_reduce(const float* __restrict__ partial, int P, int E, T* __restrict__ dW0) {
  __shared__ float s_run[kReduceWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, e = blockIdx.x * 32 + lane;
  float v = 0.0f;
  if (e < E) {
#pragma unroll 8
    for (int pi = warp; pi < P; pi += kReduceWarps) v += partial[(size_t)pi * E + e];
  }
  s_run[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && e < E) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) s += s_run[w][lane];
    dW0[e] = from_f<T>(s);
  }
}

template <typename T, bool RAW, int JP>
cudaError_t launch_fwd_jp(const FwdArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(group_fwd_kernel<T, RAW, JP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.B * ((a.M + a.qb - 1) / a.qb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  group_fwd_kernel<T, RAW, JP><<<(unsigned)blocks, kFwdWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool RAW>
cudaError_t launch_fwd(const FwdArgs& a, size_t smem, cudaStream_t stream) {
  if (a.C <= 64) return launch_fwd_jp<T, RAW, 1>(a, smem, stream);
  if (a.C <= 128) return launch_fwd_jp<T, RAW, 2>(a, smem, stream);
  if constexpr (!RAW) return launch_fwd_jp<T, RAW, 4>(a, smem, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int JP>
cudaError_t launch_bwd_sum(const BwdArgs& a, const void* g, void* dA, cudaStream_t stream) {
  group_bwd_sum<T, JP><<<a.sum_blocks, kBwdSumWarps * 32, 0, stream>>>(
      a.off, a.ent, a.rfirst, static_cast<const T*>(g), a.B, a.N, a.Mns, a.C, a.R, static_cast<T*>(dA));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, const void* g, void* dA, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(group_bwd_build, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.build_smem);
  if (err != cudaSuccess) return err;
  group_bwd_build<<<a.B, kBwdBuildThreads, a.build_smem, stream>>>(a.idx, a.N, a.Mns, a.segs, a.R, a.off, a.ent,
                                                                    a.rfirst);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.C <= 64) return launch_bwd_sum<T, 1>(a, g, dA, stream);
  if (a.C <= 128) return launch_bwd_sum<T, 2>(a, g, dA, stream);
  return launch_bwd_sum<T, 4>(a, g, dA, stream);
}

template <typename T, int JP>
cudaError_t launch_raw_bwd(const int* idx, const void* g, const void* raw, int B, int N, int M, int ns, int C0, int C,
                           int tiles_per_block, int blocks, size_t smem, float* partial, void* dW0,
                           cudaStream_t stream) {
  group_raw_bwd_partial<T, JP><<<blocks, kRawBwdWarps * 32, smem, stream>>>(
      idx, static_cast<const T*>(g), static_cast<const T*>(raw), B, N, M, ns, C0, C, tiles_per_block, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int E = C0 * C;
  group_raw_bwd_reduce<T><<<(E + 31) / 32, kReduceWarps * 32, 0, stream>>>(partial, blocks, E, static_cast<T*>(dW0));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for A/raw/W0/out. raw != null selects raw
// mode (W0 (C0, C) required, C <= 128, C0 <= 8); otherwise plane mode reads
// A (C <= 256). need may be null. block_queries, stage_xyz and smem_bytes are
// the wrapper's plan (`group_plan`); a plan whose bytes disagree with
// `fwd_smem`, or over 227 KB, is refused. Writes out (B, M, ns, C) and idx
// (B, M, ns). Returns the CUDA error of the launch.
extern "C" int or4d_group_fwd(int dtype, const float* xyz, const float* new_xyz, int B, int N, int M, float r2,
                              int ns, const int* need, const void* A, const void* raw, const void* W0, int C0, int C,
                              void* out, int* idx, int block_queries, int stage_xyz, long long smem_bytes,
                              void* stream) {
  const bool is_raw = raw != nullptr;
  if (B <= 0 || N <= 0 || M <= 0 || ns <= 0 || ns > kMaxNs || C <= 0 || (dtype != 0 && dtype != 1) ||
      (is_raw && (W0 == nullptr || C0 <= 0 || C0 > kMaxC0 || C > kMaxRawC)) ||
      (!is_raw && (A == nullptr || C > kMaxC)) || block_queries <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(N, ns, is_raw ? C0 : 0, C, stage_xyz != 0);
  if (smem != (size_t)smem_bytes || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  FwdArgs a{xyz, new_xyz, B, N, M, r2, ns, need, A, raw, W0, is_raw ? C0 : 0, C, out, idx, block_queries,
            stage_xyz ? 1 : 0};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = is_raw ? launch_fwd<float, true>(a, smem, st) : launch_fwd<float, false>(a, smem, st);
  else err = is_raw ? launch_fwd<__nv_bfloat16, true>(a, smem, st) : launch_fwd<__nv_bfloat16, false>(a, smem, st);
  return (int)err;
}

// Plane-mode backward: g (B, M, ns, C) and the forward's idx -> dA (B, N, C),
// all of g's dtype; C <= 256. segs, R, sum_blocks and smem_bytes are the
// wrapper's plan (`bwd_plan`): segs 1, 2, 4 or 8 placing warps, R =
// ceil(M * ns / kBwdRun) runs a cloud, sum_blocks = ceil(B * R / 8) and
// smem_bytes `bwd_build_smem` (with the build's 32 static bytes at most 227
// KB), or the launch is refused.
// int32 scratch: off (B, N + 1), ent (B, M * ns) and rfirst (B, R).
extern "C" int or4d_group_bwd(int dtype, const int* idx, const void* g, int B, int N, int M, int ns, int C, int segs,
                              int R, long long sum_blocks, long long smem_bytes, int* off, int* ent, int* rfirst,
                              void* dA, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || ns <= 0 || ns > kMaxNs || C <= 0 || C > kMaxC ||
      (dtype != 0 && dtype != 1) || (segs != 1 && segs != 2 && segs != 4 && segs != kBwdBuildThreads / 32))
    return (int)cudaErrorInvalidValue;
  const long long Mns = (long long)M * ns;
  const size_t smem = bwd_build_smem(N, segs);
  // the build's counts beside its static scan words must fit a block
  if (Mns > 0x7fffffffLL || (Mns + kBwdRun - 1) / kBwdRun != R ||
      ((long long)B * R + kBwdSumWarps - 1) / kBwdSumWarps != sum_blocks || sum_blocks > 0x7fffffffLL ||
      smem != (size_t)smem_bytes || smem + sizeof(int) * (kBwdBuildThreads / 32) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{idx, B, N, (int)Mns, C, segs, R, (unsigned)sum_blocks, smem, off, ent, rfirst};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_bwd<float>(a, g, dA, st) : launch_bwd<__nv_bfloat16>(a, g, dA, st));
}

// Raw-mode backward: g (B, M, ns, C), raw (B, C0, N) and the forward's idx ->
// dW0 (C0, C), all of raw's dtype. tiles_per_block, blocks and smem_bytes are
// the wrapper's plan (`raw_bwd_plan`): blocks must be the tiles of 32 queries
// (B * ceil(M / 32)) over tiles_per_block, and smem_bytes `raw_bwd_smem`, or
// the launch is refused; partial: (blocks, C0, C) f32 scratch.
extern "C" int or4d_group_raw_bwd(int dtype, const int* idx, const void* g, const void* raw, int B, int N, int M,
                                  int ns, int C0, int C, int tiles_per_block, int blocks, long long smem_bytes,
                                  float* partial, void* dW0, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || ns <= 0 || ns > kMaxNs || C0 <= 0 || C0 > kMaxC0 || C <= 0 || C > kMaxRawC ||
      (dtype != 0 && dtype != 1) || tiles_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)B * ((M + kRawBwdTile - 1) / kRawBwdTile);
  const size_t smem = raw_bwd_smem(C0, C);
  if ((tiles + tiles_per_block - 1) / tiles_per_block != blocks || smem != (size_t)smem_bytes || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (dtype == 0) {
    err = C <= 64 ? launch_raw_bwd<float, 1>(idx, g, raw, B, N, M, ns, C0, C, tiles_per_block, blocks, smem, partial,
                                              dW0, st)
                  : launch_raw_bwd<float, 2>(idx, g, raw, B, N, M, ns, C0, C, tiles_per_block, blocks, smem, partial,
                                              dW0, st);
  } else {
    err = C <= 64 ? launch_raw_bwd<__nv_bfloat16, 1>(idx, g, raw, B, N, M, ns, C0, C, tiles_per_block, blocks, smem,
                                                      partial, dW0, st)
                  : launch_raw_bwd<__nv_bfloat16, 2>(idx, g, raw, B, N, M, ns, C0, C, tiles_per_block, blocks, smem,
                                                      partial, dW0, st);
  }
  return (int)err;
}
