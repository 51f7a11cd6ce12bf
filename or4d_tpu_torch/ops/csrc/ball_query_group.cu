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
//     four points a lane per step, three 16-byte loads, one vote for the
//     steps without a hit), into a per-warp hit list. Then the rows, lanes
//     owning adjacent channel pairs, one 8-byte (f32) or 4-byte (bf16) store
//     a lane per row. Raw mode: 16 slots at a time, lanes fetch the slots'
//     raw columns (all loads in flight at once) into a per-warp buffer; each
//     row reads its column back as two broadcast loads and multiplies it by
//     W0's column pairs (staged as f32 in shared memory and loaded into
//     registers after the search, which they would otherwise crowd); the
//     fmaf chain over i = 0..C0-1 keeps the rows bit-equal to the plain
//     version. Plane mode: 32 slots at a time, four rows loaded ahead of
//     their stores.
//   * plane backward: bytes (g read once, dA written once). Deterministic,
//     no atomics in the sums: one block per cloud builds the inverse of its
//     saved indices once in shared memory, as a list per support point
//     (count with shared atomics, exclusive scan, fill), puts each list in
//     query order (its entries are distinct queries; a rank sort in
//     registers, or one lane past 32 entries), and one warp per support
//     point sums the cotangent rows that reach it in (query, slot) order: a
//     real hit, then, for a first hit, the query's filled slots. That is the
//     order of a sequential scatter over the flattened slots; the atomics
//     only count and place, the sort makes the order. The scan of the saved
//     indices is one coalesced pass, a thread per slot: a slot is real when
//     it is slot 0 or differs from slot 0 (real hits are distinct and come
//     first; filled slots repeat the first hit). The sum keeps up to four
//     cotangent rows in flight per warp (loads first, then the adds in
//     order): one row at a time leaves the warp waiting on each load. The
//     lists take (2N + 1 + M + M*ns) ints, 131.6 KB for an SA1 cloud (N
//     8000, M 512, ns 32); shapes whose lists do not fit are refused. A block
//     per cloud, not per tile of its points: per-tile blocks each rescan
//     the cloud's M*ns slots and clear a (point, query) table, 7x the bytes
//     bound on SA1 on an H100.
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

constexpr int kMaxCL = 8;  // plane backward: channels per lane, C <= 256
constexpr int kMaxC = 32 * kMaxCL;
constexpr int kMaxRawC = 128;  // raw mode: C <= 128
constexpr int kMaxNs = 127;  // a slot fits the 7 bits of a backward list entry
constexpr int kMaxC0 = 8;
constexpr int kChunk = 512;
constexpr int kBwdThreads = 512;  // plane backward: threads per cloud
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

// plane backward: dynamic shared memory of one cloud's inverse, as ints:
// per point a count and a list start (+1), per query its real slots, and
// one entry per slot
inline size_t bwd_smem(int N, int M, int ns) { return sizeof(int) * ((size_t)2 * N + 1 + M + (size_t)M * ns); }

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

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

// r[] = row gr (C channels, lane-owned) as f32
template <typename T>
__device__ __forceinline__ void load_row(float (&r)[kMaxCL], const T* gr, int C, int lane) {
#pragma unroll
  for (int j = 0; j < kMaxCL; ++j) {
    const int c = lane + 32 * j;
    r[j] = c < C ? to_f(gr[c]) : 0.0f;
  }
}

__device__ __forceinline__ void add_to(float (&acc)[kMaxCL], const float (&r)[kMaxCL]) {
#pragma unroll
  for (int j = 0; j < kMaxCL; ++j) acc[j] += r[j];
}

constexpr int kInFlight = 4;  // cotangent rows loaded ahead of their adds

// acc += rows [k0, ns) of one query's slots (gm: its slot 0), in slot order
template <typename T>
__device__ __forceinline__ void add_fill(float (&acc)[kMaxCL], const T* gm, int k0, int ns, int C, int lane) {
  for (int k = k0; k < ns; k += kInFlight) {
    float r[kInFlight][kMaxCL];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (k + u < ns) load_row(r[u], gm + (size_t)(k + u) * C, C, lane);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (k + u < ns) add_to(acc, r[u]);
  }
}

// acc += the rows of up to kInFlight real slots (qm[u], qk[u]) of one cloud
// (gb: its g; qm < 0: none), in order, a first hit (slot 0) followed by its
// query's filled slots; the rows are loaded before the adds
template <typename T>
__device__ __forceinline__ void add_slots(float (&acc)[kMaxCL], const T* gb, const int (&qm)[kInFlight],
                                          const int (&qk)[kInFlight], const int* s_thr, int ns, int C, int lane) {
  float r[kInFlight][kMaxCL];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u)
    if (qm[u] >= 0) load_row(r[u], gb + ((size_t)qm[u] * ns + qk[u]) * C, C, lane);
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    if (qm[u] < 0) continue;
    add_to(acc, r[u]);
    if (qk[u] == 0) add_fill(acc, gb + (size_t)qm[u] * ns * C, s_thr[qm[u]], ns, C, lane);
  }
}

// The plane backward's slot scan, one thread per slot of cloud b's idx
// (coalesced): real(m, k, p) for every real slot, and the count of
// real slots of each query into s_thr (0 with no hit).
template <typename F>
__device__ __forceinline__ void scan_real_slots(const int* I, int M, int ns, int* s_thr, F real) {
  for (int e = threadIdx.x; e < M * ns; e += blockDim.x) {
    const int m = e / ns, k = e - m * ns;
    const int p = I[e], p0 = I[e - k];
    if (p0 < 0) {
      if (k == 0) s_thr[m] = 0;
      continue;
    }
    if (k > 0 && p == p0) continue;  // a filled slot
    real(m, k, p);
    if (k == ns - 1 || I[e + 1] == p0) s_thr[m] = k + 1;
  }
}

// dA[b, n, :] = sum of g rows routed to support point n, in (query, slot)
// order; one block per cloud: the inverse of the cloud's real slots built
// once, as lists per support point (count, exclusive scan, fill), each list
// put in query order (its entries are distinct queries), then one warp per
// support point sums its list.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
group_bwd_kernel(const int* __restrict__ idx, const T* __restrict__ g, int N, int M, int ns, int C,
                 T* __restrict__ dA) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* cnt = reinterpret_cast<int*>(smem);  // [N]: real slots per point, then a fill cursor
  int* off = cnt + N;                       // [N + 1]: list starts
  int* s_thr = off + N + 1;                 // [M]: real slots per query
  int* list = s_thr + M;                    // [real slots]: m << 7 | k
  __shared__ int s_warp[kBwdThreads / 32];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int* I = idx + (size_t)b * M * ns;
  for (int i = threadIdx.x; i < N; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  scan_real_slots(I, M, ns, s_thr, [&](int, int, int p) { atomicAdd(&cnt[p], 1); });
  __syncthreads();

  // exclusive scan of cnt into off: a contiguous run of points per thread
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int lo = min(N, threadIdx.x * per), hi = min(N, lo + per);
  int run = 0;
  for (int i = lo; i < hi; ++i) run += cnt[i];
  int incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int base = incl - run;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  for (int i = lo; i < hi; ++i) {
    off[i] = base;
    base += cnt[i];
  }
  if (threadIdx.x == blockDim.x - 1) off[N] = base;
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  scan_real_slots(I, M, ns, s_thr, [&](int m, int k, int p) { list[off[p] + atomicAdd(&cnt[p], 1)] = (m << 7) | k; });
  __syncthreads();

  const T* gb = g + (size_t)b * M * ns * C;
  for (int n = warp; n < N; n += warps) {
    const int s0 = off[n], L = off[n + 1] - s0;
    int* seg = list + s0;
    // query order: rank by comparison in registers, or by one lane past 32
    if (L > 1 && L <= 32) {
      const int key = lane < L ? seg[lane] : 0x7fffffff;
      int rank = 0;
      for (int j = 0; j < L; ++j) rank += __shfl_sync(0xffffffffu, key, j) < key;
      __syncwarp();
      if (lane < L) seg[rank] = key;
    } else if (L > 32 && lane == 0) {
      for (int i = 1; i < L; ++i) {
        const int key = seg[i];
        int j = i - 1;
        for (; j >= 0 && seg[j] > key; --j) seg[j + 1] = seg[j];
        seg[j + 1] = key;
      }
    }
    __syncwarp();
    float acc[kMaxCL];
#pragma unroll
    for (int j = 0; j < kMaxCL; ++j) acc[j] = 0.0f;
    for (int i = 0; i < L; i += kInFlight) {
      int qm[kInFlight], qk[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int key = i + u < L ? seg[i + u] : -1;
        qm[u] = key >= 0 ? key >> 7 : -1;
        qk[u] = key >= 0 ? key & 127 : 0;
      }
      add_slots(acc, gb, qm, qk, s_thr, ns, C, lane);
    }
    T* out = dA + ((size_t)b * N + n) * C;
#pragma unroll
    for (int j = 0; j < kMaxCL; ++j) {
      const int c = lane + 32 * j;
      if (c < C) out[c] = from_f<T>(acc[j]);
    }
  }
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

template <typename T>
cudaError_t launch_bwd(const int* idx, const void* g, int B, int N, int M, int ns, int C, void* dA,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem(N, M, ns);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem + sizeof(int) * kBwdThreads / 32 > (size_t)optin) return cudaErrorInvalidValue;  // + its static s_warp
  err = cudaFuncSetAttribute(group_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  group_bwd_kernel<T><<<B, kBwdThreads, smem, stream>>>(idx, static_cast<const T*>(g), N, M, ns, C,
                                                         static_cast<T*>(dA));
  return cudaGetLastError();
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
// all of g's dtype. C <= 256, and one cloud's inverse (bwd_smem) must fit in
// a block's shared memory.
extern "C" int or4d_group_bwd(int dtype, const int* idx, const void* g, int B, int N, int M, int ns, int C, void* dA,
                              void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || ns <= 0 || ns > kMaxNs || C <= 0 || C > kMaxC ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_bwd<float>(idx, g, B, N, M, ns, C, dA, st)
                          : launch_bwd<__nv_bfloat16>(idx, g, B, N, M, ns, C, dA, st));
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
