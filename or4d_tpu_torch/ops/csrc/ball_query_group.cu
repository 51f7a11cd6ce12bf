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
//     A = round_T(sum_i raw[i, p] * W0[i, :]) (f32 accumulation) from the
//     channel-major raw [xyz|features] plane (B, C0, N); backward returns
//     dW0 = sum over slots of raw[:, p] (x) g[slot] in f32, rounded to W0's
//     dtype. raw, xyz and new_xyz get no gradient (their values are model
//     inputs on this path).
//
// Selection (both modes): per query, the first `ns` support points with
// d2 < r2 in scan order, d2 = (dx*dx + dy*dy) + dz*dz with each operation
// rounded on its own and r2 the f32 of r*r; slots past the last hit repeat
// the first hit (first-hit fill); a query with no hit gets zero rows and
// passes no gradient. With `need` (B, M) (chunk counts from the FPS
// kernel's hit counts: raw mode, and the gated plane mode) the search stops
// at need*512 points, an exact bound. Outputs are query-major
// (B, M, ns, C); the TPU's slot-major and slot-pair packed layouts, query
// sort and sub-tile gates change only speed on a TPU and are not carried
// over.
//
// Autograd residual: the forward saves the hit indices (B, M, ns) int32 with
// the fill applied and -1 in every slot of a query with no hit (4 bytes per
// slot: 75 MB for an S=8 train step at paper shapes) instead of rerunning
// the search in the backward as the TPU kernels do. Filled slots point at the
// first hit, so the backward routes their cotangents to it by construction.
//
// What bounds each kernel on the H100, and the design:
//   * forward: the scan-order search is latency-bound (a dependent ballot
//     per 32 points); the row writes (ns * C values per query) are the bytes.
//     One warp per query, 8 warps per block over 32 queries of one cloud;
//     hits go to a per-warp shared list via ballot/popc; each lane owns
//     C/32 channels of every row, so each row is one coalesced store. Raw
//     mode keeps W0 (C0 x C <= 8 x 128) in shared memory as f32 and reads the
//     C0 raw values of a hit once per slot.
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
//   * raw backward: the C0 x C product per slot (f32 FMAs) and the g bytes.
//     One block per cloud accumulates a C0 x C tile in registers (lane =
//     channel, C0 <= 8 rows), warps summed in fixed order into one partial
//     per cloud; a second kernel sums the partials over clouds in fixed order
//     and rounds to W0's dtype. Deterministic; no dA plane exists.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;
constexpr int kQueriesPerBlock = 32;
constexpr int kMaxCL = 8;  // channels per lane: C <= 256
constexpr int kMaxC = 32 * kMaxCL;
constexpr int kMaxRawCL = 4;  // raw mode: C <= 128
constexpr int kMaxRawC = 32 * kMaxRawCL;
constexpr int kMaxNs = 127;  // a slot fits the 7 bits of a backward list entry
constexpr int kMaxC0 = 8;
constexpr int kChunk = 512;
constexpr int kBwdThreads = 512;  // plane backward: threads per cloud

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// plane backward: dynamic shared memory of one cloud's inverse, as ints:
// per point a count and a list start (+1), per query its real slots, and
// one entry per slot
inline size_t bwd_smem(int N, int M, int ns) { return sizeof(int) * ((size_t)2 * N + 1 + M + (size_t)M * ns); }

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
};

template <typename T, bool RAW>
__global__ void __launch_bounds__(kWarps * 32) group_fwd_kernel(FwdArgs a) {
  __shared__ int s_idx_all[kWarps][kMaxNs + 1];
  __shared__ float s_w0[RAW ? kMaxC0 * kMaxRawC : 1];
  const int C = a.C, C0 = a.C0, ns = a.ns, N = a.N, M = a.M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* s_idx = s_idx_all[warp];
  if (RAW) {
    const T* W0 = static_cast<const T*>(a.W0);
    for (int i = threadIdx.x; i < C0 * C; i += blockDim.x) s_w0[i] = to_f(W0[i]);
  }
  __syncthreads();

  const int tiles = (M + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kQueriesPerBlock;
  const float* xyz = a.xyz + (size_t)b * N * 3;

  for (int qi = warp; qi < kQueriesPerBlock; qi += kWarps) {
    const int q = q0 + qi;
    if (q >= M) break;
    const size_t row = (size_t)b * M + q;
    const float qx = a.new_xyz[3 * row], qy = a.new_xyz[3 * row + 1], qz = a.new_xyz[3 * row + 2];
    int limit = N;
    if (a.need != nullptr) limit = min(N, max(a.need[row], 0) * kChunk);

    // first `ns` hits in scan order, 32 points per ballot
    int cnt = 0;
    for (int base = 0; base < limit && cnt < ns; base += 32) {
      const int i = base + lane;
      bool hit = false;
      if (i < limit) hit = sqdist(qx - xyz[3 * i], qy - xyz[3 * i + 1], qz - xyz[3 * i + 2]) < a.r2;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int r = cnt + __popc(m & ((1u << lane) - 1u));
        if (r < ns) s_idx[r] = i;
      }
      cnt += __popc(m);
    }
    const int nreal = min(cnt, ns);
    __syncwarp();

    int* idx = a.idx + row * ns;
    for (int k = lane; k < ns; k += 32) idx[k] = nreal > 0 ? s_idx[k < nreal ? k : 0] : -1;

    T* out = static_cast<T*>(a.out) + row * ns * (size_t)C;
    for (int k = 0; k < ns; ++k) {
      const int p = nreal > 0 ? s_idx[k < nreal ? k : 0] : -1;  // -1: no hit, zero row
      T* o = out + (size_t)k * C;
      if (RAW) {
        float rv[kMaxC0];
        const T* raw = static_cast<const T*>(a.raw) + (size_t)b * C0 * N;
#pragma unroll
        for (int i = 0; i < kMaxC0; ++i) rv[i] = (p >= 0 && i < C0) ? to_f(raw[(size_t)i * N + p]) : 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxRawCL; ++j) {
          const int c = lane + 32 * j;
          if (c < C) {
            float acc = 0.0f;
            for (int i = 0; i < C0; ++i) acc = fmaf(rv[i], s_w0[i * C + c], acc);
            o[c] = from_f<T>(p >= 0 ? acc : 0.0f);
          }
        }
      } else {
        const T* Arow = static_cast<const T*>(a.A) + ((size_t)b * N + (p >= 0 ? p : 0)) * C;
#pragma unroll
        for (int j = 0; j < kMaxCL; ++j) {
          const int c = lane + 32 * j;
          if (c < C) o[c] = p >= 0 ? Arow[c] : from_f<T>(0.0f);
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

// partial[b] (C0, C) = sum over cloud b's slots of raw[b, :, p] (x) g[slot].
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
group_raw_bwd_partial(const int* __restrict__ idx, const T* __restrict__ g, const T* __restrict__ raw, int N, int M,
                      int ns, int C0, int C, float* __restrict__ partial) {
  __shared__ float s_red[kWarps][kMaxC0 * kMaxRawC];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[kMaxC0][kMaxRawCL];
#pragma unroll
  for (int i = 0; i < kMaxC0; ++i)
#pragma unroll
    for (int j = 0; j < kMaxRawCL; ++j) acc[i][j] = 0.0f;
  const T* rb = raw + (size_t)b * C0 * N;
  for (int q = warp; q < M; q += kWarps) {
    const size_t row = (size_t)b * M + q;
    const int* iq = idx + row * ns;
    if (iq[0] < 0) continue;  // no hit: no gradient
    for (int k = 0; k < ns; ++k) {
      const int p = iq[k];
      float rv[kMaxC0];
#pragma unroll
      for (int i = 0; i < kMaxC0; ++i) rv[i] = i < C0 ? to_f(rb[(size_t)i * N + p]) : 0.0f;
      const T* gr = g + (row * ns + k) * C;
#pragma unroll
      for (int j = 0; j < kMaxRawCL; ++j) {
        const int c = lane + 32 * j;
        const float gv = c < C ? to_f(gr[c]) : 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxC0; ++i) acc[i][j] = fmaf(rv[i], gv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxC0; ++i)
#pragma unroll
    for (int j = 0; j < kMaxRawCL; ++j) {
      const int c = lane + 32 * j;
      if (i < C0 && c < C) s_red[warp][i * C + c] = acc[i][j];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < C0 * C; e += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_red[w][e];
    partial[(size_t)b * C0 * C + e] = s;
  }
}

template <typename T>
__global__ void group_raw_bwd_reduce(const float* __restrict__ partial, int B, int E, T* __restrict__ dW0) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += partial[(size_t)b * E + e];
  dW0[e] = from_f<T>(s);
}

template <typename T, bool RAW>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const long long blocks = (long long)((a.M + kQueriesPerBlock - 1) / kQueriesPerBlock) * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  group_fwd_kernel<T, RAW><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
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

template <typename T>
cudaError_t launch_raw_bwd(const int* idx, const void* g, const void* raw, int B, int N, int M, int ns, int C0, int C,
                           float* partial, void* dW0, cudaStream_t stream) {
  group_raw_bwd_partial<T><<<B, kWarps * 32, 0, stream>>>(idx, static_cast<const T*>(g), static_cast<const T*>(raw), N,
                                                          M, ns, C0, C, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int E = C0 * C;
  group_raw_bwd_reduce<T><<<(E + 255) / 256, 256, 0, stream>>>(partial, B, E, static_cast<T*>(dW0));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for A/raw/W0/out. raw != null selects raw
// mode (W0 (C0, C) required, C <= 128, C0 <= 8); otherwise plane mode reads
// A (C <= 256). need may be null. Writes out (B, M, ns, C) and idx
// (B, M, ns). Returns the CUDA error of the launch.
extern "C" int or4d_group_fwd(int dtype, const float* xyz, const float* new_xyz, int B, int N, int M, float r2,
                              int ns, const int* need, const void* A, const void* raw, const void* W0, int C0, int C,
                              void* out, int* idx, void* stream) {
  const bool is_raw = raw != nullptr;
  if (B <= 0 || N <= 0 || M <= 0 || ns <= 0 || ns > kMaxNs || C <= 0 || (dtype != 0 && dtype != 1) ||
      (is_raw && (W0 == nullptr || C0 <= 0 || C0 > kMaxC0 || C > kMaxRawC)) || (!is_raw && (A == nullptr || C > kMaxC)))
    return (int)cudaErrorInvalidValue;
  FwdArgs a{xyz, new_xyz, B, N, M, r2, ns, need, A, raw, W0, is_raw ? C0 : 0, C, out, idx};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = is_raw ? launch_fwd<float, true>(a, st) : launch_fwd<float, false>(a, st);
  else err = is_raw ? launch_fwd<__nv_bfloat16, true>(a, st) : launch_fwd<__nv_bfloat16, false>(a, st);
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
// dW0 (C0, C), all of raw's dtype; partial: (B, C0, C) f32 scratch.
extern "C" int or4d_group_raw_bwd(int dtype, const int* idx, const void* g, const void* raw, int B, int N, int M,
                                  int ns, int C0, int C, float* partial, void* dW0, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || ns <= 0 || ns > kMaxNs || C0 <= 0 || C0 > kMaxC0 || C <= 0 || C > kMaxRawC ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_raw_bwd<float>(idx, g, raw, B, N, M, ns, C0, C, partial, dW0, st)
                          : launch_raw_bwd<__nv_bfloat16>(idx, g, raw, B, N, M, ns, C0, C, partial, dW0, st));
}
