// Fused eval set-abstraction stage: ball query + grouping + folded-BN
// two-layer MLP + max over the slots, for one (radius, nsample) scale.
//
// Replaces the TPU kernels `ball_query_group_mlp_pallas_v4` (raw mode,
// or4d_tpu/ops/pallas_ball_query.py:1928, kernel :610) and
// `ball_query_group_mlp_pallas` (plane mode, :1064, kernel :807). For every
// query q of cloud b it computes
//   out[b, q] = max_k relu(a1 * (hmid_k @ W1) + b1),
//   hmid_k    = round_W1(relu((A[idx_k] - Bq[b, q]) * a0 + b0)),
// over the first `ns` support points with |q - p|^2 < r^2 in scan order
// (first-hit fill of the empty slots cannot change the max, so only the
// real hits are computed; a query with no hit uses a zero A row, as the TPU
// kernels' one-hot selection does). The layer-1 row A[idx] is
//   raw mode:   round_A(raw[b, :, idx] . W0)  (f32 accumulation), from the
//               channel-major [xyz|features] plane (B, C0(+1), N);
//   plane mode: A[b, idx, :] from a precomputed (B, N, C1) plane.
// Paired raw mode computes two halves per slot that share the hit search and
// W1: the second half reads raw channel C0 in place of channel C0-1 (the
// reverse direction's mask channel), giving out (B, M, 2*C2) = [fwd | rev] —
// the JAX package's W0p / blockdiag(W1, W1) product without the zero blocks.
// Bounds: with `need` (B, M) (chunk counts from the FPS kernel's hit
// counts, or4d_tpu/ops/pallas_ball_query.py:587-602) the search stops at
// need*512 points; the bound is exact, so results do not change.
//
// Rounding matches the TPU kernels: d2 = (dx*dx + dy*dy) + dz*dz with each
// op rounded alone and the strict test d2 < r2 (r2 the f32 of r*r); A in the
// A dtype; Bq, a0, b0, a1, b1 and all sums in f32; hmid rounded to W1's
// dtype before the product; the output stored in the A dtype.
//
// What bounds it on the H100: the per-slot MLP, C1*C2 multiply-adds per real
// hit (64x128 for SA1's second scale, 128x128 in SA2), run here on the FP32
// pipes, plus the scan-order search, which is latency-bound (a dependent
// ballot per 32 points). Design: one warp per query, 8 warps per block over
// 32 queries of one cloud; W1, W0, a1 and b1 sit in shared memory once per
// block (SA1 paired: 64x128 bf16 = 16 KB); the first `ns` hit indices go to
// a per-warp shared list via ballot/popc; each lane owns C1/32 layer-1
// channels and C2/32 output channels, keeping the slot max in registers. No
// tensor cores, one-hot products, prefix sums or sorts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;
constexpr int kQueriesPerBlock = 32;
constexpr int kMaxC1L = 4;  // C1 <= 128
constexpr int kMaxC2L = 8;  // C2 <= 256
constexpr int kMaxC1 = 32 * kMaxC1L;
constexpr int kMaxC2 = 32 * kMaxC2L;
constexpr int kMaxNs = 128;
constexpr int kMaxC0 = 16;
constexpr int kChunk = 512;

struct SAArgs {
  const float* xyz;      // (B, N, 3)
  const float* new_xyz;  // (B, M, 3)
  int B, N, M;
  float r2;
  int ns;
  const int* need;  // (B, M) chunk bound, or null
  const void* raw;  // (B, C0 + paired, N), raw mode
  const void* W0;   // (C0, C1), raw mode
  int C0;
  int paired;
  const void* A;   // (B, N, C1), plane mode
  const void* Bq;  // (B, M, C1)
  const float* a0;
  const float* b0;  // (C1,)
  const void* W1;   // (C1, C2)
  const float* a1;
  const float* b1;  // (C2,)
  int C1, C2;
  void* out;  // (B, M, C2 * (1 + paired))
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <typename T> __device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T>
__host__ __device__ inline size_t smem_bytes(int C0, int C1, int C2, bool raw) {
  return align16(sizeof(T) * C1 * C2) + (raw ? align16(sizeof(T) * C0 * C1) : 0) +
         align16(sizeof(float) * 2 * C2) + (size_t)kWarps * (kMaxNs + kMaxC1) * sizeof(float);
}

template <typename T, bool RAW>
__global__ void __launch_bounds__(kWarps * 32) sa_group_mlp_kernel(SAArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C1 = a.C1, C2 = a.C2, C0 = a.C0, ns = a.ns, N = a.N, M = a.M;
  T* s_w1 = reinterpret_cast<T*>(smem);
  size_t off = align16(sizeof(T) * C1 * C2);
  T* s_w0 = reinterpret_cast<T*>(smem + off);
  if (RAW) off += align16(sizeof(T) * C0 * C1);
  float* s_a1 = reinterpret_cast<float*>(smem + off);
  float* s_b1 = s_a1 + C2;
  off += align16(sizeof(float) * 2 * C2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* s_idx = reinterpret_cast<int*>(smem + off) + warp * (kMaxNs + kMaxC1);
  float* s_h = reinterpret_cast<float*>(s_idx + kMaxNs);

  const T* W1 = static_cast<const T*>(a.W1);
  for (int i = threadIdx.x; i < C1 * C2; i += blockDim.x) s_w1[i] = W1[i];
  if (RAW) {
    const T* W0 = static_cast<const T*>(a.W0);
    for (int i = threadIdx.x; i < C0 * C1; i += blockDim.x) s_w0[i] = W0[i];
  }
  for (int i = threadIdx.x; i < C2; i += blockDim.x) {
    s_a1[i] = a.a1[i];
    s_b1[i] = a.b1[i];
  }
  __syncthreads();

  const int tiles = (M + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kQueriesPerBlock;
  const float* xyz = a.xyz + (size_t)b * N * 3;
  const int halves = a.paired ? 2 : 1;
  const int craw = C0 + a.paired;

  float ra0[kMaxC1L], rb0[kMaxC1L];
#pragma unroll
  for (int j = 0; j < kMaxC1L; ++j) {
    const int c = lane + 32 * j;
    ra0[j] = c < C1 ? a.a0[c] : 0.0f;
    rb0[j] = c < C1 ? a.b0[c] : 0.0f;
  }

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
      if (i < limit) {
        const float d2 = sqdist(qx - xyz[3 * i], qy - xyz[3 * i + 1], qz - xyz[3 * i + 2]);
        hit = d2 < a.r2;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int r = cnt + __popc(m & ((1u << lane) - 1u));
        if (r < ns) s_idx[r] = i;
      }
      cnt += __popc(m);
    }
    const int nreal = min(cnt, ns);
    __syncwarp();

    float bq[kMaxC1L];
    const T* Bq = static_cast<const T*>(a.Bq) + row * C1;
#pragma unroll
    for (int j = 0; j < kMaxC1L; ++j) {
      const int c = lane + 32 * j;
      bq[j] = c < C1 ? to_f(Bq[c]) : 0.0f;
    }
    float best[2][kMaxC2L];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kMaxC2L; ++j) best[h][j] = 0.0f;  // every candidate is a ReLU output

    const int slots = max(nreal, 1);
    for (int k = 0; k < slots; ++k) {
      const int p = nreal > 0 ? s_idx[k] : -1;  // -1: no hit, zero layer-1 row
      for (int h = 0; h < halves; ++h) {
#pragma unroll
        for (int j = 0; j < kMaxC1L; ++j) {
          const int c = lane + 32 * j;
          if (c < C1) {
            float v = 0.0f;
            if (p >= 0) {
              if (RAW) {
                const T* raw = static_cast<const T*>(a.raw) + (size_t)b * craw * N + p;
                float acc = 0.0f;
                for (int i = 0; i < C0; ++i) {
                  const int ch = (h == 1 && i == C0 - 1) ? C0 : i;
                  acc = fmaf(to_f(raw[(size_t)ch * N]), to_f(s_w0[i * C1 + c]), acc);
                }
                v = round_to<T>(acc);
              } else {
                v = to_f(static_cast<const T*>(a.A)[((size_t)b * N + p) * C1 + c]);
              }
            }
            const float hm = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(v, bq[j]), ra0[j]), rb0[j]), 0.0f);
            s_h[c] = round_to<T>(hm);
          }
        }
        __syncwarp();
        float acc[kMaxC2L];
#pragma unroll
        for (int j = 0; j < kMaxC2L; ++j) acc[j] = 0.0f;
#pragma unroll 4
        for (int c = 0; c < C1; ++c) {
          const float hv = s_h[c];
          const T* wrow = s_w1 + c * C2;
#pragma unroll
          for (int j = 0; j < kMaxC2L; ++j) {
            const int o = lane + 32 * j;
            if (o < C2) acc[j] = fmaf(hv, to_f(wrow[o]), acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxC2L; ++j) {
          const int o = lane + 32 * j;
          if (o < C2) {
            const float v = fmaxf(__fadd_rn(__fmul_rn(acc[j], s_a1[o]), s_b1[o]), 0.0f);
            if (h == 0) best[0][j] = fmaxf(best[0][j], v);
            else best[1][j] = fmaxf(best[1][j], v);
          }
        }
        __syncwarp();
      }
    }

    T* out = static_cast<T*>(a.out) + row * (size_t)(C2 * halves);
#pragma unroll
    for (int j = 0; j < kMaxC2L; ++j) {
      const int o = lane + 32 * j;
      if (o < C2) {
        out[o] = from_f<T>(best[0][j]);
        if (halves == 2) out[C2 + o] = from_f<T>(best[1][j]);
      }
    }
    __syncwarp();
  }
}

template <typename T, bool RAW>
cudaError_t launch(const SAArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.C0, a.C1, a.C2, RAW);
  cudaError_t err = cudaFuncSetAttribute(sa_group_mlp_kernel<T, RAW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (a.M + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const long long blocks = tiles * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sa_group_mlp_kernel<T, RAW><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for raw/W0/A/Bq/W1/out. raw != null
// selects raw mode (W0 required, C0 = W0 rows, paired allowed); otherwise
// plane mode reads A. need may be null. Returns the CUDA error of the launch.
extern "C" int or4d_sa_group_mlp(int dtype, const float* xyz, const float* new_xyz, int B, int N, int M,
                                 float r2, int ns, const int* need, const void* raw, const void* W0, int C0,
                                 int paired, const void* A, const void* Bq, const float* a0, const float* b0,
                                 const void* W1, const float* a1, const float* b1, int C1, int C2, void* out,
                                 void* stream) {
  const bool is_raw = raw != nullptr;
  if (B <= 0 || N <= 0 || M <= 0 || ns <= 0 || ns > kMaxNs || C1 <= 0 || C1 > kMaxC1 || C2 <= 0 ||
      C2 > kMaxC2 || (is_raw && (W0 == nullptr || C0 <= 0 || C0 > kMaxC0)) || (!is_raw && (A == nullptr || paired)) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  SAArgs a{xyz, new_xyz, B, N, M, r2, ns, need, raw, W0, is_raw ? C0 : 0, paired ? 1 : 0, A, Bq, a0, b0, W1,
           a1, b1, C1, C2, out};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = is_raw ? launch<float, true>(a, st) : launch<float, false>(a, st);
  else err = is_raw ? launch<__nv_bfloat16, true>(a, st) : launch<__nv_bfloat16, false>(a, st);
  return (int)err;
}
