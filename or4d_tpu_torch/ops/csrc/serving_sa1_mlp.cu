// Serving SA1 MLP: the folded-BN two-layer MLP and the max over the slots on
// the serving cache's grouped [p_abs | f] planes, one SA1 scale per call.
//
// Replaces the TPU kernel `serving_sa1_mlp_pallas`
// (or4d_tpu/ops/pallas_serving_mlp.py:128, kernel :85, call :168). For every
// row r and query m it computes
//   out[r, m] = max_s relu(a1 * (h_s @ W1) + b1),
//   h_s       = round_W1(relu((A_s - Bq[r, m]) * a0 + b0)),
//   A_s       = round_A(planes[r, m, s, :C0] . W0)  (f32 accumulation),
// over all `ns` cached slots (first-hit-filled slots repeat a real slot's
// plane, so they never change the max). Rounding points as the TPU kernel
// (:105-122): A in the planes' dtype, the affine and ReLU in f32, h in W1's
// dtype, the W1 product accumulated in f32, the slot max in f32, the output
// in the planes' dtype. The arithmetic is the cold fused SA kernel's
// (sa_group_mlp.cu) operation for operation: the same fmaf chains in the
// same order, __fmul_rn/__fadd_rn for the affines.
//
// Cache layout (the port's own): planes (R, M, ns, 8), channels zero-padded
// to 8, so one slot is one aligned 16-byte load in bf16 (two in f32), and a
// query's slots are contiguous (ns * 16 bytes in bf16).
//
// What bounds it on the H100: the W1 product, C1*C2 multiply-adds per slot
// (64 x 128 for SA1's second scale); on the tensor cores that is ~2 ms per
// S=64 batch, on the FP32 pipes, where this kernel runs it, ~28 ms. Bytes are
// the planes once (~0.6 ms). Design: one warp per query, 8 warps per block
// over 64 queries of one row. W1 (as f32), W0 and the four affines sit in
// shared memory once per block. A warp copies its query's slot planes to
// shared memory with coalesced 16-byte loads, then works in groups of 16
// slots: layer 1 with lane = channel (C1/32 channels per lane, W0 column in
// registers) writes the rounded h of the group to a per-warp (C1, 16) f32
// tile; layer 2 with lane = output channel (C2/32 per lane) reads, per input
// channel, one W1 value per owned output and the 16 slots' h as four float4
// broadcasts, and keeps 16 x C2/32 accumulators in registers: 64 FMAs per 8
// shared loads at C2 = 128. The running slot max stays in registers; no
// (R, M, ns, C) intermediate reaches device memory. No tensor cores (a
// wgmma version is later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;
constexpr int kQueriesPerBlock = 64;
constexpr int kC0P = 8;       // plane channels, zero-padded
constexpr int kGroup = 16;    // slots per layer-2 pass
constexpr int kMaxC1L = 4;    // C1 <= 128
constexpr int kMaxC1 = 32 * kMaxC1L;
constexpr int kMaxC2 = 128;   // KJ <= 4
constexpr int kMaxNs = 128;

struct ServArgs {
  const void* planes;  // (R, M, ns, 8)
  const void* Bq;      // (R, M, C1)
  const void* W0;      // (C0, C1)
  const float* a0;
  const float* b0;     // (C1,)
  const void* W1;      // (C1, C2)
  const float* a1;
  const float* b1;     // (C2,)
  int R, M, ns, C0, C1, C2;
  void* out;           // (R, M, C2)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <typename T> __device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// position of slot sl in row c of the (C1, kGroup) h tile: float4 granules
// XOR-swizzled by (c >> 1) & 3, so the layer-1 stores (lane = channel c, one
// slot) spread over 8 banks instead of 2; layer 2 reads whole granules
__device__ __forceinline__ int h_swz(int c, int sl) {
  return ((((sl >> 2) ^ (c >> 1)) & 3) << 2) | (sl & 3);
}

// per-warp scratch: the query's slot planes, then the (C1, kGroup) h tile
template <typename T>
__host__ __device__ inline size_t warp_bytes(int ns, int C1) {
  return align16(sizeof(T) * ns * kC0P) + sizeof(float) * C1 * kGroup;
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int ns, int C0, int C1, int C2) {
  return align16(sizeof(float) * C1 * C2) + align16(sizeof(float) * C0 * C1) +
         align16(sizeof(float) * 2 * C1) + align16(sizeof(float) * 2 * C2) + kWarps * warp_bytes<T>(ns, C1);
}

template <typename T, int KJ>
__global__ void __launch_bounds__(kWarps * 32) serving_sa1_mlp_kernel(ServArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C0 = a.C0, C1 = a.C1, C2 = a.C2, ns = a.ns, M = a.M;
  float* s_w1 = reinterpret_cast<float*>(smem);
  size_t off = align16(sizeof(float) * C1 * C2);
  float* s_w0 = reinterpret_cast<float*>(smem + off);
  off += align16(sizeof(float) * C0 * C1);
  float* s_a0 = reinterpret_cast<float*>(smem + off);
  float* s_b0 = s_a0 + C1;
  off += align16(sizeof(float) * 2 * C1);
  float* s_a1 = reinterpret_cast<float*>(smem + off);
  float* s_b1 = s_a1 + C2;
  off += align16(sizeof(float) * 2 * C2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wsm = smem + off + (size_t)warp * warp_bytes<T>(ns, C1);
  T* s_g = reinterpret_cast<T*>(wsm);
  float* s_h = reinterpret_cast<float*>(wsm + align16(sizeof(T) * ns * kC0P));  // [c][slot]

  const T* W1 = static_cast<const T*>(a.W1);
  const T* W0 = static_cast<const T*>(a.W0);
  for (int i = threadIdx.x; i < C1 * C2; i += blockDim.x) s_w1[i] = to_f(W1[i]);
  for (int i = threadIdx.x; i < C0 * C1; i += blockDim.x) s_w0[i] = to_f(W0[i]);
  for (int i = threadIdx.x; i < C1; i += blockDim.x) {
    s_a0[i] = a.a0[i];
    s_b0[i] = a.b0[i];
  }
  for (int i = threadIdx.x; i < C2; i += blockDim.x) {
    s_a1[i] = a.a1[i];
    s_b1[i] = a.b1[i];
  }
  __syncthreads();

  const int tiles = (M + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const int r = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kQueriesPerBlock;
  const int plane_vec = ns * kC0P * (int)sizeof(T) / 16;  // 16-byte chunks per query

  for (int qi = warp; qi < kQueriesPerBlock; qi += kWarps) {
    const int m = q0 + qi;
    if (m >= M) break;
    const size_t row = (size_t)r * M + m;
    const uint4* g4 = reinterpret_cast<const uint4*>(static_cast<const T*>(a.planes) + row * ns * kC0P);
    uint4* sg4 = reinterpret_cast<uint4*>(s_g);
    for (int k = lane; k < plane_vec; k += 32) sg4[k] = g4[k];

    const T* Bq = static_cast<const T*>(a.Bq) + row * C1;
    float bq[kMaxC1L];
#pragma unroll
    for (int j = 0; j < kMaxC1L; ++j) {
      const int c = lane + 32 * j;
      bq[j] = c < C1 ? to_f(Bq[c]) : 0.0f;
    }
    float best[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) best[j] = 0.0f;  // every candidate is a ReLU output
    __syncwarp();

    for (int s0 = 0; s0 < ns; s0 += kGroup) {
      // layer 1: lane = channel; slots past ns repeat slot 0 (the max is unchanged)
#pragma unroll
      for (int j = 0; j < kMaxC1L; ++j) {
        const int c = lane + 32 * j;
        if (c < C1) {
          float w0[kC0P];
#pragma unroll
          for (int i = 0; i < kC0P; ++i) w0[i] = i < C0 ? s_w0[i * C1 + c] : 0.0f;
          const float ra0 = s_a0[c], rb0 = s_b0[c];
          for (int sl = 0; sl < kGroup; ++sl) {
            const int s = s0 + sl < ns ? s0 + sl : 0;
            const T* g = s_g + s * kC0P;
            float acc = 0.0f;
#pragma unroll
            for (int i = 0; i < kC0P; ++i)
              if (i < C0) acc = fmaf(to_f(g[i]), w0[i], acc);
            const float v = round_to<T>(acc);
            const float hm = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(v, bq[j]), ra0), rb0), 0.0f);
            s_h[c * kGroup + h_swz(c, sl)] = round_to<T>(hm);
          }
        }
      }
      __syncwarp();

      // layer 2: lane = output channel, kGroup slots at once
      float acc[kGroup][KJ];
#pragma unroll
      for (int sl = 0; sl < kGroup; ++sl)
#pragma unroll
        for (int j = 0; j < KJ; ++j) acc[sl][j] = 0.0f;
#pragma unroll 2
      for (int c = 0; c < C1; ++c) {
        float w[KJ];
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int o = lane + 32 * j;
          w[j] = o < C2 ? s_w1[c * C2 + o] : 0.0f;
        }
        const float4* h4 = reinterpret_cast<const float4*>(s_h + c * kGroup);
        const int sw = (c >> 1) & 3;
#pragma unroll
        for (int v = 0; v < kGroup / 4; ++v) {
          const float4 h = h4[v ^ sw];  // slots 4v .. 4v+3
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            acc[4 * v + 0][j] = fmaf(h.x, w[j], acc[4 * v + 0][j]);
            acc[4 * v + 1][j] = fmaf(h.y, w[j], acc[4 * v + 1][j]);
            acc[4 * v + 2][j] = fmaf(h.z, w[j], acc[4 * v + 2][j]);
            acc[4 * v + 3][j] = fmaf(h.w, w[j], acc[4 * v + 3][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int o = lane + 32 * j;
        if (o < C2) {
          const float ra1 = s_a1[o], rb1 = s_b1[o];
#pragma unroll
          for (int sl = 0; sl < kGroup; ++sl)
            best[j] = fmaxf(best[j], fmaxf(__fadd_rn(__fmul_rn(acc[sl][j], ra1), rb1), 0.0f));
        }
      }
      __syncwarp();
    }

    T* out = static_cast<T*>(a.out) + row * C2;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int o = lane + 32 * j;
      if (o < C2) out[o] = from_f<T>(best[j]);
    }
    __syncwarp();
  }
}

template <typename T, int KJ>
cudaError_t launch(const ServArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.ns, a.C0, a.C1, a.C2);
  cudaError_t err = cudaFuncSetAttribute(serving_sa1_mlp_kernel<T, KJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.R * ((a.M + kQueriesPerBlock - 1) / kQueriesPerBlock);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  serving_sa1_mlp_kernel<T, KJ><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kj(const ServArgs& a, cudaStream_t stream) {
  switch ((a.C2 + 31) / 32) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    default: return launch<T, 4>(a, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for planes/Bq/W0/W1/out; a0, b0, a1, b1
// float32. planes (R, M, ns, 8) with channels >= C0 zero; the planes pointer
// 16-byte aligned. Returns the CUDA error of the launch.
extern "C" int or4d_serving_sa1_mlp(int dtype, const void* planes, const void* Bq, const void* W0, const float* a0,
                                    const float* b0, const void* W1, const float* a1, const float* b1, int R, int M,
                                    int ns, int C0, int C1, int C2, void* out, void* stream) {
  if (R <= 0 || M <= 0 || ns <= 0 || ns > kMaxNs || C0 <= 0 || C0 > kC0P || C1 <= 0 || C1 > kMaxC1 || C2 <= 0 ||
      C2 > kMaxC2 || (dtype != 0 && dtype != 1) || (reinterpret_cast<size_t>(planes) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  ServArgs a{planes, Bq, W0, a0, b0, W1, a1, b1, R, M, ns, C0, C1, C2, out};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_kj<float>(a, st) : launch_kj<__nv_bfloat16>(a, st));
}
