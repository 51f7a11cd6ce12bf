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
// in the planes' dtype.
//
// Cache layout (the port's own): planes (R, M, ns, 8), channels zero-padded
// to 8, so one slot is 16 bytes in bf16 and a query's slots are contiguous.
//
// Two bodies, chosen by the wrapper from the dtype (ops/serving_sa1_mlp.py
// `serving_plan`, whose shared-memory bytes `srv_layout` / `fp32_smem_bytes`
// below repeat; the launch refuses a plan whose bytes disagree):
//
// bfloat16, `serving_mma_kernel` (the serving batch). What bounds it on the
// H100: the products, C0*C1 + C1*C2 multiply-adds per slot (~1e12 per S=64
// serving batch, ~2 ms on the tensor cores); the planes are read once (~0.6
// ms). Design: the tensor-core tile of the cold fused SA kernel's raw mode
// (sa_mma_tile.cuh), the same device code in the same k-order, so serving
// and the cold bf16 path agree bit for bit. A 16-row tile is 16 slots of one
// query; its A fragment comes straight from the plane (a warp's two 32-bit
// loads per tile read the tile's 256 contiguous bytes), K zero-padded to 16
// and channels >= C0 masked, as the cold kernel pads its raw channels. A
// query takes ceil(ns/16) tiles; rows past ns repeat slot 0. Two items share
// every W1^T fragment load: two tiles of a query, or with one tile per query
// (ns <= 16) the tiles of two queries. No search and no staged cloud: a
// persistent grid (blocks per SM from the occupancy query) stages W1^T, the
// W0 pair and the affines in shared memory once per block, and each warp
// walks its units (one query, or two) with a static stride.
//
// float32, `serving_fp32_kernel` (the card-vs-CPU checks), the first
// design, with the cold fp32 body's fmaf chains in the same order: one warp
// per query, 8 warps a block over 64 queries of one row, W1/W0/affines in
// shared memory; layer 1 with lane = channel into a swizzled per-warp (C1,
// 16) h tile, layer 2 with lane = output channel over 16 slots at a time on
// the FP32 pipes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sa_mma_tile.cuh"

namespace {

using sa_tile::align16;
using sa_tile::round_up;

constexpr int kC0P = 8;       // plane channels, zero-padded
constexpr int kMaxC1 = 128;
constexpr int kMaxC2 = 128;
constexpr int kMaxNs = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can have

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

// ---------------------------------------------------------------- bfloat16

constexpr int kSrvWarps = 8;

// the staged weights (sa_mma_tile.cuh), then per warp the Bq rows and
// running-max rows of a unit's (at most two) queries
struct SrvLayout {
  sa_tile::WeightLayout w;
  size_t warps, bq, best, warp_bytes, total;
};

__host__ __device__ inline SrvLayout srv_layout(int C0, int C1, int C2) {
  const int C1p = round_up(C1, 16), C2p = round_up(C2, 8);
  SrvLayout L;
  L.w = sa_tile::weight_layout(C0, C1, C2, 1, true);
  L.warps = L.w.total;
  L.bq = 0;
  L.best = L.bq + align16((size_t)2 * C1p * 4);
  L.warp_bytes = L.best + align16((size_t)2 * C2p * 4);
  L.total = L.warps + kSrvWarps * L.warp_bytes;
  return L;
}

// Three blocks an SM (24 warps): the tile's latency, not its issue rate,
// bounds this kernel, so occupancy buys more than the registers that 16
// columns per layer-2 pass (and a few spilled values) cost.
template <int KTM>
__global__ void __launch_bounds__(kSrvWarps * 32, 3) serving_mma_kernel(ServArgs a) {
  constexpr int kNChunk = 2;  // layer-2 n-tiles of 8 per pass
  extern __shared__ __align__(16) unsigned char smem[];
  const int C0 = a.C0, C1 = a.C1, C2 = a.C2, ns = a.ns;
  const SrvLayout L = srv_layout(C0, C1, C2);
  const sa_tile::Weights w = sa_tile::weights_at(smem, L.w, C0, C1, C2, true);
  const int C1p = w.C1p, C2p = w.C2p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  sa_tile::stage_weights(smem, L.w, static_cast<const __nv_bfloat16*>(a.W1),
                         static_cast<const __nv_bfloat16*>(a.W0), C0, 0, a.a0, a.b0, a.a1, a.b1, C1, C2, tid,
                         blockDim.x);
  __syncthreads();

  float* s_bq = reinterpret_cast<float*>(smem + L.warps + warp * L.warp_bytes + L.bq);
  float* s_best = reinterpret_cast<float*>(smem + L.warps + warp * L.warp_bytes + L.best);
  const uint32_t* planes = static_cast<const uint32_t*>(a.planes);  // a slot is 4 words of 2 bf16
  const __nv_bfloat16* Bqb = static_cast<const __nv_bfloat16*>(a.Bq);
  __nv_bfloat16* outb = static_cast<__nv_bfloat16*>(a.out);
  // this lane's channel pair (2t, 2t+1) of a slot, channels >= C0 zero
  const uint32_t cmask = (2 * t < C0 ? 0x0000ffffu : 0u) | (2 * t + 1 < C0 ? 0xffff0000u : 0u);
  const int T = (ns + 15) / 16;     // tiles per query
  const int qpu = T == 1 ? 2 : 1;   // queries per unit: two items per W1^T load
  const long long nqueries = (long long)a.R * a.M;
  const long long units = (nqueries + qpu - 1) / qpu;

  for (long long unit = (long long)blockIdx.x * kSrvWarps + warp; unit < units;
       unit += (long long)gridDim.x * kSrvWarps) {
    const long long q0 = unit * qpu;
    const int nq = (int)min((long long)qpu, nqueries - q0);
    for (int i = 0; i < nq; ++i) {
      for (int c = lane; c < C1p; c += 32) s_bq[i * C1p + c] = c < C1 ? __bfloat162float(Bqb[(q0 + i) * C1 + c]) : 0.0f;
      for (int c = lane; c < C2p; c += 32) s_best[i * C2p + c] = 0.0f;  // every candidate is a ReLU output
    }
    __syncwarp();

    // items: (query of the unit, tile), two at a time
    const int nitems = nq * T;
    for (int u = 0; u < nitems; u += 2) {
      const bool two = u + 1 < nitems;
      uint32_t hf[2][KTM][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s == 1 && !two) break;
        const int qi = (u + s) / T, tile = (u + s) % T;
        // rows g and g+8 of the tile: rows past ns repeat slot 0
        int k0 = tile * 16 + g, k1 = k0 + 8;
        if (k0 >= ns) k0 = 0;
        if (k1 >= ns) k1 = 0;
        const uint32_t* qp = planes + (size_t)(q0 + qi) * ns * (kC0P / 2);
        // the A fragment: channels 2t, 2t+1 of rows g and g+8; K 8..15 zero
        uint32_t rf[2][4] = {{qp[k0 * (kC0P / 2) + t] & cmask, qp[k1 * (kC0P / 2) + t] & cmask, 0u, 0u},
                             {0u, 0u, 0u, 0u}};
        sa_tile::layer1_raw<KTM>(w, rf, 0, s_bq + qi * C1p, hf[s], g, t);
      }
      sa_tile::layer2_max<KTM, kNChunk>(w, hf, two, s_best + (u / T) * C2p, s_best + ((u + 1) / T) * C2p, g, t);
    }
    __syncwarp();
    for (int i = 0; i < nq; ++i)
      for (int c = lane; c < C2; c += 32) outb[(q0 + i) * C2 + c] = __float2bfloat16_rn(s_best[i * C2p + c]);
    __syncwarp();
  }
}

// ---------------------------------------------------------------- float32

constexpr int kFpWarps = 8;
constexpr int kFpQueries = 64;
constexpr int kGroup = 16;    // slots per layer-2 pass
constexpr int kMaxC1L = kMaxC1 / 32;

// position of slot sl in row c of the (C1, kGroup) h tile: float4 granules
// XOR-swizzled by (c >> 1) & 3, so the layer-1 stores (lane = channel c, one
// slot) spread over 8 banks instead of 2; layer 2 reads whole granules
__device__ __forceinline__ int h_swz(int c, int sl) {
  return ((((sl >> 2) ^ (c >> 1)) & 3) << 2) | (sl & 3);
}

// per-warp scratch: the query's slot planes, then the (C1, kGroup) h tile
__host__ __device__ inline size_t fp32_warp_bytes(int ns, int C1) {
  return align16(sizeof(float) * ns * kC0P) + sizeof(float) * C1 * kGroup;
}

__host__ __device__ inline size_t fp32_smem_bytes(int ns, int C0, int C1, int C2) {
  return align16(sizeof(float) * C1 * C2) + align16(sizeof(float) * C0 * C1) + align16(sizeof(float) * 2 * C1) +
         align16(sizeof(float) * 2 * C2) + kFpWarps * fp32_warp_bytes(ns, C1);
}

template <int KJ>
__global__ void __launch_bounds__(kFpWarps * 32) serving_fp32_kernel(ServArgs a) {
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
  unsigned char* wsm = smem + off + (size_t)warp * fp32_warp_bytes(ns, C1);
  float* s_g = reinterpret_cast<float*>(wsm);
  float* s_h = reinterpret_cast<float*>(wsm + align16(sizeof(float) * ns * kC0P));  // [c][slot]

  const float* W1 = static_cast<const float*>(a.W1);
  const float* W0 = static_cast<const float*>(a.W0);
  for (int i = threadIdx.x; i < C1 * C2; i += blockDim.x) s_w1[i] = W1[i];
  for (int i = threadIdx.x; i < C0 * C1; i += blockDim.x) s_w0[i] = W0[i];
  for (int i = threadIdx.x; i < C1; i += blockDim.x) {
    s_a0[i] = a.a0[i];
    s_b0[i] = a.b0[i];
  }
  for (int i = threadIdx.x; i < C2; i += blockDim.x) {
    s_a1[i] = a.a1[i];
    s_b1[i] = a.b1[i];
  }
  __syncthreads();

  const int tiles = (M + kFpQueries - 1) / kFpQueries;
  const int r = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kFpQueries;
  const int plane_vec = ns * kC0P * (int)sizeof(float) / 16;  // 16-byte chunks per query

  for (int qi = warp; qi < kFpQueries; qi += kFpWarps) {
    const int m = q0 + qi;
    if (m >= M) break;
    const size_t row = (size_t)r * M + m;
    const uint4* g4 = reinterpret_cast<const uint4*>(static_cast<const float*>(a.planes) + row * ns * kC0P);
    uint4* sg4 = reinterpret_cast<uint4*>(s_g);
    for (int k = lane; k < plane_vec; k += 32) sg4[k] = g4[k];

    const float* Bq = static_cast<const float*>(a.Bq) + row * C1;
    float bq[kMaxC1L];
#pragma unroll
    for (int j = 0; j < kMaxC1L; ++j) {
      const int c = lane + 32 * j;
      bq[j] = c < C1 ? Bq[c] : 0.0f;
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
            const float* g = s_g + s * kC0P;
            float acc = 0.0f;
#pragma unroll
            for (int i = 0; i < kC0P; ++i)
              if (i < C0) acc = fmaf(g[i], w0[i], acc);
            s_h[c * kGroup + h_swz(c, sl)] = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(acc, bq[j]), ra0), rb0), 0.0f);
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
        float wv[KJ];
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int o = lane + 32 * j;
          wv[j] = o < C2 ? s_w1[c * C2 + o] : 0.0f;
        }
        const float4* h4 = reinterpret_cast<const float4*>(s_h + c * kGroup);
        const int sw = (c >> 1) & 3;
#pragma unroll
        for (int v = 0; v < kGroup / 4; ++v) {
          const float4 h = h4[v ^ sw];  // slots 4v .. 4v+3
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            acc[4 * v + 0][j] = fmaf(h.x, wv[j], acc[4 * v + 0][j]);
            acc[4 * v + 1][j] = fmaf(h.y, wv[j], acc[4 * v + 1][j]);
            acc[4 * v + 2][j] = fmaf(h.z, wv[j], acc[4 * v + 2][j]);
            acc[4 * v + 3][j] = fmaf(h.w, wv[j], acc[4 * v + 3][j]);
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

    float* out = static_cast<float*>(a.out) + row * C2;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int o = lane + 32 * j;
      if (o < C2) out[o] = best[j];
    }
    __syncwarp();
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int KJ>
cudaError_t launch_fp32(const ServArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = set_smem(serving_fp32_kernel<KJ>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.R * ((a.M + kFpQueries - 1) / kFpQueries);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  serving_fp32_kernel<KJ><<<(unsigned)blocks, kFpWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KTM>
cudaError_t launch_mma(const ServArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = set_smem(serving_mma_kernel<KTM>, smem);
  if (err != cudaSuccess) return err;
  // a persistent grid: as many blocks as fit on the card, at most one warp
  // per unit
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, serving_mma_kernel<KTM>, kSrvWarps * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long queries = (long long)a.R * a.M;
  const long long units = a.ns <= 16 ? (queries + 1) / 2 : queries;
  const long long fill = (long long)sms * per_sm, need = (units + kSrvWarps - 1) / kSrvWarps;
  const long long blocks = fill < need ? fill : need;
  serving_mma_kernel<KTM><<<(unsigned)blocks, kSrvWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FP32-pipe body), 1 = bfloat16 (tensor-core body) for
// planes/Bq/W0/W1/out; a0, b0, a1, b1 float32. planes (R, M, ns, 8) with
// channels >= C0 zero; the planes pointer 16-byte aligned. smem_bytes is the
// wrapper's plan; a plan whose bytes disagree with this file's layout, or
// over 227 KB, is refused. Returns the CUDA error of the launch.
extern "C" int or4d_serving_sa1_mlp(int dtype, const void* planes, const void* Bq, const void* W0, const float* a0,
                                    const float* b0, const void* W1, const float* a1, const float* b1, int R, int M,
                                    int ns, int C0, int C1, int C2, void* out, long long smem_bytes, void* stream) {
  if (R <= 0 || M <= 0 || ns <= 0 || ns > kMaxNs || C0 <= 0 || C0 > kC0P || C1 <= 0 || C1 > kMaxC1 || C2 <= 0 ||
      C2 > kMaxC2 || (dtype != 0 && dtype != 1) || (reinterpret_cast<size_t>(planes) & 15) != 0 ||
      smem_bytes <= 0 || (size_t)smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  ServArgs a{planes, Bq, W0, a0, b0, W1, a1, b1, R, M, ns, C0, C1, C2, out};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const size_t smem = fp32_smem_bytes(ns, C0, C1, C2);
    if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
    switch ((C2 + 31) / 32) {
      case 1: return (int)launch_fp32<1>(a, smem, st);
      case 2: return (int)launch_fp32<2>(a, smem, st);
      case 3: return (int)launch_fp32<3>(a, smem, st);
      default: return (int)launch_fp32<4>(a, smem, st);
    }
  }
  const size_t smem = srv_layout(C0, C1, C2).total;
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  // layer-1 widths up to 64 keep half the hmid fragments in registers
  return (int)(round_up(C1, 16) <= 64 ? launch_mma<4>(a, smem, st) : launch_mma<8>(a, smem, st));
}
