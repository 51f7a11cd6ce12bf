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
// (empty slots repeat the first hit, which cannot change the max; a query
// with no hit uses a zero A row, as the TPU kernels' one-hot selection
// does). The layer-1 row A[idx] is
//   raw mode:   round_A(raw[b, :, idx] . W0)  (f32 accumulation), from the
//               channel-major [xyz|features] plane (B, C0(+1), N);
//   plane mode: A[b, idx, :] from a precomputed (B, N, C1) plane.
// Paired raw mode computes two halves per slot that share the hit search and
// W1: the second half reads raw channel C0 in place of channel C0-1 (the
// reverse direction's mask channel), giving out (B, M, 2*C2) = [fwd | rev].
// With `need` (B, M) (chunk counts from the FPS kernel's hit counts,
// or4d_tpu/ops/pallas_ball_query.py:587-602) a search stops at need*512
// points; the bound is exact, so results do not change.
//
// Rounding matches the TPU kernels: d2 = (dx*dx + dy*dy) + dz*dz with each
// op rounded alone and the strict test d2 < r2 (r2 the f32 of r*r); A in the
// A dtype; Bq, a0, b0, a1, b1 and all sums in f32; hmid rounded to W1's
// dtype before the product; the output stored in the A dtype.
//
// Two bodies, chosen by the wrapper from the dtype (ops/sa_group_mlp.py
// `tile_plan`, whose shared-memory layout `mma_layout` below repeats; the
// launch refuses a plan whose bytes disagree):
//
// bfloat16, `sa_mma_kernel` (the eval and serving batches). What bounds it
// on the H100: the per-slot products (C1*C2 multiply-adds per real slot,
// plus C0*C1 in raw mode), then the scan-order search. Design:
//  - 16 warps per block over the queries of one cloud; a warp takes one
//    query at a time (a shared counter hands them out) and runs search and
//    MLP for it alone, with no block barrier after the set-up.
//  - Set-up: W1^T (K-contiguous rows padded by 8 bf16, so the B-fragment
//    loads of a warp hit 32 distinct banks), [W0 | W0 with row C0-1 moved
//    to C0] likewise, the affines, and with `cp.async` the cloud's xyz up to
//    the largest search bound of the block's queries (12-byte rows: a warp's
//    32 strided reads fall in 32 distinct banks) and, in plane mode, the
//    cloud's (N, C1) A plane, each where `tile_plan` found room in 227 KB;
//    otherwise the search and the gathers read global memory.
//  - Products on the tensor cores: `mma.sync.m16n8k16` bf16 with f32
//    accumulation. A tile is 16 rows = 16 slots of one query (a query with
//    ns slots takes ceil(real hits / 16) tiles; rows past its hits repeat
//    the first hit). Raw mode gathers each slot's C0(+1) raw values into an
//    A fragment (K zero-padded to 16) and multiplies it by the W0 pair; the
//    f32 result is rounded to bf16, turned into hmid in registers and
//    repacked as the A fragment of layer 2, so neither A nor hmid touches
//    memory. An item is a tile and a half; two items (two tiles of a query,
//    or a tile's two paired halves) share every W1 fragment load: a lone
//    16-row tile reads all of W1 from shared memory for 16 flops a byte,
//    which is about what the shared-memory bandwidth feeds the mma.sync
//    rate. Layer 2 runs in passes of 32 output columns (16 in raw mode
//    with C1 > 64, for registers). The search takes
//    64 points per step (two distances a lane, two ballots).
//  - Epilogue: relu(acc*a1 + b1) per element (with __fmul_rn/__fadd_rn;
//    the affines as one float4 per column pair), then the max over the
//    item's 16 rows by shuffles, and over the items into a per-warp row in
//    shared memory; out is rounded once.
//  A warpgroup `wgmma` over 64 rows would need four warps to agree on a
//  tile of several queries and an hmid tile in shared memory; per-warp m16
//  tiles keep each warp's queries independent. The weight staging and the
//  tile's device code (raw-mode layer 1, the hmid repack, layer 2 and the
//  epilogue) are sa_mma_tile.cuh, which the serving SA1 kernel runs too.
//
// The search and the staging of the cloud's xyz are ball_search.cuh, which
// the train grouping kernels (ball_query_group.cu) share.
//
// float32, `sa_fp32_kernel` (card-vs-CPU checks), the first design: one warp
// per query, 8 warps over 32 queries of one cloud, W1/W0/a1/b1 in shared
// memory, the first `ns` hits to a per-warp list by ballot/popc, each lane
// owning C1/32 layer-1 and C2/32 output channels on the FP32 pipes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ball_search.cuh"
#include "sa_mma_tile.cuh"

namespace {

constexpr int kMaxC1L = 4;  // C1 <= 128
constexpr int kMaxC2L = 8;  // C2 <= 256
constexpr int kMaxC1 = 32 * kMaxC1L;
constexpr int kMaxC2 = 32 * kMaxC2L;
constexpr int kMaxNs = 128;
constexpr int kMaxC0 = 16;
constexpr int kChunk = 512;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can have

constexpr int kFpWarps = 8;
constexpr int kFpQueries = 32;
constexpr int kMmaWarps = 16;

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
  int qb;     // queries per block
  int stage_xyz, stage_plane;
};

using ball_search::search;
using sa_tile::align16;
using sa_tile::round_up;

// ---------------------------------------------------------------- float32

__host__ __device__ inline size_t fp32_smem_bytes(int C0, int C1, int C2, bool raw) {
  return align16(sizeof(float) * C1 * C2) + (raw ? align16(sizeof(float) * C0 * C1) : 0) +
         align16(sizeof(float) * 2 * C2) + (size_t)kFpWarps * (kMaxNs + kMaxC1) * sizeof(float);
}

template <bool RAW>
__global__ void __launch_bounds__(kFpWarps * 32) sa_fp32_kernel(SAArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C1 = a.C1, C2 = a.C2, C0 = a.C0, ns = a.ns, N = a.N, M = a.M;
  float* s_w1 = reinterpret_cast<float*>(smem);
  size_t off = align16(sizeof(float) * C1 * C2);
  float* s_w0 = reinterpret_cast<float*>(smem + off);
  if (RAW) off += align16(sizeof(float) * C0 * C1);
  float* s_a1 = reinterpret_cast<float*>(smem + off);
  float* s_b1 = s_a1 + C2;
  off += align16(sizeof(float) * 2 * C2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* s_idx = reinterpret_cast<int*>(smem + off) + warp * (kMaxNs + kMaxC1);
  float* s_h = reinterpret_cast<float*>(s_idx + kMaxNs);

  const float* W1 = static_cast<const float*>(a.W1);
  for (int i = threadIdx.x; i < C1 * C2; i += blockDim.x) s_w1[i] = W1[i];
  if (RAW) {
    const float* W0 = static_cast<const float*>(a.W0);
    for (int i = threadIdx.x; i < C0 * C1; i += blockDim.x) s_w0[i] = W0[i];
  }
  for (int i = threadIdx.x; i < C2; i += blockDim.x) {
    s_a1[i] = a.a1[i];
    s_b1[i] = a.b1[i];
  }
  __syncthreads();

  const int tiles = (M + kFpQueries - 1) / kFpQueries;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kFpQueries;
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

  for (int qi = warp; qi < kFpQueries; qi += kFpWarps) {
    const int q = q0 + qi;
    if (q >= M) break;
    const size_t row = (size_t)b * M + q;
    const float qx = a.new_xyz[3 * row], qy = a.new_xyz[3 * row + 1], qz = a.new_xyz[3 * row + 2];
    int limit = N;
    if (a.need != nullptr) limit = min(N, max(a.need[row], 0) * kChunk);
    const int nreal = min(search(xyz, limit, qx, qy, qz, a.r2, ns, s_idx, lane), ns);
    __syncwarp();

    float bq[kMaxC1L];
    const float* Bq = static_cast<const float*>(a.Bq) + row * C1;
#pragma unroll
    for (int j = 0; j < kMaxC1L; ++j) {
      const int c = lane + 32 * j;
      bq[j] = c < C1 ? Bq[c] : 0.0f;
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
                const float* raw = static_cast<const float*>(a.raw) + (size_t)b * craw * N + p;
                float acc = 0.0f;
                for (int i = 0; i < C0; ++i) {
                  const int ch = (h == 1 && i == C0 - 1) ? C0 : i;
                  acc = fmaf(raw[(size_t)ch * N], s_w0[i * C1 + c], acc);
                }
                v = acc;
              } else {
                v = static_cast<const float*>(a.A)[((size_t)b * N + p) * C1 + c];
              }
            }
            s_h[c] = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(v, bq[j]), ra0[j]), rb0[j]), 0.0f);
          }
        }
        __syncwarp();
        float acc[kMaxC2L];
#pragma unroll
        for (int j = 0; j < kMaxC2L; ++j) acc[j] = 0.0f;
#pragma unroll 4
        for (int c = 0; c < C1; ++c) {
          const float hv = s_h[c];
          const float* wrow = s_w1 + c * C2;
#pragma unroll
          for (int j = 0; j < kMaxC2L; ++j) {
            const int o = lane + 32 * j;
            if (o < C2) acc[j] = fmaf(hv, wrow[o], acc[j]);
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

    float* out = static_cast<float*>(a.out) + row * (size_t)(C2 * halves);
#pragma unroll
    for (int j = 0; j < kMaxC2L; ++j) {
      const int o = lane + 32 * j;
      if (o < C2) {
        out[o] = best[0][j];
        if (halves == 2) out[C2 + o] = best[1][j];
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------- bfloat16

// Byte offsets of the bf16 body's dynamic shared memory (ops/sa_group_mlp.py
// `_mma_smem_bytes` computes the same total): the staged weights
// (sa_mma_tile.cuh), per warp its hit list, Bq row and running max, a
// control word, then the staged xyz and A plane.
struct MmaLayout {
  size_t warps, warp_bytes, idx, bq, best, ctl, xyz, plane, total;
  sa_tile::WeightLayout w;
};

__host__ __device__ inline MmaLayout mma_layout(int N, int ns, int craw, int C1, int C2, int halves, bool raw,
                                                bool stage_xyz, bool stage_plane) {
  const int C1p = round_up(C1, 16), C2p = round_up(C2, 8);
  MmaLayout L;
  L.w = sa_tile::weight_layout(craw, C1, C2, halves, raw);
  L.warps = L.w.total;
  L.idx = 0;
  L.bq = L.idx + align16((size_t)ns * 4);
  L.best = L.bq + align16((size_t)C1p * 4);
  L.warp_bytes = L.best + align16((size_t)halves * C2p * 4);
  L.ctl = L.warps + kMmaWarps * L.warp_bytes;
  L.xyz = L.ctl + 16;
  L.plane = L.xyz + (stage_xyz ? align16((size_t)N * 12) : 0);
  L.total = L.plane + (stage_plane ? align16((size_t)N * C1 * 2) : 0);
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// A[p, c] and A[p, c+1] of one plane row (zero past C1 or for p < 0)
__device__ __forceinline__ void plane_pair(const __nv_bfloat16* A, int p, int c, int C1, float& v0, float& v1) {
  v0 = v1 = 0.0f;
  if (p < 0) return;
  const __nv_bfloat16* row = A + (size_t)p * C1;
  if (!(C1 & 1)) {
    if (c < C1) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(row + c);
      v0 = __low2float(v);
      v1 = __high2float(v);
    }
  } else {
    if (c < C1) v0 = __bfloat162float(row[c]);
    if (c + 1 < C1) v1 = __bfloat162float(row[c + 1]);
  }
}

template <bool RAW, int KTM>
__global__ void __launch_bounds__(kMmaWarps * 32, 1) sa_mma_kernel(SAArgs a) {
  // layer-2 n-tiles of 8 per pass: 32 columns (16 where raw mode's fragments
  // and C1 > 64 would not fit in 128 registers)
  constexpr int kNChunk = RAW && KTM == 8 ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C1 = a.C1, C2 = a.C2, C0 = a.C0, ns = a.ns, N = a.N, M = a.M;
  const int halves = a.paired ? 2 : 1, craw = C0 + a.paired;
  const MmaLayout L = mma_layout(N, ns, craw, C1, C2, halves, RAW, a.stage_xyz, a.stage_plane);
  const sa_tile::Weights w = sa_tile::weights_at(smem, L.w, craw, C1, C2, RAW);
  const int C1p = w.C1p, C2p = w.C2p;
  int* s_ctl = reinterpret_cast<int*>(smem + L.ctl);  // [next query, search bound]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

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
  sa_tile::stage_weights(smem, L.w, static_cast<const __nv_bfloat16*>(a.W1),
                         RAW ? static_cast<const __nv_bfloat16*>(a.W0) : nullptr, C0, a.paired, a.a0, a.b0, a.a1,
                         a.b1, C1, C2, tid, nthr);
  __syncthreads();
  lim = s_ctl[1];

  // the cloud's xyz up to the block's search bound, and its A plane
  const float* pts = a.xyz + (size_t)b * N * 3;
  if (a.stage_xyz) {
    float* s_xyz = reinterpret_cast<float*>(smem + L.xyz);
    ball_search::stage_points(s_xyz, pts, lim, tid, nthr);
    pts = s_xyz;
  }
  const __nv_bfloat16* Ab = nullptr;
  if (!RAW) {
    Ab = static_cast<const __nv_bfloat16*>(a.A) + (size_t)b * N * C1;
    if (a.stage_plane) {
      __nv_bfloat16* s_plane = reinterpret_cast<__nv_bfloat16*>(smem + L.plane);
      const size_t bytes = (size_t)lim * C1 * 2;
      if (((reinterpret_cast<uintptr_t>(Ab) | bytes) & 15) == 0) {
        for (size_t i = tid; i < bytes / 16; i += nthr)
          cp_async16(reinterpret_cast<uint4*>(s_plane) + i, reinterpret_cast<const uint4*>(Ab) + i);
      } else {
        for (size_t i = tid; i < (size_t)lim * C1; i += nthr) s_plane[i] = Ab[i];
      }
      Ab = s_plane;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  unsigned char* wbase = smem + L.warps + warp * L.warp_bytes;
  int* s_idx = reinterpret_cast<int*>(wbase + L.idx);
  float* s_bq = reinterpret_cast<float*>(wbase + L.bq);
  float* s_best = reinterpret_cast<float*>(wbase + L.best);
  const unsigned short* rawb =
      RAW ? static_cast<const unsigned short*>(a.raw) + (size_t)b * craw * N : nullptr;  // bf16 bits
  const __nv_bfloat16* Bqb = static_cast<const __nv_bfloat16*>(a.Bq);
  __nv_bfloat16* outb = static_cast<__nv_bfloat16*>(a.out);

  while (true) {
    int qi = 0;
    if (lane == 0) qi = atomicAdd(&s_ctl[0], 1);
    qi = __shfl_sync(0xffffffffu, qi, 0);
    if (qi >= nq) break;
    const size_t row = (size_t)b * M + q0 + qi;
    const float qx = a.new_xyz[3 * row], qy = a.new_xyz[3 * row + 1], qz = a.new_xyz[3 * row + 2];
    const int limit = a.need != nullptr ? min(N, max(a.need[row], 0) * kChunk) : N;
    const int nreal = min(search(pts, limit, qx, qy, qz, a.r2, ns, s_idx, lane), ns);
    for (int c = lane; c < C1p; c += 32) s_bq[c] = c < C1 ? __bfloat162float(Bqb[row * C1 + c]) : 0.0f;
    for (int c = lane; c < halves * C2p; c += 32) s_best[c] = 0.0f;  // every candidate is a ReLU output
    __syncwarp();

    // items: (tile, half), two at a time, so each W1 fragment load feeds two
    // products (two tiles of a query, or a tile's two paired halves)
    const int nitems = (max(nreal, 1) + 15) / 16 * halves;
    for (int u = 0; u < nitems; u += 2) {
      const bool two = u + 1 < nitems;
      // hmid of each item as layer 2's A fragments
      uint32_t hf[2][KTM][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s == 1 && !two) break;
        const int tile = (u + s) / halves, h = (u + s) % halves;
        // rows g and g+8 of the tile: slots past the hits repeat the first hit
        int k0 = tile * 16 + g, k1 = k0 + 8;
        if (k0 >= nreal) k0 = 0;
        if (k1 >= nreal) k1 = 0;
        const int p0 = nreal > 0 ? s_idx[k0] : -1, p1 = nreal > 0 ? s_idx[k1] : -1;
        if (RAW) {
          // the slots' raw channels as A fragments, K zero-padded
          uint32_t rf[2][4];
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) rf[kt][r] = 0u;
            if (kt < w.KT) {
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int p = (r & 1) ? p1 : p0;
                const int ch = kt * 16 + t * 2 + ((r & 2) ? 8 : 0);
                uint32_t lo = 0u, hi = 0u;
                if (p >= 0 && ch < craw) lo = rawb[(size_t)ch * N + p];
                if (p >= 0 && ch + 1 < craw) hi = rawb[(size_t)(ch + 1) * N + p];
                rf[kt][r] = lo | (hi << 16);
              }
            }
          }
          sa_tile::layer1_raw<KTM>(w, rf, h, s_bq, hf[s], g, t);
        } else {
#pragma unroll
          for (int kk = 0; kk < KTM; ++kk) {
            if (kk < w.KT1) {
              float v[2][4];  // two n-tiles of 8 columns, C-fragment order
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const int c = kk * 16 + nt * 8 + t * 2;
                plane_pair(Ab, p0, c, C1, v[nt][0], v[nt][1]);
                plane_pair(Ab, p1, c, C1, v[nt][2], v[nt][3]);
                sa_tile::hmid_affine(v[nt], s_bq, w.ab0, c);
              }
              sa_tile::pack_hmid(v, hf[s][kk]);
            }
          }
        }
      }
      sa_tile::layer2_max<KTM, kNChunk>(w, hf, two, s_best + (u % halves) * C2p, s_best + ((u + 1) % halves) * C2p,
                                        g, t);
    }
    __syncwarp();
    __nv_bfloat16* out = outb + row * (size_t)(C2 * halves);
    for (int c = lane; c < halves * C2; c += 32) out[c] = __float2bfloat16_rn(s_best[(c / C2) * C2p + c % C2]);
    __syncwarp();
  }
}

template <typename K>
cudaError_t launch_kernel(K kernel, const SAArgs& a, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.B * ((a.M + a.qb - 1) / a.qb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FP32-pipe body), 1 = bfloat16 (tensor-core body) for
// raw/W0/A/Bq/W1/out. raw != null selects raw mode (W0 required, C0 = W0
// rows, paired allowed); otherwise plane mode reads A. need may be null.
// block_queries, stage_xyz, stage_plane and smem_bytes are the wrapper's
// tile plan; a plan whose bytes disagree with this file's layout, or over
// 227 KB, is refused. Returns the CUDA error of the launch.
extern "C" int or4d_sa_group_mlp(int dtype, const float* xyz, const float* new_xyz, int B, int N, int M,
                                 float r2, int ns, const int* need, const void* raw, const void* W0, int C0,
                                 int paired, const void* A, const void* Bq, const float* a0, const float* b0,
                                 const void* W1, const float* a1, const float* b1, int C1, int C2, void* out,
                                 int block_queries, int stage_xyz, int stage_plane, long long smem_bytes,
                                 void* stream) {
  const bool is_raw = raw != nullptr;
  if (B <= 0 || N <= 0 || M <= 0 || ns <= 0 || ns > kMaxNs || C1 <= 0 || C1 > kMaxC1 || C2 <= 0 ||
      C2 > kMaxC2 || (is_raw && (W0 == nullptr || C0 <= 0 || C0 > kMaxC0)) || (!is_raw && (A == nullptr || paired)) ||
      (dtype != 0 && dtype != 1) || block_queries <= 0 || smem_bytes <= 0 || (size_t)smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  SAArgs a{xyz, new_xyz, B, N, M, r2, ns, need, raw, W0, is_raw ? C0 : 0, paired ? 1 : 0, A, Bq, a0, b0, W1,
           a1, b1, C1, C2, out, block_queries, stage_xyz ? 1 : 0, stage_plane ? 1 : 0};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  size_t smem;
  if (dtype == 0) {
    smem = fp32_smem_bytes(a.C0, C1, C2, is_raw);
    if (block_queries != kFpQueries || stage_xyz || stage_plane || smem != (size_t)smem_bytes)
      return (int)cudaErrorInvalidValue;
    return (int)(is_raw ? launch_kernel(sa_fp32_kernel<true>, a, kFpWarps * 32, smem, st)
                        : launch_kernel(sa_fp32_kernel<false>, a, kFpWarps * 32, smem, st));
  }
  smem = mma_layout(N, ns, a.C0 + a.paired, C1, C2, a.paired ? 2 : 1, is_raw, stage_xyz, stage_plane).total;
  if (smem != (size_t)smem_bytes || (is_raw && stage_plane)) return (int)cudaErrorInvalidValue;
  // layer-1 widths up to 64 keep half the hmid fragments in registers
  const int threads = kMmaWarps * 32;
  if (round_up(C1, 16) <= 64)
    return (int)(is_raw ? launch_kernel(sa_mma_kernel<true, 4>, a, threads, smem, st)
                        : launch_kernel(sa_mma_kernel<false, 4>, a, threads, smem, st));
  return (int)(is_raw ? launch_kernel(sa_mma_kernel<true, 8>, a, threads, smem, st)
                      : launch_kernel(sa_mma_kernel<false, 8>, a, threads, smem, st));
}
