// The tensor-core tile of the SA MLP, shared by the fused eval SA kernel's
// bfloat16 body (sa_group_mlp.cu, `sa_mma_kernel`, TPU rows 3 and 4) and the
// serving SA1 kernel's (serving_sa1_mlp.cu, TPU row 7). Both run this code
// for a 16-slot tile of one query, so serving and the cold raw-mode path
// round A, hmid and the output at the same values: with the same raw
// channels per slot they agree bit for bit.
//
// A tile is 16 rows = 16 slots of one query. Layer 1 (raw mode) multiplies
// the slots' raw channels, an A fragment with K zero-padded to 16, by the W0
// pair with `mma.sync.m16n8k16` bf16 (f32 accumulation), rounds A to bf16,
// applies relu((A - Bq) * a0 + b0) per element with __fmul_rn/__fadd_rn and
// packs hmid as layer 2's A fragments in registers. Layer 2 runs the hmid
// fragments of one or two items against W1^T in passes of kNChunk n-tiles of
// 8, in k-order; the epilogue applies relu(acc * a1 + b1) per element and
// takes the max over each item's 16 rows by shuffles into the item's f32
// row of running maxima (shared memory, lanes g == 0 write).
//
// Shared-memory weights (`stage_weights`): W1^T and the W0 pair with
// K-contiguous rows padded by 8 bf16 (a warp's B-fragment loads hit 32
// distinct banks), [W0 | W0 with row C0-1 moved to C0] for the paired
// halves, and the affines as one float4 per column pair.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sa_tile {

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Byte offsets of the staged weights: W1^T, the W0 pair (raw mode), the
// affines; `total` is where the caller's own shared memory starts.
struct WeightLayout {
  size_t w1t, w0t, aff, total;
};

__host__ __device__ inline WeightLayout weight_layout(int craw, int C1, int C2, int halves, bool raw) {
  const int C1p = round_up(C1, 16), C2p = round_up(C2, 8), KT = raw ? (craw + 15) / 16 : 0;
  WeightLayout L;
  L.w1t = 0;
  L.w0t = L.w1t + align16((size_t)C2p * (C1p + 8) * 2);
  L.aff = L.w0t + (raw ? align16((size_t)halves * C1p * (KT * 16 + 8) * 2) : 0);
  L.total = L.aff + align16((size_t)(2 * C1p + 2 * C2p) * 4);
  return L;
}

// The staged weights and their padded strides, as one warp reads them.
struct Weights {
  const __nv_bfloat16* w1t;  // (C2p, C1p + 8): W1^T
  const __nv_bfloat16* w0t;  // (halves * C1p, KT * 16 + 8): the W0 pair, transposed
  const float4* ab0;         // per column pair (c, c+1): {a0[c], a0[c+1], b0[c], b0[c+1]}
  const float4* ab1;         // the same for a1, b1
  int C1p, C2p, KT, KW, KT1, NT2, W1S;
};

__device__ __forceinline__ Weights weights_at(const unsigned char* smem, const WeightLayout& L, int craw, int C1,
                                              int C2, bool raw) {
  Weights w;
  w.C1p = round_up(C1, 16);
  w.C2p = round_up(C2, 8);
  w.KT = raw ? (craw + 15) / 16 : 1;
  w.KW = w.KT * 16 + 8;
  w.KT1 = w.C1p / 16;
  w.NT2 = w.C2p / 8;
  w.W1S = w.C1p + 8;
  w.w1t = reinterpret_cast<const __nv_bfloat16*>(smem + L.w1t);
  w.w0t = reinterpret_cast<const __nv_bfloat16*>(smem + L.w0t);
  w.ab0 = reinterpret_cast<const float4*>(smem + L.aff);
  w.ab1 = w.ab0 + w.C1p / 2;
  return w;
}

// All threads of the block: W1^T and (with W0) the W0 pair K-contiguous,
// zero-padded to the tiles, and the affines. The caller synchronises.
__device__ __forceinline__ void stage_weights(unsigned char* smem, const WeightLayout& L, const __nv_bfloat16* W1,
                                              const __nv_bfloat16* W0, int C0, int paired, const float* a0,
                                              const float* b0, const float* a1, const float* b1, int C1, int C2,
                                              int tid, int nthr) {
  const int halves = paired ? 2 : 1, craw = C0 + paired;
  const int C1p = round_up(C1, 16), C2p = round_up(C2, 8), W1S = C1p + 8;
  const int KT = W0 != nullptr ? (craw + 15) / 16 : 1, KW = KT * 16 + 8;
  __nv_bfloat16* s_w1t = reinterpret_cast<__nv_bfloat16*>(smem + L.w1t);
  __nv_bfloat16* s_w0t = reinterpret_cast<__nv_bfloat16*>(smem + L.w0t);
  float4* s_ab0 = reinterpret_cast<float4*>(smem + L.aff);
  float4* s_ab1 = s_ab0 + C1p / 2;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = tid; i < C1p * C2p; i += nthr) {
    const int k = i / C2p, n = i % C2p;
    s_w1t[n * W1S + k] = (k < C1 && n < C2) ? W1[k * C2 + n] : zero;
  }
  if (W0 != nullptr) {
    for (int i = tid; i < halves * C1p * KT * 16; i += nthr) {
      const int h = i / (C1p * KT * 16), n = (i / (KT * 16)) % C1p, k = i % (KT * 16);
      // half 1 reads raw channel C0 in place of channel C0-1
      const int src = h == 0 ? (k < C0 ? k : -1) : (k < C0 - 1 ? k : (k == C0 ? C0 - 1 : -1));
      s_w0t[(h * C1p + n) * KW + k] = (src >= 0 && n < C1) ? W0[src * C1 + n] : zero;
    }
  }
  for (int c = 2 * tid; c < C1p; c += 2 * nthr) {
    const bool v0 = c < C1, v1 = c + 1 < C1;
    s_ab0[c / 2] = make_float4(v0 ? a0[c] : 0.0f, v1 ? a0[c + 1] : 0.0f, v0 ? b0[c] : 0.0f, v1 ? b0[c + 1] : 0.0f);
  }
  for (int c = 2 * tid; c < C2p; c += 2 * nthr) {
    const bool v0 = c < C2, v1 = c + 1 < C2;
    s_ab1[c / 2] = make_float4(v0 ? a1[c] : 0.0f, v1 ? a1[c + 1] : 0.0f, v0 ? b1[c] : 0.0f, v1 ? b1[c + 1] : 0.0f);
  }
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&af)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(b0), "r"(b1));
}

// two bf16 (lo at the lower address) as one 32-bit fragment register
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Layer-1 values v (C-fragment order: columns c, c+1 of rows g, g+8) ->
// hmid = relu((v - Bq) * a0 + b0) per element, in f32.
__device__ __forceinline__ void hmid_affine(float (&v)[4], const float* s_bq, const float4* ab0, int c) {
  const float2 bq = *reinterpret_cast<const float2*>(s_bq + c);
  const float4 ab = ab0[c / 2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool odd = r & 1;
    v[r] = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(v[r], odd ? bq.y : bq.x), odd ? ab.y : ab.x), odd ? ab.w : ab.z),
                 0.0f);
  }
}

// hmid of two n-tiles of 8 columns as layer 2's A fragment of one k-tile
__device__ __forceinline__ void pack_hmid(const float (&v)[2][4], uint32_t (&hf)[4]) {
  hf[0] = pack_bf16(v[0][0], v[0][1]);
  hf[1] = pack_bf16(v[0][2], v[0][3]);
  hf[2] = pack_bf16(v[1][0], v[1][1]);
  hf[3] = pack_bf16(v[1][2], v[1][3]);
}

// Raw mode's layer 1 for one item: the slots' raw channels rf (K-tiles of
// 16, zero past the raw channels) times half h of the W0 pair, A rounded to
// bf16, then hmid packed as layer 2's A fragments hf (k-tile kk holds
// columns kk*16..+15). g = lane / 4, t = lane % 4.
template <int KTM>
__device__ __forceinline__ void layer1_raw(const Weights& w, const uint32_t (&rf)[2][4], int h, const float* s_bq,
                                           uint32_t (&hf)[KTM][4], int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KTM; ++kk) {
    if (kk < w.KT1) {
      float v[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = kk * 16 + nt * 8 + t * 2;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const __nv_bfloat16* wp = w.w0t + (size_t)(h * w.C1p + c - t * 2 + g) * w.KW + t * 2;
#pragma unroll
        for (int kt = 0; kt < 2; ++kt)
          if (kt < w.KT) mma16816(acc, rf[kt], ld_pair(wp + kt * 16), ld_pair(wp + kt * 16 + 8));
#pragma unroll
        for (int r = 0; r < 4; ++r) v[nt][r] = round_bf16(acc[r]);
        hmid_affine(v[nt], s_bq, w.ab0, c);
      }
      pack_hmid(v, hf[kk]);
    }
  }
}

// Layer 2 and the epilogue for one or two items (`two`) sharing every W1^T
// fragment load: relu(acc * a1 + b1) per element, the max over each item's
// 16 rows, folded into the item's running-max row best0 / best1 (C2p f32).
template <int KTM, int kNChunk>
__device__ __forceinline__ void layer2_max(const Weights& w, const uint32_t (&hf)[2][KTM][4], bool two, float* best0,
                                           float* best1, int g, int t) {
  for (int nc = 0; nc < w.NT2; nc += kNChunk) {
    float acc[2][kNChunk][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < kNChunk; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][j][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KTM; ++kk) {
      if (kk < w.KT1) {
#pragma unroll
        for (int j = 0; j < kNChunk; ++j) {
          if (nc + j < w.NT2) {
            const __nv_bfloat16* wp = w.w1t + (size_t)((nc + j) * 8 + g) * w.W1S + kk * 16 + t * 2;
            const uint32_t b0 = ld_pair(wp), b1 = ld_pair(wp + 8);
            mma16816(acc[0][j], hf[0][kk], b0, b1);
            if (two) mma16816(acc[1][j], hf[1][kk], b0, b1);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s == 1 && !two) break;
      float* best = s == 0 ? best0 : best1;
#pragma unroll
      for (int j = 0; j < kNChunk; ++j) {
        if (nc + j < w.NT2) {
          const int col = (nc + j) * 8 + t * 2;
          const float4 ab = w.ab1[col / 2];
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sc = e ? ab.y : ab.x, of = e ? ab.w : ab.z;
            o[e] = fmaxf(fmaxf(__fadd_rn(__fmul_rn(acc[s][j][e], sc), of), 0.0f),
                         fmaxf(__fadd_rn(__fmul_rn(acc[s][j][e + 2], sc), of), 0.0f));
#pragma unroll
            for (int sh = 4; sh < 32; sh <<= 1) o[e] = fmaxf(o[e], __shfl_xor_sync(0xffffffffu, o[e], sh));
          }
          if (g == 0) {
            float2* bp = reinterpret_cast<float2*>(best + col);
            const float2 old = *bp;
            *bp = make_float2(fmaxf(old.x, o[0]), fmaxf(old.y, o[1]));
          }
        }
      }
    }
  }
}

}  // namespace sa_tile
