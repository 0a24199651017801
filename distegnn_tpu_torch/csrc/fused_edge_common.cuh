// fused_edge_common.cuh — device functions shared by the fused edge pass's
// forward (fused_edge_fwd.cu) and backward (fused_edge_bwd.cu) kernels, so
// that the backward recomputes the forward with the same roundings, bit for
// bit.
//
// Tile convention: a tile is TE = 64 consecutive receiver-sorted edges held
// in shared memory as [TE, LDA] f32 rows (LDA = H + 1: conflict-free column
// walks). THREADS = 256 threads form a 16 x 16 grid; thread (ty, tx) owns
// the tile rows ty + 16r and the columns tx + 16c of every tile product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_edge {

constexpr int TE = 64;         // edges per tile
constexpr int THREADS = 256;   // 16 x 16 thread grid of the tile products
constexpr int XL = 8;          // lanes of scal [E, XL]

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) {
    return round_bf16(v);
  } else {
    return v;
  }
}

// silu(t) = t * sigmoid(t), the sigmoid rounded to the compute dtype first
// (jax.nn.sigmoid on a bf16 array returns bf16)
template <bool BF16>
__device__ __forceinline__ float silu(float t) {
  const float s = rnd<BF16>(1.0f / (1.0f + expf(-t)));
  return rnd<BF16>(t * s);
}

// silu'(t) = s * (1 + t * (1 - s)), every operation rounded to the compute
// dtype as the JAX package's _dsilu rounds it on a bf16 array; no FMA
// contraction, so f32 mode rounds as the plain version does
template <bool BF16>
__device__ __forceinline__ float dsilu(float t) {
  const float s = rnd<BF16>(1.0f / (1.0f + expf(-t)));
  const float a = rnd<BF16>(__fsub_rn(1.0f, s));
  const float b = rnd<BF16>(__fmul_rn(t, a));
  const float c = rnd<BF16>(__fadd_rn(1.0f, b));
  return rnd<BF16>(__fmul_rn(s, c));
}

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// acc[r][c] = sum_k src[(ty + 16r) * LDA + k] * W'[k, tx + 16c] over the H
// columns of the tile rows, where W' = W (W[k * LDW + j]) or, with WT, its
// transpose (W[j * LDW + k]; LDW = H + 1 keeps that walk conflict-free).
// The sum runs over k in order, one fmaf per term.
template <int H, int LDW, bool WT>
__device__ __forceinline__ void tile_mm(const float* src, const float* W,
                                        float (&acc)[4][H / 16]) {
  constexpr int LDA = H + 1;
  constexpr int CPT = H / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    float a[4], b[CPT];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = src[(ty + 16 * r) * LDA + k];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      b[c] = WT ? W[(tx + 16 * c) * LDW + k] : W[k * LDW + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// a Dense's pre-activation: the product and the bias add each rounded to the
// compute dtype, as flax's nn.Dense(dtype=...) and the TPU kernel round them
template <bool BF16>
__device__ __forceinline__ float dense_pre(float acc, float bias) {
  return rnd<BF16>(rnd<BF16>(acc) + bias);
}

// dst[e, j] = silu(dense_pre(src[e, :] @ W[:, j], bias[j])), and with
// head != nullptr the gate terms dst[e, j] * head[j] instead.
template <int H, bool BF16, int LDW = H>
__device__ __forceinline__ void tile_dense_silu(const float* src,
                                                const float* W,
                                                const float* bias,
                                                const float* head,
                                                float* dst) {
  constexpr int LDA = H + 1;
  constexpr int CPT = H / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][CPT];
  tile_mm<H, LDW, false>(src, W, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = tx + 16 * c;
      float y = silu<BF16>(dense_pre<BF16>(acc[r][c], bias[j]));
      if (head != nullptr) y *= head[j];
      dst[(ty + 16 * r) * LDA + j] = y;
    }
}

}  // namespace fused_edge
