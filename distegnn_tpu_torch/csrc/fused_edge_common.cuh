// fused_edge_common.cuh — device functions shared by the fused edge pass's
// forward (fused_edge_fwd.cu) and backward (fused_edge_bwd.cu) kernels, so
// that the backward recomputes the forward with the same roundings, bit for
// bit, and by the fused-stack megakernel (fused_stack_fwd.cu), whose
// in-window pass is the forward tile below, the same code.
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

// acc[r][c] = sum_{k < K} src[(ty + 16r) * LDA + k] * W'[k, j] for the
// columns j = tx + 16c < N (0 beyond N, where N is not a multiple of 16),
// where W' = W (W[k * LDW + j]) or, with WT, its transpose (W[j * LDW + k];
// LDW = H + 1 keeps that walk conflict-free). The sum runs over k in order,
// one fmaf per term. K and N are H, or the phi_x width HX = H / T of the
// tensor axis.
template <int K, int N, int LDA, int LDW, bool WT>
__device__ __forceinline__ void tile_mm(const float* src, const float* W,
                                        float (&acc)[4][(N + 15) / 16]) {
  constexpr int CPT = (N + 15) / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[CPT];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = src[(ty + 16 * r) * LDA + k];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = tx + 16 * c;
      if constexpr (N % 16 == 0)
        b[c] = WT ? W[j * LDW + k] : W[k * LDW + j];
      else
        b[c] = j < N ? (WT ? W[j * LDW + k] : W[k * LDW + j]) : 0.0f;
    }
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

// dst[e, j] = silu(dense_pre(src[e, :] @ W[:, j], bias[j])) for the N
// columns j of W [H, N] (rows of N), and with head != nullptr the gate
// terms dst[e, j] * head[j] instead
template <int H, int N, bool BF16>
__device__ __forceinline__ void tile_dense_silu(const float* src,
                                                const float* W,
                                                const float* bias,
                                                const float* head,
                                                float* dst) {
  constexpr int LDA = H + 1;
  constexpr int CPT = (N + 15) / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][CPT];
  tile_mm<H, N, LDA, N, false>(src, W, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = tx + 16 * c;
      if (N % 16 != 0 && j >= N) continue;
      float y = silu<BF16>(dense_pre<BF16>(acc[r][c], bias[j]));
      if (head != nullptr) y *= head[j];
      dst[(ty + 16 * r) * LDA + j] = y;
    }
}

// ------------------------------------------------------ the forward tile
//
// One tile of TE edges through phi_e + phi_x and the row segment sums:
//   t1 = hr[row] + hc[col] + [radial, a0, a1] @ ws + b1; y1 = silu(t1)
//   ef = silu(y1 @ w2 + b2); g = silu(ef @ w3 + b3) . w4; trans = cd * g
// The edge's (row, col, a0, a1) come from the blocked in-window layout
// (fwd_setup_inwindow) or from a compact remote edge list
// (fwd_setup_remote); fwd_aggregate_inwindow sums the TPU kernel's packed
// [bf16 hi(trans), bf16 lo(trans), 1, 0, bf16(ef)] row, and
// fwd_aggregate_remote the remote tail's unrounded [trans, 1, ef] (EGCLVel's
// dense tail), both by f32 atomicAdd at each row-segment end of the tile.
//
// HX is the width of phi_x's hidden layer: H, or H / T under the tensor
// axis, where w3 is [H, HX] (rows of HX), b3 and w4 [HX], and the gate g is
// the rank's partial sum over its HX columns. The buffers keep their H x H
// size either way.

template <int H>
struct FwdTile {
  static constexpr int LDA = H + 1;
  static constexpr size_t kFloats = 2 * H * H + 2 * TE * LDA + 7 * H + 7 * TE;
  static constexpr size_t kBytes = kFloats * sizeof(float) +
                                   2 * TE * sizeof(int);
  float* W2;    // [H, H]
  float* W3;    // [H, H]
  float* A;     // [TE, LDA] y1, then the gate terms
  float* B;     // [TE, LDA] ef
  float* Ws;    // [3, H]
  float* B1;
  float* B2;
  float* B3;
  float* W4;
  float* Cd;    // [TE, 3]
  float* S;     // [TE, 3] [radial, a0, a1] in the compute dtype
  float* G;     // [TE]
  int* Row;     // [TE], -1 = inactive
  int* Col;     // [TE]
  __device__ explicit FwdTile(float* smem) {
    W2 = smem;
    W3 = W2 + H * H;
    A = W3 + H * H;
    B = A + TE * LDA;
    Ws = B + TE * LDA;
    B1 = Ws + 3 * H;
    B2 = B1 + H;
    B3 = B2 + H;
    W4 = B3 + H;
    Cd = W4 + H;
    S = Cd + 3 * TE;
    G = S + 3 * TE;
    Row = reinterpret_cast<int*>(G + TE);
    Col = Row + TE;
  }
};

// weights in the compute dtype (the TPU kernel casts them with astype); the
// phi_x head w4 stays f32
template <int H, bool BF16, int HX = H>
__device__ __forceinline__ void fwd_load_weights(
    const FwdTile<H>& s, const float* __restrict__ ws,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, const float* __restrict__ w4) {
  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += THREADS) s.W2[i] = rnd<BF16>(w2[i]);
  for (int i = tid; i < H * HX; i += THREADS) s.W3[i] = rnd<BF16>(w3[i]);
  for (int i = tid; i < 3 * H; i += THREADS) s.Ws[i] = rnd<BF16>(ws[i]);
  for (int i = tid; i < H; i += THREADS) {
    s.B1[i] = rnd<BF16>(b1[i]);
    s.B2[i] = rnd<BF16>(b2[i]);
  }
  for (int i = tid; i < HX; i += THREADS) {
    s.B3[i] = rnd<BF16>(b3[i]);
    s.W4[i] = w4[i];
  }
}

// slot el of the tile: an edge row <- col with attributes (a0, a1), or
// inactive (row < 0); returns whether it is active
template <int H, bool BF16>
__device__ __forceinline__ int fwd_store_edge(const FwdTile<H>& s, int el,
                                              int row, int col, float a0,
                                              float a1,
                                              const float* __restrict__ x) {
  float cd0 = 0.f, cd1 = 0.f, cd2 = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (row >= 0) {
    cd0 = x[3 * (size_t)row + 0] - x[3 * (size_t)col + 0];
    cd1 = x[3 * (size_t)row + 1] - x[3 * (size_t)col + 1];
    cd2 = x[3 * (size_t)row + 2] - x[3 * (size_t)col + 2];
    // no FMA contraction: |cd|^2 rounded as the reference sums it
    const float radial = __fadd_rn(
        __fadd_rn(__fmul_rn(cd0, cd0), __fmul_rn(cd1, cd1)),
        __fmul_rn(cd2, cd2));
    s0 = rnd<BF16>(radial);
    s1 = rnd<BF16>(a0);
    s2 = rnd<BF16>(a1);
  } else {
    col = 0;
  }
  s.Row[el] = row;
  s.Col[el] = col;
  s.Cd[3 * el + 0] = cd0;
  s.Cd[3 * el + 1] = cd1;
  s.Cd[3 * el + 2] = cd2;
  s.S[3 * el + 0] = s0;
  s.S[3 * el + 1] = s1;
  s.S[3 * el + 2] = s2;
  return row >= 0;
}

// the in-window slots of tile `tile` of the blocked layout: global (row,
// col) from row_t / col_l / kblk and the window start clip(b-1, 0, nb-3);
// an edge is active iff scal[e, 2] (in-window & real) is set
template <int H, bool BF16>
__device__ __forceinline__ int fwd_setup_inwindow(
    const FwdTile<H>& s, int tile, const int* __restrict__ row_t,
    const int* __restrict__ col_l, const int* __restrict__ kblk,
    const float* __restrict__ scal, const float* __restrict__ x,
    int n_nodes, int n_edges, int block) {
  const int tid = threadIdx.x;
  int active = 0;
  if (tid < TE) {
    const int T = block;
    const int nb = n_nodes / T;
    const int epb = n_edges / nb;
    const int smax = nb - 3 > 0 ? nb - 3 : 0;
    const int e = tile * TE + tid;
    int row = -1, col = 0;
    float a0 = 0.f, a1 = 0.f;
    if (e < n_edges) {
      const float m = scal[(size_t)e * XL + 2];
      const int rl = row_t[e];
      if (m > 0.f && rl < T) {
        const int b = e / epb;
        const int st = min(max(b - 1, 0), smax);
        row = b * T + rl;
        col = (st + kblk[e]) * T + col_l[e];
        a0 = scal[(size_t)e * XL + 0];
        a1 = scal[(size_t)e * XL + 1];
      }
    }
    active = fwd_store_edge<H, BF16>(s, tid, row, col, a0, a1, x);
  }
  return active;
}

// the slots of tile `tile` of a compact remote edge list (rr, rc, rattr
// [R, 2], rmask [R]; R a multiple of TE)
template <int H, bool BF16>
__device__ __forceinline__ int fwd_setup_remote(
    const FwdTile<H>& s, int tile, const int* __restrict__ rr,
    const int* __restrict__ rc, const float* __restrict__ rattr,
    const float* __restrict__ rmask, const float* __restrict__ x) {
  const int tid = threadIdx.x;
  int active = 0;
  if (tid < TE) {
    const int e = tile * TE + tid;
    const bool on = rmask[e] > 0.f;
    active = fwd_store_edge<H, BF16>(s, tid, on ? rr[e] : -1, rc[e],
                                     rattr[2 * (size_t)e],
                                     rattr[2 * (size_t)e + 1], x);
  }
  return active;
}

// the tile's MLPs: leaves ef in s.B and the gate g in s.G
template <int H, bool BF16, typename Act, int HX = H>
__device__ __forceinline__ void fwd_tile_mlp(const FwdTile<H>& s,
                                             const Act* __restrict__ hr,
                                             const Act* __restrict__ hc) {
  constexpr int LDA = H + 1;
  const int tid = threadIdx.x;
  // t1 = (hr[row] + hc[col]) + sfeat @ ws + b1;  y1 = silu(t1)
  for (int i = tid; i < TE * H; i += THREADS) {
    const int el = i / H, j = i % H;
    const int row = s.Row[el];
    float y = 0.f;
    if (row >= 0) {
      const float hrc = rnd<BF16>(load(hr, (size_t)row * H + j) +
                                  load(hc, (size_t)s.Col[el] * H + j));
      const float sw = rnd<BF16>(
          fmaf(s.S[3 * el + 2], s.Ws[2 * H + j],
               fmaf(s.S[3 * el + 1], s.Ws[H + j], s.S[3 * el] * s.Ws[j])));
      y = silu<BF16>(rnd<BF16>(rnd<BF16>(hrc + sw) + s.B1[j]));
    }
    s.A[el * LDA + j] = y;
  }
  __syncthreads();

  // ef = silu(y1 @ w2 + b2)
  tile_dense_silu<H, H, BF16>(s.A, s.W2, s.B2, nullptr, s.B);
  __syncthreads();

  // gate terms silu(ef @ w3 + b3) * w4 (into A, free again)
  tile_dense_silu<H, HX, BF16>(s.B, s.W3, s.B3, s.W4, s.A);
  __syncthreads();

  if (tid < TE) {
    float g = 0.f;
    for (int j = 0; j < HX; ++j) g += s.A[tid * LDA + j];
    s.G[tid] = g;
  }
  __syncthreads();
}

// segment sums by row into out [N, F] (F >= H+8): column c per thread, in
// edge order, the TPU kernel's packed in-window row
template <int H>
__device__ __forceinline__ void fwd_aggregate_inwindow(const FwdTile<H>& s,
                                                       float* __restrict__ out,
                                                       int F) {
  constexpr int LDA = H + 1;
  const int tid = threadIdx.x;
  if (tid < H + 8 && tid != 7) {
    const int c = tid;
    float acc = 0.f;
    int cur = -1;
    for (int el = 0; el < TE; ++el) {
      const int row = s.Row[el];
      if (row < 0) continue;
      float v;
      if (c < 6) {
        const float tr = s.Cd[3 * el + (c % 3)] * s.G[el];
        const float hi = round_bf16(tr);
        v = c < 3 ? hi : round_bf16(tr - hi);
      } else if (c == 6) {
        v = 1.f;
      } else {
        v = round_bf16(s.B[el * LDA + (c - 8)]);
      }
      if (row != cur) {
        if (cur >= 0) atomicAdd(&out[(size_t)cur * F + c], acc);
        cur = row;
        acc = 0.f;
      }
      acc += v;
    }
    if (cur >= 0) atomicAdd(&out[(size_t)cur * F + c], acc);
  }
}

// the remote tail's sums into out [N, F]: trans (f32, unsplit) at columns
// trans_col..+2, the count at column 6, ef (unrounded) at columns 8..8+H
template <int H>
__device__ __forceinline__ void fwd_aggregate_remote(const FwdTile<H>& s,
                                                     float* __restrict__ out,
                                                     int F, int trans_col) {
  constexpr int LDA = H + 1;
  const int tid = threadIdx.x;
  if (tid < H + 4) {
    const int c = tid;
    const int col = c < 3 ? trans_col + c : (c == 3 ? 6 : 8 + (c - 4));
    float acc = 0.f;
    int cur = -1;
    for (int el = 0; el < TE; ++el) {
      const int row = s.Row[el];
      if (row < 0) continue;
      const float v = c < 3 ? s.Cd[3 * el + c] * s.G[el]
                            : (c == 3 ? 1.f : s.B[el * LDA + (c - 4)]);
      if (row != cur) {
        if (cur >= 0) atomicAdd(&out[(size_t)cur * F + col], acc);
        cur = row;
        acc = 0.f;
      }
      acc += v;
    }
    if (cur >= 0) atomicAdd(&out[(size_t)cur * F + col], acc);
  }
}

}  // namespace fused_edge
