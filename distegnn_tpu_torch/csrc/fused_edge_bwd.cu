// fused_edge_bwd.cu — one EGCL layer's in-window edge pass, backward, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes
// (distegnn_tpu_torch/ops/edge_pipeline.py: _fused_edge_bwd_cuda).
//
// Replaces the TPU kernel _bwd_kernel (distegnn_tpu/ops/edge_pipeline.py:314,
// launched by pallas_call in _fused_bwd_impl, :517) together with the XLA
// combine of its column-side window partials (:527-539). Same function: given
// the cotangents of the forward's sums, packed per node as
// gp = [g_trans (3) | 0 (5) | g_ef (H)] (f32 [N, H+8]), for every in-window
// edge it recomputes the forward (fused_edge_fwd.cu, through the same device
// functions of fused_edge_common.cuh) and runs the chain rule
//     d_trans = gp[row, 0:3];  d_g = cd . d_trans;  d_y2 = d_g * w4
//     d_t3 = d_y2 silu'(t3);   d_ef = gp[row, 8:] + d_t3 w3^T
//     d_t2 = d_ef silu'(t2);   d_y1 = d_t2 w2^T;     d_t1 = d_y1 silu'(t1)
//     d_radial = d_t1 . ws[0];  d_cd = 2 cd d_radial + d_trans g
// then scatters [hi(d_cd), lo(d_cd), 0, 0, bf16(d_t1)] into out_row at row
// and [hi(-d_cd), lo(-d_cd), 0, 0, bf16(d_t1)] into out_col at col (f32
// sums), and reduces the seven weight gradients
//     dws = sfeat^T d_t1, db1 = sum d_t1, dw2 = y1^T d_t2, db2 = sum d_t2,
//     dw3 = ef^T d_t3,    db3 = sum d_t3, dw4 = sum_e y2 d_g.
// The roundings are the TPU kernel's (edge_pipeline.py:346-410): the per-edge
// d_t1 payload is rounded to bf16 and d_cd split into bf16 hi + lo even in
// f32 mode; in bf16 mode every intermediate and every "@ w^T" product is
// rounded to bf16 where _bwd_kernel rounds it, and the weight-gradient
// products take the bf16 operands with f32 accumulation.
//
// What bounds it on the H100: six H x H tile products per edge (the two of
// the recomputed forward, the two transposed products of the chain, the two
// weight-gradient products), 12*H*H = 49 Kflop per edge at H=64, run as f32
// FMAs from shared memory (as in the forward kernel: exact f32 parity; bf16
// operands are exact in f32), so the f32 CUDA-core rate (67 TFLOP/s) and not
// the 3.35 TB/s memory bounds it. Tensor cores are a later step.
//
// Design, against the TPU kernel:
//  - Persistent blocks take TE=64-edge tiles of the receiver-sorted layout
//    with a grid stride, rebuild global (row, col) from row_t/col_l/kblk and
//    the window start clip(b-1, 0, nb-3) exactly as _global_edges and the
//    forward kernel do, and process an edge iff scal[e, 2] is set: the edge
//    set is the forward's, so nothing is double-counted against the remote
//    tail.
//  - Four [TE, H+1] tile buffers hold t1, t3/d_t3, t2/d_t2 and ef/y1; the
//    chain overwrites them in place (y1 is recomputed from t1 instead of
//    kept), so two blocks fit on an SM at H=64 (~106 KB each).
//  - Row side: edges are sorted by row, so each output column is reduced by
//    one thread walking the tile in order, with one f32 atomicAdd per row
//    segment, as in the forward.
//  - Column side: the TPU wrote 3-slot window partials per node block and
//    combined them in XLA because its grid steps may not race. Here every
//    active edge adds its payload straight into the zeroed out_col with
//    float4 atomics. The column sums are therefore NOT bitwise
//    deterministic: their f32 summation order changes from run to run.
//  - Weight gradients: each block accumulates its share in registers (the
//    H x H products per thread, the vectors per column) across all its
//    tiles and writes one f32 partial per block; a second kernel
//    (reduce_partials) sums the partials over the blocks in a fixed order, so
//    the weight gradients are deterministic for a given grid.
//  - H must be 16, 32 or 64 (the column passes give THREADS / H threads to
//    each column). No allocation, no synchronisation; both kernels run on
//    the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "fused_edge_common.cuh"

namespace {

using namespace fused_edge;

// layout of one weight-gradient vector (a block's partial, and the result):
// [dws 3H | db1 H | dw2 H*H | db2 H | dw3 H*H | db3 H | dw4 H]
template <int H>
struct WOff {
  static constexpr int dws = 0;
  static constexpr int db1 = 3 * H;
  static constexpr int dw2 = 4 * H;
  static constexpr int db2 = 4 * H + H * H;
  static constexpr int dw3 = 5 * H + H * H;
  static constexpr int db3 = 5 * H + 2 * H * H;
  static constexpr int dw4 = 6 * H + 2 * H * H;
  static constexpr int total = 7 * H + 2 * H * H;
};

template <int H>
constexpr size_t smem_bytes() {
  return (2 * H * (H + 1) + 4 * TE * (H + 1) + 7 * H + 14 * TE) *
             sizeof(float) +
         2 * TE * sizeof(int);
}

// f32 add of four lanes at p (16-byte aligned) into global memory
__device__ __forceinline__ void red_add4(float* p, float4 v) {
#if (__CUDACC_VER_MAJOR__ > 12) || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(reinterpret_cast<float4*>(p), v);
#else
  atomicAdd(p + 0, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

// acc[r][c] += sum_e A[e, ty + 16r] * B[e, tx + 16c] over the tile's edges:
// thread (ty, tx)'s share of the [H, H] weight gradient A^T B
template <int H>
__device__ __forceinline__ void tile_wgrad(const float* A, const float* B,
                                           float (&acc)[H / 16][H / 16]) {
  constexpr int LDA = H + 1;
  constexpr int CPT = H / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int e = 0; e < TE; ++e) {
    float a[CPT], b[CPT];
#pragma unroll
    for (int r = 0; r < CPT; ++r) a[r] = A[e * LDA + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < CPT; ++c) b[c] = B[e * LDA + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < CPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <int H, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
fused_edge_bwd_kernel(const int* __restrict__ row_t,
                      const int* __restrict__ col_l,
                      const int* __restrict__ kblk,
                      const float* __restrict__ scal,
                      const float* __restrict__ x,
                      const std::conditional_t<BF16, __nv_bfloat16, float>* __restrict__ hr,
                      const std::conditional_t<BF16, __nv_bfloat16, float>* __restrict__ hc,
                      const float* __restrict__ ws, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ w3, const float* __restrict__ b3,
                      const float* __restrict__ w4,
                      const float* __restrict__ gp,
                      float* __restrict__ out_row, float* __restrict__ out_col,
                      float* __restrict__ part, int n_nodes, int n_edges,
                      int block) {
  constexpr int LDA = H + 1;
  constexpr int LDW = H + 1;
  constexpr int F = H + 8;
  constexpr int CPT = H / 16;
  constexpr int G = THREADS / H;   // edge groups of the column passes
  constexpr int EPG = TE / G;      // edges of one group per tile
  constexpr int Q4 = 2 + H / 4;    // float4 lanes of one column-side payload
  static_assert(THREADS % H == 0 && TE % G == 0, "H must divide THREADS");
  using W = WOff<H>;

  extern __shared__ float smem[];
  float* sW2 = smem;                 // [H, LDW]
  float* sW3 = sW2 + H * LDW;        // [H, LDW]
  float* sP = sW3 + H * LDW;         // [TE, LDA] t1, then d_t1
  float* sQ = sP + TE * LDA;         // y1, then t3, then d_t3
  float* sR = sQ + TE * LDA;         // t2, then d_t2
  float* sS = sR + TE * LDA;         // ef, then y1 (recomputed)
  float* sWs = sS + TE * LDA;        // [3, H]
  float* sB1 = sWs + 3 * H;
  float* sB2 = sB1 + H;
  float* sB3 = sB2 + H;
  float* sW4 = sB3 + H;
  float* sCd = sW4 + H;              // [TE, 3] cd (f32)
  float* sSf = sCd + 3 * TE;         // [TE, 3] sfeat in the compute dtype
  float* sG = sSf + 3 * TE;          // [TE] the forward's gate g
  float* sDt = sG + TE;              // [TE, 3] d_trans
  float* sDg = sDt + 3 * TE;         // [TE] d_g
  float* sDcd = sDg + TE;            // [TE, 3] d_cd
  int* sRow = reinterpret_cast<int*>(sDcd + 3 * TE);  // [TE], -1 = inactive
  int* sCol = sRow + TE;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int cj = tid % H, cg = tid / H;   // column pass: column, edge group

  for (int i = tid; i < H * H; i += THREADS) {
    const int k = i / H, j = i % H;
    sW2[k * LDW + j] = rnd<BF16>(w2[i]);
    sW3[k * LDW + j] = rnd<BF16>(w3[i]);
  }
  for (int i = tid; i < 3 * H; i += THREADS) sWs[i] = rnd<BF16>(ws[i]);
  for (int i = tid; i < H; i += THREADS) {
    sB1[i] = rnd<BF16>(b1[i]);
    sB2[i] = rnd<BF16>(b2[i]);
    sB3[i] = rnd<BF16>(b3[i]);
    sW4[i] = w4[i];
  }

  float acc_dw2[CPT][CPT], acc_dw3[CPT][CPT];
#pragma unroll
  for (int r = 0; r < CPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_dw2[r][c] = acc_dw3[r][c] = 0.f;
  float a_db1 = 0.f, a_db2 = 0.f, a_db3 = 0.f, a_dw4 = 0.f;
  float a_dws0 = 0.f, a_dws1 = 0.f, a_dws2 = 0.f;

  const int T = block;
  const int nb = n_nodes / T;
  const int epb = n_edges / nb;
  const int smax = nb - 3 > 0 ? nb - 3 : 0;
  const int n_tiles = (n_edges + TE - 1) / TE;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // weights loaded / previous tile fully consumed

    // ---- per edge: layout -> global (row, col), geometry, d_trans
    int active = 0;
    if (tid < TE) {
      const int e = tile * TE + tid;
      int row = -1, col = 0;
      float cd[3] = {0.f, 0.f, 0.f}, sf[3] = {0.f, 0.f, 0.f};
      float dt[3] = {0.f, 0.f, 0.f};
      if (e < n_edges) {
        const float m = scal[(size_t)e * XL + 2];
        const int rl = row_t[e];
        if (m > 0.f && rl < T) {
          const int b = e / epb;
          const int s = min(max(b - 1, 0), smax);
          row = b * T + rl;
          col = (s + kblk[e]) * T + col_l[e];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            cd[k] = x[3 * (size_t)row + k] - x[3 * (size_t)col + k];
            dt[k] = gp[(size_t)row * F + k];
          }
          const float radial = __fadd_rn(
              __fadd_rn(__fmul_rn(cd[0], cd[0]), __fmul_rn(cd[1], cd[1])),
              __fmul_rn(cd[2], cd[2]));
          sf[0] = rnd<BF16>(radial);
          sf[1] = rnd<BF16>(scal[(size_t)e * XL + 0]);
          sf[2] = rnd<BF16>(scal[(size_t)e * XL + 1]);
          active = 1;
        }
      }
      sRow[tid] = row;
      sCol[tid] = col;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sCd[3 * tid + k] = cd[k];
        sSf[3 * tid + k] = sf[k];
        sDt[3 * tid + k] = dt[k];
      }
    }
    if (!__syncthreads_or(active)) continue;  // all-padding tile

    // ---- forward: t1 -> sP, y1 = silu(t1) -> sQ
    for (int i = tid; i < TE * H; i += THREADS) {
      const int el = i / H, j = i % H;
      const int row = sRow[el];
      float t = 0.f;
      if (row >= 0) {
        const float hrc = rnd<BF16>(load(hr, (size_t)row * H + j) +
                                    load(hc, (size_t)sCol[el] * H + j));
        const float sw = rnd<BF16>(
            fmaf(sSf[3 * el + 2], sWs[2 * H + j],
                 fmaf(sSf[3 * el + 1], sWs[H + j], sSf[3 * el] * sWs[j])));
        t = dense_pre<BF16>(hrc + sw, sB1[j]);
      }
      sP[el * LDA + j] = t;
      sQ[el * LDA + j] = silu<BF16>(t);
    }
    __syncthreads();

    // ---- forward: t2 -> sR, ef = silu(t2) -> sS
    {
      float acc[4][CPT];
      tile_mm<H, LDW, false>(sQ, sW2, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int e = ty + 16 * r, j = tx + 16 * c;
          const float t = dense_pre<BF16>(acc[r][c], sB2[j]);
          sR[e * LDA + j] = t;
          sS[e * LDA + j] = silu<BF16>(t);
        }
    }
    __syncthreads();

    // ---- forward: t3 -> sQ
    {
      float acc[4][CPT];
      tile_mm<H, LDW, false>(sS, sW3, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int e = ty + 16 * r, j = tx + 16 * c;
          sQ[e * LDA + j] = dense_pre<BF16>(acc[r][c], sB3[j]);
        }
    }
    __syncthreads();

    // ---- per edge: the gate g (summed as the forward sums it), d_g
    if (tid < TE) {
      float g = 0.f, dg = 0.f;
      if (sRow[tid] >= 0) {
        for (int j = 0; j < H; ++j)
          g = __fadd_rn(g, __fmul_rn(silu<BF16>(sQ[tid * LDA + j]), sW4[j]));
        const float* c3 = sCd + 3 * tid;
        const float* t3 = sDt + 3 * tid;
        dg = __fadd_rn(__fadd_rn(__fmul_rn(c3[0], t3[0]),
                                 __fmul_rn(c3[1], t3[1])),
                       __fmul_rn(c3[2], t3[2]));
      }
      sG[tid] = g;
      sDg[tid] = dg;
    }
    __syncthreads();

    // ---- d_y2 = d_g w4; d_t3 = d_y2 silu'(t3) in place in sQ; dw4, db3
#pragma unroll 4
    for (int m = 0; m < EPG; ++m) {
      const int el = cg + G * m;
      const float t3 = sQ[el * LDA + cj];
      const float dg = sDg[el];
      const float d_y2 = rnd<BF16>(__fmul_rn(dg, sW4[cj]));
      const float d_t3 = rnd<BF16>(__fmul_rn(d_y2, dsilu<BF16>(t3)));
      a_dw4 = fmaf(silu<BF16>(t3), dg, a_dw4);
      a_db3 += d_t3;
      sQ[el * LDA + cj] = d_t3;
    }
    __syncthreads();

    // ---- dw3 += ef^T d_t3; d_ef = g_ef[row] + d_t3 w3^T;
    //      d_t2 = d_ef silu'(t2) in place in sR
    tile_wgrad<H>(sS, sQ, acc_dw3);
    {
      float acc[4][CPT];
      tile_mm<H, LDW, true>(sQ, sW3, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = ty + 16 * r;
        const int row = sRow[e];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int i = tx + 16 * c;
          const float up = row >= 0 ? gp[(size_t)row * F + 8 + i] : 0.f;
          const float d_ef = rnd<BF16>(rnd<BF16>(up) + rnd<BF16>(acc[r][c]));
          const float t2 = sR[e * LDA + i];
          sR[e * LDA + i] = rnd<BF16>(__fmul_rn(d_ef, dsilu<BF16>(t2)));
        }
      }
    }
    __syncthreads();

    // ---- y1 = silu(t1) -> sS (recomputed); db2
#pragma unroll 4
    for (int m = 0; m < EPG; ++m) {
      const int el = cg + G * m;
      sS[el * LDA + cj] = silu<BF16>(sP[el * LDA + cj]);
      a_db2 += sR[el * LDA + cj];
    }
    __syncthreads();

    // ---- dw2 += y1^T d_t2; d_y1 = d_t2 w2^T; d_t1 = d_y1 silu'(t1) in sP
    tile_wgrad<H>(sS, sR, acc_dw2);
    {
      float acc[4][CPT];
      tile_mm<H, LDW, true>(sR, sW2, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int e = ty + 16 * r, i = tx + 16 * c;
          const float t1 = sP[e * LDA + i];
          sP[e * LDA + i] =
              rnd<BF16>(__fmul_rn(rnd<BF16>(acc[r][c]), dsilu<BF16>(t1)));
        }
    }
    __syncthreads();

    // ---- db1, dws; per edge d_radial = d_t1 . ws[0], d_cd
#pragma unroll 4
    for (int m = 0; m < EPG; ++m) {
      const int el = cg + G * m;
      const float d = sP[el * LDA + cj];
      a_db1 += d;
      a_dws0 = fmaf(sSf[3 * el + 0], d, a_dws0);
      a_dws1 = fmaf(sSf[3 * el + 1], d, a_dws1);
      a_dws2 = fmaf(sSf[3 * el + 2], d, a_dws2);
    }
    if (tid < TE) {
      float dcd[3] = {0.f, 0.f, 0.f};
      if (sRow[tid] >= 0) {
        float ds = 0.f;
        for (int j = 0; j < H; ++j) ds = fmaf(sP[tid * LDA + j], sWs[j], ds);
        const float d_radial = rnd<BF16>(ds);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          dcd[k] = __fadd_rn(
              __fmul_rn(__fmul_rn(2.0f, sCd[3 * tid + k]), d_radial),
              __fmul_rn(sDt[3 * tid + k], sG[tid]));
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) sDcd[3 * tid + k] = dcd[k];
    }
    __syncthreads();

    // ---- row side: [hi(d_cd), lo(d_cd), 0, 0, bf16(d_t1)] by row segment
    if (tid < F && tid != 6 && tid != 7) {
      const int c = tid;
      float acc = 0.f;
      int cur = -1;
      for (int el = 0; el < TE; ++el) {
        const int row = sRow[el];
        if (row < 0) continue;
        float v;
        if (c < 6) {
          const float d = sDcd[3 * el + (c % 3)];
          const float hi = round_bf16(d);
          v = c < 3 ? hi : round_bf16(d - hi);
        } else {
          v = round_bf16(sP[el * LDA + (c - 8)]);
        }
        if (row != cur) {
          if (cur >= 0) atomicAdd(&out_row[(size_t)cur * F + c], acc);
          cur = row;
          acc = 0.f;
        }
        acc += v;
      }
      if (cur >= 0) atomicAdd(&out_row[(size_t)cur * F + c], acc);
    }

    // ---- column side: [hi(-d_cd), lo(-d_cd), 0, 0, bf16(d_t1)] at col,
    //      one float4 atomic per 4 lanes (order-dependent f32 sums)
    for (int i = tid; i < TE * Q4; i += THREADS) {
      const int el = i / Q4, q = i % Q4;
      if (sRow[el] < 0) continue;
      float4 v;
      if (q < 2) {
        const float* d = sDcd + 3 * el;
        const float h0 = round_bf16(d[0]), h1 = round_bf16(d[1]),
                    h2 = round_bf16(d[2]);
        const float l0 = round_bf16(d[0] - h0), l1 = round_bf16(d[1] - h1),
                    l2 = round_bf16(d[2] - h2);
        v = q == 0 ? make_float4(-h0, -h1, -h2, -l0)
                   : make_float4(-l1, -l2, 0.f, 0.f);
      } else {
        const float* p = sP + el * LDA + 4 * (q - 2);
        v = make_float4(round_bf16(p[0]), round_bf16(p[1]), round_bf16(p[2]),
                        round_bf16(p[3]));
      }
      red_add4(out_col + (size_t)sCol[el] * F + 4 * q, v);
    }
  }

  // ---- this block's weight-gradient partial
  float* pb = part + (size_t)blockIdx.x * W::total;
#pragma unroll
  for (int r = 0; r < CPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      pb[W::dw2 + i * H + j] = acc_dw2[r][c];
      pb[W::dw3 + i * H + j] = acc_dw3[r][c];
    }
  __syncthreads();  // sP is free: reduce the column accumulators over groups
  float* red = sP;  // [7, G, H]
  const float vals[7] = {a_dws0, a_dws1, a_dws2, a_db1, a_db2, a_db3, a_dw4};
#pragma unroll
  for (int q = 0; q < 7; ++q) red[(q * G + cg) * H + cj] = vals[q];
  __syncthreads();
  if (tid < H) {
    const int off[7] = {W::dws, W::dws + H, W::dws + 2 * H, W::db1,
                        W::db2, W::db3,     W::dw4};
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      float s = 0.f;
      for (int g = 0; g < G; ++g) s += red[(q * G + g) * H + tid];
      pb[off[q] + tid] = s;
    }
  }
}

// out[k] = sum over the n_blocks partials of part[b, k], in block order
__global__ void reduce_partials(const float* __restrict__ part,
                                float* __restrict__ out, int n_blocks,
                                int total) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[(size_t)b * total + k];
  out[k] = s;
}

template <int H, bool BF16>
cudaError_t launch(const void* row_t, const void* col_l, const void* kblk,
                   const void* scal, const void* x, const void* hr,
                   const void* hc, const void* ws, const void* b1,
                   const void* w2, const void* b2, const void* w3,
                   const void* b3, const void* w4, const void* gp,
                   void* out_row, void* out_col, void* part, void* dw,
                   int n_nodes, int n_edges, int block, int n_sm,
                   int max_grid, cudaStream_t stream) {
  using Act = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr size_t smem = smem_bytes<H>();
  auto kern = fused_edge_bwd_kernel<H, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_edges + TE - 1) / TE;
  int grid = (per_sm > 0 ? per_sm : 1) * n_sm;
  if (grid > n_tiles) grid = n_tiles;
  if (grid > max_grid) grid = max_grid;
  if (grid >= 1) {
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const int*>(row_t), static_cast<const int*>(col_l),
        static_cast<const int*>(kblk), static_cast<const float*>(scal),
        static_cast<const float*>(x), static_cast<const Act*>(hr),
        static_cast<const Act*>(hc), static_cast<const float*>(ws),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(w3),
        static_cast<const float*>(b3), static_cast<const float*>(w4),
        static_cast<const float*>(gp), static_cast<float*>(out_row),
        static_cast<float*>(out_col), static_cast<float*>(part), n_nodes,
        n_edges, block);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr int total = WOff<H>::total;
  reduce_partials<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw),
      grid > 0 ? grid : 0, total);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launches (0 = success). gp [N, H+8] f32 is
// the packed cotangent; out_row/out_col [N, H+8] f32 must be zeroed by the
// caller; part is scratch for max_grid weight-gradient partials of
// 7H + 2H^2 floats each; dw [7H + 2H^2] f32 receives the reduced weight
// gradients. hr/hc are f32 (bf16 == 0) or bf16 (bf16 == 1).
extern "C" int fused_edge_bwd(const void* row_t, const void* col_l,
                              const void* kblk, const void* scal,
                              const void* x, const void* hr, const void* hc,
                              const void* ws, const void* b1, const void* w2,
                              const void* b2, const void* w3, const void* b3,
                              const void* w4, const void* gp, void* out_row,
                              void* out_col, void* part, void* dw,
                              int n_nodes, int n_edges, int block, int H,
                              int bf16, int n_sm, int max_grid,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEG_CASE(HH)                                                        \
  case HH:                                                                  \
    return bf16 ? (int)launch<HH, true>(row_t, col_l, kblk, scal, x, hr,    \
                                        hc, ws, b1, w2, b2, w3, b3, w4, gp, \
                                        out_row, out_col, part, dw,         \
                                        n_nodes, n_edges, block, n_sm,      \
                                        max_grid, s)                        \
                : (int)launch<HH, false>(row_t, col_l, kblk, scal, x, hr,   \
                                         hc, ws, b1, w2, b2, w3, b3, w4,    \
                                         gp, out_row, out_col, part, dw,    \
                                         n_nodes, n_edges, block, n_sm,     \
                                         max_grid, s);
  switch (H) {
    DEG_CASE(16)
    DEG_CASE(32)
    DEG_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DEG_CASE
}
