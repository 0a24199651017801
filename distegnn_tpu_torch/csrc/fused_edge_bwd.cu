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
// Two kernels compute it. The bf16 path (the flagship's) runs
// fused_edge_bwd_tc_kernel, the f32 path fused_edge_bwd_kernel.
//
// Under the tensor axis of the mesh both run at a phi_x width HX = H / T:
// w3 is [H, HX], b3 and w4 [HX], so t3, y2 and d_t3 are [TE, HX], dw3 is
// [H, HX] and the weight-gradient vector [dws 3H | db1 H | dw2 H*H | db2 H
// | dw3 H*HX | db3 HX | dw4 HX]. Each is instantiated at HX in {H, H/2,
// H/4} (at least 8); HX = H is the code it was before the axis.
//
// What bounds it on the H100. Per edge six H x H tile products (the two of
// the recomputed forward, the two transposed products of the chain, the two
// weight-gradient products), 12*H*H = 49 Kflop at H=64, plus ~30 H of
// elementwise work with three sigmoids and some twenty bf16 roundings per
// element. On the tensor cores (989 TFLOP/s bf16) the products are not the
// limit: at the flagship shape (113k nodes, 1.43 M in-window edges) the
// bound is 0.07 ms and the kernel takes ~2.1 ms, and what it spends is the
// elementwise epilogues of the products (the sigmoid's expf and IEEE
// division, the roundings), the hr/hc gathers of the recomputed t1, and the
// per-edge f32 atomics of the column side (PERF.md has the measured split).
// The f32 path keeps its products as f32 FMAs from shared memory: on the
// tensor cores f32 operands would be rounded to TF32, which breaks the f32
// parity the tests hold; its bound is the 67 TFLOP/s f32 rate.
//
// Design of the bf16 kernel (fused_edge_bwd_tc_kernel), against the TPU
// kernel and the FMA kernel it replaced on this path:
//  - Persistent blocks (2 an SM: ~100 KB of shared memory and 128
//    registers a thread) take TE=64-edge tiles of the receiver-sorted
//    layout with a grid stride, and rebuild global (row, col) from
//    row_t/col_l/kblk and the window start clip(b-1, 0, nb-3) as
//    _global_edges does; an edge is processed iff scal[e, 2] is set.
//  - The six products run as mma.sync m16n8k16 (bf16 in, f32 accumulate)
//    from bf16 tiles in shared memory read by ldmatrix, rows padded to H+8
//    so the eight rows of one ldmatrix phase fall in distinct banks; the
//    weights are staged once a block and read plainly or transposed by
//    ldmatrix, so W and W^T come from one copy. Every operand is a bf16
//    value in _bwd_kernel's bf16 path, so each product term is exact; only
//    the f32 summation order differs. The weight-gradient products keep
//    their f32 accumulators in registers across all of a block's tiles.
//  - Each sigmoid is computed once and kept (sigmoid(t1), sigmoid(t2) in
//    bf16 tiles); the gate g and d_radial are reduced by warp shuffles
//    inside the product epilogues (the FMA kernel walked them per edge).
//  - While a tile's last phases run, warps 0-1 stage the next tile: its
//    indices, geometry and d_g into the other of two per-edge buffers, and
//    its hr[row] / hc[col] rows by cp.async into two tiles that are dead by
//    then (Hopper's TMA cannot gather rows by index).
//  - Row side: the payload [hi(d_cd), lo(d_cd), 0, 0, d_t1] of each edge
//    is summed by row segment as a tensor-core product, a 0/1 one-hot
//    [segment, edge] times the payload tile, then one f32 atomicAdd per
//    (segment, column) into out_row.
// The tensor-core building blocks (ldmatrix / mma.sync, the edge staging,
// the one-hot row side) are fused_edge_tc.cuh's, shared with the forward's
// tensor-core kernel (fused_edge_fwd.cu).
// Both kernels:
//  - Column side: the TPU wrote 3-slot window partials per node block and
//    combined them in XLA because its grid steps may not race. Here every
//    active edge adds its payload straight into the zeroed out_col with
//    float4 atomics. The column sums are therefore NOT bitwise
//    deterministic: their f32 summation order changes from run to run.
//  - Weight gradients: each block accumulates its share in registers
//    across all its tiles and writes one f32 partial per block; a second
//    kernel (reduce_partials) sums the partials over the blocks in a fixed
//    order, so the weight gradients are deterministic for a given grid. The
//    grid (every resident block, at most one per tile) is what
//    fused_edge_bwd_grid reports, and the caller sizes the partials by it.
//  - H must be 16, 32 or 64 (the column passes give THREADS / H threads to
//    each column). No allocation, no synchronisation; both kernels run on
//    the caller's stream.
//
// Design of the f32 kernel (fused_edge_bwd_kernel): four [TE, H+1] f32
// tile buffers (t1, t3/d_t3, t2/d_t2, ef/y1, the chain overwriting them in
// place), the products as f32 FMAs per thread of a 16 x 16 grid, and the
// row side as one thread per output column walking the tile in edge order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "fused_edge_common.cuh"
#include "fused_edge_tc.cuh"

namespace {

using namespace fused_edge;

// layout of one weight-gradient vector (a block's partial, and the result):
// [dws 3H | db1 H | dw2 H*H | db2 H | dw3 H*HX | db3 HX | dw4 HX]
template <int H, int HX = H>
struct WOff {
  static constexpr int dws = 0;
  static constexpr int db1 = 3 * H;
  static constexpr int dw2 = 4 * H;
  static constexpr int db2 = 4 * H + H * H;
  static constexpr int dw3 = 5 * H + H * H;
  static constexpr int db3 = 5 * H + H * H + H * HX;
  static constexpr int dw4 = 5 * H + H * H + H * HX + HX;
  static constexpr int total = 5 * H + H * H + H * HX + 2 * HX;
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

// acc[r][c] += sum_e A[e, ty + 16r] * B[e, j] over the tile's edges for
// the columns j = tx + 16c < N of B (rows of LDA = H + 1): thread (ty,
// tx)'s share of the [H, N] weight gradient A^T B, N = H or the phi_x
// width HX
template <int H, int N>
__device__ __forceinline__ void tile_wgrad(const float* A, const float* B,
                                           float (&acc)[H / 16][(N + 15) / 16]) {
  constexpr int LDA = H + 1;
  constexpr int CPT = H / 16;
  constexpr int CPN = (N + 15) / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int e = 0; e < TE; ++e) {
    float a[CPT], b[CPN];
#pragma unroll
    for (int r = 0; r < CPT; ++r) a[r] = A[e * LDA + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < CPN; ++c) {
      const int j = tx + 16 * c;
      if constexpr (N % 16 == 0)
        b[c] = B[e * LDA + j];
      else
        b[c] = j < N ? B[e * LDA + j] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < CPT; ++r)
#pragma unroll
      for (int c = 0; c < CPN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <int H, int HX>
__global__ void __launch_bounds__(THREADS, 2)
fused_edge_bwd_kernel(const int* __restrict__ row_t,
                      const int* __restrict__ col_l,
                      const int* __restrict__ kblk,
                      const float* __restrict__ scal,
                      const float* __restrict__ x,
                      const float* __restrict__ hr,
                      const float* __restrict__ hc,
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
  constexpr int CPX = (HX + 15) / 16;   // phi_x columns of a thread
  using W = WOff<H, HX>;

  extern __shared__ float smem[];
  float* sW2 = smem;                 // [H, LDW]
  float* sW3 = sW2 + H * LDW;        // [H, LDW], columns j < HX
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
    sW2[k * LDW + j] = w2[i];
  }
  for (int i = tid; i < H * HX; i += THREADS) {
    const int k = i / HX, j = i % HX;
    sW3[k * LDW + j] = w3[i];
  }
  for (int i = tid; i < 3 * H; i += THREADS) sWs[i] = ws[i];
  for (int i = tid; i < H; i += THREADS) {
    sB1[i] = b1[i];
    sB2[i] = b2[i];
  }
  for (int i = tid; i < HX; i += THREADS) {
    sB3[i] = b3[i];
    sW4[i] = w4[i];
  }

  float acc_dw2[CPT][CPT], acc_dw3[CPT][CPX];
#pragma unroll
  for (int r = 0; r < CPT; ++r) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_dw2[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CPX; ++c) acc_dw3[r][c] = 0.f;
  }
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
          sf[0] = radial;
          sf[1] = scal[(size_t)e * XL + 0];
          sf[2] = scal[(size_t)e * XL + 1];
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
        const float hrc = hr[(size_t)row * H + j] + hc[(size_t)sCol[el] * H + j];
        const float sw =
            fmaf(sSf[3 * el + 2], sWs[2 * H + j],
                 fmaf(sSf[3 * el + 1], sWs[H + j], sSf[3 * el] * sWs[j]));
        t = dense_pre<false>(hrc + sw, sB1[j]);
      }
      sP[el * LDA + j] = t;
      sQ[el * LDA + j] = silu<false>(t);
    }
    __syncthreads();

    // ---- forward: t2 -> sR, ef = silu(t2) -> sS
    {
      float acc[4][CPT];
      tile_mm<H, H, LDA, LDW, false>(sQ, sW2, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int e = ty + 16 * r, j = tx + 16 * c;
          const float t = dense_pre<false>(acc[r][c], sB2[j]);
          sR[e * LDA + j] = t;
          sS[e * LDA + j] = silu<false>(t);
        }
    }
    __syncthreads();

    // ---- forward: t3 -> sQ (columns j < HX)
    {
      float acc[4][CPX];
      tile_mm<H, HX, LDA, LDW, false>(sS, sW3, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPX; ++c) {
          const int e = ty + 16 * r, j = tx + 16 * c;
          if (j < HX) sQ[e * LDA + j] = dense_pre<false>(acc[r][c], sB3[j]);
        }
    }
    __syncthreads();

    // ---- per edge: the gate g (summed as the forward sums it), d_g
    if (tid < TE) {
      float g = 0.f, dg = 0.f;
      if (sRow[tid] >= 0) {
        for (int j = 0; j < HX; ++j)
          g = __fadd_rn(g, __fmul_rn(silu<false>(sQ[tid * LDA + j]), sW4[j]));
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
    if (cj < HX) {
#pragma unroll 4
      for (int m = 0; m < EPG; ++m) {
        const int el = cg + G * m;
        const float t3 = sQ[el * LDA + cj];
        const float dg = sDg[el];
        const float d_y2 = __fmul_rn(dg, sW4[cj]);
        const float d_t3 = __fmul_rn(d_y2, dsilu<false>(t3));
        a_dw4 = fmaf(silu<false>(t3), dg, a_dw4);
        a_db3 += d_t3;
        sQ[el * LDA + cj] = d_t3;
      }
    }
    __syncthreads();

    // ---- dw3 += ef^T d_t3; d_ef = g_ef[row] + d_t3 w3^T;
    //      d_t2 = d_ef silu'(t2) in place in sR
    tile_wgrad<H, HX>(sS, sQ, acc_dw3);
    {
      float acc[4][CPT];
      tile_mm<HX, H, LDA, LDW, true>(sQ, sW3, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = ty + 16 * r;
        const int row = sRow[e];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int i = tx + 16 * c;
          const float up = row >= 0 ? gp[(size_t)row * F + 8 + i] : 0.f;
          const float d_ef = up + acc[r][c];
          const float t2 = sR[e * LDA + i];
          sR[e * LDA + i] = __fmul_rn(d_ef, dsilu<false>(t2));
        }
      }
    }
    __syncthreads();

    // ---- y1 = silu(t1) -> sS (recomputed); db2
#pragma unroll 4
    for (int m = 0; m < EPG; ++m) {
      const int el = cg + G * m;
      sS[el * LDA + cj] = silu<false>(sP[el * LDA + cj]);
      a_db2 += sR[el * LDA + cj];
    }
    __syncthreads();

    // ---- dw2 += y1^T d_t2; d_y1 = d_t2 w2^T; d_t1 = d_y1 silu'(t1) in sP
    tile_wgrad<H, H>(sS, sR, acc_dw2);
    {
      float acc[4][CPT];
      tile_mm<H, H, LDA, LDW, true>(sR, sW2, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int e = ty + 16 * r, i = tx + 16 * c;
          const float t1 = sP[e * LDA + i];
          sP[e * LDA + i] =
              __fmul_rn(acc[r][c], dsilu<false>(t1));
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
        const float d_radial = ds;
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
  for (int r = 0; r < CPT; ++r) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      pb[W::dw2 + i * H + j] = acc_dw2[r][c];
    }
#pragma unroll
    for (int c = 0; c < CPX; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      if (j < HX) pb[W::dw3 + i * HX + j] = acc_dw3[r][c];
    }
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
      if (q >= 5 && tid >= HX) continue;   // db3, dw4: HX columns
      float s = 0.f;
      for (int g = 0; g < G; ++g) s += red[(q * G + g) * H + tid];
      pb[off[q] + tid] = s;
    }
  }
}

// ------------------------------------------------ the bf16 tensor-core path
//
// The bf16 instantiation runs the six H x H tile products on the tensor
// cores (mma.sync m16n8k16, bf16 operands from shared memory through
// ldmatrix, f32 accumulation). Every operand of those products is already a
// bf16 value in _bwd_kernel's bf16 path (y1, ef, d_t3, d_t2 and the weights
// are rounded to bf16 before they are multiplied), so the per-edge tiles are
// held in bf16 and each product is exact term by term; only the f32
// summation order inside a product differs from the FMA path.

// The backward's shared-memory plan on top of the generic tile strides of
// fused_edge_tc.cuh
template <int H>
struct TcLayout : TcTiles<H> {
  using B = TcTiles<H>;
  static constexpr int NTILES = 7;        // s1, y1, t2, s2, ef, d_t3, y2
  // per edge and staging buffer: row, col; cd, sfeat, d_trans [3], d_g
  static constexpr int EDGE = EdgeBuf::kWords(true);
  // f32: ws [3H], b1, b2, b3, w4 [H]; per edge the two column halves'
  // partial sums of g and of d_radial
  static constexpr int F32 = 7 * H + TE * 4;
  // the ballots (4 + 2 words) and the row of each segment [TE]
  static constexpr size_t kBytes =
      (size_t)(2 * B::WT + B::PAY + NTILES * B::TILE) * 2 + (size_t)F32 * 4 +
      (size_t)2 * TE * EDGE * 4 + 6 * 4 + TE * 4;
  // the weight-gradient products' warp tiling: NTW n8 tiles of one m16
  // tile a warp, the K = TE edges split over KSPLIT warps
  static constexpr int NTW = H >= 32 ? 4 : 1;
  static constexpr int NUNITS = (H / 16) * (H / 8 / NTW);
  static constexpr int KSPLIT = 8 / NUNITS;
  static constexpr int KPW = (TE / 16) / KSPLIT;   // k16 steps a warp
};

// dw3 [H, HX]'s warp tiling at the phi_x width HX (at HX = H TcLayout's):
// NTW n8 tiles of one m16 tile a warp, the edges split over KSPLIT warps
// (at most TE / 16; the warps from KSPLIT x NUNITS on take no part)
template <int H, int HX>
struct TcWgradX {
  static constexpr int NTW = HX == H ? TcLayout<H>::NTW
                                     : (HX / 8 < 4 ? HX / 8 : 4);
  static constexpr int NUNITS = (H / 16) * (HX / 8 / NTW);
  static constexpr int KSPLIT = 8 / NUNITS < TE / 16 ? 8 / NUNITS : TE / 16;
  static constexpr int KPW = (TE / 16) / KSPLIT;
  static_assert(NTW == 1 || NTW % 2 == 0, "n8 tiles in pairs");
  static_assert(HX != H || (NTW == TcLayout<H>::NTW &&
                            KSPLIT == TcLayout<H>::KSPLIT),
                "HX = H keeps dw2's tiling");
};

template <int H, int HX>
__global__ void __launch_bounds__(THREADS, 2)
fused_edge_bwd_tc_kernel(const int* __restrict__ row_t,
                         const int* __restrict__ col_l,
                         const int* __restrict__ kblk,
                         const float* __restrict__ scal,
                         const float* __restrict__ x,
                         const __nv_bfloat16* __restrict__ hr,
                         const __nv_bfloat16* __restrict__ hc,
                         const float* __restrict__ ws,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ w3,
                         const float* __restrict__ b3,
                         const float* __restrict__ w4,
                         const float* __restrict__ gp,
                         float* __restrict__ out_row,
                         float* __restrict__ out_col,
                         float* __restrict__ part, int n_nodes, int n_edges,
                         int block) {
  using L = TcLayout<H>;
  constexpr int LDS = L::LDS;
  constexpr int F = H + 8;
  constexpr int G = THREADS / H;   // edge groups of the column passes
  constexpr int EPG = TE / G;      // edges of one group per tile
  constexpr int Q4 = 2 + H / 4;    // float4 lanes of one column-side payload
  constexpr int NTM = L::NTM;
  constexpr int NTW = L::NTW;
  using X = TcWgradX<H, HX>;
  // the phi_x products: n8 tiles a warp of t3 (column half HX / 2; at HX
  // = 8 the first half takes all 8) and k16 steps of d_t3 w3^T
  constexpr int NTX = HX >= 16 ? HX / 16 : 1;
  constexpr int KSX = (HX + 15) / 16;
  static_assert(THREADS == 256 && TE == 64, "8 warps over 64-edge tiles");
  static_assert(THREADS % H == 0 && TE % G == 0, "H must divide THREADS");
  static_assert(NTM == 1 || NTM % 2 == 0, "n8 tiles in pairs");
  static_assert(HX % 8 == 0 && H % HX == 0 && (NTX == 1 || NTX % 2 == 0),
                "HX in {H, H/2, H/4}, at least 8");
  static_assert((L::KSPLIT * H * H + X::KSPLIT * H * HX) + 7 * THREADS <=
                    (L::PAY + L::NTILES * L::TILE) / 2,
                "the end-of-block reductions fit in the tile buffers");
  static_assert(L::EDGE == 12, "EdgeBuf's layout");
  using W = WOff<H, HX>;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sW2 = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [k][j]
  __nv_bfloat16* sW3 = sW2 + L::WT;      // [k][j < HX]; 0 for HX <= j < 16
  __nv_bfloat16* tP = sW3 + L::WT;       // [TE, LDP] payload; t1, d_t1 at 8
  __nv_bfloat16* tS1 = tP + L::PAY;      // sigmoid(t1)
  __nv_bfloat16* tY1 = tS1 + L::TILE;    // y1, then the row side's one-hot
  __nv_bfloat16* tT2 = tY1 + L::TILE;    // t2, then d_t2
  __nv_bfloat16* tS2 = tT2 + L::TILE;    // sigmoid(t2)
  __nv_bfloat16* tEF = tS2 + L::TILE;    // ef
  __nv_bfloat16* tD3 = tEF + L::TILE;    // d_t3; 0 for HX <= j < 16
  __nv_bfloat16* tY2 = tD3 + L::TILE;    // y2 = silu(t3)
  // the next tile's hr[row] / hc[col] rows [TE, H], staged while this
  // tile's last phases run, in ef's and sigmoid(t2)'s tiles (dead by then;
  // the next tile rewrites them only after its t1 phase has read these)
  __nv_bfloat16* sHr = tEF;
  __nv_bfloat16* sHc = tS2;
  __nv_bfloat16* tT1 = tP + 8;           // t1 / d_t1 [TE, LDP] from column 8
  float* sWs = reinterpret_cast<float*>(tY2 + L::TILE);   // [3, H]
  float* sB1 = sWs + 3 * H;
  float* sB2 = sB1 + H;
  float* sB3 = sB2 + H;
  float* sW4 = sB3 + H;
  float* sGp = sW4 + H;        // [2, TE] the column halves' sums of g
  float* sRp = sGp + 2 * TE;   // [2, TE] ... of d_t1 . ws[0]
  // the two per-edge staging buffers (12 words an edge each), their
  // ballots, and the first edge of each row segment of the tile (two
  // 32-bit ballots)
  int* sEdge = reinterpret_cast<int*>(sRp + 2 * TE);
  unsigned* sAct = reinterpret_cast<unsigned*>(sEdge + 2 * L::EDGE * TE);
  unsigned* sStart = sAct + 4;
  int* sSegRow = reinterpret_cast<int*>(sStart + 2);   // [TE] segment -> row

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cj = tid % H, cg = tid / H;   // column passes: column, group
  // the main products: rows m0.., columns n0.. of the [TE, H] result
  const int m0 = 16 * (warp & 3), half = warp >> 2, n0 = half * (H / 2);
  // this thread's accumulator rows and the column of its first element
  const int er0 = m0 + (lane >> 2), er1 = er0 + 8;
  const int jc = n0 + 2 * (lane & 3);
  const int n0x = half * (HX / 2), jcx = n0x + 2 * (lane & 3);
  // the weight-gradient products: unit (m16 tile, NTW n8 tiles), k slice
  const int wu = warp % L::NUNITS, wk = warp / L::NUNITS;
  const int wm0 = 16 * (wu % (H / 16)), wn0 = 8 * NTW * (wu / (H / 16));
  // ... and dw3's
  const int xu = warp % X::NUNITS, xk = warp / X::NUNITS;
  const int xm0 = 16 * (xu % (H / 16)), xn0 = 8 * X::NTW * (xu / (H / 16));

  for (int i = tid; i < H * H; i += THREADS) {
    const int k = i / H, j = i % H;
    sW2[k * LDS + j] = __float2bfloat16_rn(w2[i]);
  }
  for (int i = tid; i < H * HX; i += THREADS) {
    const int k = i / HX, j = i % HX;
    sW3[k * LDS + j] = __float2bfloat16_rn(w3[i]);
  }
  if constexpr (HX < 16) {
    // d_t3 w3^T takes whole k16 steps: the lanes HX..15 of w3's rows and
    // of d_t3's rows are zero
    for (int i = tid; i < H * (16 - HX); i += THREADS)
      sW3[(i / (16 - HX)) * LDS + HX + i % (16 - HX)] =
          __float2bfloat16_rn(0.f);
    for (int i = tid; i < TE * (16 - HX); i += THREADS)
      tD3[(i / (16 - HX)) * LDS + HX + i % (16 - HX)] =
          __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < 3 * H; i += THREADS) sWs[i] = round_bf16(ws[i]);
  for (int i = tid; i < H; i += THREADS) {
    sB1[i] = round_bf16(b1[i]);
    sB2[i] = round_bf16(b2[i]);
  }
  for (int i = tid; i < HX; i += THREADS) {
    sB3[i] = round_bf16(b3[i]);
    sW4[i] = w4[i];
  }

  float acc_dw2[NTW][4], acc_dw3[X::NTW][4];
#pragma unroll
  for (int t = 0; t < NTW; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dw2[t][c] = 0.f;
#pragma unroll
  for (int t = 0; t < X::NTW; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dw3[t][c] = 0.f;
  float a_db1 = 0.f, a_db2 = 0.f, a_db3 = 0.f, a_dw4 = 0.f;
  float a_dws0 = 0.f, a_dws1 = 0.f, a_dws2 = 0.f;

  const int T = block;
  const int nb = n_nodes / T;
  const int epb = n_edges / nb;
  const int smax = nb - 3 > 0 ? nb - 3 : 0;
  const int n_tiles = (n_edges + TE - 1) / TE;

  if (tid < TE)
    tc_stage_edges<H, true>(EdgeBuf(sEdge, sAct), sHr, sHc, blockIdx.x, tid,
                            row_t, col_l, kblk, scal, x, hr, hc, gp, n_edges,
                            T, epb, smax);
  cp_async_wait_all();

  int cur = 0;
  for (int tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, cur ^= 1) {
    __syncthreads();  // this tile staged, the previous one fully consumed
    const EdgeBuf E(sEdge + cur * L::EDGE * TE, sAct + 2 * cur);
    const EdgeBuf next(sEdge + (cur ^ 1) * L::EDGE * TE,
                       sAct + 2 * (cur ^ 1));
    if (!(E.act[0] | E.act[1])) {   // all-padding tile
      if (tid < TE)
        tc_stage_edges<H, true>(next, sHr, sHc, tile + gridDim.x, tid, row_t,
                                col_l, kblk, scal, x, hr, hc, gp, n_edges, T,
                                epb, smax);
      cp_async_wait_all();
      continue;
    }

    // ---- forward: t1, sigmoid(t1), y1 (eight columns a thread per item)
    for (int i = tid; i < TE * (H / 8); i += THREADS) {
      const int el = i / (H / 8), j0 = 8 * (i % (H / 8));
      float t[8], s[8], y[8];
      if (E.row[el] >= 0) {
        const uint4 ur = *reinterpret_cast<const uint4*>(sHr + el * H + j0);
        const uint4 uc = *reinterpret_cast<const uint4*>(sHc + el * H + j0);
        const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&ur);
        const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&uc);
        const float f0 = E.sf[3 * el], f1 = E.sf[3 * el + 1],
                    f2 = E.sf[3 * el + 2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 a = __bfloat1622float2(pr[q]);
          const float2 c = __bfloat1622float2(pc[q]);
          const float hv[2] = {a.x + c.x, a.y + c.y};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = j0 + 2 * q + u;
            const float hrc = round_bf16(hv[u]);
            const float sw = round_bf16(
                fmaf(f2, sWs[2 * H + j], fmaf(f1, sWs[H + j], f0 * sWs[j])));
            t[2 * q + u] = dense_pre<true>(hrc + sw, sB1[j]);
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) t[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        s[q] = sig_bf16(t[q]);
        y[q] = silu_s(t[q], s[q]);
      }
      // one 16-byte store per tile row piece (a quarter warp writes one
      // 128-byte row: no bank conflict)
      uint4 pt, ps, py;
      __nv_bfloat162* qt = reinterpret_cast<__nv_bfloat162*>(&pt);
      __nv_bfloat162* qs = reinterpret_cast<__nv_bfloat162*>(&ps);
      __nv_bfloat162* qy = reinterpret_cast<__nv_bfloat162*>(&py);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        qt[q] = __floats2bfloat162_rn(t[2 * q], t[2 * q + 1]);
        qs[q] = __floats2bfloat162_rn(s[2 * q], s[2 * q + 1]);
        qy[q] = __floats2bfloat162_rn(y[2 * q], y[2 * q + 1]);
      }
      const int o = el * LDS + j0;
      *reinterpret_cast<uint4*>(tT1 + el * L::LDP + j0) = pt;
      *reinterpret_cast<uint4*>(tS1 + o) = ps;
      *reinterpret_cast<uint4*>(tY1 + o) = py;
    }
    __syncthreads();

    // ---- forward: t2 = y1 w2 + b2 -> t2, sigmoid(t2), ef
    {
      float acc[NTM][4] = {};
      warp_mm<LDS, LDS, NTM, false, true>(tY1, sW2, m0, n0, 0, H / 16, acc);
#pragma unroll
      for (int t = 0; t < NTM; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = h ? er1 : er0, j = jc + 8 * t;
          const float t0 = dense_pre<true>(acc[t][2 * h], sB2[j]);
          const float t1 = dense_pre<true>(acc[t][2 * h + 1], sB2[j + 1]);
          const float s0 = sig_bf16(t0), s1 = sig_bf16(t1);
          st2(tT2 + e * LDS + j, t0, t1);
          st2(tS2 + e * LDS + j, s0, s1);
          st2(tEF + e * LDS + j, silu_s(t0, s0), silu_s(t1, s1));
        }
    }
    __syncthreads();

    // ---- forward: t3 = ef w3 + b3; y2 = silu(t3), the gate's partial sums;
    //      d_y2 = d_g w4, d_t3 = d_y2 silu'(t3)
    {
      float gsum[2] = {0.f, 0.f};
      if (HX >= 16 || half == 0) {
        float acc[NTX][4] = {};
        warp_mm<LDS, LDS, NTX, false, true>(tEF, sW3, m0, n0x, 0, H / 16,
                                            acc);
        const float dg[2] = {E.dg[er0], E.dg[er1]};
#pragma unroll
        for (int t = 0; t < NTX; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = h ? er1 : er0, j = jcx + 8 * t;
            float y[2], d[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float t3 =
                  dense_pre<true>(acc[t][2 * h + u], sB3[j + u]);
              const float s3 = sig_bf16(t3);
              y[u] = silu_s(t3, s3);
              gsum[h] = __fadd_rn(gsum[h], __fmul_rn(y[u], sW4[j + u]));
              const float d_y2 = round_bf16(__fmul_rn(dg[h], sW4[j + u]));
              d[u] = round_bf16(__fmul_rn(d_y2, dsilu_s(t3, s3)));
            }
            st2(tY2 + e * LDS + j, y[0], y[1]);
            st2(tD3 + e * LDS + j, d[0], d[1]);
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        gsum[h] += __shfl_xor_sync(0xffffffffu, gsum[h], 1);
        gsum[h] += __shfl_xor_sync(0xffffffffu, gsum[h], 2);
      }
      if ((lane & 3) == 0) {
        sGp[half * TE + er0] = gsum[0];
        sGp[half * TE + er1] = gsum[1];
      }
    }
    __syncthreads();

    // ---- dw3 += ef^T d_t3; d_ef = g_ef[row] + d_t3 w3^T;
    //      d_t2 = d_ef silu'(t2) in place of t2
    if (xk < X::KSPLIT)
      warp_mm<LDS, LDS, X::NTW, true, true>(tEF, tD3, xm0, xn0, xk * X::KPW,
                                            X::KPW, acc_dw3);
    {
      float acc[NTM][4] = {};
      warp_mm<LDS, LDS, NTM, false, false>(tD3, sW3, m0, n0, 0, KSX, acc);
      const int rows[2] = {E.row[er0], E.row[er1]};
#pragma unroll
      for (int t = 0; t < NTM; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = h ? er1 : er0, i = jc + 8 * t;
          const float2 up =
              rows[h] >= 0
                  ? *reinterpret_cast<const float2*>(gp + (size_t)rows[h] * F +
                                                     8 + i)
                  : make_float2(0.f, 0.f);
          const float2 t2 = ld2(tT2 + e * LDS + i);
          const float2 s2 = ld2(tS2 + e * LDS + i);
          const float d0 = round_bf16(round_bf16(up.x) +
                                      round_bf16(acc[t][2 * h]));
          const float d1 = round_bf16(round_bf16(up.y) +
                                      round_bf16(acc[t][2 * h + 1]));
          st2(tT2 + e * LDS + i, __fmul_rn(d0, dsilu_s(t2.x, s2.x)),
              __fmul_rn(d1, dsilu_s(t2.y, s2.y)));
        }
    }
    __syncthreads();

    // ---- dw2 += y1^T d_t2; d_t1 = (d_t2 w2^T) silu'(t1) in place of t1;
    //      the partial sums of d_radial = d_t1 . ws[0]
    warp_mm<LDS, LDS, NTW, true, true>(tY1, tT2, wm0, wn0, wk * L::KPW, L::KPW,
                                  acc_dw2);
    {
      float acc[NTM][4] = {};
      warp_mm<LDS, LDS, NTM, false, false>(tT2, sW2, m0, n0, 0, H / 16, acc);
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < NTM; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = h ? er1 : er0, i = jc + 8 * t;
          const float2 t1 = ld2(tT1 + e * L::LDP + i);
          const float2 s1 = ld2(tS1 + e * LDS + i);
          const float d0 = round_bf16(
              __fmul_rn(round_bf16(acc[t][2 * h]), dsilu_s(t1.x, s1.x)));
          const float d1 = round_bf16(
              __fmul_rn(round_bf16(acc[t][2 * h + 1]), dsilu_s(t1.y, s1.y)));
          rsum[h] = fmaf(d1, sWs[i + 1], fmaf(d0, sWs[i], rsum[h]));
          st2(tT1 + e * L::LDP + i, d0, d1);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
      }
      if ((lane & 3) == 0) {
        sRp[half * TE + er0] = rsum[0];
        sRp[half * TE + er1] = rsum[1];
      }
    }
    __syncthreads();

    // ---- per edge: g, d_radial, d_cd; whether the edge starts a row
    //      segment (its row differs from the previous active edge's)
    if (tid < TE) {
      float dcd[3] = {0.f, 0.f, 0.f};
      const int row = E.row[tid];
      tc_mark_segment_starts(E, sStart);
      if (row >= 0) {
        const float g = sGp[tid] + sGp[TE + tid];
        const float d_radial = round_bf16(sRp[tid] + sRp[TE + tid]);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          dcd[k] = __fadd_rn(
              __fmul_rn(__fmul_rn(2.0f, E.cd[3 * tid + k]), d_radial),
              __fmul_rn(E.dt[3 * tid + k], g));
      }
      // the payload's first 8 lanes: [hi(d_cd), lo(d_cd), 0, 0]
      float hl[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        hl[k] = round_bf16(dcd[k]);
        hl[3 + k] = round_bf16(dcd[k] - hl[k]);
      }
      uint4 ph;
      __nv_bfloat162* qh = reinterpret_cast<__nv_bfloat162*>(&ph);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        qh[q] = __floats2bfloat162_rn(hl[2 * q], hl[2 * q + 1]);
      *reinterpret_cast<uint4*>(tP + tid * L::LDP) = ph;
    }
    __syncthreads();

    // ---- warps 0-1 stage the next tile (its global loads overlap the rest
    //      of this one)
    if (tid < TE)
      tc_stage_edges<H, true>(next, sHr, sHc, tile + gridDim.x, tid, row_t,
                              col_l, kblk, scal, x, hr, hc, gp, n_edges, T,
                              epb, smax);

    // ---- the column sums of the tile: db1, dws, db2, db3, dw4
#pragma unroll 4
    for (int m = 0; m < EPG; ++m) {
      const int el = cg + G * m;
      const int o = el * LDS + cj;
      const float d1 = __bfloat162float(tT1[el * L::LDP + cj]);
      a_db1 += d1;
      a_dws0 = fmaf(E.sf[3 * el + 0], d1, a_dws0);
      a_dws1 = fmaf(E.sf[3 * el + 1], d1, a_dws1);
      a_dws2 = fmaf(E.sf[3 * el + 2], d1, a_dws2);
      a_db2 += __bfloat162float(tT2[o]);
      if (cj < HX) {
        a_db3 += __bfloat162float(tD3[o]);
        a_dw4 = fmaf(__bfloat162float(tY2[o]), E.dg[el], a_dw4);
      }
    }

    // ---- row side: the payload [hi(d_cd), lo(d_cd), 0, 0, d_t1] summed
    //      by row segment as a tensor-core product, onehot[segment, edge]
    //      (exact 0/1, inactive edges 0) x payload[edge, F], 16 segments
    //      at a time, f32 accumulation; one f32 atomic per (segment,
    //      column), as the FMA kernel's walk adds one per segment end
    tc_row_side<H, false>(E, sStart, sSegRow, tY1, tP, out_row);

    // ---- column side: [hi(-d_cd), lo(-d_cd), 0, 0, d_t1] at col, one
    //      float4 atomic per 4 lanes (order-dependent f32 sums)
    for (int i = tid; i < TE * Q4; i += THREADS) {
      const int el = i / Q4, q = i % Q4;
      if (E.row[el] < 0) continue;
      const __nv_bfloat16* p = tP + el * L::LDP + 4 * q;
      const float2 a = ld2(p), b = ld2(p + 2);
      // lanes 0-5 are the row side's hi / lo negated, 6-7 zero
      const float4 v = q == 0   ? make_float4(-a.x, -a.y, -b.x, -b.y)
                       : q == 1 ? make_float4(-a.x, -a.y, 0.f, 0.f)
                                : make_float4(a.x, a.y, b.x, b.y);
      red_add4(out_col + (size_t)E.col[el] * F + 4 * q, v);
    }
    cp_async_wait_all();   // the next tile's rows have landed
  }

  // ---- this block's weight-gradient partial: the k slices' fragments
  //      summed in slice order, then the column accumulators over groups
  __syncthreads();  // the tile buffers are free
  float* red = reinterpret_cast<float*>(tP);     // [KSPLIT, H, H] dw2
  float* red3 = red + L::KSPLIT * H * H;         // [X::KSPLIT, H, HX] dw3
  float* redc = red3 + X::KSPLIT * H * HX;       // [7, G, H]
#pragma unroll
  for (int t = 0; t < NTW; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = wm0 + (lane >> 2) + 8 * (c >> 1);
      const int j = wn0 + 8 * t + 2 * (lane & 3) + (c & 1);
      red[wk * H * H + i * H + j] = acc_dw2[t][c];
    }
  if (xk < X::KSPLIT) {
#pragma unroll
    for (int t = 0; t < X::NTW; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = xm0 + (lane >> 2) + 8 * (c >> 1);
        const int j = xn0 + 8 * t + 2 * (lane & 3) + (c & 1);
        red3[xk * H * HX + i * HX + j] = acc_dw3[t][c];
      }
  }
  const float vals[7] = {a_dws0, a_dws1, a_dws2, a_db1, a_db2, a_db3, a_dw4};
#pragma unroll
  for (int q = 0; q < 7; ++q) redc[(q * G + cg) * H + cj] = vals[q];
  __syncthreads();
  float* pb = part + (size_t)blockIdx.x * W::total;
  for (int i = tid; i < H * H; i += THREADS) {
    float s2 = 0.f;
    for (int k = 0; k < L::KSPLIT; ++k) s2 += red[k * H * H + i];
    pb[W::dw2 + i] = s2;
  }
  for (int i = tid; i < H * HX; i += THREADS) {
    float s3 = 0.f;
    for (int k = 0; k < X::KSPLIT; ++k) s3 += red3[k * H * HX + i];
    pb[W::dw3 + i] = s3;
  }
  if (tid < H) {
    const int off[7] = {W::dws, W::dws + H, W::dws + 2 * H, W::db1,
                        W::db2, W::db3,     W::dw4};
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      if (q >= 5 && tid >= HX) continue;   // db3, dw4: HX columns
      float s = 0.f;
      for (int g = 0; g < G; ++g) s += redc[(q * G + g) * H + tid];
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

// The kernel a launch of (H, bf16) runs, its dynamic shared memory and how
// many of its blocks an SM holds (0: the launch would be refused). bf16 runs
// the tensor-core kernel, f32 the FMA kernel (tensor cores would round f32
// operands to TF32).
template <bool BF16>
using BwdKernel = void (*)(const int*, const int*, const int*, const float*,
                           const float*,
                           const std::conditional_t<BF16, __nv_bfloat16,
                                                    float>*,
                           const std::conditional_t<BF16, __nv_bfloat16,
                                                    float>*,
                           const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, const float*, float*, float*, float*,
                           int, int, int);

template <bool BF16>
struct Pick {
  BwdKernel<BF16> kern;
  size_t smem;
  int per_sm;
};

template <int H, bool BF16, int HX>
cudaError_t pick_uncached(Pick<BF16>& p) {
  if constexpr (BF16) {
    p.kern = fused_edge_bwd_tc_kernel<H, HX>;
    p.smem = TcLayout<H>::kBytes;
  } else {
    p.kern = fused_edge_bwd_kernel<H, HX>;
    p.smem = smem_bytes<H>();
  }
  cudaError_t err = cudaFuncSetAttribute(
      p.kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  p.per_sm = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, p.kern,
                                                       THREADS, p.smem);
}

// pick_uncached once per device: the attribute and the occupancy query cost
// host time per launch
template <int H, bool BF16, int HX>
cudaError_t pick(Pick<BF16>& p) {
  constexpr int kDevices = 64;
  static Pick<BF16> cache[kDevices];
  static bool ready[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return pick_uncached<H, BF16, HX>(p);
  if (!ready[dev]) {
    err = pick_uncached<H, BF16, HX>(cache[dev]);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  p = cache[dev];
  return cudaSuccess;
}

// persistent blocks: every resident block, at most one per tile
inline int grid_of(int per_sm, int n_sm, int n_edges) {
  const int n_tiles = (n_edges + TE - 1) / TE;
  const int grid = per_sm * n_sm;
  return grid < n_tiles ? grid : n_tiles;
}

template <int H, bool BF16, int HX>
cudaError_t grid_for(int n_sm, int n_edges, int* grid) {
  Pick<BF16> p;
  cudaError_t err = pick<H, BF16, HX>(p);
  if (err != cudaSuccess) return err;
  if (p.per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = grid_of(p.per_sm, n_sm, n_edges);
  return cudaSuccess;
}

template <int H, bool BF16, int HX>
cudaError_t launch(const void* row_t, const void* col_l, const void* kblk,
                   const void* scal, const void* x, const void* hr,
                   const void* hc, const void* ws, const void* b1,
                   const void* w2, const void* b2, const void* w3,
                   const void* b3, const void* w4, const void* gp,
                   void* out_row, void* out_col, void* part, void* dw,
                   int n_nodes, int n_edges, int block, int n_sm,
                   int max_grid, cudaStream_t stream) {
  using Act = std::conditional_t<BF16, __nv_bfloat16, float>;
  Pick<BF16> p;
  cudaError_t err = pick<H, BF16, HX>(p);
  if (err != cudaSuccess) return err;
  if (p.per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = grid_of(p.per_sm, n_sm, n_edges);
  // part holds max_grid partials (fused_edge_bwd_grid sizes it)
  if (grid > max_grid) return cudaErrorInvalidValue;
  if (grid >= 1) {
    p.kern<<<grid, THREADS, p.smem, stream>>>(
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
  constexpr int total = WOff<H, HX>::total;
  reduce_partials<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw),
      grid > 0 ? grid : 0, total);
  return cudaGetLastError();
}

}  // namespace

#define BWD_WIDTHS(CASE) \
  CASE(16, 16)           \
  CASE(16, 8)            \
  CASE(32, 32)           \
  CASE(32, 16)           \
  CASE(32, 8)            \
  CASE(64, 64)           \
  CASE(64, 32)           \
  CASE(64, 16)

// The grid a launch of (H, HX, bf16) over n_edges edge slots on n_sm SMs
// uses, into *grid: the wrapper sizes the weight-gradient partials with it.
// Returns the cudaError_t of the occupancy query; cudaErrorInvalidConfiguration
// when no block of the kernel fits on an SM, cudaErrorInvalidValue for an
// (H, HX) the kernels do not take.
extern "C" int fused_edge_bwd_grid(int H, int HX, int bf16, int n_sm,
                                   int n_edges, int* grid) {
#define GRID_CASE(HH, XX)                                          \
  if (H == HH && HX == XX)                                         \
    return bf16 ? (int)grid_for<HH, true, XX>(n_sm, n_edges, grid) \
                : (int)grid_for<HH, false, XX>(n_sm, n_edges, grid);
  BWD_WIDTHS(GRID_CASE)
  return (int)cudaErrorInvalidValue;
#undef GRID_CASE
}

// Returns the cudaError_t of the launches (0 = success). gp [N, H+8] f32 is
// the packed cotangent; out_row/out_col [N, H+8] f32 must be zeroed by the
// caller; part is scratch for max_grid >= fused_edge_bwd_grid's
// weight-gradient partials of 5H + H^2 + H*HX + 2HX floats each; dw (as many
// f32) receives the reduced weight gradients. hr/hc are f32 (bf16 == 0) or
// bf16 (bf16 == 1). H in {16, 32, 64}, HX in {H, H/2, H/4} and at least 8.
extern "C" int fused_edge_bwd(const void* row_t, const void* col_l,
                              const void* kblk, const void* scal,
                              const void* x, const void* hr, const void* hc,
                              const void* ws, const void* b1, const void* w2,
                              const void* b2, const void* w3, const void* b3,
                              const void* w4, const void* gp, void* out_row,
                              void* out_col, void* part, void* dw,
                              int n_nodes, int n_edges, int block, int H,
                              int HX, int bf16, int n_sm, int max_grid,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEG_CASE(HH, XX)                                                     \
  if (H == HH && HX == XX)                                                   \
    return bf16 ? (int)launch<HH, true, XX>(row_t, col_l, kblk, scal, x, hr, \
                                            hc, ws, b1, w2, b2, w3, b3, w4,  \
                                            gp, out_row, out_col, part, dw,  \
                                            n_nodes, n_edges, block, n_sm,   \
                                            max_grid, s)                     \
                : (int)launch<HH, false, XX>(row_t, col_l, kblk, scal, x,    \
                                             hr, hc, ws, b1, w2, b2, w3, b3, \
                                             w4, gp, out_row, out_col, part, \
                                             dw, n_nodes, n_edges, block,    \
                                             n_sm, max_grid, s);
  BWD_WIDTHS(DEG_CASE)
  return (int)cudaErrorInvalidValue;
#undef DEG_CASE
}
#undef BWD_WIDTHS
