// fused_edge_tc.cuh — the tensor-core building blocks of the fused edge
// pass's bf16 kernels: the forward fused_edge_fwd_tc_kernel
// (fused_edge_fwd.cu) and the backward fused_edge_bwd_tc_kernel
// (fused_edge_bwd.cu) include this one copy.
//
// Both hold a tile of TE = 64 receiver-sorted edges as bf16 rows in shared
// memory and run its H x H products as mma.sync m16n8k16 (bf16 operands read
// by ldmatrix, f32 accumulation). Every operand is a bf16 value in the TPU
// kernels' bf16 path, so each product term is exact and only the f32
// summation order inside a product differs from the FMA tile of
// fused_edge_common.cuh. Here:
//  - TcTiles: the tile and weight strides,
//  - cp_async16 / ldsm_x4 / ldsm_x2 / mma_bf16 / warp_mm: the data movement
//    and the warp-level product,
//  - sig_bf16 / silu_s / dsilu_s: silu and silu' from one rounded sigmoid,
//  - EdgeBuf / EdgeFetch / tc_stage_edges: a tile's per-edge data staged
//    into one of two buffers, its hr[row] / hc[col] rows by cp.async,
//  - tc_mark_segment_starts / tc_row_side: the row segment sums of a bf16
//    payload tile as a one-hot tensor-core product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "fused_edge_common.cuh"

namespace fused_edge {

// bf16 tile rows: H + 8 elements (16 bytes of padding), so the eight
// 16-byte rows one ldmatrix phase reads fall into distinct bank groups
template <int H>
struct TcTiles {
  static constexpr int LDS = H + 8;
  static constexpr int TILE = TE * LDS;   // bf16 elements of one edge tile
  static constexpr int WT = H * LDS;      // bf16 elements of one weight
  // the row-side payload tile [TE, F]: eight lanes of per-edge scalars,
  // then H lanes from column 8, rows of H + 24 (an odd number of 16-byte
  // units)
  static constexpr int LDP = H + 24;
  static constexpr int PAY = TE * LDP;
  // the row side's one-hot [16 segments, TE edges]
  static constexpr int LDO = TE + 8;
  // the main products: warp w takes the m16 tile w % 4 and the column half
  // w / 4, NTM n8 tiles
  static constexpr int NTM = H / 16;
  static_assert(16 * LDO <= TILE, "the one-hot fits in a tile");
  static_assert(TE * H <= TILE, "a staged hr / hc tile fits in a tile");
};

// One staging buffer of a tile's per-edge data (two alternate: a tile's is
// loaded while the one before it finishes). The forward's buffers hold the
// first kWords(false) = 8 words an edge (row, col, cd, sf), the backward's
// all kWords(true) = 12 (and d_trans, d_g).
struct EdgeBuf {
  int* row;      // [TE], -1 = inactive
  int* col;      // [TE]
  float* cd;     // [TE, 3] x[row] - x[col] (f32)
  float* sf;     // [TE, 3] sfeat = [radial, a0, a1], bf16 values
  float* dt;     // [TE, 3] d_trans = gp[row, 0:3] (backward)
  float* dg;     // [TE] d_g = cd . d_trans (backward)
  unsigned* act; // [2] ballots of the active edges (0-31, 32-63)
  static constexpr int kWords(bool gp) { return gp ? 12 : 8; }
  // the buffer's words per edge from p, its ballots at a
  __device__ EdgeBuf(int* p, unsigned* a)
      : row(p),
        col(p + TE),
        cd(reinterpret_cast<float*>(p + 2 * TE)),
        sf(cd + 3 * TE),
        dt(cd + 6 * TE),
        dg(cd + 9 * TE),
        act(a) {}
};

// 16 bytes global -> shared without a register round trip; wait_all
// completes every copy this thread issued
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four (x4) or two (x2) 8x8 b16 matrices from shared memory; with T the
// transposed matrices
template <bool T>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (T) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  }
}

template <bool T>
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  if constexpr (T) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
                 : "=r"(r0), "=r"(r1)
                 : "r"(smem_addr(p))
                 : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
                 : "=r"(r0), "=r"(r1)
                 : "r"(smem_addr(p))
                 : "memory");
  }
}

// d += a b: one m16n8k16 product, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B operand [K, N] of a product, as a bf16 matrix in shared memory with
// row stride LDB: KN stored as B[k][n] (read transposed by ldmatrix), or
// not KN: stored as its transpose, Bt[n][k].
// acc[t] (t < NT n8 tiles from column n0) += A[m0:m0+16, :K] B[:K, n0 + 8t]
// where A (row stride LDA) is stored as A[m][k] (AT = false) or as
// A^T[k][m] (AT = true); k runs over the k16 steps [ks0, ks0 + KS).
template <int LDA, int LDB, int NT, bool AT, bool KN>
__device__ __forceinline__ void warp_mm(const __nv_bfloat16* A,
                                        const __nv_bfloat16* B, int m0,
                                        int n0, int ks0, int KS,
                                        float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31;
  for (int ks = ks0; ks < ks0 + KS; ++ks) {
    const int k0 = 16 * ks;
    uint32_t a[4];
    if constexpr (AT) {
      ldsm_x4<true>(a, A + (k0 + (lane & 7) + (lane >> 4) * 8) * LDA + m0 +
                           ((lane >> 3) & 1) * 8);
    } else {
      ldsm_x4<false>(a, A + (m0 + (lane & 15)) * LDA + k0 + (lane >> 4) * 8);
    }
    if constexpr (NT == 1) {
      uint32_t b0, b1;
      if constexpr (KN) {
        ldsm_x2<true>(b0, b1, B + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      LDB + n0);
      } else {
        ldsm_x2<false>(b0, b1, B + (n0 + (lane & 7)) * LDB + k0 +
                                   ((lane >> 3) & 1) * 8);
      }
      mma_bf16(acc[0], a, b0, b1);
    } else {
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        uint32_t b[4];
        if constexpr (KN) {
          ldsm_x4<true>(b, B + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LDB + n0 + 8 * t + (lane >> 4) * 8);
        } else {
          ldsm_x4<false>(b, B + (n0 + 8 * t + (lane & 7) + (lane >> 4) * 8) *
                                    LDB + k0 + ((lane >> 3) & 1) * 8);
        }
        mma_bf16(acc[t], a, b[0], b[1]);
        mma_bf16(acc[t + 1], a, b[2], b[3]);
      }
    }
  }
}

// the sigmoid of silu / dsilu, rounded to bf16 (computed once per element
// and kept: silu and silu' of the same t share it)
__device__ __forceinline__ float sig_bf16(float t) {
  return round_bf16(1.0f / (1.0f + expf(-t)));
}

// silu(t) and silu'(t) from t and its rounded sigmoid s, with the roundings
// of fused_edge_common.cuh's silu<true> / dsilu<true>
__device__ __forceinline__ float silu_s(float t, float s) {
  return round_bf16(t * s);
}

__device__ __forceinline__ float dsilu_s(float t, float s) {
  const float a = round_bf16(__fsub_rn(1.0f, s));
  const float b = round_bf16(__fmul_rn(t, a));
  const float c = round_bf16(__fadd_rn(1.0f, b));
  return round_bf16(__fmul_rn(s, c));
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Staging one tile's edges, in three steps that a kernel may spread over a
// tile's phases so that their global loads overlap its work (the forward
// does), or run back to back (tc_stage_edges). One thread an edge slot el
// (0..63), in two whole warps.
struct EdgeFetch {
  int e = 0, rl = 0, kb = 0, cl = 0;   // the slot's raw layout fields
  float m = 0.f, a0 = 0.f, a1 = 0.f;
  int row = -1, col = 0;
  float xr[3] = {0.f, 0.f, 0.f}, xc[3] = {0.f, 0.f, 0.f};
};

// 1. the slot's layout fields (row_t, col_l, kblk, scal), loads issued
__device__ __forceinline__ void tc_fetch_fields(
    EdgeFetch& f, int tile, int el, const int* __restrict__ row_t,
    const int* __restrict__ col_l, const int* __restrict__ kblk,
    const float* __restrict__ scal, int n_edges) {
  f.e = tile * TE + el;
  if (f.e < n_edges) {
    f.m = scal[(size_t)f.e * XL + 2];
    f.rl = row_t[f.e];
    f.kb = kblk[f.e];
    f.cl = col_l[f.e];
    f.a0 = scal[(size_t)f.e * XL + 0];
    f.a1 = scal[(size_t)f.e * XL + 1];
  }
}

// 2. global (row, col) as _global_edges rebuilds them (the window start
// clip(b-1, 0, nb-3)); an edge is active iff scal[e, 2] is set. Its
// hr[row] / hc[col] rows go to the staging tiles by cp.async (completed by
// cp_async_wait_all before the next __syncthreads), x[row] / x[col] to
// registers.
template <int H>
__device__ __forceinline__ void tc_fetch_rows(
    EdgeFetch& f, int el, __nv_bfloat16* sHr, __nv_bfloat16* sHc,
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ hr,
    const __nv_bfloat16* __restrict__ hc, int n_edges, int T, int epb,
    int smax) {
  f.row = -1;
  f.col = 0;
  if (f.e < n_edges && f.m > 0.f && f.rl < T) {
    const int bl = f.e / epb;
    const int s = min(max(bl - 1, 0), smax);
    f.row = bl * T + f.rl;
    f.col = (s + f.kb) * T + f.cl;
#pragma unroll
    for (int q = 0; q < H / 8; ++q) {
      cp_async16(sHr + el * H + 8 * q, hr + (size_t)f.row * H + 8 * q);
      cp_async16(sHc + el * H + 8 * q, hc + (size_t)f.col * H + 8 * q);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f.xr[k] = x[3 * (size_t)f.row + k];
      f.xc[k] = x[3 * (size_t)f.col + k];
    }
  }
}

// 3. the slot into buffer b as the FMA tile's setup computes it: cd, sfeat
// = [radial, a0, a1] rounded to bf16, and the buffer's active ballot; with
// GP (the backward) also d_trans = gp[row, 0:3] and d_g = cd . d_trans
template <int H, bool GP>
__device__ __forceinline__ void tc_store_edge(const EdgeBuf& b,
                                              const EdgeFetch& f, int el,
                                              const float* __restrict__ gp) {
  constexpr int F = H + 8;
  float cd[3] = {0.f, 0.f, 0.f}, sf[3] = {0.f, 0.f, 0.f};
  float dt[3] = {0.f, 0.f, 0.f};
  float dg = 0.f;
  if (f.row >= 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cd[k] = f.xr[k] - f.xc[k];
      if constexpr (GP) dt[k] = gp[(size_t)f.row * F + k];
    }
    // no FMA contraction: |cd|^2 and d_g rounded as the FMA tile sums
    const float radial = __fadd_rn(
        __fadd_rn(__fmul_rn(cd[0], cd[0]), __fmul_rn(cd[1], cd[1])),
        __fmul_rn(cd[2], cd[2]));
    sf[0] = round_bf16(radial);
    sf[1] = round_bf16(f.a0);
    sf[2] = round_bf16(f.a1);
    if constexpr (GP)
      dg = __fadd_rn(__fadd_rn(__fmul_rn(cd[0], dt[0]),
                               __fmul_rn(cd[1], dt[1])),
                     __fmul_rn(cd[2], dt[2]));
  }
  b.row[el] = f.row;
  b.col[el] = f.col;
  if constexpr (GP) b.dg[el] = dg;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b.cd[3 * el + k] = cd[k];
    b.sf[3 * el + k] = sf[k];
    if constexpr (GP) b.dt[3 * el + k] = dt[k];
  }
  const unsigned am = __ballot_sync(0xffffffffu, f.row >= 0);
  if ((el & 31) == 0) b.act[el >> 5] = am;
}

// The three steps back to back: tile `tile`'s edges into buffer b and their
// hr / hc rows into the staging tiles
template <int H, bool GP>
__device__ __forceinline__ void tc_stage_edges(
    const EdgeBuf& b, __nv_bfloat16* sHr, __nv_bfloat16* sHc, int tile,
    int el, const int* __restrict__ row_t, const int* __restrict__ col_l,
    const int* __restrict__ kblk, const float* __restrict__ scal,
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ hr,
    const __nv_bfloat16* __restrict__ hc, const float* __restrict__ gp,
    int n_edges, int T, int epb, int smax) {
  EdgeFetch f;
  tc_fetch_fields(f, tile, el, row_t, col_l, kblk, scal, n_edges);
  tc_fetch_rows<H>(f, el, sHr, sHc, x, hr, hc, n_edges, T, epb, smax);
  tc_store_edge<H, GP>(b, f, el, gp);
}

// Threads tid < TE (warps 0 and 1), one an edge: whether edge tid starts a
// row segment (it is active and its row differs from the previous active
// edge's), as two 32-bit ballots into start[0..1]
__device__ __forceinline__ void tc_mark_segment_starts(const EdgeBuf& E,
                                                       unsigned* start) {
  const int tid = threadIdx.x;
  const int row = E.row[tid];
  const unsigned long long act =
      ((unsigned long long)E.act[1] << 32) | E.act[0];
  const unsigned long long below = act & ((1ull << tid) - 1ull);
  const int prev = below ? 63 - __clzll((long long)below) : -1;
  const unsigned sm = __ballot_sync(
      0xffffffffu, row >= 0 && (prev < 0 || E.row[prev] != row));
  if ((tid & 31) == 0) start[tid >> 5] = sm;
}

// All threads. Row side: the bf16 payload tile P [TE, H+8] (row stride
// TcTiles::LDP) summed by row segment as a tensor-core product, onehot
// [segment, edge] (exact 0/1, inactive edges 0) x P [edge, H+8], 16
// segments at a time, f32 accumulation; then one f32 atomicAdd per
// (segment, column) into out_row [N, H+8], as the FMA tile's walk adds one
// per segment end. Column 7 is never added, and column 6 only with COUNT
// (the forward's edge count; the backward's lanes 6-7 are zero). oh is a
// [16, LDO] bf16 scratch tile, seg_row [TE] shared scratch. Starts and ends
// with every thread past a __syncthreads.
template <int H, bool COUNT>
__device__ __forceinline__ void tc_row_side(const EdgeBuf& E,
                                            const unsigned* start,
                                            int* seg_row, __nv_bfloat16* oh,
                                            const __nv_bfloat16* P,
                                            float* __restrict__ out_row) {
  using L = TcTiles<H>;
  constexpr int F = H + 8;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned long long starts =
      ((unsigned long long)start[1] << 32) | start[0];
  const int nseg = __popcll(starts);
  for (int s0 = 0; s0 < nseg; s0 += 16) {
    for (int i = tid; i < 16 * TE; i += THREADS) {
      const int sg = i / TE, el = i % TE;
      // the segment of edge el: the starts at or before it, less one
      const int seg = __popcll(starts & (~0ull >> (63 - el))) - 1;
      const bool on = E.row[el] >= 0 && seg == s0 + sg;
      oh[sg * L::LDO + el] = __float2bfloat16_rn(on ? 1.f : 0.f);
    }
    if (s0 == 0 && tid < TE && ((starts >> tid) & 1ull))
      seg_row[__popcll(starts & (~0ull >> (63 - tid))) - 1] = E.row[tid];
    __syncthreads();
    for (int nt = warp; nt < F / 8; nt += THREADS / 32) {
      float acc[1][4] = {};
      warp_mm<L::LDO, L::LDP, 1, false, true>(oh, P, 0, 8 * nt, 0, TE / 16,
                                              acc);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int seg = s0 + (lane >> 2) + 8 * (q >> 1);
        const int c = 8 * nt + 2 * (lane & 3) + (q & 1);
        if (seg < nseg && c != 7 && (COUNT || c != 6))
          atomicAdd(&out_row[(size_t)seg_row[seg] * F + c], acc[0][q]);
      }
    }
    __syncthreads();   // the one-hot is rewritten for the next 16
  }
}

}  // namespace fused_edge
