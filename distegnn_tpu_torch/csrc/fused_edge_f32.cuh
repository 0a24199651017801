// fused_edge_f32.cuh — the f32 building blocks of the fused edge pass's
// forward on the CUDA cores (fused_edge_fwd_f32_kernel, fused_edge_fwd.cu):
// a register-blocked tile product read from a k-major shared tile, the
// staging of the next tile's per-edge data, and the row segment sums as
// (column, segment) tasks. They sit beside fused_edge_common.cuh's FMA tile
// (which the f32 backward and the fused-stack megakernel keep) so that those
// kernels can take them next.
//
// The f32 path cannot use the tensor cores as the bf16 one does: mma.sync
// rounds f32 operands to TF32, which breaks the f32 parity the tests hold.
// So its two H x H products stay f32 FMAs, and what bounded the FMA tile was
// not the FMA rate but shared-memory issue (8 scalar loads for every 16
// FMAs) and, for 38 % of its time, the row side's serial walk (PERF.md,
// section 6). Here a tile of TE = 64 edges is held k-major ([H][LDT] f32, a
// column's 64 edges contiguous), and each of the F32_THREADS = 128 threads
// owns 8 edges x CW = H/16 columns: per k it loads its 8 edges as two
// float4 and its CW weights as one vector (the weights' columns are stored
// permuted so that the columns tc, tc + 16, ... of thread tc are
// contiguous), 3 loads for 32 FMAs at H = 64. Every product sums over k in
// order with one fmaf per term, from 0, as tile_mm does, so the products
// round exactly as the FMA tile's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_edge_common.cuh"
#include "fused_edge_tc.cuh"

namespace fused_edge {

constexpr int F32_THREADS = 128;   // 8 edge groups x 16 column groups
constexpr int F32_LDT = TE + 4;    // k-major tile row: 64 edges + 16 bytes
template <int H>
struct F32Layout {
  static constexpr int CW = H / 16;   // columns of a thread
  static constexpr int EDGE = EdgeBuf::kWords(false);   // an edge's words
  // w2, w3 [H][H]; the k-major tile [H][LDT] (y1, then ef); ws [3H], b1,
  // b2, b3, w4 [H]; the payload's first seven lanes [7][TE]; two edge
  // buffers, their ballots and the segment starts: ~57 KB at H = 64
  static constexpr size_t kBytes =
      ((size_t)2 * H * H + (size_t)H * F32_LDT + 7 * H + 7 * TE +
       (size_t)2 * EDGE * TE + 6) *
      4;
  static_assert(H % 16 == 0 && kBytes <= 232448, "H in 16..128");
};

// silu(t) = t * sigmoid(t) in f32 with the sigmoid's exponential and
// reciprocal on the special-function unit (__expf, __fdividef), a few f32
// ulps from the exact expf and IEEE division; three sigmoids an element
// were a third of the kernel's time with the exact forms
__device__ __forceinline__ float f32_silu(float t) {
  return t * __fdividef(1.0f, 1.0f + __expf(-t));
}

// weights in f32; w2 / w3 with the columns of each thread contiguous:
// sW[k][tc * CW + c] = w[k][tc + 16 c]. At the phi_x width HX < H (the
// tensor axis: w3 [H, HX], b3 and w4 [HX]) w3's rows hold 16 CX columns,
// CX = ceil(HX / 16), those from HX on zero, and b3 / w4 their first HX
// entries.
template <int H, int HX = H>
__device__ __forceinline__ void f32_load_weights(
    float* sW2, float* sW3, float* sWs, const float* __restrict__ ws,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, const float* __restrict__ w4) {
  constexpr int CW = H / 16, CX = (HX + 15) / 16;
  for (int i = threadIdx.x; i < H * H; i += F32_THREADS) {
    const int k = i / H, j = i % H;
    sW2[k * H + (j % 16) * CW + j / 16] = w2[i];
  }
  for (int i = threadIdx.x; i < H * 16 * CX; i += F32_THREADS) {
    const int k = i / (16 * CX), j = i % (16 * CX);
    sW3[k * 16 * CX + (j % 16) * CX + j / 16] = j < HX ? w3[k * HX + j] : 0.f;
  }
  // ws [3, H], then b1, b2, b3, w4 [H]
  for (int i = threadIdx.x; i < 3 * H; i += F32_THREADS) sWs[i] = ws[i];
  for (int i = threadIdx.x; i < H; i += F32_THREADS) {
    sWs[3 * H + i] = b1[i];
    sWs[4 * H + i] = b2[i];
    if (i < HX) {
      sWs[5 * H + i] = b3[i];
      sWs[6 * H + i] = w4[i];
    }
  }
}

// CW consecutive floats, as the widest vectors that divide CW
template <int CW>
__device__ __forceinline__ void load_cols(float (&b)[CW], const float* p) {
  if constexpr (CW % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CW; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      b[c] = v.x;
      b[c + 1] = v.y;
      b[c + 2] = v.z;
      b[c + 3] = v.w;
    }
  } else if constexpr (CW % 2 == 0) {
#pragma unroll
    for (int c = 0; c < CW; c += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + c);
      b[c] = v.x;
      b[c + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CW; ++c) b[c] = p[c];
  }
}

// acc[r][c] = sum_k At[k][8 te + r] * W[k][tc + 16 c] (W column-permuted,
// rows of 16 CW, see f32_load_weights), te = tid / 16, tc = tid % 16: over
// k in order, one fmaf per term, from 0 — tile_mm's roundings
template <int H, int CW = H / 16>
__device__ __forceinline__ void f32_tile_mm(const float* At, const float* W,
                                            float (&acc)[8][CW]) {
  const int te = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float* pa = At + 8 * te;
  const float* pb = W + CW * tc;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[r][c] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < H; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(pa + k * F32_LDT);
    const float4 a1 = *reinterpret_cast<const float4*>(pa + k * F32_LDT + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[CW];
    load_cols<CW>(b, pb + k * 16 * CW);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// 2. of the staging (tc_fetch_rows in f32): global (row, col) of the slot
// and its x[row] / x[col] rows, to registers. The hr / hc rows are read
// from global memory (mostly L2 hits) when the tile is computed: staged in
// shared memory by cp.async they left room for two blocks an SM instead of
// three, and the kernel ran slower (PERF.md, section 6).
__device__ __forceinline__ void f32_fetch_rows(EdgeFetch& f,
                                               const float* __restrict__ x,
                                               int n_edges, int T, int epb,
                                               int smax) {
  f.row = -1;
  f.col = 0;
  if (f.e < n_edges && f.m > 0.f && f.rl < T) {
    const int bl = f.e / epb;
    const int s = min(max(bl - 1, 0), smax);
    f.row = bl * T + f.rl;
    f.col = (s + f.kb) * T + f.cl;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f.xr[k] = x[3 * (size_t)f.row + k];
      f.xc[k] = x[3 * (size_t)f.col + k];
    }
  }
}

// 3. of the staging (tc_store_edge in f32): the slot into buffer b as the
// FMA tile's setup computes it — cd, sfeat = [radial, a0, a1] unrounded —
// and the buffer's active ballot. One thread an edge slot el, in two whole
// warps.
__device__ __forceinline__ void f32_store_edge(const EdgeBuf& b,
                                               const EdgeFetch& f, int el) {
  float cd[3] = {0.f, 0.f, 0.f}, sf[3] = {0.f, 0.f, 0.f};
  if (f.row >= 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) cd[k] = f.xr[k] - f.xc[k];
    // no FMA contraction: |cd|^2 rounded as the reference sums it
    sf[0] = __fadd_rn(__fadd_rn(__fmul_rn(cd[0], cd[0]),
                                __fmul_rn(cd[1], cd[1])),
                      __fmul_rn(cd[2], cd[2]));
    sf[1] = f.a0;
    sf[2] = f.a1;
  }
  b.row[el] = f.row;
  b.col[el] = f.col;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b.cd[3 * el + k] = cd[k];
    b.sf[3 * el + k] = sf[k];
  }
  const unsigned am = __ballot_sync(0xffffffffu, f.row >= 0);
  if ((el & 31) == 0) b.act[el >> 5] = am;
}

// The payload's first seven lanes of the tile's edges 8 te .. 8 te + 7 from
// their gate values g[r]: P[c][el] = bf16 hi(trans) (c < 3), bf16
// lo(trans) (3 <= c < 6), the count 1 (c = 6), all 0 at an inactive slot
__device__ __forceinline__ void f32_store_payload(const EdgeBuf& E,
                                                  const float (&g)[8], int te,
                                                  float* P) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int el = 8 * te + r;
    const bool on = E.row[el] >= 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float tr = __fmul_rn(E.cd[3 * el + k], g[r]);
      const float hi = round_bf16(tr);
      P[k * TE + el] = on ? hi : 0.f;
      P[(3 + k) * TE + el] = on ? round_bf16(__fsub_rn(tr, hi)) : 0.f;
    }
    P[6 * TE + el] = on ? 1.f : 0.f;
  }
}

// The row side of one tile: the TPU kernel's packed in-window row [bf16
// hi(trans), bf16 lo(trans), 1, 0, bf16(ef)] summed by row segment into out
// [N, H + 8], each segment's sum in edge order from 0 and one f32 atomicAdd
// per (segment, column), as fwd_aggregate_inwindow's walk adds them. The
// walk's 64 serial steps per column, each behind a load of the edge's row,
// become one task per (column, segment): ``start`` holds the segment
// starts (tc_mark_segment_starts), and task t sums column t / nseg over
// segment t % nseg (the lanes of a warp on different segments of one column
// read different edges of one row, in distinct banks). Inactive slots hold
// 0 in P and in the ef tile EFt, so a segment is a contiguous range summed
// without a test; adding +0 leaves every partial sum as the walk's, bit for
// bit.
template <int H>
__device__ __forceinline__ void f32_row_side(const EdgeBuf& E,
                                             const unsigned* start,
                                             const float* P, const float* EFt,
                                             float* __restrict__ out) {
  constexpr int F = H + 8;
  const unsigned long long starts =
      ((unsigned long long)start[1] << 32) | start[0];
  const int nseg = __popcll(starts);
  for (int t = threadIdx.x; t < nseg * F; t += F32_THREADS) {
    const int c = t / nseg, sg = t - c * nseg;
    if (c == 7) continue;
    unsigned long long m = starts;
    for (int i = 0; i < sg; ++i) m &= m - 1;   // drop the earlier starts
    const int e0 = __ffsll((long long)m) - 1;
    m &= m - 1;
    const int e1 = m ? __ffsll((long long)m) - 1 : TE;
    // P's lanes are bf16 values already: rounding them again is exact
    const float* src = c < 7 ? P + c * TE : EFt + (c - 8) * F32_LDT;
    float acc = 0.f;
#pragma unroll 4
    for (int el = e0; el < e1; ++el) acc += round_bf16(src[el]);
    atomicAdd(&out[(size_t)E.row[e0] * F + c], acc);
  }
}

}  // namespace fused_edge
