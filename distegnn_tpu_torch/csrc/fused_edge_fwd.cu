// fused_edge_fwd.cu — one EGCL layer's in-window edge pass, forward, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes
// (distegnn_tpu_torch/ops/edge_pipeline.py: _fused_edge_layer_cuda).
//
// Replaces the TPU kernel _fwd_kernel (distegnn_tpu/ops/edge_pipeline.py:288,
// launched by pallas_call in _fused_fwd_impl, :474). Same function: for every
// in-window edge of the blocked layout
//     cd = x[row] - x[col]; radial = |cd|^2                     (f32)
//     t1 = hr[row] + hc[col] + [radial, a0, a1] @ ws + b1; y1 = silu(t1)
//     ef = silu(y1 @ w2 + b2); y2 = silu(ef @ w3 + b3)          (compute dtype)
//     g  = y2 . w4;  trans = cd * g                              (f32)
// and out[row] += [bf16 hi(trans), bf16 lo(trans), 1, 0, bf16(ef)], summed
// in f32 — the TPU kernel's roundings, kept even in f32 mode so that the two
// agree to summation order.
//
// Under the tensor axis of the mesh the same function runs at a phi_x width
// HX = H / T: w3 is [H, HX], b3 and w4 [HX], and g = y2 . w4 is this rank's
// partial sum over its HX columns of phi_x's hidden layer (the caller sums
// trans over the tensor ranks; ef and the count are the rank's whole).
// Every kernel is instantiated at HX in {H, H/2, H/4} (at least 8); HX = H
// is the code it was before the axis.
//
// Three kernels compute it, and the wrapper picks one by dtype and H:
//  - fused_edge_fwd_tc_kernel<H>, bf16 at H in {16, 32, 64} (the flagship's
//    path): the two H x H products on the tensor cores;
//  - fused_edge_fwd_f32_kernel<H>, f32 at every H (serving's path): the two
//    products as register-blocked FMAs (on the tensor cores f32 operands
//    would be rounded to TF32, which breaks the f32 parity the tests hold);
//  - fused_edge_fwd_kernel<H, true>, bf16 at the other H: the FMA tile of
//    fused_edge_common.cuh.
//
// What bounds it on the H100: the two H x H products per edge, 4*H*H =
// 16 Kflop at H=64, against ~44 bytes of edge stream plus two gathered node
// rows (mostly L2 hits). In f32 the CUDA-core rate (67 TFLOP/s) bounds it;
// in bf16 on the tensor cores (989 TFLOP/s) the products are not the limit,
// and the bound is the bytes: at the flagship shape (113k nodes, 1.43 M
// in-window edges) 0.04 ms. What the tensor-core kernel spends instead is
// the elementwise epilogues (three sigmoids an element, each an expf and an
// IEEE division, and the bf16 roundings) and the hr / hc gathers (PERF.md
// has the measured split).
//
// Design of the FMA kernels, against the TPU kernel:
//  - The TPU gathers the sender rows from a 3-block VMEM window and sums with
//    one-hot MXU products over a sequential (nb, nt) grid. Here each block
//    takes tiles of TE=64 consecutive row-sorted edges, rebuilds global
//    (row, col) from the same layout arrays (row_t/col_l/kblk and the window
//    start clip(b-1, 0, nb-3)), and gathers hr/hc straight from global
//    memory. An edge is processed iff scal[e, 2] (the in-window & real mask
//    of build_edge_blocks) is set, so the edge set is the TPU kernel's.
//  - w2 and w3 (2*H*H f32, 32 KB at H=64) are loaded once per block into
//    shared memory; blocks are persistent (grid = resident blocks per SM x
//    SMs) and walk the tiles with a grid stride, so the weights are read
//    once per block, not once per tile.
//  - Tiles with no active edge (trailing padding blocks of a bucketed batch)
//    are skipped after one __syncthreads_or.
//  - Aggregation: edges are sorted by row, so each of the H+8 output columns
//    is reduced by one thread walking the tile in order; only the tile's
//    row-segment ends issue an f32 atomicAdd into the zeroed [N, H+8] output
//    (a row's sum is therefore order-dependent across tiles at f32 rounding).
//  - No allocation, no synchronisation; launched on the caller's stream.
//  - rnd, silu, the tile product and the whole tile (setup, MLPs, row
//    sums) live in fused_edge_common.cuh, shared with the backward kernel
//    (fused_edge_bwd.cu), which recomputes this forward with the same
//    roundings, and with the fused-stack megakernel (fused_stack_fwd.cu),
//    whose in-window pass is this tile.
// The tensor-core and f32 kernels' designs are at their definitions below;
// the tensor-core building blocks (ldmatrix / mma.sync, the edge staging,
// the one-hot row side) are fused_edge_tc.cuh's, shared with the backward's
// tensor-core kernel; the f32 ones (the register-blocked tile, its staging
// and row walk) fused_edge_f32.cuh's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "fused_edge_common.cuh"
#include "fused_edge_f32.cuh"
#include "fused_edge_tc.cuh"

namespace {

using namespace fused_edge;

template <int H>
constexpr size_t smem_bytes() {
  return FwdTile<H>::kBytes;
}

template <int H, bool BF16, int HX>
__global__ void __launch_bounds__(THREADS)
fused_edge_fwd_kernel(const int* __restrict__ row_t,
                      const int* __restrict__ col_l,
                      const int* __restrict__ kblk,
                      const float* __restrict__ scal,
                      const float* __restrict__ x,
                      const std::conditional_t<BF16, __nv_bfloat16, float>* __restrict__ hr,
                      const std::conditional_t<BF16, __nv_bfloat16, float>* __restrict__ hc,
                      const float* __restrict__ ws, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ w3, const float* __restrict__ b3,
                      const float* __restrict__ w4, float* __restrict__ out,
                      int n_nodes, int n_edges, int block) {
  extern __shared__ float smem[];
  const FwdTile<H> s(smem);
  fwd_load_weights<H, BF16, HX>(s, ws, b1, w2, b2, w3, b3, w4);

  const int n_tiles = (n_edges + TE - 1) / TE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // weights loaded / previous tile fully consumed
    const int active = fwd_setup_inwindow<H, BF16>(
        s, tile, row_t, col_l, kblk, scal, x, n_nodes, n_edges, block);
    if (!__syncthreads_or(active)) continue;  // all-padding tile
    fwd_tile_mlp<H, BF16,
                 std::conditional_t<BF16, __nv_bfloat16, float>, HX>(s, hr,
                                                                     hc);
    fwd_aggregate_inwindow<H>(s, out, H + 8);
  }
}

// ------------------------------------------------ the bf16 tensor-core path
//
// fused_edge_fwd_tc_kernel<H>: the same tile on the tensor cores, for bf16
// at H in {16, 32, 64}. Every operand of the two products (y1, ef and the
// weights) is a bf16 value in _fwd_kernel's bf16 path, so the products run
// as mma.sync m16n8k16 (bf16 in, f32 accumulate) with every term exact;
// every rounding is the FMA tile's (fused_edge_common.cuh), and only the f32
// summation order inside a product (and of the gate g and of a row
// segment's sums) differs.
//
// Persistent blocks, 3 an SM (at most 85 registers a thread; ~60 KB of
// shared memory at H=64), walk the tiles with a grid stride; w2 and w3 are
// staged once a block as bf16, rows padded to H+8. Per tile, all 8 warps:
//   1. t1 = hr[row] + hc[col] + sfeat @ ws + b1 and y1 = silu(t1), eight
//      columns a thread, from the staged rows, into the bf16 tile y1;
//   2. y1 @ w2 on the tensor cores (warp w: rows 16 (w % 4).., column half
//      w / 4); epilogue ef = silu(. + b2), stored as bf16 into the payload
//      tile from column 8;
//   3. ef @ w3; epilogue y2 = silu(. + b3) and the gate's partial sums
//      y2 * w4, reduced over the quad by shuffles, one per column half;
//   4. per edge (warps 0-1): g, trans = cd * g and the payload's first
//      eight lanes [hi(trans), lo(trans), 1, 0], the row segment starts;
//      meanwhile warps 2-3 store the next tile's slots. Its staging is
//      spread over the tile so that its global loads overlap the work: its
//      layout fields are loaded at the top of the tile, its hr / hc rows
//      (cp.async into their own staging tiles) and x rows after phase 1;
//   5. the row side: one-hot [segment, edge] x payload on the tensor cores,
//      one f32 atomicAdd per (segment, column) (tc_row_side).
// Each sigmoid is computed once (sig_bf16 / silu_s).
// At HX < H phase 3 is [TE, H] x [H, HX]: each column half takes HX / 2
// columns (HX / 16 n8 tiles a warp); at HX = 8 the first half takes all 8
// and the second contributes 0 to g.

template <int H>
struct FwdTcLayout : TcTiles<H> {
  using B = TcTiles<H>;
  static constexpr int EDGE = EdgeBuf::kWords(false);
  // bf16: w2, w3 [H, LDS]; the payload [TE, LDP]; y1 [TE, LDS] (then the
  // row side's one-hot); the staged hr / hc rows [TE, H] each.
  // f32: ws [3H], b1, b2, b3, w4 [H]; the column halves' sums of g [2, TE].
  // Then the two per-edge staging buffers, their ballots (4 words), the
  // segment starts (2 words) and the row of each segment [TE].
  static constexpr size_t kBytes =
      (size_t)(2 * B::WT + B::PAY + B::TILE + 2 * TE * H) * 2 +
      (size_t)(7 * H + 2 * TE) * 4 + (size_t)2 * TE * EDGE * 4 + 6 * 4 +
      TE * 4;
};

template <int H, int HX>
__global__ void __launch_bounds__(THREADS, 3)
fused_edge_fwd_tc_kernel(const int* __restrict__ row_t,
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
                         float* __restrict__ out, int n_nodes, int n_edges,
                         int block) {
  using L = FwdTcLayout<H>;
  constexpr int LDS = L::LDS;
  constexpr int LDP = L::LDP;
  constexpr int NTM = L::NTM;
  static_assert(THREADS == 256 && TE == 64, "8 warps over 64-edge tiles");
  static_assert(NTM == 1 || NTM % 2 == 0, "n8 tiles in pairs");
  // phase 3's n8 tiles a warp and the column half's start
  constexpr int NTX = HX >= 16 ? HX / 16 : 1;
  static_assert(HX % 8 == 0 && H % HX == 0 && (NTX == 1 || NTX % 2 == 0),
                "HX in {H, H/2, H/4}, at least 8");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sW2 = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [k][j]
  __nv_bfloat16* sW3 = sW2 + L::WT;     // [k][j < HX]
  __nv_bfloat16* tP = sW3 + L::WT;      // [TE, LDP] payload; ef from col 8
  __nv_bfloat16* tEF = tP + 8;
  __nv_bfloat16* tY1 = tP + L::PAY;     // y1, then the row side's one-hot
  __nv_bfloat16* sHr = tY1 + L::TILE;   // [TE, H] staged hr[row]
  __nv_bfloat16* sHc = sHr + TE * H;    // [TE, H] staged hc[col]
  float* sWs = reinterpret_cast<float*>(sHc + TE * H);   // [3, H]
  float* sB1 = sWs + 3 * H;
  float* sB2 = sB1 + H;
  float* sB3 = sB2 + H;
  float* sW4 = sB3 + H;
  float* sGp = sW4 + H;                 // [2, TE] the column halves' g sums
  int* sEdge = reinterpret_cast<int*>(sGp + 2 * TE);
  unsigned* sAct = reinterpret_cast<unsigned*>(sEdge + 2 * L::EDGE * TE);
  unsigned* sStart = sAct + 4;
  int* sSegRow = reinterpret_cast<int*>(sStart + 2);   // [TE] segment -> row

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = 16 * (warp & 3), half = warp >> 2, n0 = half * (H / 2);
  const int er0 = m0 + (lane >> 2), er1 = er0 + 8;
  const int jc = n0 + 2 * (lane & 3);
  const int n0x = half * (HX / 2), jcx = n0x + 2 * (lane & 3);
  // warps 2-3 stage the next tile, one edge slot a thread
  const bool stager = tid >= TE && tid < 2 * TE;
  const int sel = tid - TE;

  for (int i = tid; i < H * H; i += THREADS) {
    const int k = i / H, j = i % H;
    sW2[k * LDS + j] = __float2bfloat16_rn(w2[i]);
  }
  for (int i = tid; i < H * HX; i += THREADS) {
    const int k = i / HX, j = i % HX;
    sW3[k * LDS + j] = __float2bfloat16_rn(w3[i]);
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

  const int T = block;
  const int nb = n_nodes / T;
  const int epb = n_edges / nb;
  const int smax = nb - 3 > 0 ? nb - 3 : 0;
  const int n_tiles = (n_edges + TE - 1) / TE;

  if (tid < TE)
    tc_stage_edges<H, false>(EdgeBuf(sEdge, sAct), sHr, sHc, blockIdx.x,
                             tid, row_t, col_l, kblk, scal, x, hr, hc,
                             nullptr, n_edges, T, epb, smax);
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
        tc_stage_edges<H, false>(next, sHr, sHc, tile + gridDim.x, tid,
                                 row_t, col_l, kblk, scal, x, hr, hc,
                                 nullptr, n_edges, T, epb, smax);
      cp_async_wait_all();
      continue;
    }
    // the next tile's staging, spread over this tile's phases so that its
    // global loads overlap them: its layout fields now, its rows once the
    // t1 phase has read the staging tiles, its slots at phase 4
    EdgeFetch nf;
    if (stager)
      tc_fetch_fields(nf, tile + gridDim.x, sel, row_t, col_l, kblk, scal,
                      n_edges);

    // ---- 1. t1 and y1 = silu(t1), eight columns a thread per item
    for (int i = tid; i < TE * (H / 8); i += THREADS) {
      const int el = i / (H / 8), j0 = 8 * (i % (H / 8));
      float y[8];
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
            const float t = dense_pre<true>(hrc + sw, sB1[j]);
            y[2 * q + u] = silu_s(t, sig_bf16(t));
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) y[q] = 0.f;
      }
      uint4 py;
      __nv_bfloat162* qy = reinterpret_cast<__nv_bfloat162*>(&py);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        qy[q] = __floats2bfloat162_rn(y[2 * q], y[2 * q + 1]);
      *reinterpret_cast<uint4*>(tY1 + el * LDS + j0) = py;
    }
    __syncthreads();
    if (stager)   // the staging tiles are free: the next tile's rows
      tc_fetch_rows<H>(nf, sel, sHr, sHc, x, hr, hc, n_edges, T, epb, smax);

    // ---- 2. ef = silu(y1 w2 + b2) into the payload from column 8
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
          st2(tEF + e * LDP + j, silu_s(t0, sig_bf16(t0)),
              silu_s(t1, sig_bf16(t1)));
        }
    }
    __syncthreads();

    // ---- 3. y2 = silu(ef w3 + b3); the gate's sums of y2 * w4
    {
      float gsum[2] = {0.f, 0.f};
      if (HX >= 16 || half == 0) {
        float acc[NTX][4] = {};
        warp_mm<LDP, LDS, NTX, false, true>(tEF, sW3, m0, n0x, 0, H / 16,
                                            acc);
#pragma unroll
        for (int t = 0; t < NTX; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int j = jcx + 8 * t + u;
              const float t3 = dense_pre<true>(acc[t][2 * h + u], sB3[j]);
              const float y2 = silu_s(t3, sig_bf16(t3));
              gsum[h] = __fadd_rn(gsum[h], __fmul_rn(y2, sW4[j]));
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

    // ---- 4. warps 0-1: the payload's first eight lanes [hi(trans),
    //      lo(trans), 1, 0] and the segment starts; warps 2-3: the next
    //      tile's slots
    if (tid < TE) {
      const int row = E.row[tid];
      tc_mark_segment_starts(E, sStart);
      float hl[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (row >= 0) {
        const float g = sGp[tid] + sGp[TE + tid];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float tr = __fmul_rn(E.cd[3 * tid + k], g);
          hl[k] = round_bf16(tr);
          hl[3 + k] = round_bf16(__fsub_rn(tr, hl[k]));
        }
        hl[6] = 1.f;
      }
      uint4 ph;
      __nv_bfloat162* qh = reinterpret_cast<__nv_bfloat162*>(&ph);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        qh[q] = __floats2bfloat162_rn(hl[2 * q], hl[2 * q + 1]);
      *reinterpret_cast<uint4*>(tP + tid * LDP) = ph;
    } else if (stager) {
      tc_store_edge<H, false>(next, nf, sel, nullptr);
    }
    __syncthreads();

    // ---- 5. the row side: [hi, lo, 1, 0, ef] summed by row segment
    tc_row_side<H, true>(E, sStart, sSegRow, tY1, tP, out);
    cp_async_wait_all();   // the next tile's rows have landed
  }
}

// ---------------------------------------------------- the f32 FMA path
//
// fused_edge_fwd_f32_kernel<H>: the FMA tile redesigned for f32 (any H in
// 16..128). The function is the FMA tile's (rnd<false> is the identity) and
// each product sums over k in order with one fmaf per term; the sigmoid
// runs on the special-function unit (f32_silu, a few ulps from the exact
// form), and the summation order of the gate g and of the row segments'
// atomics across tiles can differ. The f32 checks against the plain version
// hold at their tolerances. Persistent blocks of F32_THREADS = 128
// threads walk 64-edge tiles with a grid stride; w2 and w3 are staged once a
// block (the columns permuted, fused_edge_f32.cuh). At H = 64 a block takes
// ~57 KB of shared memory and 157 registers a thread, so three blocks share
// an SM and one's barriers and serial steps overlap the others' work. Per
// tile:
//   1. t1 = hr[row] + hc[col] + sfeat @ ws + b1 and y1 = silu(t1), one edge
//      and H/8 column quads a thread (consecutive threads on consecutive
//      edges), its hr / hc row loads issued together, into the k-major tile
//      [H][LDT];
//   2. y1 @ w2, 8 edges x H/16 columns a thread (f32_tile_mm); once every
//      thread has read y1, epilogue ef = silu(. + b2) into the same tile (0
//      at inactive slots);
//   3. ef @ w3; epilogue y2 = silu(. + b3) and the gate's partial sums
//      y2 * w4, reduced over the 16 column groups by shuffles; from the
//      gate g the payload's lanes [hi(trans), lo(trans), 1] of each edge;
//   4. the row side: one task per (payload column, row segment), each
//      segment summed in edge order, one f32 atomicAdd per segment and
//      column (f32_row_side).
// The next tile's per-edge data is staged while this one computes, as the
// tensor-core kernel stages it (threads 0-63, one edge slot each): its
// layout fields are loaded at the top of the tile, its x rows after phase 1,
// and its edge data stored into the other of two edge buffers after phase 2.
// At HX < H phase 3 runs over w3's CX = ceil(HX / 16) column groups a
// thread, the columns from HX on (zero weights) left out of g.

template <int H, int HX>
__global__ void __launch_bounds__(F32_THREADS)
fused_edge_fwd_f32_kernel(const int* __restrict__ row_t,
                          const int* __restrict__ col_l,
                          const int* __restrict__ kblk,
                          const float* __restrict__ scal,
                          const float* __restrict__ x,
                          const float* __restrict__ hr,
                          const float* __restrict__ hc,
                          const float* __restrict__ ws,
                          const float* __restrict__ b1,
                          const float* __restrict__ w2,
                          const float* __restrict__ b2,
                          const float* __restrict__ w3,
                          const float* __restrict__ b3,
                          const float* __restrict__ w4,
                          float* __restrict__ out, int n_nodes, int n_edges,
                          int block) {
  using L = F32Layout<H>;
  constexpr int CW = L::CW;
  constexpr int EDGE = L::EDGE;
  static_assert(F32_THREADS == 128 && TE == 64,
                "8 x 16 threads over 64-edge tiles");

  extern __shared__ __align__(16) float fsm[];
  float* sW2 = fsm;                       // [H][H], columns permuted
  float* sW3 = sW2 + H * H;
  float* sT = sW3 + H * H;                // [H][LDT] y1, then ef, k-major
  float* sWs = sT + H * F32_LDT;          // ws [3H], b1, b2, b3, w4
  const float* sB1 = sWs + 3 * H;
  const float* sB2 = sWs + 4 * H;
  const float* sB3 = sWs + 5 * H;
  const float* sW4 = sWs + 6 * H;
  float* sP = sWs + 7 * H;                // [7][TE] the payload's lanes 0-6
  int* sEdge = reinterpret_cast<int*>(sP + 7 * TE);
  unsigned* sAct = reinterpret_cast<unsigned*>(sEdge + 2 * EDGE * TE);
  unsigned* sStart = sAct + 4;            // [2] the row segment starts

  const int tid = threadIdx.x;
  const int te = tid >> 4, tc = tid & 15;
  const bool stager = tid < TE;

  f32_load_weights<H, HX>(sW2, sW3, sWs, ws, b1, w2, b2, w3, b3, w4);

  const int T = block;
  const int nb = n_nodes / T;
  const int epb = n_edges / nb;
  const int smax = nb - 3 > 0 ? nb - 3 : 0;
  const int n_tiles = (n_edges + TE - 1) / TE;

  if (stager) {
    EdgeFetch f;
    tc_fetch_fields(f, blockIdx.x, tid, row_t, col_l, kblk, scal, n_edges);
    f32_fetch_rows(f, x, n_edges, T, epb, smax);
    f32_store_edge(EdgeBuf(sEdge, sAct), f, tid);
  }

  int cur = 0;
  for (int tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, cur ^= 1) {
    __syncthreads();  // this tile staged, the previous one fully consumed
    const EdgeBuf E(sEdge + cur * EDGE * TE, sAct + 2 * cur);
    const EdgeBuf next(sEdge + (cur ^ 1) * EDGE * TE, sAct + 2 * (cur ^ 1));
    if (!(E.act[0] | E.act[1])) {   // all-padding tile
      if (stager) {
        EdgeFetch f;
        tc_fetch_fields(f, tile + gridDim.x, tid, row_t, col_l, kblk, scal,
                        n_edges);
        f32_fetch_rows(f, x, n_edges, T, epb, smax);
        f32_store_edge(next, f, tid);
      }
      continue;
    }
    // the next tile's layout fields now, its x rows after phase 1, its
    // per-edge data after phase 2; this tile's segment starts for phase 4
    EdgeFetch nf;
    if (stager) {
      tc_fetch_fields(nf, tile + gridDim.x, tid, row_t, col_l, kblk, scal,
                      n_edges);
      tc_mark_segment_starts(E, sStart);
    }

    // ---- 1. t1 and y1 = silu(t1). Thread tid takes edge tid % TE and the
    //      column quads 4 (tid / TE + 2 m): consecutive threads on
    //      consecutive edges; a batch of its hr / hc row loads is issued
    //      before any is used
    {
      constexpr int NI = H / 8;               // column quads a thread
      constexpr int PB = NI <= 8 ? NI : NI / 2;   // quads loaded together
      const int el = tid % TE, q0 = tid / TE;
      const int row = E.row[el];
      const float* hrr = hr + (size_t)(row >= 0 ? row : 0) * H;
      const float* hcr = hc + (size_t)E.col[el] * H;
      const float f0 = E.sf[3 * el], f1 = E.sf[3 * el + 1],
                  f2 = E.sf[3 * el + 2];
#pragma unroll
      for (int m0 = 0; m0 < NI; m0 += PB) {
        float4 a[PB], b[PB];
#pragma unroll
        for (int u = 0; u < PB; ++u) {
          const int j0 = 4 * (q0 + 2 * (m0 + u));
          if (row >= 0) {
            a[u] = *reinterpret_cast<const float4*>(hrr + j0);
            b[u] = *reinterpret_cast<const float4*>(hcr + j0);
          }
        }
#pragma unroll
        for (int u = 0; u < PB; ++u) {
          const int j0 = 4 * (q0 + 2 * (m0 + u));
          float y[4] = {0.f, 0.f, 0.f, 0.f};
          if (row >= 0) {
            const float4 w0 = *reinterpret_cast<const float4*>(sWs + j0);
            const float4 w1 = *reinterpret_cast<const float4*>(sWs + H + j0);
            const float4 w2v =
                *reinterpret_cast<const float4*>(sWs + 2 * H + j0);
            const float4 bb = *reinterpret_cast<const float4*>(sB1 + j0);
            const float hv[4] = {a[u].x + b[u].x, a[u].y + b[u].y,
                                 a[u].z + b[u].z, a[u].w + b[u].w};
            const float u0[4] = {w0.x, w0.y, w0.z, w0.w};
            const float u1[4] = {w1.x, w1.y, w1.z, w1.w};
            const float u2[4] = {w2v.x, w2v.y, w2v.z, w2v.w};
            const float ub[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float sw = fmaf(f2, u2[q], fmaf(f1, u1[q], f0 * u0[q]));
              y[q] = f32_silu((hv[q] + sw) + ub[q]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) sT[(j0 + q) * F32_LDT + el] = y[q];
        }
      }
    }
    if (stager) f32_fetch_rows(nf, x, n_edges, T, epb, smax);
    __syncthreads();

    // ---- 2. ef = silu(y1 w2 + b2), into the tile once all have read y1
    {
      float acc[8][CW];
      f32_tile_mm<H>(sT, sW2, acc);
      __syncthreads();
      bool on[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) on[r] = E.row[8 * te + r] >= 0;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int j = tc + 16 * c;
        float v[8];
        // 0 at an inactive slot: the row side sums segments as ranges
#pragma unroll
        for (int r = 0; r < 8; ++r)
          v[r] = on[r] ? f32_silu(acc[r][c] + sB2[j]) : 0.f;
        float* p = sT + j * F32_LDT + 8 * te;
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(p + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    if (stager) f32_store_edge(next, nf, tid);
    __syncthreads();

    // ---- 3. y2 = silu(ef w3 + b3); g = sum_j y2 * w4, the 16 column
    //      groups' partial sums reduced by shuffles within the half-warp
    {
      constexpr int CX = (HX + 15) / 16;
      float acc[8][CX];
      f32_tile_mm<H, CX>(sT, sW3, acc);
      float gs[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        gs[r] = 0.f;
#pragma unroll
        for (int c = 0; c < CX; ++c) {
          const int j = tc + 16 * c;
          if (j < HX) {
            const float y2 = f32_silu(acc[r][c] + sB3[j]);
            gs[r] = __fadd_rn(gs[r], __fmul_rn(y2, sW4[j]));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int d = 8; d >= 1; d >>= 1)
          gs[r] = __fadd_rn(gs[r], __shfl_xor_sync(0xffffffffu, gs[r], d));
      if (tc == 0) f32_store_payload(E, gs, te, sP);
    }
    __syncthreads();

    // ---- 4. the row side: [hi, lo, 1, 0, ef] summed by row segment
    f32_row_side<H>(E, sStart, sP, sT, out);
  }
}

template <int H, bool BF16, int HX>
cudaError_t launch(const void* row_t, const void* col_l, const void* kblk,
                   const void* scal, const void* x, const void* hr,
                   const void* hc, const void* ws, const void* b1,
                   const void* w2, const void* b2, const void* w3,
                   const void* b3, const void* w4, void* out, int n_nodes,
                   int n_edges, int block, int n_sm, cudaStream_t stream) {
  using Act = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr size_t smem = smem_bytes<H>();
  auto kern = fused_edge_fwd_kernel<H, BF16, HX>;
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
  if (grid < 1) return cudaSuccess;
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const int*>(row_t), static_cast<const int*>(col_l),
      static_cast<const int*>(kblk), static_cast<const float*>(scal),
      static_cast<const float*>(x), static_cast<const Act*>(hr),
      static_cast<const Act*>(hc), static_cast<const float*>(ws),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<const float*>(w4),
      static_cast<float*>(out), n_nodes, n_edges, block);
  return cudaGetLastError();
}

template <int H, int HX>
cudaError_t launch_f32(const void* row_t, const void* col_l,
                       const void* kblk, const void* scal, const void* x,
                       const void* hr, const void* hc, const void* ws,
                       const void* b1, const void* w2, const void* b2,
                       const void* w3, const void* b3, const void* w4,
                       void* out, int n_nodes, int n_edges, int block,
                       int n_sm, cudaStream_t stream) {
  constexpr size_t smem = F32Layout<H>::kBytes;
  auto kern = fused_edge_fwd_f32_kernel<H, HX>;
  // the attribute and the occupancy query once per device: they cost host
  // time per launch
  constexpr int kDevices = 64;
  static int per_sm_of[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int per_sm = dev >= 0 && dev < kDevices ? per_sm_of[dev] : 0;
  if (per_sm == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    // the largest shared-memory carveout: three ~57 KB blocks at H = 64
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        F32_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (dev >= 0 && dev < kDevices) per_sm_of[dev] = per_sm;
  }
  const int n_tiles = (n_edges + TE - 1) / TE;
  int grid = per_sm * n_sm;
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) return cudaSuccess;
  kern<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const int*>(row_t), static_cast<const int*>(col_l),
      static_cast<const int*>(kblk), static_cast<const float*>(scal),
      static_cast<const float*>(x), static_cast<const float*>(hr),
      static_cast<const float*>(hc), static_cast<const float*>(ws),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<const float*>(w4),
      static_cast<float*>(out), n_nodes, n_edges, block);
  return cudaGetLastError();
}

template <int H, int HX>
cudaError_t launch_tc(const void* row_t, const void* col_l, const void* kblk,
                      const void* scal, const void* x, const void* hr,
                      const void* hc, const void* ws, const void* b1,
                      const void* w2, const void* b2, const void* w3,
                      const void* b3, const void* w4, void* out, int n_nodes,
                      int n_edges, int block, int n_sm, cudaStream_t stream) {
  constexpr size_t smem = FwdTcLayout<H>::kBytes;
  auto kern = fused_edge_fwd_tc_kernel<H, HX>;
  // the attribute and the occupancy query once per device: they cost host
  // time per launch
  constexpr int kDevices = 64;
  static int per_sm_of[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int per_sm = dev >= 0 && dev < kDevices ? per_sm_of[dev] : 0;
  if (per_sm == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (dev >= 0 && dev < kDevices) per_sm_of[dev] = per_sm;
  }
  const int n_tiles = (n_edges + TE - 1) / TE;
  int grid = per_sm * n_sm;
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) return cudaSuccess;
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const int*>(row_t), static_cast<const int*>(col_l),
      static_cast<const int*>(kblk), static_cast<const float*>(scal),
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(hr),
      static_cast<const __nv_bfloat16*>(hc), static_cast<const float*>(ws),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<const float*>(w4),
      static_cast<float*>(out), n_nodes, n_edges, block);
  return cudaGetLastError();
}

template <int H, int HX>
cudaError_t dispatch_dtype(int bf16, const void* row_t, const void* col_l,
                           const void* kblk, const void* scal, const void* x,
                           const void* hr, const void* hc, const void* ws,
                           const void* b1, const void* w2, const void* b2,
                           const void* w3, const void* b3, const void* w4,
                           void* out, int n_nodes, int n_edges, int block,
                           int n_sm, cudaStream_t stream) {
  if (bf16)
    return launch<H, true, HX>(row_t, col_l, kblk, scal, x, hr, hc, ws, b1,
                               w2, b2, w3, b3, w4, out, n_nodes, n_edges,
                               block, n_sm, stream);
  return launch_f32<H, HX>(row_t, col_l, kblk, scal, x, hr, hc, ws, b1, w2,
                           b2, w3, b3, w4, out, n_nodes, n_edges, block,
                           n_sm, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). out [N, H+8] f32 must
// be zeroed by the caller; hr/hc are f32 (bf16 == 0: the f32 kernel) or
// bf16 (bf16 == 1: the bf16 FMA kernel; fused_edge_fwd_tc takes bf16 at H in
// {16, 32, 64}). HX: phi_x's width, w3 [H, HX], b3 and w4 [HX], HX in {H,
// H/2, H/4} and at least 8 (cudaErrorInvalidValue otherwise).
extern "C" int fused_edge_fwd(const void* row_t, const void* col_l,
                              const void* kblk, const void* scal,
                              const void* x, const void* hr, const void* hc,
                              const void* ws, const void* b1, const void* w2,
                              const void* b2, const void* w3, const void* b3,
                              const void* w4, void* out, int n_nodes,
                              int n_edges, int block, int H, int HX,
                              int bf16, int n_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEG_CASE(HH, XX)                                                    \
  if (H == HH && HX == XX)                                                  \
    return (int)dispatch_dtype<HH, XX>(bf16, row_t, col_l, kblk, scal, x,   \
                                       hr, hc, ws, b1, w2, b2, w3, b3, w4,  \
                                       out, n_nodes, n_edges, block, n_sm,  \
                                       s);
#define DEG_WIDTHS(HH)                                                      \
  DEG_CASE(HH, HH)                                                          \
  DEG_CASE(HH, HH / 2)                                                      \
  DEG_CASE(HH, HH / 4)
  DEG_CASE(16, 16)
  DEG_CASE(16, 8)
  DEG_WIDTHS(32)
  DEG_WIDTHS(48)
  DEG_WIDTHS(64)
  DEG_WIDTHS(80)
  DEG_WIDTHS(96)
  DEG_WIDTHS(112)
  DEG_WIDTHS(128)
  return (int)cudaErrorInvalidValue;
#undef DEG_WIDTHS
#undef DEG_CASE
}


// The tensor-core kernel, for bf16 hr / hc at H in {16, 32, 64} and HX in
// {H, H/2, H/4} (at least 8); the same arguments and result as
// fused_edge_fwd. Returns the cudaError_t of the launch (0 = success).
extern "C" int fused_edge_fwd_tc(const void* row_t, const void* col_l,
                                 const void* kblk, const void* scal,
                                 const void* x, const void* hr,
                                 const void* hc, const void* ws,
                                 const void* b1, const void* w2,
                                 const void* b2, const void* w3,
                                 const void* b3, const void* w4, void* out,
                                 int n_nodes, int n_edges, int block, int H,
                                 int HX, int n_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TC_CASE(HH, XX)                                                    \
  if (H == HH && HX == XX)                                                 \
    return (int)launch_tc<HH, XX>(row_t, col_l, kblk, scal, x, hr, hc, ws, \
                                  b1, w2, b2, w3, b3, w4, out, n_nodes,    \
                                  n_edges, block, n_sm, s);
  TC_CASE(16, 16)
  TC_CASE(16, 8)
  TC_CASE(32, 32)
  TC_CASE(32, 16)
  TC_CASE(32, 8)
  TC_CASE(64, 64)
  TC_CASE(64, 32)
  TC_CASE(64, 16)
  return (int)cudaErrorInvalidValue;
#undef TC_CASE
}
