// fused_stack_fwd.cu — all L EGCL layers of a batch of graphs in one
// cooperative launch, forward, for Hopper (sm_90a). Plain C interface,
// loaded with ctypes (distegnn_tpu_torch/ops/layer_pipeline.py:
// _fused_egnn_stack_batch_cuda).
//
// Replaces the TPU megakernel _stack_kernel (distegnn_tpu/ops/
// layer_pipeline.py:425, launched by pallas_call in _stack_fwd_impl, :608).
// Same function, for each graph b of the batch: per layer l, from the
// layer-INPUT state (h, x, X, Hv)
//   hr, hc = h @ e_w1[:H], h @ e_w1[H:2H]                  (hoisted phi_e)
//   in-window blocked edges: the fused edge forward's tile (bf16 hi + lo
//     translations, bf16 edge features)
//   remote tail: the same per-edge math over the compact remote list,
//     summed unrounded (EGCLVel's dense tail)
//   agg = trans_sum / count, agg_h = ef_sum / count
//   the virtual section and the node / virtual updates (phi_ev, phi_xv,
//     phi_X, phi_v, phi_g, phi_h, phi_hv; layer_pipeline._virtual_and_update)
// and returns the final state plus the four [L, ...] layer-input
// checkpoints of every graph, which the backward reruns each layer from.
// The TPU's grid is the sequential layer axis, one graph a call; here the
// graph-batch axis is inside the launch: a served request (4 padded graphs)
// is one launch.
//
// What bounds it on the H100: neither bytes nor operations. A served batch
// (4 graphs, L=4, N=1536, H=64, ~20k real edges a graph) does ~8 GFLOP and
// touches ~21 MB, so its f32 bound is 0.12 ms; what the launch spends is
// the chain of dependent steps of its slowest block in each phase, plus 3
// grid-wide syncs a layer (~1-2 us each). The parent kernel (one launch per
// graph) spent 92 % of its critical path in the edge phase (the old FMA
// tile, ~28 us a tile) and in the node phase (12-14 small dense layers per
// 8-node tile, each a K-deep dependent FMA chain per output behind a weight
// staging; PERF.md, section 6, has the split). This design:
//  - One cooperative launch (cudaLaunchCooperativeKernel) for the whole
//    batch, with a grid of the co-resident blocks; grid.sync() separates
//    the phases of a layer. Phases A and C walk (graph, 16-node tile) work
//    items, phase B (graph, 64-edge tile) items, with a grid stride:
//      A  the hoisted hr / hc products (compute dtype), per-tile partials
//         of the masked coordinate sum and node count, the aggregate rows
//         zeroed (and at l = 0 the inputs copied into checkpoint slot 0)
//      B  the in-window tiles, then the remote tiles, into the graph's
//         [N, H+8] aggregate (the fused edge forward's row) and [N, 4]
//         remote translation sums, f32 atomicAdd at row-segment ends (so
//         their summation order changes from run to run)
//      C  per tile: the mean aggregates, the virtual section, the x and h
//         updates (written to slot l+1), and per-tile partials of trans_X
//         and agg_Hv
//      D  graph b's X and Hv (phi_hv) into slot l+1 from those partials,
//         on block gridDim.x - 1 - b, after the next layer's first sync and
//         before its edge items (phase B reads neither X nor Hv; the next
//         sync orders D before phase C), so that it overlaps phase B
//    Every block reaches every sync, whether or not it has items.
//  - The edge phase runs the fused edge forward's redesigned tiles: f32 in
//    blocks of F32_THREADS = 128 threads on fused_edge_f32.cuh's
//    register-blocked tile (f32_silu on the special-function unit), bf16 in
//    blocks of THREADS = 256 on fused_edge_tc.cuh's mma.sync tile; each
//    block stages the edge weights once a layer and the next item's edges
//    while it computes the current one. Remote tiles take the same tiles;
//    only their row side differs (unrounded sums, by (column, segment)).
//  - The node phase's dense layers (A, C, D): f32 blocks run them as
//    register-blocked FMA products (each thread a 16-row pass's rows tr +
//    TR i and H/16 contiguous columns, independent accumulators, one fmaf
//    per term, k in order from 0: exact f32; phi_ev's first H terms summed
//    once per node and continued per channel, the same fmaf chain as the
//    whole sum), weights staged per dense layer in chunks of at most H + 1
//    + MAXC rows. bf16 blocks run them on the tensor cores (mma.sync
//    m16n8k16, fragments read from the f32 tiles, whose values are bf16
//    numbers: every term exact, f32 sums in the tensor cores' order), each
//    dense layer's weights staged whole. Both round as _dense does: bf16
//    operands, the product and the bias add each rounded. The [H, 1]
//    heads (phi_xv, phi_X, phi_v, phi_g) are reduced in the epilogue of
//    the layer before them. A tile is 16 nodes, so a served batch of 4
//    graphs of 1536 nodes gives every block at most one tile.
//  - The state lives in the checkpoint slots themselves: S_h [B, L+1, N, H],
//    S_x [B, L+1, N, 3], S_X [B, L+1, 3, C], S_Hv [B, L+1, H, C]; layer l
//    reads slot l and writes slot l+1. The whole batch's working set stays
//    L2-resident (50 MB; PERF.md, section 6, reckons it).
//  - Determinism: the node reductions (coordinate mean, trans_X, agg_Hv)
//    are per-(graph, tile) partials summed in a fixed order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "fused_edge_common.cuh"
#include "fused_edge_f32.cuh"
#include "fused_edge_tc.cuh"

namespace {

using namespace fused_edge;
namespace cg = cooperative_groups;

constexpr int NT = 16;      // nodes per node tile (phases A and C)
constexpr int MAXC = 8;     // virtual channels
constexpr int NODE_SCAL = 12 + 4 * MAXC;   // per-node scalars (see below)

// the stacked weights, in layer_pipeline._WKEYS order
enum WKey {
  E_W1, E_B1, E_W2, E_B2, E_W3, E_B3, E_W4,
  EV_K0, EV_B0, EV_K1, EV_B1, XV_K0, XV_B0, XV_K1, X_K0, X_B0, X_K1,
  V_K0, V_B0, V_K1, V_B1, H_K0, H_B0, H_K1, H_B1,
  HV_K0, HV_B0, HV_K1, HV_B1, G_K0, G_B0, G_K1, G_B1, N_WKEYS
};

// the operands, in layer_pipeline._PTRS order, then the weights, then the
// dimensions; every per-graph array has a leading B axis
struct StackArgs {
  const int* row_t;     // [B, E/T, T]
  const int* col_l;     // [B, E]
  const int* kblk;      // [B, E]
  const float* scal;    // [B, E, XL]
  const int* rr;        // [B, R]
  const int* rc;        // [B, R]
  const float* rattr;   // [B, R, 2]
  const float* rmask;   // [B, R]
  const float* h0;      // [B, N, H]
  const float* x0;      // [B, N, 3]
  const float* v;       // [B, N, 3]
  const float* X0;      // [B, 3, C]
  const float* Hv0;     // [B, H, C]
  const float* nm;      // [B, N]
  const float* nattr;   // [B, N, A] or null
  const float* gvec;    // [3] or null
  float* S_h;           // [B, L+1, N, H]
  float* S_x;           // [B, L+1, N, 3]
  float* S_X;           // [B, L+1, 3, C]
  float* S_Hv;          // [B, L+1, H, C]
  void* hr;             // [B, N, H] compute dtype
  void* hc;             // [B, N, H] compute dtype
  float* agg;           // [B, N, H+8] hi 3, lo 3, count, -, ef H
  float* rtr;           // [B, N, 4] remote translation sums
  float* part_cm;       // [2, B, N/NT, 4]
  float* part_tX;       // [B, N/NT, 3C]
  float* part_Hv;       // [B, N/NT, C*H]
  const float* w[N_WKEYS];
  int B, N, E, R, T, L, C, A, has_grav, residual, coords_mean, n_sm;
};
constexpr int N_PTRS = 27;
constexpr int N_DIMS = 12;

// Block shapes: f32 blocks are the f32 edge tile's 128 threads, bf16 blocks
// the tensor-core tile's 256. An f32 node product's pass over a tile's 16
// rows (its nodes, or one channel of them) gives thread (tr, tc) = (tid /
// 16, tid % 16) the rows tr + TR i (i < RB) and the columns tc * CPT ..
// tc * CPT + CPT - 1. MIN_BLOCKS is the co-resident blocks an SM the
// registers are bounded for: 3 for f32 (serving: 4 graphs keep every SM
// busy in phase C), 2 for bf16 (at 3 its products spilled ~2 KB a thread
// and a train launch ran 18 % slower).
template <bool BF16>
struct Blk {
  static constexpr int NTHR = BF16 ? THREADS : F32_THREADS;
  static constexpr int TR = NTHR / 16;
  static constexpr int RB = NT / TR;
  static constexpr int MIN_BLOCKS = BF16 ? 2 : 3;
};

// one layer's slice of stacked weight `k`
template <int H>
__device__ __forceinline__ const float* wl(const StackArgs& a, int k, int l) {
  const int C = a.C, A = a.A;
  size_t n;
  switch (k) {
    case E_W1: n = (size_t)(2 * H + 3) * H; break;
    case EV_K0: n = (size_t)(2 * H + 1 + C) * H; break;
    case H_K0: n = (size_t)(3 * H + A) * H; break;
    case HV_K0: n = (size_t)2 * H * H; break;
    case E_W2: case E_W3: case EV_K1: case XV_K0: case X_K0: case V_K0:
    case H_K1: case HV_K1: case G_K0:
      n = (size_t)H * H; break;
    case V_B1: case G_B1: n = 1; break;
    default: n = H; break;   // row biases, e_w4 and the [H, 1] heads
  }
  return a.w[k] + (size_t)l * n;
}

__host__ __device__ constexpr size_t r4(size_t n) { return (n + 3) & ~(size_t)3; }

// ---------------------------------------------------- node-phase smem

// per-node scalars in Node
enum { NX = 0, NV = 3, NAGG = 6, NNM = 9, NVS = 10, NGS = 11, NVRAD = 12,
       NVCD = 12 + MAXC };

template <int H, bool BF16>
struct NodeSmem {
  static constexpr int LD = H + 4;              // activation row stride
  static constexpr int NTHR = Blk<BF16>::NTHR;
  // rows of the weight buffer: f32 blocks (3 an SM) hold a chunk of at most
  // H + 1 + MAXC rows; bf16 blocks (2 an SM, room to spare) a whole dense
  // layer, phi_h's 3H + A rows being the largest
  __host__ __device__ static int wrows(int A) {
    return BF16 ? 3 * H + A : H + 1 + MAXC;
  }
  int WR;        // wrows(A)
  float* W;      // [WR, H] one staged weight chunk (bf16 blocks' tensor-core
                 //   phase C: [WR, H + 4])
  float* Vb;     // [H] the layer's bias
  float* Vh;     // [H + 4] an [H, 1] head and its bias at [H]
  float* Hrow;   // [NT, LD] the layer-input h rows (f32)
  float* HrowR;  // [NT, LD] the same in the compute dtype (= Hrow in f32)
  float* Aggh;   // [NT, LD] agg_h (compute dtype); phase D's hidden rows
  float* Aggv;   // [NT, LD] agg_v (compute dtype)
  float* Act;    // [NT*C, LD] hidden activations, rows c * NT + n
  float* Vef;    // [NT*C, LD] vef (masked)
  float* Nat;    // [NT, A] node attributes (compute dtype)
  float* Node;   // [NT, NODE_SCAL]: x 3, v 3, aggx 3, nm, vs, gs,
                 //   |vcd| MAXC (compute dtype), vcd 3*MAXC ([d][c])
  float* HvT;    // [MAXC, H] the layer-input Hv^T (compute dtype)
  float* MX;     // [MAXC, MAXC] m_X (compute dtype)
  float* X;      // [3, MAXC] the layer-input X ([d * C + c])
  float* Px;     // [NT*C] phi_xv
  float* PX;     // [NT*C] phi_X
  float* Glob;   // coord mean 3, count, gvec 3, -, sums 4, -
  float* Red;    // [NTHR] reduction scratch
  float* Qv;     // bf16 blocks: [MAXC, H] Hv^T[c] @ ev_k0[H:2H]
  float* HRed;   // bf16 blocks: [H / 8, NT * MAXC] the heads' column sums

  __host__ __device__ static size_t floats(int C, int A) {
    const size_t R = (size_t)NT * C;
    return r4((size_t)wrows(A) * (H + 4)) + r4(H) + r4(H + 4) +
           (size_t)(BF16 ? 4 : 3) * NT * LD + 2 * R * LD + r4((size_t)NT * A) +
           r4((size_t)NT * NODE_SCAL) + (size_t)MAXC * H + r4(MAXC * MAXC) +
           r4(3 * MAXC) + 2 * r4(R) + 16 + NTHR +
           (BF16 ? (size_t)MAXC * H + (size_t)(H / 8) * NT * MAXC : 0);
  }

  __device__ NodeSmem(float* p, int C, int A) {
    const size_t R = (size_t)NT * C;
    auto take = [&p](size_t n) {
      float* q = p;
      p += r4(n);
      return q;
    };
    WR = wrows(A);
    W = take((size_t)WR * (H + 4));
    Vb = take(H);
    Vh = take(H + 4);
    Hrow = take((size_t)NT * LD);
    HrowR = BF16 ? take((size_t)NT * LD) : Hrow;
    Aggh = take((size_t)NT * LD);
    Aggv = take((size_t)NT * LD);
    Act = take(R * LD);
    Vef = take(R * LD);
    Nat = take((size_t)NT * A);
    Node = take((size_t)NT * NODE_SCAL);
    HvT = take((size_t)MAXC * H);
    MX = take(MAXC * MAXC);
    X = take(3 * MAXC);
    Px = take(R);
    PX = take(R);
    Glob = take(16);
    Red = take(NTHR);
    Qv = BF16 ? take((size_t)MAXC * H) : nullptr;
    HRed = BF16 ? take((size_t)(H / 8) * NT * MAXC) : nullptr;
  }
};

// acc[i][c] += sum_{k < KN} in(i, k) * Wc[k][tc * CPT + c] over a thread's
// NR rows, k in order, one fmaf per term (Wc: a staged chunk, row stride
// H); KN fixed, unrolled so that the loads run ahead of the products
template <int H, int NR, int KN, class In>
__device__ __forceinline__ void mm_k(float (&acc)[NR][H / 16], const float* Wc,
                                     In in) {
  constexpr int CPT = H / 16;
  const float* pw = Wc + (threadIdx.x & 15) * CPT;
#pragma unroll 16
  for (int k = 0; k < KN; ++k) {
    float w[CPT];
    load_cols<CPT>(w, pw + k * H);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float x = in(i, k);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(x, w[c], acc[i][c]);
    }
  }
}

// the same over a run-time kn
template <int H, int NR, class In>
__device__ __forceinline__ void mm(float (&acc)[NR][H / 16], const float* Wc,
                                   int kn, In in) {
  constexpr int CPT = H / 16;
  const float* pw = Wc + (threadIdx.x & 15) * CPT;
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    float w[CPT];
    load_cols<CPT>(w, pw + k * H);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float x = in(i, k);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(x, w[c], acc[i][c]);
    }
  }
}

template <int CPT>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[CPT]) {
  if constexpr (CPT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CPT; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else if constexpr (CPT % 2 == 0) {
#pragma unroll
    for (int c = 0; c < CPT; c += 2)
      *reinterpret_cast<float2*>(p + c) = make_float2(v[c], v[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) p[c] = v[c];
  }
}

// rows x H floats of a weight into shared memory at row stride ld (a
// multiple of 4), rounded to the compute dtype
template <int H, bool BF16>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int rows, int ld) {
  constexpr int NTHR = Blk<BF16>::NTHR, Q = H / 4;
  if (((uintptr_t)src & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * Q; i += NTHR) {
      const int r = i / Q, c = i - r * Q;
      float4 v = __ldg(s4 + i);
      v.x = rnd<BF16>(v.x);
      v.y = rnd<BF16>(v.y);
      v.z = rnd<BF16>(v.z);
      v.w = rnd<BF16>(v.w);
      *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < rows * H; i += NTHR)
      dst[(i / H) * ld + i % H] = rnd<BF16>(__ldg(src + i));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16 blocks, one warp: acc += A[0:16, 0:K] @ W[0:K, n0:n0+8] as mma.sync
// m16n8k16, f32 accumulation. A (row stride lda) and W (row stride ldw)
// are f32 tiles whose values are bf16 numbers, so the fragments' bf16
// conversion is exact; acc is the m16n8 fragment (rows g, g + 8; columns
// n0 + 2t, n0 + 2t + 1 with g = lane / 4, t = lane % 4).
template <int K>
__device__ __forceinline__ void tc_mm(float (&acc)[4], const float* A,
                                      int lda, const float* W, int ldw,
                                      int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const float* pa = A + g * lda + k0 + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(pa);
    const float2 x1 = *reinterpret_cast<const float2*>(pa + 8 * lda);
    const float2 x2 = *reinterpret_cast<const float2*>(pa + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(pa + 8 * lda + 8);
    const uint32_t af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                            pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
    const float* pw = W + (k0 + 2 * t) * ldw + n0 + g;
    mma_bf16(acc, af, pack_bf16(pw[0], pw[ldw]),
             pack_bf16(pw[8 * ldw], pw[9 * ldw]));
  }
}

// the sum of s over the 16 threads of a row group (one half-warp)
__device__ __forceinline__ float row_sum(float s) {
#pragma unroll
  for (int d = 8; d >= 1; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  return s;
}

// A dense layer's epilogue over a 16-row pass whose rows start at row0
// (row0 + n for node n = tr + TR i): y = act(dense_pre(acc, Vb[j])) into
// out (row stride LD), and with a head (hv != nullptr) its [H, 1] product
// reduced over the row into head_out[(row0 + n) * head_ld] (rnd of the sum,
// plus the rounded bias hb when HB). `scale` multiplies each stored row by
// scale[n * scale_ld] (the node mask), when given.
template <int H, bool BF16, bool SILU, bool HB>
__device__ __forceinline__ void epilogue(
    const NodeSmem<H, BF16>& s, const float (&acc)[Blk<BF16>::RB][H / 16],
    int row0, float* out, const float* scale, int scale_ld, const float* hv,
    float hb, float* head_out, int head_ld) {
  constexpr int RB = Blk<BF16>::RB, TR = Blk<BF16>::TR, CPT = H / 16;
  constexpr int LD = NodeSmem<H, BF16>::LD;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int n = tr + TR * i, r = row0 + n;
    const float m = scale != nullptr ? scale[n * scale_ld] : 1.f;
    float y[CPT];
    float hs = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = tc * CPT + c;
      float t = dense_pre<BF16>(acc[i][c], s.Vb[j]);
      if (SILU) t = silu<BF16>(t);
      if (hv != nullptr) hs = fmaf(t, hv[j], hs);
      y[c] = t * m;
    }
    if (out != nullptr) store_cols<CPT>(out + (size_t)r * LD + tc * CPT, y);
    if (hv != nullptr) {
      hs = row_sum(hs);
      if (tc == 0)
        head_out[(size_t)r * head_ld] =
            HB ? dense_pre<BF16>(hs, hb) : rnd<BF16>(hs);
    }
  }
}

// sum_t p[t * 4 + v] for v < 4 over the ntile tile partials, in a fixed
// order (thread slices, then the slices in order) into out[0..3]
template <bool BF16>
__device__ __forceinline__ void sum_cm(const float* p, int ntile, float* red,
                                       float* out) {
  constexpr int NTHR = Blk<BF16>::NTHR;
  const int tid = threadIdx.x;
  {
    const int v = tid & 3, sl = tid >> 2;
    float acc = 0.f;
    for (int t = sl; t < ntile; t += NTHR / 4) acc += p[(size_t)t * 4 + v];
    red[tid] = acc;
  }
  __syncthreads();
  if (tid < 4) {
    float acc = 0.f;
    for (int sl = 0; sl < NTHR / 4; ++sl) acc += red[sl * 4 + tid];
    out[tid] = acc;
  }
  __syncthreads();
}

// ------------------------------------------------------------ phase A

// a phase-A tile's rows: h in the compute dtype into HrowR, the aggregate
// rows zeroed, the tile's partial of the masked coordinate sum and node
// count, and at l = 0 the inputs copied into checkpoint slot 0
template <int H, bool BF16>
__device__ void tile_a_rows(const StackArgs& a, const NodeSmem<H, BF16>& s,
                            int l, int b, int tile, size_t gn, size_t slot,
                            const float* h_in, const float* x_in) {
  constexpr int NTHR = Blk<BF16>::NTHR, LD = NodeSmem<H, BF16>::LD;
  constexpr int FA = H + 8;
  const int tid = threadIdx.x, ntile = a.N / NT;
  for (int i = tid; i < NT * H; i += NTHR) {
    const int n = i / H, j = i - n * H;
    const float hv = h_in[i];
    s.HrowR[n * LD + j] = rnd<BF16>(hv);
    if (l == 0) a.S_h[slot * H + i] = hv;
  }
  for (int i = tid; i < NT * FA; i += NTHR) a.agg[gn * FA + i] = 0.f;
  for (int i = tid; i < NT * 4; i += NTHR) a.rtr[gn * 4 + i] = 0.f;
  if (l == 0)
    for (int i = tid; i < NT * 3; i += NTHR) a.S_x[slot * 3 + i] = x_in[i];
  if (tid < 4) {
    float acc = 0.f;
    for (int n = 0; n < NT; ++n) {
      const float m = a.nm[gn + n];
      acc += tid < 3 ? x_in[n * 3 + tid] * m : m;
    }
    a.part_cm[(((size_t)(l & 1) * a.B + b) * ntile + tile) * 4 + tid] = acc;
  }
}

template <int H, bool BF16>
__device__ void phase_a(const StackArgs& a, const NodeSmem<H, BF16>& s,
                        int l) {
  using NS = NodeSmem<H, BF16>;
  constexpr int NTHR = Blk<BF16>::NTHR, TR = Blk<BF16>::TR;
  constexpr int RB = Blk<BF16>::RB, CPT = H / 16, LD = NS::LD;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int N = a.N, C = a.C, L = a.L;
  const int ntile = N / NT, items = a.B * ntile;

  // at l = 0 graph b's X and Hv into slot 0, by the block of its phase D
  if (l == 0)
    for (int b = gridDim.x - 1 - blockIdx.x; b < a.B; b += gridDim.x) {
      float* SX = a.S_X + (size_t)b * (L + 1) * 3 * C;
      float* SHv = a.S_Hv + (size_t)b * (L + 1) * H * C;
      for (int i = tid; i < 3 * C; i += NTHR) SX[i] = a.X0[(size_t)b * 3 * C + i];
      for (int i = tid; i < H * C; i += NTHR)
        SHv[i] = a.Hv0[(size_t)b * H * C + i];
    }
  if ((int)blockIdx.x >= items) return;

  // hr with e_w1's rows [0, H), hc with rows [H, 2H). bf16 blocks stage
  // both at once (row stride H + 4) and run them on the tensor cores (warp
  // w: column tile w % (H / 8) of the products w / (H / 8), w / (H / 8) +
  // 8 / (H / 8)); f32 blocks stage one after the other (the tiles' h rows
  // read again for the second), each once a block, as f32 FMA products
  const float* w1 = wl<H>(a, E_W1, l);
  if constexpr (BF16) {
    constexpr int NB = H / 8, MS = 8 / NB, WLD = H + 4;
    const int lane = tid & 31, warp = tid >> 5, g = lane >> 2;
    const int cn0 = (warp % NB) * 8, j0 = cn0 + 2 * (lane & 3);
    __syncthreads();
    stage_rows<H, true>(s.W, w1, 2 * H, WLD);
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int b = it / ntile, tile = it - b * ntile, n0 = tile * NT;
      const size_t gn = (size_t)b * N + n0;
      const size_t slot = (size_t)b * (L + 1) * N + n0;
      const float* h_in = l == 0 ? a.h0 + gn * H : a.S_h + (slot + (size_t)l * N) * H;
      const float* x_in = l == 0 ? a.x0 + gn * 3 : a.S_x + (slot + (size_t)l * N) * 3;
      __syncthreads();   // the staged weights; the previous tile's rows read
      tile_a_rows<H, BF16>(a, s, l, b, tile, gn, slot, h_in, x_in);
      __syncthreads();
      for (int q = warp / NB; q < 2; q += MS) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        tc_mm<H>(acc, s.HrowR, LD, s.W + q * H * WLD, WLD, cn0);
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(q ? a.hc : a.hr);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(dst + (gn + g + 8 * h) * H + j0) =
              __floats2bfloat162_rn(acc[2 * h], acc[2 * h + 1]);
      }
    }
  } else {
    for (int half = 0; half < 2; ++half) {
      __syncthreads();   // the chunk is free
      stage_rows<H, BF16>(s.W, w1 + (size_t)half * H * H, H, H);
      float* dst = static_cast<float*>(half ? a.hc : a.hr);
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int b = it / ntile, tile = it - b * ntile, n0 = tile * NT;
        const size_t gn = (size_t)b * N + n0;   // the tile's first node
        const size_t slot = (size_t)b * (L + 1) * N + n0;
        const float* h_in = l == 0 ? a.h0 + gn * H : a.S_h + (slot + (size_t)l * N) * H;
        const float* x_in = l == 0 ? a.x0 + gn * 3 : a.S_x + (slot + (size_t)l * N) * 3;
        __syncthreads();   // the staged chunk; the previous tile's rows read
        if (half == 0) {
          tile_a_rows<H, BF16>(a, s, l, b, tile, gn, slot, h_in, x_in);
        } else {
          for (int i = tid; i < NT * H; i += NTHR)
            s.HrowR[(i / H) * LD + i % H] = h_in[i];
        }
        __syncthreads();
        float acc[RB][CPT] = {};
        const float* hrow = s.HrowR;
        mm_k<H, RB, H>(acc, s.W, [=](int i, int k) {
          return hrow[(tr + TR * i) * LD + k];
        });
#pragma unroll
        for (int i = 0; i < RB; ++i)
          store_cols<CPT>(dst + (gn + tr + TR * i) * H + tc * CPT, acc[i]);
      }
    }
  }
}

// ------------------------------------------------------------ phase B
//
// The work items: per graph its n_in in-window tiles, then its remote
// tiles; item i is graph i / per, tile i % per.

struct ItemFetch {
  EdgeFetch f;
  int b = 0;
  bool remote = false;
};

struct Items {
  int n_in, per, n_items, N, E, R, T, epb, smax;
  __device__ explicit Items(const StackArgs& a) {
    n_in = a.E / TE;
    per = n_in + a.R / TE;
    n_items = a.B * per;
    N = a.N;
    E = a.E;
    R = a.R;
    T = a.T;
    const int nb = N / T;
    epb = E / nb;
    smax = nb - 3 > 0 ? nb - 3 : 0;
  }

  // 1. the slot's layout fields (an item past the end: an inactive slot)
  __device__ void fields(const StackArgs& a, ItemFetch& q, int item,
                         int el) const {
    if (item >= n_items) {
      q.b = 0;
      q.remote = false;
      q.f.e = E;   // rows() leaves it inactive
      return;
    }
    q.b = item / per;
    const int t = item - q.b * per;
    q.remote = t >= n_in;
    const size_t b = q.b;
    if (!q.remote) {
      tc_fetch_fields(q.f, t, el, a.row_t + b * E, a.col_l + b * E,
                      a.kblk + b * E, a.scal + b * E * XL, E);
    } else {
      const size_t e = b * R + (size_t)(t - n_in) * TE + el;
      q.f.m = a.rmask[e];
      q.f.rl = a.rr[e];
      q.f.cl = a.rc[e];
      q.f.a0 = a.rattr[2 * e];
      q.f.a1 = a.rattr[2 * e + 1];
    }
  }

  __device__ const float* x_of(const StackArgs& a, int b, int l) const {
    return a.S_x + (((size_t)b * (a.L + 1) + l) * N) * 3;
  }

  // a remote slot's row / col and x rows
  __device__ void remote_rows(ItemFetch& q, const float* x) const {
    EdgeFetch& f = q.f;
    f.row = f.m > 0.f ? f.rl : -1;
    f.col = f.row >= 0 ? f.cl : 0;
    if (f.row >= 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        f.xr[k] = x[3 * (size_t)f.row + k];
        f.xc[k] = x[3 * (size_t)f.col + k];
      }
    }
  }

  // 2. (f32 tile) the slot's global row / col and its x rows
  __device__ void rows_f32(const StackArgs& a, ItemFetch& q, int l) const {
    const float* x = x_of(a, q.b, l);
    if (q.remote) {
      remote_rows(q, x);
    } else {
      f32_fetch_rows(q.f, x, E, T, epb, smax);
    }
  }

  // 2. (tensor-core tile) the same, and its hr / hc rows by cp.async
  template <int H>
  __device__ void rows_tc(const StackArgs& a, ItemFetch& q, int el,
                          __nv_bfloat16* sHr, __nv_bfloat16* sHc,
                          int l) const {
    const float* x = x_of(a, q.b, l);
    const __nv_bfloat16* hr =
        static_cast<const __nv_bfloat16*>(a.hr) + (size_t)q.b * N * H;
    const __nv_bfloat16* hc =
        static_cast<const __nv_bfloat16*>(a.hc) + (size_t)q.b * N * H;
    if (!q.remote) {
      tc_fetch_rows<H>(q.f, el, sHr, sHc, x, hr, hc, E, T, epb, smax);
      return;
    }
    remote_rows(q, x);
    if (q.f.row >= 0) {
#pragma unroll
      for (int p = 0; p < H / 8; ++p) {
        cp_async16(sHr + el * H + 8 * p, hr + (size_t)q.f.row * H + 8 * p);
        cp_async16(sHc + el * H + 8 * p, hc + (size_t)q.f.col * H + 8 * p);
      }
    }
  }
};

// A remote tile's row side: the unrounded per-edge [trans 3, 1, ef H]
// (get(c, el), c < H + 4) summed by row segment, each in edge order, one
// f32 atomicAdd per (segment, column): trans into rtr [N, 4], the count
// into agg column 6, ef into agg columns 8.. (the remote tail of
// fwd_aggregate_remote). Tasks are (column, segment) pairs.
template <int H, int NTHR, class Get>
__device__ __forceinline__ void remote_row_side(const EdgeBuf& E,
                                                const unsigned* start,
                                                Get get, float* agg,
                                                float* rtr) {
  constexpr int F = H + 4;
  const unsigned long long starts =
      ((unsigned long long)start[1] << 32) | start[0];
  const int nseg = __popcll(starts);
  for (int t = threadIdx.x; t < nseg * F; t += NTHR) {
    const int c = t / nseg, sg = t - c * nseg;
    unsigned long long m = starts;
    for (int i = 0; i < sg; ++i) m &= m - 1;
    const int e0 = __ffsll((long long)m) - 1;
    m &= m - 1;
    const int e1 = m ? __ffsll((long long)m) - 1 : TE;
    float acc = 0.f;
    for (int el = e0; el < e1; ++el)
      if (E.row[el] >= 0) acc += get(c, el);
    const size_t row = E.row[e0];
    float* dst = c < 3 ? rtr + row * 4 + c
                       : agg + row * (H + 8) + (c == 3 ? 6 : 8 + (c - 4));
    atomicAdd(dst, acc);
  }
}

// f32: fused_edge_fwd_f32_kernel's tile over the work items (see
// fused_edge_fwd.cu for its phases)
template <int H>
__device__ void phase_b_f32(const StackArgs& a, float* smem, int l) {
  using L = F32Layout<H>;
  constexpr int CW = L::CW;
  constexpr int EDGE = L::EDGE;
  float* sW2 = smem;
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
  unsigned* sStart = sAct + 4;

  const int tid = threadIdx.x;
  const int te = tid >> 4, tc = tid & 15;
  const bool stager = tid < TE;
  const Items its(a);
  if ((int)blockIdx.x >= its.n_items) return;

  const float* w1 = wl<H>(a, E_W1, l);
  f32_load_weights<H>(sW2, sW3, sWs, w1 + 2 * H * H, wl<H>(a, E_B1, l),
                      wl<H>(a, E_W2, l), wl<H>(a, E_B2, l),
                      wl<H>(a, E_W3, l), wl<H>(a, E_B3, l),
                      wl<H>(a, E_W4, l));
  if (stager) {
    ItemFetch q;
    its.fields(a, q, blockIdx.x, tid);
    its.rows_f32(a, q, l);
    f32_store_edge(EdgeBuf(sEdge, sAct), q.f, tid);
  }

  int cur = 0;
  for (int item = blockIdx.x; item < its.n_items;
       item += gridDim.x, cur ^= 1) {
    __syncthreads();  // this tile staged, the previous one fully consumed
    const EdgeBuf E(sEdge + cur * EDGE * TE, sAct + 2 * cur);
    const EdgeBuf next(sEdge + (cur ^ 1) * EDGE * TE, sAct + 2 * (cur ^ 1));
    if (!(E.act[0] | E.act[1])) {   // all-padding tile
      if (stager) {
        ItemFetch q;
        its.fields(a, q, item + gridDim.x, tid);
        its.rows_f32(a, q, l);
        f32_store_edge(next, q.f, tid);
      }
      continue;
    }
    const int b = item / its.per;
    const bool remote = item - b * its.per >= its.n_in;
    const float* hr = static_cast<const float*>(a.hr) + (size_t)b * a.N * H;
    const float* hc = static_cast<const float*>(a.hc) + (size_t)b * a.N * H;
    ItemFetch nf;
    if (stager) {
      its.fields(a, nf, item + gridDim.x, tid);
      tc_mark_segment_starts(E, sStart);
    }

    // ---- 1. t1 and y1 = silu(t1), one edge and H/8 column quads a thread
    {
      constexpr int NI = H / 8;
      constexpr int PB = NI <= 8 ? NI : NI / 2;
      const int el = tid % TE, q0 = tid / TE;
      const int row = E.row[el];
      const float* hrr = hr + (size_t)(row >= 0 ? row : 0) * H;
      const float* hcr = hc + (size_t)E.col[el] * H;
      const float f0 = E.sf[3 * el], f1 = E.sf[3 * el + 1],
                  f2 = E.sf[3 * el + 2];
#pragma unroll
      for (int m0 = 0; m0 < NI; m0 += PB) {
        float4 va[PB], vb[PB];
#pragma unroll
        for (int u = 0; u < PB; ++u) {
          const int j0 = 4 * (q0 + 2 * (m0 + u));
          if (row >= 0) {
            va[u] = *reinterpret_cast<const float4*>(hrr + j0);
            vb[u] = *reinterpret_cast<const float4*>(hcr + j0);
          }
        }
#pragma unroll
        for (int u = 0; u < PB; ++u) {
          const int j0 = 4 * (q0 + 2 * (m0 + u));
          float y[4] = {0.f, 0.f, 0.f, 0.f};
          if (row >= 0) {
            const float hv[4] = {va[u].x + vb[u].x, va[u].y + vb[u].y,
                                 va[u].z + vb[u].z, va[u].w + vb[u].w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = j0 + q;
              const float sw =
                  fmaf(f2, sWs[2 * H + j], fmaf(f1, sWs[H + j], f0 * sWs[j]));
              y[q] = f32_silu((hv[q] + sw) + sB1[j]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) sT[(j0 + q) * F32_LDT + el] = y[q];
        }
      }
    }
    if (stager) its.rows_f32(a, nf, l);
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
#pragma unroll
        for (int r = 0; r < 8; ++r)
          v[r] = on[r] ? f32_silu(acc[r][c] + sB2[j]) : 0.f;
        float* p = sT + j * F32_LDT + 8 * te;
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(p + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    if (stager) f32_store_edge(next, nf.f, tid);
    __syncthreads();

    // ---- 3. y2 = silu(ef w3 + b3); g = sum_j y2 * w4; the payload lanes
    {
      float acc[8][CW];
      f32_tile_mm<H>(sT, sW3, acc);
      float gs[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        gs[r] = 0.f;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = tc + 16 * c;
          const float y2 = f32_silu(acc[r][c] + sB3[j]);
          gs[r] = __fadd_rn(gs[r], __fmul_rn(y2, sW4[j]));
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int d = 8; d >= 1; d >>= 1)
          gs[r] = __fadd_rn(gs[r], __shfl_xor_sync(0xffffffffu, gs[r], d));
      if (tc == 0) {
        if (remote) {   // the remote tail's unsplit trans
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int el = 8 * te + r;
            const bool on = E.row[el] >= 0;
#pragma unroll
            for (int k = 0; k < 3; ++k)
              sP[k * TE + el] = on ? __fmul_rn(E.cd[3 * el + k], gs[r]) : 0.f;
          }
        } else {
          f32_store_payload(E, gs, te, sP);
        }
      }
    }
    __syncthreads();

    // ---- 4. the row side
    float* agg = a.agg + (size_t)b * a.N * (H + 8);
    if (remote) {
      remote_row_side<H, F32_THREADS>(
          E, sStart,
          [&](int c, int el) {
            return c < 3 ? sP[c * TE + el]
                         : (c == 3 ? 1.f : sT[(c - 4) * F32_LDT + el]);
          },
          agg, a.rtr + (size_t)b * a.N * 4);
    } else {
      f32_row_side<H>(E, sStart, sP, sT, agg);
    }
  }
}

// bf16 at H in {16, 32, 64}: fused_edge_fwd_tc_kernel's tile over the work
// items (see fused_edge_fwd.cu for its phases), plus an f32 [3, TE] tile of
// a remote tile's translations
template <int H>
struct StackTcLayout : TcTiles<H> {
  using B = TcTiles<H>;
  static constexpr int EDGE = EdgeBuf::kWords(false);
  static constexpr size_t kBytes =
      (size_t)(2 * B::WT + B::PAY + B::TILE + 2 * TE * H) * 2 +
      (size_t)(7 * H + 2 * TE + 3 * TE) * 4 + (size_t)2 * TE * EDGE * 4 +
      6 * 4 + TE * 4;
};

template <int H>
__device__ void phase_b_tc(const StackArgs& a, float* smem, int l) {
  using L = StackTcLayout<H>;
  constexpr int LDS = L::LDS;
  constexpr int LDP = L::LDP;
  constexpr int NTM = L::NTM;
  static_assert(THREADS == 256 && TE == 64, "8 warps over 64-edge tiles");
  static_assert(NTM == 1 || NTM % 2 == 0, "n8 tiles in pairs");

  unsigned char* raw = reinterpret_cast<unsigned char*>(smem);
  __nv_bfloat16* sW2 = reinterpret_cast<__nv_bfloat16*>(raw);  // [k][j]
  __nv_bfloat16* sW3 = sW2 + L::WT;
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
  float* sTr = sGp + 2 * TE;            // [3, TE] a remote tile's trans
  int* sEdge = reinterpret_cast<int*>(sTr + 3 * TE);
  unsigned* sAct = reinterpret_cast<unsigned*>(sEdge + 2 * L::EDGE * TE);
  unsigned* sStart = sAct + 4;
  int* sSegRow = reinterpret_cast<int*>(sStart + 2);   // [TE] segment -> row

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = 16 * (warp & 3), half = warp >> 2, n0 = half * (H / 2);
  const int er0 = m0 + (lane >> 2), er1 = er0 + 8;
  const int jc = n0 + 2 * (lane & 3);
  const bool stager = tid >= TE && tid < 2 * TE;
  const int sel = tid - TE;
  const Items its(a);
  if ((int)blockIdx.x >= its.n_items) return;

  const float* w1 = wl<H>(a, E_W1, l);
  const float* w2 = wl<H>(a, E_W2, l);
  const float* w3 = wl<H>(a, E_W3, l);
  for (int i = tid; i < H * H; i += THREADS) {
    const int k = i / H, j = i % H;
    sW2[k * LDS + j] = __float2bfloat16_rn(w2[i]);
    sW3[k * LDS + j] = __float2bfloat16_rn(w3[i]);
  }
  {
    const float* ws = w1 + 2 * H * H;
    const float* b1 = wl<H>(a, E_B1, l);
    const float* b2 = wl<H>(a, E_B2, l);
    const float* b3 = wl<H>(a, E_B3, l);
    const float* w4 = wl<H>(a, E_W4, l);
    for (int i = tid; i < 3 * H; i += THREADS) sWs[i] = round_bf16(ws[i]);
    for (int i = tid; i < H; i += THREADS) {
      sB1[i] = round_bf16(b1[i]);
      sB2[i] = round_bf16(b2[i]);
      sB3[i] = round_bf16(b3[i]);
      sW4[i] = w4[i];
    }
  }

  if (tid < TE) {
    ItemFetch q;
    its.fields(a, q, blockIdx.x, tid);
    its.rows_tc<H>(a, q, tid, sHr, sHc, l);
    tc_store_edge<H, false>(EdgeBuf(sEdge, sAct), q.f, tid, nullptr);
  }
  cp_async_wait_all();

  int cur = 0;
  for (int item = blockIdx.x; item < its.n_items;
       item += gridDim.x, cur ^= 1) {
    __syncthreads();  // this tile staged, the previous one fully consumed
    const EdgeBuf E(sEdge + cur * L::EDGE * TE, sAct + 2 * cur);
    const EdgeBuf next(sEdge + (cur ^ 1) * L::EDGE * TE,
                       sAct + 2 * (cur ^ 1));
    if (!(E.act[0] | E.act[1])) {   // all-padding tile
      if (tid < TE) {
        ItemFetch q;
        its.fields(a, q, item + gridDim.x, tid);
        its.rows_tc<H>(a, q, tid, sHr, sHc, l);
        tc_store_edge<H, false>(next, q.f, tid, nullptr);
      }
      cp_async_wait_all();
      continue;
    }
    const int b = item / its.per;
    const bool remote = item - b * its.per >= its.n_in;
    ItemFetch nf;
    if (stager) its.fields(a, nf, item + gridDim.x, sel);

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
          const float2 va = __bfloat1622float2(pr[q]);
          const float2 vc = __bfloat1622float2(pc[q]);
          const float hv[2] = {va.x + vc.x, va.y + vc.y};
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
      its.rows_tc<H>(a, nf, sel, sHr, sHc, l);

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
      float acc[NTM][4] = {};
      warp_mm<LDP, LDS, NTM, false, true>(tEF, sW3, m0, n0, 0, H / 16, acc);
      float gsum[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < NTM; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = jc + 8 * t + u;
            const float t3 = dense_pre<true>(acc[t][2 * h + u], sB3[j]);
            const float y2 = silu_s(t3, sig_bf16(t3));
            gsum[h] = __fadd_rn(gsum[h], __fmul_rn(y2, sW4[j]));
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
    //      lo(trans), 1, 0] (a remote tile: trans unsplit into sTr) and
    //      the segment starts; warps 2-3: the next tile's slots
    if (tid < TE) {
      const int row = E.row[tid];
      tc_mark_segment_starts(E, sStart);
      float hl[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (row >= 0) {
        const float g = sGp[tid] + sGp[TE + tid];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float tr = __fmul_rn(E.cd[3 * tid + k], g);
          sTr[k * TE + tid] = tr;
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
      tc_store_edge<H, false>(next, nf.f, sel, nullptr);
    }
    __syncthreads();

    // ---- 5. the row side
    float* agg = a.agg + (size_t)b * a.N * (H + 8);
    if (remote) {
      remote_row_side<H, THREADS>(
          E, sStart,
          [&](int c, int el) {
            return c < 3 ? sTr[c * TE + el]
                         : (c == 3 ? 1.f
                                   : __bfloat162float(tEF[el * LDP + c - 4]));
          },
          agg, a.rtr + (size_t)b * a.N * 4);
    } else {
      tc_row_side<H, true>(E, sStart, sSegRow, tY1, tP, agg);
    }
    cp_async_wait_all();   // the next tile's rows have landed
  }
}

// ------------------------------------------------------------ phase C

// graph b's layer-l globals into s: the coordinate mean and node count (the
// phase-A tile partials), X, Hv^T, m_X (both in the compute dtype), gravity
template <int H, bool BF16>
__device__ void graph_globals(const StackArgs& a, const NodeSmem<H, BF16>& s,
                              int l, int b) {
  constexpr int NTHR = Blk<BF16>::NTHR;
  const int tid = threadIdx.x, C = a.C, L = a.L, ntile = a.N / NT;
  const float* X = a.S_X + ((size_t)b * (L + 1) + l) * 3 * C;
  const float* Hv = a.S_Hv + ((size_t)b * (L + 1) + l) * H * C;
  for (int i = tid; i < 3 * C; i += NTHR) s.X[i] = X[i];
  for (int i = tid; i < H * C; i += NTHR) {
    const int c = i / H, j = i - c * H;
    s.HvT[c * H + j] = rnd<BF16>(Hv[j * C + c]);
  }
  if (a.has_grav && tid < 3) s.Glob[4 + tid] = a.gvec[tid];
  sum_cm<BF16>(a.part_cm + (((size_t)(l & 1) * a.B + b) * ntile) * 4, ntile,
               s.Red, s.Glob + 8);
  if (tid == 0) {
    const float cnt = fmaxf(s.Glob[11], 1.f);
    s.Glob[3] = cnt;
    for (int d = 0; d < 3; ++d) s.Glob[d] = s.Glob[8 + d] / cnt;
  }
  __syncthreads();
  for (int i = tid; i < C * C; i += NTHR) {
    const int c = i / C, e = i - c * C;
    float acc = 0.f;
    for (int d = 0; d < 3; ++d)
      acc += (s.X[d * C + c] - s.Glob[d]) * (s.X[d * C + e] - s.Glob[d]);
    s.MX[c * C + e] = rnd<BF16>(acc);
  }
  __syncthreads();
}

// a tile's rows (phase C): per-node scalars (x, v, the mean translation,
// the mask, vcd and |vcd| per channel), h (f32 and in the compute dtype),
// agg_h (compute dtype), the node attributes
template <int H, bool BF16>
__device__ void tile_rows(const StackArgs& a, const NodeSmem<H, BF16>& s,
                          size_t gn, const float* x_in, const float* h_in) {
  constexpr int NTHR = Blk<BF16>::NTHR, LD = NodeSmem<H, BF16>::LD;
  constexpr int FA = H + 8;
  const int tid = threadIdx.x, C = a.C, A = a.A;
  if (tid < NT) {
    float* q = s.Node + tid * NODE_SCAL;
    const float* ag = a.agg + (gn + tid) * FA;
    const float* rt = a.rtr + (gn + tid) * 4;
    const float cnt = fmaxf(ag[6], 1.f);
    for (int d = 0; d < 3; ++d) {
      q[NX + d] = x_in[tid * 3 + d];
      q[NV + d] = a.v[(gn + tid) * 3 + d];
      const float ts = (ag[d] + ag[3 + d]) + rt[d];
      q[NAGG + d] = a.coords_mean ? ts / cnt : ts;
    }
    q[NNM] = a.nm[gn + tid];
    for (int c = 0; c < C; ++c) {
      float r2 = 0.f;
      for (int d = 0; d < 3; ++d) {
        const float vc = s.X[d * C + c] - q[NX + d];
        q[NVCD + d * MAXC + c] = vc;
        r2 += vc * vc;
      }
      q[NVRAD + c] = rnd<BF16>(sqrtf(r2));
    }
  }
  for (int i = tid; i < NT * H; i += NTHR) {
    const int n = i / H, j = i - n * H;
    const float* ag = a.agg + (gn + n) * FA;
    const float hv = h_in[i];
    s.Hrow[n * LD + j] = hv;
    if (BF16) s.HrowR[n * LD + j] = rnd<BF16>(hv);
    s.Aggh[n * LD + j] = rnd<BF16>(ag[8 + j] / fmaxf(ag[6], 1.f));
  }
  for (int i = tid; i < NT * A; i += NTHR)
    s.Nat[i] = rnd<BF16>(a.nattr[gn * A + i]);
}

// after phi_ev: agg_v = the mean of vef over the channels (rounded), and the
// tile's partial of agg_Hv (its nodes' masked vef, in node order)
template <int H, bool BF16>
__device__ void tile_vef_sums(const StackArgs& a, const NodeSmem<H, BF16>& s,
                              size_t part) {
  constexpr int NTHR = Blk<BF16>::NTHR, LD = NodeSmem<H, BF16>::LD;
  const int tid = threadIdx.x, C = a.C;
  for (int i = tid; i < NT * H; i += NTHR) {
    const int n = i / H, j = i - n * H;
    float sv = 0.f;
    for (int c = 0; c < C; ++c) sv += s.Vef[(c * NT + n) * LD + j];
    s.Aggv[n * LD + j] = rnd<BF16>(sv / C);
  }
  for (int i = tid; i < C * H; i += NTHR) {
    const int c = i / H, j = i - c * H;
    float acc = 0.f;
    for (int n = 0; n < NT; ++n)
      acc += s.Vef[(c * NT + n) * LD + j] * s.Node[n * NODE_SCAL + NNM];
    a.part_Hv[part * C * H + i] = acc;
  }
}

// after the heads: the x update into slot l+1 and the tile's trans_X
// partial
template <int H, bool BF16>
__device__ void tile_x_update(const StackArgs& a, const NodeSmem<H, BF16>& s,
                              size_t part, float* x_out) {
  constexpr int NTHR = Blk<BF16>::NTHR;
  const int tid = threadIdx.x, C = a.C;
  if (tid < NT * 3) {
    const int n = tid / 3, d = tid - 3 * n;
    const float* q = s.Node + n * NODE_SCAL;
    float xn = q[NX + d] + q[NAGG + d];
    float sv = 0.f;
    for (int c = 0; c < C; ++c)
      sv += -q[NVCD + d * MAXC + c] * s.Px[c * NT + n];
    xn = xn + sv / C;
    xn = xn + q[NVS] * q[NV + d];
    if (a.has_grav) xn = xn + q[NGS] * s.Glob[4 + d];
    x_out[n * 3 + d] = xn * q[NNM];
  }
  for (int i = tid; i < 3 * C; i += NTHR) {
    const int d = i / C, c = i - d * C;
    float acc = 0.f;
    for (int n = 0; n < NT; ++n) {
      const float* q = s.Node + n * NODE_SCAL;
      acc += q[NVCD + d * MAXC + c] * s.PX[c * NT + n] * q[NNM];
    }
    a.part_tX[part * 3 * C + i] = acc;
  }
}

// f32 blocks: register-blocked FMA products, k in order from 0
template <int H, bool BF16>
__device__ void phase_c(const StackArgs& a, const NodeSmem<H, BF16>& s,
                        int l) {
  using NS = NodeSmem<H, BF16>;
  constexpr int NTHR = Blk<BF16>::NTHR, TR = Blk<BF16>::TR;
  constexpr int RB = Blk<BF16>::RB, CPT = H / 16, LD = NS::LD;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int N = a.N, C = a.C, A = a.A, L = a.L;
  const int ntile = N / NT, items = a.B * ntile;
  // the node attributes' rows of phi_h ride with agg_v's when they fit
  const int a0 = A <= s.WR - H ? A : 0;

  // a dense layer's weight chunk (rows k0 .. k0 + kn of Wg) and, with it,
  // the bias / head vectors; every thread past a barrier on both sides
  auto begin = [&](const float* Wg, int k0, int kn, const float* bg,
                   const float* hg, const float* hbg) {
    __syncthreads();
    stage_rows<H, BF16>(s.W, Wg + (size_t)k0 * H, kn, H);
    if (bg != nullptr) stage_rows<H, BF16>(s.Vb, bg, 1, H);
    if (hg != nullptr) stage_rows<H, BF16>(s.Vh, hg, 1, H);
    if (hbg != nullptr && tid == 0) s.Vh[H] = rnd<BF16>(hbg[0]);
    __syncthreads();
  };

  // the rows of a pass over a tile's 16 rows from base
  auto node_rows = [&](const float* base) {
    return [=](int i, int k) { return base[(tr + TR * i) * LD + k]; };
  };

  int cur_b = -1;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / ntile, tile = it - b * ntile, n0 = tile * NT;
    const size_t gn = (size_t)b * N + n0;
    const size_t slot = (size_t)b * (L + 1) * N + n0;
    const float* h_in = a.S_h + (slot + (size_t)l * N) * H;
    const float* x_in = a.S_x + (slot + (size_t)l * N) * 3;
    float* h_out = a.S_h + (slot + (size_t)(l + 1) * N) * H;
    float* x_out = a.S_x + (slot + (size_t)(l + 1) * N) * 3;
    const float* ev_k0 = wl<H>(a, EV_K0, l);
    const float* h_k0 = wl<H>(a, H_K0, l);
    __syncthreads();   // the previous tile is done with the tiles
    if (b != cur_b) {
      graph_globals<H, BF16>(a, s, l, b);
      cur_b = b;
    }

    tile_rows<H, BF16>(a, s, gn, x_in, h_in);

    // ---- phi_ev: per channel c, [h, Hv^T[c], |vcd|_c, m_X[c]] @ ev_k0;
    //      the h part once per node, continued per channel in order
    float sh[RB][CPT] = {};
    begin(ev_k0, 0, H, wl<H>(a, EV_B0, l), nullptr, nullptr);
    mm_k<H, RB, H>(sh, s.W, node_rows(s.HrowR));
    begin(ev_k0, H, H + 1 + C, nullptr, nullptr, nullptr);
    const float* w_ev = s.W;   // rows H .. 2H + 1 + C of ev_k0
    for (int c = 0; c < C; ++c) {
      float acc[RB][CPT];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = sh[i][cc];
      const float* hvt = s.HvT + c * H;
      const float* vrad = s.Node + NVRAD + c;
      const float* mx = s.MX + c * C;
      mm_k<H, RB, H>(acc, w_ev, [=](int, int k) { return hvt[k]; });
      mm_k<H, RB, 1>(acc, w_ev + H * H, [=](int i, int) {
        return vrad[(tr + TR * i) * NODE_SCAL];
      });
      mm<H, RB>(acc, w_ev + (H + 1) * H, C, [=](int, int k) { return mx[k]; });
      epilogue<H, BF16, true, false>(s, acc, c * NT, s.Act, nullptr, 0,
                                     nullptr, 0.f, nullptr, 0);
    }
    // ---- vef = silu(. @ ev_k1 + ev_b1) * mask
    begin(wl<H>(a, EV_K1, l), 0, H, wl<H>(a, EV_B1, l), nullptr, nullptr);
    for (int c = 0; c < C; ++c) {
      float acc[RB][CPT] = {};
      mm_k<H, RB, H>(acc, s.W, node_rows(s.Act + c * NT * LD));
      epilogue<H, BF16, true, false>(s, acc, c * NT, s.Vef, s.Node + NNM,
                                     NODE_SCAL, nullptr, 0.f, nullptr, 0);
    }
    __syncthreads();
    tile_vef_sums<H, BF16>(a, s, (size_t)b * ntile + tile);

    // ---- the coordinate heads phi_xv and phi_X on vef
    begin(wl<H>(a, XV_K0, l), 0, H, wl<H>(a, XV_B0, l), wl<H>(a, XV_K1, l),
          nullptr);
    for (int c = 0; c < C; ++c) {
      float acc[RB][CPT] = {};
      mm_k<H, RB, H>(acc, s.W, node_rows(s.Vef + c * NT * LD));
      epilogue<H, BF16, true, false>(s, acc, c * NT, nullptr, nullptr, 0,
                                     s.Vh, 0.f, s.Px, 1);
    }
    begin(wl<H>(a, X_K0, l), 0, H, wl<H>(a, X_B0, l), wl<H>(a, X_K1, l),
          nullptr);
    for (int c = 0; c < C; ++c) {
      float acc[RB][CPT] = {};
      mm_k<H, RB, H>(acc, s.W, node_rows(s.Vef + c * NT * LD));
      epilogue<H, BF16, true, false>(s, acc, c * NT, nullptr, nullptr, 0,
                                     s.Vh, 0.f, s.PX, 1);
    }
    // ---- phi_v (and phi_g) on h
    {
      begin(wl<H>(a, V_K0, l), 0, H, wl<H>(a, V_B0, l), wl<H>(a, V_K1, l),
            wl<H>(a, V_B1, l));
      float acc[RB][CPT] = {};
      mm_k<H, RB, H>(acc, s.W, node_rows(s.HrowR));
      epilogue<H, BF16, true, true>(s, acc, 0, nullptr, nullptr, 0, s.Vh,
                                    s.Vh[H], s.Node + NVS, NODE_SCAL);
    }
    if (a.has_grav) {
      begin(wl<H>(a, G_K0, l), 0, H, wl<H>(a, G_B0, l), wl<H>(a, G_K1, l),
            wl<H>(a, G_B1, l));
      float acc[RB][CPT] = {};
      mm_k<H, RB, H>(acc, s.W, node_rows(s.HrowR));
      epilogue<H, BF16, true, true>(s, acc, 0, nullptr, nullptr, 0, s.Vh,
                                    s.Vh[H], s.Node + NGS, NODE_SCAL);
    }
    __syncthreads();
    tile_x_update<H, BF16>(a, s, (size_t)b * ntile + tile, x_out);

    // ---- phi_h on [h, agg_h, agg_v, node_attr] and the h update
    {
      float acc[RB][CPT] = {};
      begin(h_k0, 0, H, wl<H>(a, H_B0, l), nullptr, nullptr);
      mm_k<H, RB, H>(acc, s.W, node_rows(s.HrowR));
      begin(h_k0, H, H, nullptr, nullptr, nullptr);
      mm_k<H, RB, H>(acc, s.W, node_rows(s.Aggh));
      begin(h_k0, 2 * H, H + a0, nullptr, nullptr, nullptr);
      const float* w_v = s.W;   // agg_v's rows, then the node attributes'
      mm_k<H, RB, H>(acc, w_v, node_rows(s.Aggv));
      const float* nat = s.Nat;
      if (a0 > 0) {
        mm<H, RB>(acc, w_v + H * H, a0, [=](int i, int k) {
          return nat[(tr + TR * i) * A + k];
        });
      } else {
        for (int k0 = 0; k0 < A; k0 += s.WR) {
          const int kn = A - k0 < s.WR ? A - k0 : s.WR;
          begin(h_k0, 3 * H + k0, kn, nullptr, nullptr, nullptr);
          mm<H, RB>(acc, s.W, kn, [=](int i, int k) {
            return nat[(tr + TR * i) * A + k0 + k];
          });
        }
      }
      epilogue<H, BF16, true, false>(s, acc, 0, s.Act, nullptr, 0, nullptr,
                                     0.f, nullptr, 0);
    }
    {
      begin(wl<H>(a, H_K1, l), 0, H, wl<H>(a, H_B1, l), nullptr, nullptr);
      float acc[RB][CPT] = {};
      mm_k<H, RB, H>(acc, s.W, node_rows(s.Act));
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int n = tr + TR * i;
        const float m = s.Node[n * NODE_SCAL + NNM];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = tc * CPT + c;
          const float out = dense_pre<BF16>(acc[i][c], s.Vb[j]);
          const float hn = a.residual ? s.Hrow[n * LD + j] + out : out;
          h_out[n * H + j] = hn * m;
        }
      }
    }
  }
}

// ------------------------------------------------ phase C on the tensor cores
//
// bf16 blocks: the same phase C with its products as mma.sync m16n8k16. A
// pass's rows are m16 tiles (a node tile's 16 nodes, or one channel of
// them); warp w takes the n8 column tile w % (H / 8) of every H / 8-th m
// tile from w / (H / 8). The f32 sums are the tensor cores' order (the bf16
// path's products, like the fused edge forward's, are exact in each term
// and differ only in summation order); phi_ev's sum is reassociated as h @
// ev_k0[:H] (once per node) + Hv^T[c] @ ev_k0[H:2H] (once per channel) +
// the |vcd| and m_X terms. Weights are staged whole, at row stride H + 4
// (conflict-free fragment loads).

// one warp's m16n8 fragment of a pass (rows m0 + g, m0 + g + 8, nodes g,
// g + 8; columns j0, j0 + 1): y = act(dense_pre(acc, Vb[j])) into out (row
// stride LD) times the node mask when masked, and with a head (hv) the row's
// partial sum over the warp's columns into hred[m0 + node]
template <int H, bool SILU>
__device__ __forceinline__ void tc_epi(const NodeSmem<H, true>& s,
                                       const float (&acc)[4], int m0, int j0,
                                       float* out, bool masked,
                                       const float* hv, float* hred) {
  constexpr int LD = NodeSmem<H, true>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = g + 8 * h;
    float y0 = dense_pre<true>(acc[2 * h], s.Vb[j0]);
    float y1 = dense_pre<true>(acc[2 * h + 1], s.Vb[j0 + 1]);
    if (SILU) {
      y0 = silu<true>(y0);
      y1 = silu<true>(y1);
    }
    if (out != nullptr) {
      const float m = masked ? s.Node[n * NODE_SCAL + NNM] : 1.f;
      *reinterpret_cast<float2*>(out + (size_t)(m0 + n) * LD + j0) =
          make_float2(y0 * m, y1 * m);
    }
    if (hv != nullptr) {
      float hs = fmaf(y1, hv[j0 + 1], y0 * hv[j0]);
      hs += __shfl_xor_sync(0xffffffffu, hs, 1);
      hs += __shfl_xor_sync(0xffffffffu, hs, 2);
      if (t == 0) hred[m0 + n] = hs;
    }
  }
}

// the heads' sums of rows < rows: the column tiles' partials in order,
// rounded (plus the rounded bias hb when HB) into out[r * ld]
template <int H, bool HB>
__device__ __forceinline__ void tc_heads(const NodeSmem<H, true>& s, int rows,
                                         float hb, float* out, int ld) {
  constexpr int NB = H / 8, HR = NT * MAXC;
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    float sum = 0.f;
    for (int q = 0; q < NB; ++q) sum += s.HRed[q * HR + r];
    out[(size_t)r * ld] = HB ? dense_pre<true>(sum, hb) : rnd<true>(sum);
  }
}

template <int H>
__device__ void phase_c_tc(const StackArgs& a, const NodeSmem<H, true>& s,
                           int l) {
  constexpr int LD = NodeSmem<H, true>::LD, WLD = H + 4;
  constexpr int NB = H / 8, MS = 8 / NB, HR = NT * MAXC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;
  const int nt = warp % NB, mw = warp / NB;
  const int cn0 = nt * 8, j0 = cn0 + 2 * (lane & 3);
  float* hred = s.HRed + nt * HR;
  const int N = a.N, C = a.C, A = a.A, L = a.L;
  const int ntile = N / NT, items = a.B * ntile;
  const int KV = 2 * H + 1 + C;

  // a dense layer's weights (rows of Wg) at row stride WLD, its bias and
  // head; every thread past a barrier on both sides
  auto begin = [&](const float* Wg, int rows, const float* bg,
                   const float* hg, const float* hbg) {
    __syncthreads();
    stage_rows<H, true>(s.W, Wg, rows, WLD);
    if (bg != nullptr) stage_rows<H, true>(s.Vb, bg, 1, H);
    if (hg != nullptr) stage_rows<H, true>(s.Vh, hg, 1, H);
    if (hbg != nullptr && tid == 0) s.Vh[H] = rnd<true>(hbg[0]);
    __syncthreads();
  };
  // silu(rows @ W + Vb) over mts m tiles of rows from Ab
  auto pass = [&](const float* Ab, int mts, float* out, bool masked,
                  const float* hv) {
    for (int mt = mw; mt < mts; mt += MS) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      tc_mm<H>(acc, Ab + mt * 16 * LD, LD, s.W, WLD, cn0);
      tc_epi<H, true>(s, acc, mt * 16, j0, out, masked, hv, hred);
    }
  };

  int cur_b = -1;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / ntile, tile = it - b * ntile, nn0 = tile * NT;
    const size_t gn = (size_t)b * N + nn0;
    const size_t slot = (size_t)b * (L + 1) * N + nn0;
    const float* h_in = a.S_h + (slot + (size_t)l * N) * H;
    const float* x_in = a.S_x + (slot + (size_t)l * N) * 3;
    float* h_out = a.S_h + (slot + (size_t)(l + 1) * N) * H;
    float* x_out = a.S_x + (slot + (size_t)(l + 1) * N) * 3;
    const size_t part = (size_t)b * ntile + tile;
    __syncthreads();   // the previous tile is done with the tiles
    if (b != cur_b) {
      graph_globals<H, true>(a, s, l, b);
      cur_b = b;
    }
    tile_rows<H, true>(a, s, gn, x_in, h_in);

    // ---- phi_ev
    begin(wl<H>(a, EV_K0, l), KV, wl<H>(a, EV_B0, l), nullptr, nullptr);
    float sh[4] = {0.f, 0.f, 0.f, 0.f};
    tc_mm<H>(sh, s.HrowR, LD, s.W, WLD, cn0);
    for (int i = tid; i < C * H; i += THREADS) {
      const int c = i / H, j = i - c * H;
      float q = 0.f;
      for (int k = 0; k < H; ++k)
        q = fmaf(s.HvT[c * H + k], s.W[(H + k) * WLD + j], q);
      s.Qv[i] = q;
    }
    __syncthreads();
    for (int c = mw; c < C; c += MS)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = g + 8 * h;
        const float vr = s.Node[n * NODE_SCAL + NVRAD + c];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + u;
          float v = sh[2 * h + u] + s.Qv[c * H + j];
          v = fmaf(vr, s.W[2 * H * WLD + j], v);
          for (int e = 0; e < C; ++e)
            v = fmaf(s.MX[c * C + e], s.W[(2 * H + 1 + e) * WLD + j], v);
          s.Act[(c * NT + n) * LD + j] =
              silu<true>(dense_pre<true>(v, s.Vb[j]));
        }
      }
    // ---- vef = silu(. @ ev_k1 + ev_b1) * mask; agg_v and agg_Hv
    begin(wl<H>(a, EV_K1, l), H, wl<H>(a, EV_B1, l), nullptr, nullptr);
    pass(s.Act, C, s.Vef, true, nullptr);
    __syncthreads();
    tile_vef_sums<H, true>(a, s, part);
    // ---- the coordinate heads phi_xv and phi_X, phi_v (and phi_g)
    begin(wl<H>(a, XV_K0, l), H, wl<H>(a, XV_B0, l), wl<H>(a, XV_K1, l),
          nullptr);
    pass(s.Vef, C, nullptr, false, s.Vh);
    tc_heads<H, false>(s, C * NT, 0.f, s.Px, 1);
    begin(wl<H>(a, X_K0, l), H, wl<H>(a, X_B0, l), wl<H>(a, X_K1, l),
          nullptr);
    pass(s.Vef, C, nullptr, false, s.Vh);
    tc_heads<H, false>(s, C * NT, 0.f, s.PX, 1);
    begin(wl<H>(a, V_K0, l), H, wl<H>(a, V_B0, l), wl<H>(a, V_K1, l),
          wl<H>(a, V_B1, l));
    pass(s.HrowR, 1, nullptr, false, s.Vh);
    tc_heads<H, true>(s, NT, s.Vh[H], s.Node + NVS, NODE_SCAL);
    if (a.has_grav) {
      begin(wl<H>(a, G_K0, l), H, wl<H>(a, G_B0, l), wl<H>(a, G_K1, l),
            wl<H>(a, G_B1, l));
      pass(s.HrowR, 1, nullptr, false, s.Vh);
      tc_heads<H, true>(s, NT, s.Vh[H], s.Node + NGS, NODE_SCAL);
    }
    __syncthreads();
    tile_x_update<H, true>(a, s, part, x_out);

    // ---- phi_h on [h, agg_h, agg_v, node_attr] and the h update
    begin(wl<H>(a, H_K0, l), 3 * H + A, wl<H>(a, H_B0, l), nullptr, nullptr);
    if (mw == 0) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      tc_mm<H>(acc, s.HrowR, LD, s.W, WLD, cn0);
      tc_mm<H>(acc, s.Aggh, LD, s.W + H * WLD, WLD, cn0);
      tc_mm<H>(acc, s.Aggv, LD, s.W + 2 * H * WLD, WLD, cn0);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          for (int k = 0; k < A; ++k)
            acc[2 * h + u] = fmaf(s.Nat[(g + 8 * h) * A + k],
                                  s.W[(3 * H + k) * WLD + j0 + u],
                                  acc[2 * h + u]);
      tc_epi<H, true>(s, acc, 0, j0, s.Act, false, nullptr, hred);
    }
    begin(wl<H>(a, H_K1, l), H, wl<H>(a, H_B1, l), nullptr, nullptr);
    if (mw == 0) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      tc_mm<H>(acc, s.Act, LD, s.W, WLD, cn0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = g + 8 * h;
        const float m = s.Node[n * NODE_SCAL + NNM];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + u;
          const float out = dense_pre<true>(acc[2 * h + u], s.Vb[j]);
          const float hn = a.residual ? s.Hrow[n * LD + j] + out : out;
          h_out[n * H + j] = hn * m;
        }
      }
    }
  }
}

// ------------------------------------------------------------ phase D

// graph b's X and Hv of slot l+1 from the phase C partials (each summed
// over the graph's tiles in tile order), on block gridDim.x - 1 - b. It
// runs after the next layer's first sync, beside that layer's edge phase
// (which reads neither), and ends before its second sync, which orders it
// before the next phase C.
template <int H, bool BF16>
__device__ void phase_d(const StackArgs& a, const NodeSmem<H, BF16>& s,
                        int l) {
  using NS = NodeSmem<H, BF16>;
  constexpr int NTHR = Blk<BF16>::NTHR, TR = Blk<BF16>::TR;
  constexpr int RB = Blk<BF16>::RB, CPT = H / 16, LD = NS::LD;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int C = a.C, L = a.L, ntile = a.N / NT;
  for (int b = gridDim.x - 1 - blockIdx.x; b < a.B; b += gridDim.x) {
    const float* X = a.S_X + ((size_t)b * (L + 1) + l) * 3 * C;
    const float* Hv = a.S_Hv + ((size_t)b * (L + 1) + l) * H * C;
    float* Xo = a.S_X + ((size_t)b * (L + 1) + l + 1) * 3 * C;
    float* Hvo = a.S_Hv + ((size_t)b * (L + 1) + l + 1) * H * C;
    __syncthreads();
    sum_cm<BF16>(a.part_cm + (((size_t)(l & 1) * a.B + b) * ntile) * 4,
                 ntile, s.Red, s.Glob + 8);
    const float cnt = fmaxf(s.Glob[11], 1.f);
    const float* ptx = a.part_tX + (size_t)b * ntile * 3 * C;
    for (int i = tid; i < 3 * C; i += NTHR) {
      float acc = 0.f;
#pragma unroll 32
      for (int t = 0; t < ntile; ++t) acc += ptx[(size_t)t * 3 * C + i];
      Xo[i] = X[i] + acc / cnt;
    }
    // hv_in [C, 2H] = [Hv^T, agg_Hv] as 16 rows (rows >= C zero)
    const float* phv = a.part_Hv + (size_t)b * ntile * C * H;
    for (int i = tid; i < NT * H; i += NTHR) {
      const int c = i / H, j = i - c * H;
      float hv = 0.f, ag = 0.f;
      if (c < C) {
        hv = Hv[j * C + c];
#pragma unroll 32
        for (int t = 0; t < ntile; ++t) ag += phv[(size_t)t * C * H + i];
        ag = ag / cnt;
      }
      s.Act[c * LD + j] = rnd<BF16>(hv);
      s.Vef[c * LD + j] = rnd<BF16>(ag);
    }
    // phi_hv: bf16 blocks stage its first layer whole (row stride H + 4)
    // and run both on the tensor cores (one m16 tile, rows c < C); f32
    // blocks stage it in two chunks and run FMA products
    constexpr int WLD = BF16 ? H + 4 : H;
    const float* hv_k0 = wl<H>(a, HV_K0, l);
    auto begin = [&](const float* Wg, int rows, const float* bg) {
      __syncthreads();
      stage_rows<H, BF16>(s.W, Wg, rows, WLD);
      if (bg != nullptr) stage_rows<H, BF16>(s.Vb, bg, 1, H);
      __syncthreads();
    };
    if constexpr (BF16) {
      constexpr int NB = H / 8;
      const int lane = tid & 31, warp = tid >> 5, g = lane >> 2;
      const int cn0 = (warp % NB) * 8, j0 = cn0 + 2 * (lane & 3);
      begin(hv_k0, 2 * H, wl<H>(a, HV_B0, l));
      if (warp < NB) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        tc_mm<H>(acc, s.Act, LD, s.W, WLD, cn0);
        tc_mm<H>(acc, s.Vef, LD, s.W + H * WLD, WLD, cn0);
        tc_epi<H, true>(s, acc, 0, j0, s.Aggh, false, nullptr, nullptr);
      }
      begin(wl<H>(a, HV_K1, l), H, wl<H>(a, HV_B1, l));
      if (warp < NB) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        tc_mm<H>(acc, s.Aggh, LD, s.W, WLD, cn0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = g + 8 * h;
          if (c >= C) continue;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = j0 + u;
            const float out = dense_pre<true>(acc[2 * h + u], s.Vb[j]);
            Hvo[j * C + c] = a.residual ? Hv[j * C + c] + out : out;
          }
        }
      }
    } else {
      auto rows_of = [&](const float* base) {
        return [=](int i, int k) { return base[(tr + TR * i) * LD + k]; };
      };
      float acc[RB][CPT] = {};
      begin(hv_k0, H, wl<H>(a, HV_B0, l));
      mm_k<H, RB, H>(acc, s.W, rows_of(s.Act));
      begin(hv_k0 + (size_t)H * H, H, nullptr);
      mm_k<H, RB, H>(acc, s.W, rows_of(s.Vef));
      epilogue<H, BF16, true, false>(s, acc, 0, s.Aggh, nullptr, 0, nullptr,
                                     0.f, nullptr, 0);
      begin(wl<H>(a, HV_K1, l), H, wl<H>(a, HV_B1, l));
      float acc1[RB][CPT] = {};
      mm_k<H, RB, H>(acc1, s.W, rows_of(s.Aggh));
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int c = tr + TR * i;
        if (c >= C) continue;
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          const int j = tc * CPT + cc;
          const float out = dense_pre<BF16>(acc1[i][cc], s.Vb[j]);
          Hvo[j * C + c] = a.residual ? Hv[j * C + c] + out : out;
        }
      }
    }
  }
  __syncthreads();   // the shared memory is the edge phase's next
}

// ------------------------------------------------------------ the kernel

template <int H, bool BF16>
__global__ void __launch_bounds__(Blk<BF16>::NTHR, Blk<BF16>::MIN_BLOCKS)
fused_stack_kernel(const StackArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const NodeSmem<H, BF16> s(smem, a.C, a.A);
  for (int l = 0; l < a.L; ++l) {
    phase_a<H, BF16>(a, s, l);
    grid.sync();
    if (l > 0) phase_d<H, BF16>(a, s, l - 1);
    if constexpr (BF16) {
      phase_b_tc<H>(a, smem, l);
    } else {
      phase_b_f32<H>(a, smem, l);
    }
    grid.sync();
    if constexpr (BF16) {
      phase_c_tc<H>(a, s, l);
    } else {
      phase_c<H, BF16>(a, s, l);
    }
    grid.sync();
  }
  phase_d<H, BF16>(a, s, a.L - 1);
}

template <int H, bool BF16>
cudaError_t launch(const StackArgs& a, int* info, cudaStream_t stream) {
  constexpr int NTHR = Blk<BF16>::NTHR;
  auto kern = fused_stack_kernel<H, BF16>;
  size_t smem = NodeSmem<H, BF16>::floats(a.C, a.A) * sizeof(float);
  const size_t edge = BF16 ? StackTcLayout<H>::kBytes : F32Layout<H>::kBytes;
  if (smem < edge) smem = edge;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTHR,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = per_sm * a.n_sm;
  info[0] = grid;
  info[1] = per_sm;
  info[2] = (int)smem;
  void* args[] = {const_cast<StackArgs*>(&a)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid),
                                    dim3(NTHR), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). `ptrs` holds the
// N_PTRS operand pointers of StackArgs then the N_WKEYS stacked-weight
// pointers (null where absent), `dims` the N_DIMS integers from B to n_sm;
// `info` receives the grid, the co-resident blocks per SM and the dynamic
// shared memory bytes of the launch.
extern "C" int fused_stack_fwd(const void* const* ptrs, const int* dims,
                               int H, int bf16, int* info, void* stream) {
  StackArgs a;
  int i = 0;
  a.row_t = static_cast<const int*>(ptrs[i++]);
  a.col_l = static_cast<const int*>(ptrs[i++]);
  a.kblk = static_cast<const int*>(ptrs[i++]);
  a.scal = static_cast<const float*>(ptrs[i++]);
  a.rr = static_cast<const int*>(ptrs[i++]);
  a.rc = static_cast<const int*>(ptrs[i++]);
  a.rattr = static_cast<const float*>(ptrs[i++]);
  a.rmask = static_cast<const float*>(ptrs[i++]);
  a.h0 = static_cast<const float*>(ptrs[i++]);
  a.x0 = static_cast<const float*>(ptrs[i++]);
  a.v = static_cast<const float*>(ptrs[i++]);
  a.X0 = static_cast<const float*>(ptrs[i++]);
  a.Hv0 = static_cast<const float*>(ptrs[i++]);
  a.nm = static_cast<const float*>(ptrs[i++]);
  a.nattr = static_cast<const float*>(ptrs[i++]);
  a.gvec = static_cast<const float*>(ptrs[i++]);
  a.S_h = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.S_x = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.S_X = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.S_Hv = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.hr = const_cast<void*>(ptrs[i++]);
  a.hc = const_cast<void*>(ptrs[i++]);
  a.agg = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.rtr = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.part_cm = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.part_tX = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.part_Hv = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  if (i != N_PTRS) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < N_WKEYS; ++k)
    a.w[k] = static_cast<const float*>(ptrs[N_PTRS + k]);
  int* d[N_DIMS] = {&a.B, &a.N, &a.E, &a.R, &a.T, &a.L, &a.C, &a.A,
                    &a.has_grav, &a.residual, &a.coords_mean, &a.n_sm};
  for (int k = 0; k < N_DIMS; ++k) *d[k] = dims[k];
  if (a.B < 1 || a.C < 1 || a.C > MAXC || a.L < 1 || a.T < 1 || a.N < 1 ||
      a.N % a.T || a.T % NT || a.E % TE || a.R % TE ||
      (a.A > 0 && a.nattr == nullptr) || (a.has_grav && a.gvec == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 16:
      return bf16 ? (int)launch<16, true>(a, info, s)
                  : (int)launch<16, false>(a, info, s);
    case 32:
      return bf16 ? (int)launch<32, true>(a, info, s)
                  : (int)launch<32, false>(a, info, s);
    case 64:
      return bf16 ? (int)launch<64, true>(a, info, s)
                  : (int)launch<64, false>(a, info, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
