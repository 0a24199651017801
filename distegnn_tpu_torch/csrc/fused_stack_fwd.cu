// fused_stack_fwd.cu — all L EGCL layers of one graph in one cooperative
// launch, forward, for Hopper (sm_90a). Plain C interface, loaded with
// ctypes (distegnn_tpu_torch/ops/layer_pipeline.py: _fused_egnn_stack_cuda).
//
// Replaces the TPU megakernel _stack_kernel (distegnn_tpu/ops/
// layer_pipeline.py:425, launched by pallas_call in _stack_fwd_impl, :608).
// Same function: per layer l, from the layer-INPUT state (h, x, X, Hv)
//   hr, hc = h @ e_w1[:H], h @ e_w1[H:2H]                  (hoisted phi_e)
//   in-window blocked edges: fused_edge_fwd's tile (the shared code of
//     fused_edge_common.cuh: bf16 hi + lo translations, bf16 edge features)
//   remote tail: the same per-edge math over the compact remote list,
//     summed unrounded (EGCLVel's dense tail)
//   agg = trans_sum / count, agg_h = ef_sum / count
//   the virtual section and the node / virtual updates (phi_ev, phi_xv,
//     phi_X, phi_v, phi_g, phi_h, phi_hv; layer_pipeline._virtual_and_update)
// and returns the final state plus the four [L, ...] layer-input
// checkpoints, which the backward reruns each layer from.
//
// What bounds it on the H100: neither bytes nor operations. One serving
// launch (L=4, N=1536, H=64, ~20-30k edge slots) does a few hundred MFLOP a
// layer and touches ~10 MB, so latency bounds it: 3 grid-wide syncs a
// layer, and within each phase the serial chain of small dense layers.
// The design keeps everything on chip or in L2 and launches once:
//  - One cooperative launch (cudaLaunchCooperativeKernel) with a grid of
//    the co-resident blocks; cooperative_groups' grid.sync() separates the
//    phases of a layer:
//      A  per 8-node tile: the hoisted hr / hc products (compute dtype),
//         per-block partials of the masked coordinate sum and node count,
//         the aggregate rows zeroed (and at l = 0 the inputs copied into
//         checkpoint slot 0)
//      B  the in-window tiles, then the remote tiles, each 64 edges, into
//         one [N, H+12] f32 aggregate by f32 atomicAdd at row-segment ends
//         (so its summation order changes from run to run)
//      C  per 8-node tile: the mean aggregates, the virtual section, the x
//         and h updates (written to slot l+1), and per-block partials of
//         trans_X and agg_Hv
//      D  block 0 sums the partials in block order, updates X and Hv
//         (phi_hv) into slot l+1. D runs while the other blocks start the
//         next layer's phase A, which does not read X or Hv; the next sync
//         orders it before phase C.
//    Every block reaches every sync, whether or not it has tiles.
//  - The state lives in the checkpoint slots themselves: S_h [L+1, N, H],
//    S_x [L+1, N, 3], S_X [L+1, 3, C], S_Hv [L+1, H, C]; layer l reads slot
//    l and writes slot l+1, so the TPU's double-buffered VMEM window and its
//    checkpoint copy are one write here. Under the 16 MiB residency budget
//    the graph and the state stay L2-resident (50 MB).
//  - No lane padding (the TPU's XL = 8) and no one-hot matrix sums: gathers
//    are plain loads, segment sums atomics.
//  - Weights are staged phase by phase: phase B holds the edge MLP (w2, w3,
//    ~33 KB at H=64), phases A / C / D stage one dense layer at a time
//    (at most 50 KB: phi_h's [3H+A, H]), rounded to the compute dtype when
//    staged, so bf16 products round as _dense does (operands in bf16, f32
//    accumulation, the product and the bias add each rounded).
//  - Determinism: the node reductions (coordinate mean, trans_X, agg_Hv)
//    are per-block partials over whole tiles, summed in block order.
//  - The dense layers are f32 FMAs from shared memory, one output per
//    thread (exact f32 parity; bf16 operands are exact in f32), not tensor
//    cores: a first version that is right.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "fused_edge_common.cuh"

namespace {

using namespace fused_edge;
namespace cg = cooperative_groups;

constexpr int NT = 8;       // nodes per node tile (phases A and C)
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
// dimensions
struct StackArgs {
  const int* row_t;
  const int* col_l;
  const int* kblk;
  const float* scal;
  const int* rr;
  const int* rc;
  const float* rattr;   // [R, 2]
  const float* rmask;   // [R]
  const float* h0;      // [N, H]
  const float* x0;      // [N, 3]
  const float* v;       // [N, 3]
  const float* X0;      // [3, C]
  const float* Hv0;     // [H, C]
  const float* nm;      // [N]
  const float* nattr;   // [N, A] or null
  const float* gvec;    // [3] or null
  float* S_h;           // [L+1, N, H]
  float* S_x;           // [L+1, N, 3]
  float* S_X;           // [L+1, 3, C]
  float* S_Hv;          // [L+1, H, C]
  void* hr;             // [N, H] compute dtype
  void* hc;             // [N, H] compute dtype
  float* agg;           // [N, H+12]
  float* part_cm;       // [2, max_grid, 4]
  float* part_tX;       // [max_grid, 3C]
  float* part_Hv;       // [max_grid, C*H]
  const float* w[N_WKEYS];
  int N, E, R, T, L, C, A, has_grav, residual, coords_mean, max_grid, n_sm;
};
constexpr int N_PTRS = 26;
constexpr int N_DIMS = 12;

// aggregate row: [hi 3, lo 3, count, -, ef H, remote trans 3, -]
template <int H>
__host__ __device__ constexpr int agg_width() {
  return H + 12;
}

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

// ---------------------------------------------------- node-phase smem

struct NodeSmem {
  float* W;      // one staged dense layer [K, n]
  float* Bias;   // [H]
  float* In;     // dense input rows (v_in, phi_v input, n_in, hv_in)
  float* Act;    // [rows, H+1] hidden activations
  float* Vef;    // [rows, H+1] vef, then dense outputs
  float* Hrow;   // [NT, H] the layer-input h rows (f32)
  float* Aggh;   // [NT, H] agg_h
  float* Px;     // [NT*C] phi_xv
  float* PX;     // [NT*C] phi_X
  float* Node;   // [NT, NODE_SCAL]: x 3, v 3, aggx 3, nm, vs, gs,
                 //   vrad MAXC, vcd 3*MAXC ([d][c])
  float* X;      // [3, MAXC] layer-input X ([d * C + c])
  float* Hv;     // [H * MAXC] layer-input Hv ([j * C + c])
  float* MX;     // [MAXC * MAXC] m_X
  float* Glob;   // coord mean 3, cnt_n, gvec 3, reduction scratch 4
  float* AccX;   // [3 * MAXC] block partial of trans_X
  float* AccHv;  // [MAXC * H] block partial of agg_Hv
  float* AccCm;  // [4] block partial of the coordinate sum and count
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline size_t node_smem_floats(int H, int C, int A) {
  const int R = NT * C, KV = 2 * H + 1 + C, KH = 3 * H + A;
  size_t n = (size_t)imax(imax(KV, KH), 2 * H) * H;          // W
  n += H;                                                     // Bias
  n += imax(imax(R * KV, NT * KH), imax(C * 2 * H, NT * H));  // In
  n += 2 * (size_t)R * (H + 1);                               // Act, Vef
  n += 2 * NT * H + 2 * R + NT * NODE_SCAL;
  n += 3 * MAXC + H * MAXC + MAXC * MAXC + 12;
  n += 3 * MAXC + MAXC * H + 4;
  return n;
}

__device__ inline NodeSmem node_smem(float* base, int H, int C, int A) {
  const int R = NT * C, KV = 2 * H + 1 + C, KH = 3 * H + A;
  NodeSmem s;
  s.W = base;
  s.Bias = s.W + imax(imax(KV, KH), 2 * H) * H;
  s.In = s.Bias + H;
  s.Act = s.In + imax(imax(R * KV, NT * KH), imax(C * 2 * H, NT * H));
  s.Vef = s.Act + R * (H + 1);
  s.Hrow = s.Vef + R * (H + 1);
  s.Aggh = s.Hrow + NT * H;
  s.Px = s.Aggh + NT * H;
  s.PX = s.Px + R;
  s.Node = s.PX + R;
  s.X = s.Node + NT * NODE_SCAL;
  s.Hv = s.X + 3 * MAXC;
  s.MX = s.Hv + H * MAXC;
  s.Glob = s.MX + MAXC * MAXC;
  s.AccX = s.Glob + 12;
  s.AccHv = s.AccX + 3 * MAXC;
  s.AccCm = s.AccHv + MAXC * H;
  return s;
}

// per-node scalars in s.Node
enum { NX = 0, NV = 3, NAGG = 6, NNM = 9, NVS = 10, NGS = 11, NVRAD = 12,
       NVCD = 12 + MAXC };

template <bool BF16>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = rnd<BF16>(src[i]);
}

// out[r, j] = [silu](dense_pre(sum_k in[r, k] W[k, j], bias[j])) for r <
// rows, j < n; without a bias the product is only rounded (CoordMLP's
// last layer). One output per thread, k in order, one fmaf per term.
template <bool BF16, bool SILU>
__device__ __forceinline__ void block_dense(const float* in, int ldi, int rows,
                                            int K, const float* W, int n,
                                            const float* bias, float* out,
                                            int ldo) {
  for (int idx = threadIdx.x; idx < rows * n; idx += THREADS) {
    const int r = idx / n, j = idx - r * n;
    const float* ir = in + (size_t)r * ldi;
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) acc = fmaf(ir[k], W[k * n + j], acc);
    float y = bias != nullptr ? dense_pre<BF16>(acc, bias[j])
                              : rnd<BF16>(acc);
    if (SILU) y = silu<BF16>(y);
    out[(size_t)r * ldo + j] = y;
  }
}

// one Dense(+silu) of an MLP: stage W [K, n] (and the bias) rounded to the
// compute dtype, then the product. `in` must be complete (synchronised).
template <bool BF16, bool SILU>
__device__ __forceinline__ void dense_layer(const NodeSmem& s,
                                            const float* __restrict__ Wg,
                                            const float* __restrict__ bg,
                                            const float* in, int ldi,
                                            int rows, int K, int n,
                                            float* out, int ldo) {
  stage<BF16>(s.W, Wg, K * n);
  if (bg != nullptr) stage<BF16>(s.Bias, bg, n);
  __syncthreads();
  block_dense<BF16, SILU>(in, ldi, rows, K, s.W, n,
                          bg != nullptr ? s.Bias : nullptr, out, ldo);
  __syncthreads();
}

// ------------------------------------------------------------ phase A

template <int H, bool BF16>
__device__ void phase_a(const StackArgs& a, const NodeSmem& s, int l) {
  using Act = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int FA = agg_width<H>();
  const int tid = threadIdx.x;
  const int N = a.N, C = a.C;
  const float* h_in = l == 0 ? a.h0 : a.S_h + (size_t)l * N * H;
  const float* x_in = l == 0 ? a.x0 : a.S_x + (size_t)l * N * 3;
  Act* hr = static_cast<Act*>(a.hr);
  Act* hc = static_cast<Act*>(a.hc);

  // e_w1's first 2H rows: [W_row; W_col]
  stage<BF16>(s.W, wl<H>(a, E_W1, l), 2 * H * H);
  if (tid < 4) s.AccCm[tid] = 0.f;
  if (l == 0 && blockIdx.x == 0) {
    for (int i = tid; i < 3 * C; i += THREADS) a.S_X[i] = a.X0[i];
    for (int i = tid; i < H * C; i += THREADS) a.S_Hv[i] = a.Hv0[i];
  }
  __syncthreads();

  for (int tile = blockIdx.x; tile < N / NT; tile += gridDim.x) {
    const int n0 = tile * NT;
    for (int i = tid; i < NT * H; i += THREADS) {
      const float hv = h_in[(size_t)n0 * H + i];
      if (l == 0) a.S_h[(size_t)n0 * H + i] = hv;
      s.Hrow[i] = rnd<BF16>(hv);
    }
    if (l == 0)
      for (int i = tid; i < NT * 3; i += THREADS)
        a.S_x[(size_t)n0 * 3 + i] = x_in[(size_t)n0 * 3 + i];
    for (int i = tid; i < NT * FA; i += THREADS)
      a.agg[(size_t)n0 * FA + i] = 0.f;
    __syncthreads();
    for (int idx = tid; idx < NT * 2 * H; idx += THREADS) {
      const int n = idx / (2 * H), j = idx % (2 * H);
      const int half = j / H, jj = j % H;
      float acc = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k)
        acc = fmaf(s.Hrow[n * H + k], s.W[(half * H + k) * H + jj], acc);
      const float y = rnd<BF16>(acc);
      Act* dst = half ? hc : hr;
      if constexpr (BF16) {
        dst[(size_t)(n0 + n) * H + jj] = __float2bfloat16_rn(y);
      } else {
        dst[(size_t)(n0 + n) * H + jj] = y;
      }
    }
    if (tid < 4) {
      float acc = s.AccCm[tid];
      for (int n = 0; n < NT; ++n) {
        const float m = a.nm[n0 + n];
        acc += tid < 3 ? x_in[(size_t)(n0 + n) * 3 + tid] * m : m;
      }
      s.AccCm[tid] = acc;
    }
    __syncthreads();
  }
  if (tid < 4)
    a.part_cm[((size_t)(l & 1) * a.max_grid + blockIdx.x) * 4 + tid] =
        s.AccCm[tid];
  __syncthreads();
}

// ------------------------------------------------------------ phase B

template <int H, bool BF16>
__device__ void phase_b(const StackArgs& a, float* smem, int l) {
  using Act = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int FA = agg_width<H>();
  const FwdTile<H> s(smem);
  const float* w1 = wl<H>(a, E_W1, l);
  fwd_load_weights<H, BF16>(s, w1 + 2 * H * H, wl<H>(a, E_B1, l),
                            wl<H>(a, E_W2, l), wl<H>(a, E_B2, l),
                            wl<H>(a, E_W3, l), wl<H>(a, E_B3, l),
                            wl<H>(a, E_W4, l));
  const float* x = a.S_x + (size_t)l * a.N * 3;
  const Act* hr = static_cast<const Act*>(a.hr);
  const Act* hc = static_cast<const Act*>(a.hc);
  const int n_in = a.E / TE, n_tiles = n_in + a.R / TE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // weights loaded / previous tile fully consumed
    const bool remote = tile >= n_in;
    const int active =
        remote ? fwd_setup_remote<H, BF16>(s, tile - n_in, a.rr, a.rc,
                                           a.rattr, a.rmask, x)
               : fwd_setup_inwindow<H, BF16>(s, tile, a.row_t, a.col_l,
                                             a.kblk, a.scal, x, a.N, a.E,
                                             a.T);
    if (!__syncthreads_or(active)) continue;  // all-padding tile
    fwd_tile_mlp<H, BF16>(s, hr, hc);
    if (remote) {
      fwd_aggregate_remote<H>(s, a.agg, FA, H + 8);
    } else {
      fwd_aggregate_inwindow<H>(s, a.agg, FA);
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------ phase C

template <int H, bool BF16>
__device__ void phase_c(const StackArgs& a, const NodeSmem& s, int l) {
  constexpr int FA = agg_width<H>();
  constexpr int LH = H + 1;
  const int tid = threadIdx.x;
  const int N = a.N, C = a.C, A = a.A;
  const int R = NT * C, KV = 2 * H + 1 + C, KH = 3 * H + A;
  const float* h_in = a.S_h + (size_t)l * N * H;
  const float* x_in = a.S_x + (size_t)l * N * 3;
  float* h_out = a.S_h + (size_t)(l + 1) * N * H;
  float* x_out = a.S_x + (size_t)(l + 1) * N * 3;

  // the layer's globals: coordinate mean and count (the phase A partials in
  // block order), X, Hv, m_X, gravity
  if (tid < 4) {
    const float* p = a.part_cm + (size_t)(l & 1) * a.max_grid * 4;
    float acc = 0.f;
    for (int g = 0; g < gridDim.x; ++g) acc += p[g * 4 + tid];
    s.Glob[8 + tid] = acc;
  }
  for (int i = tid; i < 3 * C; i += THREADS) {
    s.X[i] = a.S_X[(size_t)l * 3 * C + i];
    s.AccX[i] = 0.f;
  }
  for (int i = tid; i < H * C; i += THREADS) {
    s.Hv[i] = a.S_Hv[(size_t)l * H * C + i];
    s.AccHv[i] = 0.f;
  }
  if (a.has_grav && tid < 3) s.Glob[4 + tid] = a.gvec[tid];
  __syncthreads();
  if (tid == 0) {
    const float cnt = fmaxf(s.Glob[11], 1.f);
    s.Glob[3] = cnt;
    for (int d = 0; d < 3; ++d) s.Glob[d] = s.Glob[8 + d] / cnt;
  }
  __syncthreads();
  for (int i = tid; i < C * C; i += THREADS) {
    const int c = i / C, e = i % C;
    float acc = 0.f;
    for (int d = 0; d < 3; ++d)
      acc += (s.X[d * C + c] - s.Glob[d]) * (s.X[d * C + e] - s.Glob[d]);
    s.MX[i] = acc;
  }
  __syncthreads();

  const float* ev_k0 = wl<H>(a, EV_K0, l);
  for (int tile = blockIdx.x; tile < N / NT; tile += gridDim.x) {
    const int n0 = tile * NT;
    // ---- the tile's rows: h, x, v, mask, mean aggregates, virtual geometry
    if (tid < NT) {
      const int node = n0 + tid;
      float* q = s.Node + tid * NODE_SCAL;
      const float* ag = a.agg + (size_t)node * FA;
      const float cnt = fmaxf(ag[6], 1.f);
      for (int d = 0; d < 3; ++d) {
        q[NX + d] = x_in[(size_t)node * 3 + d];
        q[NV + d] = a.v[(size_t)node * 3 + d];
        const float ts = (ag[d] + ag[3 + d]) + ag[H + 8 + d];
        q[NAGG + d] = a.coords_mean ? ts / cnt : ts;
      }
      q[NNM] = a.nm[node];
      for (int c = 0; c < C; ++c) {
        float r2 = 0.f;
        for (int d = 0; d < 3; ++d) {
          const float vc = s.X[d * C + c] - q[NX + d];
          q[NVCD + d * MAXC + c] = vc;
          r2 += vc * vc;
        }
        q[NVRAD + c] = sqrtf(r2);
      }
    }
    for (int i = tid; i < NT * H; i += THREADS) {
      const int n = i / H, j = i % H;
      const float* ag = a.agg + (size_t)(n0 + n) * FA;
      s.Hrow[i] = h_in[(size_t)n0 * H + i];
      s.Aggh[i] = ag[8 + j] / fmaxf(ag[6], 1.f);
    }
    __syncthreads();

    // ---- phi_ev over the C virtual channels: v_in = [h, Hv^T, |vcd|, m_X]
    for (int idx = tid; idx < R * KV; idx += THREADS) {
      const int r = idx / KV, k = idx % KV;
      const int n = r / C, c = r % C;
      float val;
      if (k < H) {
        val = s.Hrow[n * H + k];
      } else if (k < 2 * H) {
        val = s.Hv[(k - H) * C + c];
      } else if (k == 2 * H) {
        val = s.Node[n * NODE_SCAL + NVRAD + c];
      } else {
        val = s.MX[c * C + (k - 2 * H - 1)];
      }
      s.In[idx] = rnd<BF16>(val);
    }
    dense_layer<BF16, true>(s, ev_k0, wl<H>(a, EV_B0, l), s.In, KV, R, KV, H,
                            s.Act, LH);
    dense_layer<BF16, true>(s, wl<H>(a, EV_K1, l), wl<H>(a, EV_B1, l), s.Act,
                            LH, R, H, H, s.Vef, LH);
    for (int i = tid; i < R * H; i += THREADS) {
      const int r = i / H, j = i % H;
      s.Vef[r * LH + j] *= s.Node[(r / C) * NODE_SCAL + NNM];
    }
    __syncthreads();

    // ---- the coordinate heads phi_xv and phi_X on vef
    dense_layer<BF16, true>(s, wl<H>(a, XV_K0, l), wl<H>(a, XV_B0, l), s.Vef,
                            LH, R, H, H, s.Act, LH);
    dense_layer<BF16, false>(s, wl<H>(a, XV_K1, l), nullptr, s.Act, LH, R, H,
                             1, s.Px, 1);
    dense_layer<BF16, true>(s, wl<H>(a, X_K0, l), wl<H>(a, X_B0, l), s.Vef,
                            LH, R, H, H, s.Act, LH);
    dense_layer<BF16, false>(s, wl<H>(a, X_K1, l), nullptr, s.Act, LH, R, H,
                             1, s.PX, 1);

    // ---- phi_v (and phi_g) on h
    for (int i = tid; i < NT * H; i += THREADS) s.In[i] = rnd<BF16>(s.Hrow[i]);
    dense_layer<BF16, true>(s, wl<H>(a, V_K0, l), wl<H>(a, V_B0, l), s.In, H,
                            NT, H, H, s.Act, LH);
    dense_layer<BF16, false>(s, wl<H>(a, V_K1, l), wl<H>(a, V_B1, l), s.Act,
                             LH, NT, H, 1, s.Node + NVS, NODE_SCAL);
    if (a.has_grav) {
      dense_layer<BF16, true>(s, wl<H>(a, G_K0, l), wl<H>(a, G_B0, l), s.In,
                              H, NT, H, H, s.Act, LH);
      dense_layer<BF16, false>(s, wl<H>(a, G_K1, l), wl<H>(a, G_B1, l),
                               s.Act, LH, NT, H, 1, s.Node + NGS, NODE_SCAL);
    }

    // ---- x update; trans_X and agg_Hv partials; n_in = [h, agg_h, agg_v,
    //      node_attr]
    if (tid < NT * 3) {
      const int n = tid / 3, d = tid % 3;
      const float* q = s.Node + n * NODE_SCAL;
      float xn = q[NX + d] + q[NAGG + d];
      float sv = 0.f;
      for (int c = 0; c < C; ++c)
        sv += -q[NVCD + d * MAXC + c] * s.Px[n * C + c];
      xn = xn + sv / C;
      xn = xn + q[NVS] * q[NV + d];
      if (a.has_grav) xn = xn + q[NGS] * s.Glob[4 + d];
      x_out[(size_t)(n0 + n) * 3 + d] = xn * q[NNM];
    }
    for (int i = tid; i < 3 * C; i += THREADS) {
      const int d = i / C, c = i % C;
      float acc = s.AccX[i];
      for (int n = 0; n < NT; ++n) {
        const float* q = s.Node + n * NODE_SCAL;
        acc += q[NVCD + d * MAXC + c] * s.PX[n * C + c] * q[NNM];
      }
      s.AccX[i] = acc;
    }
    for (int i = tid; i < C * H; i += THREADS) {
      const int c = i / H, j = i % H;
      float acc = s.AccHv[i];
      for (int n = 0; n < NT; ++n)
        acc += s.Vef[(n * C + c) * LH + j] * s.Node[n * NODE_SCAL + NNM];
      s.AccHv[i] = acc;
    }
    for (int idx = tid; idx < NT * KH; idx += THREADS) {
      const int n = idx / KH, k = idx % KH;
      float val;
      if (k < H) {
        val = s.Hrow[n * H + k];
      } else if (k < 2 * H) {
        val = s.Aggh[n * H + k - H];
      } else if (k < 3 * H) {
        float sv = 0.f;
        for (int c = 0; c < C; ++c) sv += s.Vef[(n * C + c) * LH + k - 2 * H];
        val = rnd<BF16>(sv / C);   // mean over the channels, in the dtype
      } else {
        val = a.nattr[(size_t)(n0 + n) * A + k - 3 * H];
      }
      s.In[idx] = rnd<BF16>(val);
    }
    __syncthreads();

    // ---- phi_h and the h update
    dense_layer<BF16, true>(s, wl<H>(a, H_K0, l), wl<H>(a, H_B0, l), s.In, KH,
                            NT, KH, H, s.Act, LH);
    dense_layer<BF16, false>(s, wl<H>(a, H_K1, l), wl<H>(a, H_B1, l), s.Act,
                             LH, NT, H, H, s.Vef, LH);
    for (int i = tid; i < NT * H; i += THREADS) {
      const int n = i / H, j = i % H;
      const float out = s.Vef[n * LH + j];
      const float hn = a.residual ? s.Hrow[i] + out : out;
      h_out[(size_t)n0 * H + i] = hn * s.Node[n * NODE_SCAL + NNM];
    }
    __syncthreads();
  }
  for (int i = tid; i < 3 * C; i += THREADS)
    a.part_tX[(size_t)blockIdx.x * 3 * C + i] = s.AccX[i];
  for (int i = tid; i < C * H; i += THREADS)
    a.part_Hv[(size_t)blockIdx.x * C * H + i] = s.AccHv[i];
  __syncthreads();
}

// ------------------------------------------------------------ phase D

// block 0: X and Hv of slot l+1 from the phase C partials, summed in block
// order
template <int H, bool BF16>
__device__ void phase_d(const StackArgs& a, const NodeSmem& s, int l) {
  constexpr int LH = H + 1;
  const int tid = threadIdx.x;
  const int C = a.C, G = gridDim.x;
  const float* X = a.S_X + (size_t)l * 3 * C;
  const float* Hv = a.S_Hv + (size_t)l * H * C;
  if (tid == 0) {
    const float* p = a.part_cm + (size_t)(l & 1) * a.max_grid * 4;
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += p[g * 4 + 3];
    s.Glob[3] = fmaxf(acc, 1.f);
  }
  __syncthreads();
  const float cnt = s.Glob[3];
  for (int i = tid; i < 3 * C; i += THREADS) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += a.part_tX[(size_t)g * 3 * C + i];
    a.S_X[(size_t)(l + 1) * 3 * C + i] = X[i] + acc / cnt;
  }
  // hv_in [C, 2H] = [Hv^T, agg_Hv]
  for (int i = tid; i < C * H; i += THREADS) {
    const int c = i / H, j = i % H;
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += a.part_Hv[(size_t)g * C * H + i];
    s.In[c * 2 * H + j] = rnd<BF16>(Hv[j * C + c]);
    s.In[c * 2 * H + H + j] = rnd<BF16>(acc / cnt);
  }
  __syncthreads();
  dense_layer<BF16, true>(s, wl<H>(a, HV_K0, l), wl<H>(a, HV_B0, l), s.In,
                          2 * H, C, 2 * H, H, s.Act, LH);
  dense_layer<BF16, false>(s, wl<H>(a, HV_K1, l), wl<H>(a, HV_B1, l), s.Act,
                           LH, C, H, H, s.Vef, LH);
  for (int i = tid; i < H * C; i += THREADS) {
    const int j = i / C, c = i % C;
    const float out = s.Vef[c * LH + j];
    a.S_Hv[(size_t)(l + 1) * H * C + i] = a.residual ? Hv[i] + out : out;
  }
  __syncthreads();
}

// ------------------------------------------------------------ the kernel

template <int H, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_stack_kernel(const StackArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const NodeSmem s = node_smem(smem, H, a.C, a.A);
  for (int l = 0; l < a.L; ++l) {
    if (l > 0 && blockIdx.x == 0) phase_d<H, BF16>(a, s, l - 1);
    phase_a<H, BF16>(a, s, l);
    grid.sync();
    phase_b<H, BF16>(a, smem, l);
    grid.sync();
    phase_c<H, BF16>(a, s, l);
    grid.sync();
  }
  if (blockIdx.x == 0) phase_d<H, BF16>(a, s, a.L - 1);
}

template <int H, bool BF16>
cudaError_t launch(const StackArgs& a, int* info, cudaStream_t stream) {
  auto kern = fused_stack_kernel<H, BF16>;
  size_t smem = node_smem_floats(H, a.C, a.A) * sizeof(float);
  if (smem < FwdTile<H>::kBytes) smem = FwdTile<H>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int grid = per_sm * a.n_sm;
  if (grid > a.max_grid) grid = a.max_grid;
  info[0] = grid;
  info[1] = per_sm;
  info[2] = (int)smem;
  void* args[] = {const_cast<StackArgs*>(&a)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). `ptrs` holds the
// N_PTRS operand pointers of StackArgs then the N_WKEYS stacked-weight
// pointers (null where absent), `dims` the N_DIMS integers from N to n_sm;
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
  a.part_cm = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.part_tX = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.part_Hv = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  if (i != N_PTRS) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < N_WKEYS; ++k)
    a.w[k] = static_cast<const float*>(ptrs[N_PTRS + k]);
  int* d[N_DIMS] = {&a.N, &a.E, &a.R, &a.T, &a.L, &a.C, &a.A,
                    &a.has_grav, &a.residual, &a.coords_mean, &a.max_grid,
                    &a.n_sm};
  for (int i = 0; i < N_DIMS; ++i) *d[i] = dims[i];
  if (a.C < 1 || a.C > MAXC || a.L < 1 || a.N % a.T || a.T % NT ||
      a.E % TE || a.R % TE || (a.A > 0 && a.nattr == nullptr) ||
      (a.has_grav && a.gvec == nullptr))
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
