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
// What bounds it on the H100: the two H x H products per edge. At H=64 that
// is 4*H*H = 16 Kflop per edge against ~44 bytes of edge stream plus two
// gathered node rows (mostly L2 hits: [N, 2H] is a few MB at serving sizes),
// so the f32 CUDA-core rate (67 TFLOP/s) and not the 3.35 TB/s memory bounds
// it. This first version runs the products as f32 FMAs from shared memory
// (exact f32 parity; bf16 operands are exact in f32), not on tensor cores.
//
// Design, against the TPU kernel:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "fused_edge_common.cuh"

namespace {

using namespace fused_edge;

template <int H>
constexpr size_t smem_bytes() {
  return FwdTile<H>::kBytes;
}

template <int H, bool BF16>
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
  fwd_load_weights<H, BF16>(s, ws, b1, w2, b2, w3, b3, w4);

  const int n_tiles = (n_edges + TE - 1) / TE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // weights loaded / previous tile fully consumed
    const int active = fwd_setup_inwindow<H, BF16>(
        s, tile, row_t, col_l, kblk, scal, x, n_nodes, n_edges, block);
    if (!__syncthreads_or(active)) continue;  // all-padding tile
    fwd_tile_mlp<H, BF16>(s, hr, hc);
    fwd_aggregate_inwindow<H>(s, out, H + 8);
  }
}

template <int H, bool BF16>
cudaError_t launch(const void* row_t, const void* col_l, const void* kblk,
                   const void* scal, const void* x, const void* hr,
                   const void* hc, const void* ws, const void* b1,
                   const void* w2, const void* b2, const void* w3,
                   const void* b3, const void* w4, void* out, int n_nodes,
                   int n_edges, int block, int n_sm, cudaStream_t stream) {
  using Act = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr size_t smem = smem_bytes<H>();
  auto kern = fused_edge_fwd_kernel<H, BF16>;
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

template <int H>
cudaError_t dispatch_dtype(int bf16, const void* row_t, const void* col_l,
                           const void* kblk, const void* scal, const void* x,
                           const void* hr, const void* hc, const void* ws,
                           const void* b1, const void* w2, const void* b2,
                           const void* w3, const void* b3, const void* w4,
                           void* out, int n_nodes, int n_edges, int block,
                           int n_sm, cudaStream_t stream) {
  if (bf16)
    return launch<H, true>(row_t, col_l, kblk, scal, x, hr, hc, ws, b1, w2,
                           b2, w3, b3, w4, out, n_nodes, n_edges, block, n_sm,
                           stream);
  return launch<H, false>(row_t, col_l, kblk, scal, x, hr, hc, ws, b1, w2, b2,
                          w3, b3, w4, out, n_nodes, n_edges, block, n_sm,
                          stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). out [N, H+8] f32 must
// be zeroed by the caller; hr/hc are f32 (bf16 == 0) or bf16 (bf16 == 1).
extern "C" int fused_edge_fwd(const void* row_t, const void* col_l,
                              const void* kblk, const void* scal,
                              const void* x, const void* hr, const void* hc,
                              const void* ws, const void* b1, const void* w2,
                              const void* b2, const void* w3, const void* b3,
                              const void* w4, void* out, int n_nodes,
                              int n_edges, int block, int H, int bf16,
                              int n_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEG_CASE(HH)                                                        \
  case HH:                                                                  \
    return (int)dispatch_dtype<HH>(bf16, row_t, col_l, kblk, scal, x, hr,   \
                                   hc, ws, b1, w2, b2, w3, b3, w4, out,     \
                                   n_nodes, n_edges, block, n_sm, s);
  switch (H) {
    DEG_CASE(16)
    DEG_CASE(32)
    DEG_CASE(48)
    DEG_CASE(64)
    DEG_CASE(80)
    DEG_CASE(96)
    DEG_CASE(112)
    DEG_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DEG_CASE
}
