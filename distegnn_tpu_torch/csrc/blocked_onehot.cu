// blocked_onehot.cu — the blocked segment sum, its CSR plan and the row
// gather of the blocked edge layout, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes (distegnn_tpu_torch/ops/blocked.py:
// _plan_cuda, _seg_sum_cuda, _gather_cuda).
//
// Replaces the TPU kernels _seg_sum_kernel and _gather_kernel
// (distegnn_tpu/ops/blocked.py:290 and :306, launched by pallas_call in
// _seg_sum_impl, :336, and _gather_impl, :360). The layout: node block bi of
// graph b owns the edge slots [bi*epb, (bi+1)*epb) of the graph's E = nb*epb
// slots, and slot[b, e] is the block-local receiver of edge e, in
// [0, block), or a sentinel (any other value, `block` in practice) for a
// padding slot.
//
//   plan     the CSR of the slots: perm[b, bi*epb + j] (j < epb) lists the
//            block-local slot positions of block bi stably sorted by slot,
//            sentinels last; node k of the block owns perm entries
//            [off[b, bi, k], off[b, bi, k+1]) of the block's slice, and
//            deg[b, bi*block + k] = off[k+1] - off[k] (exact in f32).
//   seg_sum  out[b, bi*block + k, :] = sum of data[b, e, :] over the slots e
//            of block bi with slot == k, in edge order, in f32; data f32 or
//            bf16. Sentinels add nothing. It reads the slots through a plan.
//   gather   out[b, e, :] = h[b, bi*block + slot[b, e], :], and 0 at a
//            sentinel; in h's type (a bit copy, f32 or bf16).
//
// The TPU computes the sum and the gather as matmuls against a [tile,
// block] one-hot built in VMEM, because its matrix unit has no cheap
// scatter, and needs no sort. Here the function is E*F adds and one indexed
// read per slot. One forward's slots are the same for every layer, forward
// and backward, so the sort that turns them into per-node edge lists is a
// kernel of its own (blocked_plan), launched once per slot tensor; every
// segment sum over those slots then is a pure in-order reduction. One launch
// serves every graph of a batch (a grid axis), where the JAX package vmaps
// one pallas_call per graph.
//
// What bounds them on the H100: memory. The least time is the bytes over
// 3.35 TB/s: for seg_sum the real slots' rows of data and their perm
// entries read once, the offsets read once and the [B, N, F] f32 output
// written once; for the plan the slots read once and perm, off and deg
// written once; for the gather h and the slots read once and [B, E, F]
// written once.
//
// plan design. One CUDA block of PT threads per (node block, graph), every
// warp taking part. Warp w owns a contiguous range of the block's slots.
//   1. each warp counts its range per bucket (the block's nodes, then one
//      bucket for the sentinels) into its own row of shared memory:
//      __match_any_sync groups equal slots of 32 consecutive edges, and the
//      highest lane of a group adds the group's size (no atomics: a warp's
//      row is its own, a group's bucket unique in the warp);
//   2. per bucket, each warp's start within the bucket (the counts of the
//      warps before it) and the bucket's total;
//   3. a block-wide exclusive scan of the totals gives off (and deg);
//   4. each warp walks its range again in order and places every slot at
//      its bucket's start for this warp plus its rank among the equal slots
//      of lower lanes. Ranks follow lane order, warps follow edge order, so
//      the placement is stable: perm equals a stable argsort per block.
//
// seg_sum design. The grid covers nodes (graphs on the y axis), not node
// blocks, so a few node blocks still fill the card. Each node walks its
// perm range in order, loading SU rows before it adds any, and adds them in
// edge order into f32 registers: the result is the in-order f32 sum, bit
// for bit, and repeatable run to run (no floating-point atomics).
//   - rows of at most 16 bytes (F <= 4 f32, F <= 8 bf16: the coordinates'
//     F = 3, the F = 1 of a degree): one thread per node, its F columns in
//     registers (seg_sum_rows_kernel);
//   - wider rows: a group of G lanes per node (the smallest power of two
//     that covers the row in vectors of up to 16 bytes, at most 32), each
//     lane a vector of VEC columns, so the group reads a row in one
//     coalesced load (a 128-byte bf16 row is eight 16-byte vectors) and
//     writes its f32 sums as vectors (seg_sum_cols_kernel).
// Sentinel slots are never read.
//
// gather design, by row width (the wrapper chooses by the row's bytes).
// Rows over 16 bytes (F = 64): one output per (slot, vector of 16, 8, 4 or
// 2 bytes of the row), the widest vector that divides the row's bytes and
// to which both h and out are aligned (a view that starts mid-row takes a
// narrower one), a plain load from h (or zero at a sentinel), one store;
// each thread takes GU outputs and issues their loads together. Rows of at
// most 16 bytes (F <= 4 f32, F <= 8 bf16: the coordinates' F = 3) would
// give a 12-byte row three threads, three divisions and three reads of the
// same slot, so one thread takes one row (gather_rows_kernel): one slot
// read, one bounds test and one division, the row's words loaded together,
// GU rows in flight; a warp's 32 rows are one contiguous stretch of out,
// staged in shared memory and stored as 16-byte vectors. Graphs on the
// grid's y axis, so each thread's index arithmetic is 32-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int PT = 512;      // threads per block of the plan
constexpr int PW = PT / 32;  // its warps
constexpr int PU = 4;        // slots a lane loads ahead in the plan's walks
constexpr int NTR = 64;      // threads per block of the narrow segment sum
constexpr int NTC = 256;     // threads per block of the wide segment sum
constexpr int SU = 8;        // rows of a node loaded before any is added
constexpr int GT = 256;      // threads per block of the gather
constexpr int GU = 4;        // outputs per gather thread, loaded together

template <bool BF16>
__device__ __forceinline__ float load_f(const void* __restrict__ p,
                                        int64_t i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else {
    return static_cast<const float*>(p)[i];
  }
}

__host__ __device__ constexpr size_t plan_smem(int block) {
  // the per-warp counts, then starts [PW][block + 1], the bucket totals
  // [block + 1] and the scan's per-warp sums [PW]
  return ((size_t)(PW + 1) * (block + 1) + PW) * sizeof(int);
}

// a slot's bucket: its node, or `block` for every sentinel
__device__ __forceinline__ int plan_key(int s, int block) {
  return (unsigned)s < (unsigned)block ? s : block;
}

__global__ void __launch_bounds__(PT)
    plan_kernel(const int* __restrict__ slot, int* __restrict__ perm,
                int* __restrict__ off, float* __restrict__ deg, int nb,
                int epb, int block) {
  extern __shared__ int psm[];
  const int nk = block + 1;   // buckets
  int* cnt = psm;             // [PW][nk] counts, then each warp's starts
  int* tot = cnt + PW * nk;   // [nk]
  int* wsum = tot + nk;       // [PW]
  const int64_t blk = (int64_t)blockIdx.y * nb + blockIdx.x;
  const int* sl = slot + blk * epb;
  int* pm = perm + blk * epb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < PW * nk; i += PT) cnt[i] = 0;
  __syncthreads();

  // 1. each warp counts its contiguous range of slots into its own row
  const int per = (epb + PW - 1) / PW;
  const int r0 = min(epb, warp * per), r1 = min(epb, r0 + per);
  int* mine = cnt + warp * nk;
  for (int t = r0; t < r1; t += 32 * PU) {
    int key[PU];
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const int i = t + 32 * u + lane;
      key[u] = i < r1 ? plan_key(sl[i], block) : -1;
    }
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
      if (key[u] >= 0 && lane == 31 - __clz(peers))
        mine[key[u]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // 2. per bucket: each warp's start within it, and its total
  for (int k = tid; k < nk; k += PT) {
    int run = 0;
    for (int w = 0; w < PW; ++w) {
      const int c = cnt[w * nk + k];
      cnt[w * nk + k] = run;
      run += c;
    }
    tot[k] = run;
  }
  __syncthreads();

  // 3. exclusive scan of the totals: thread t owns q consecutive buckets
  const int q = (nk + PT - 1) / PT;
  const int k0 = min(nk, tid * q), k1 = min(nk, k0 + q);
  int local = 0;
  for (int k = k0; k < k1; ++k) local += tot[k];
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < PW ? wsum[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += v;
    }
    if (lane < PW) wsum[lane] = wi - w;
  }
  __syncthreads();
  int run = wsum[warp] + incl - local;
  int* og = off + blk * nk;
  float* dg = deg + blk * block;
  for (int k = k0; k < k1; ++k) {
    const int c = tot[k];
    og[k] = run;
    if (k < block) dg[k] = (float)c;
    for (int w = 0; w < PW; ++w) cnt[w * nk + k] += run;
    run += c;
  }
  __syncthreads();

  // 4. stable placement: each warp walks its range again, in order
  for (int t = r0; t < r1; t += 32 * PU) {
    int key[PU];
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const int i = t + 32 * u + lane;
      key[u] = i < r1 ? plan_key(sl[i], block) : -1;
    }
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
      if (key[u] >= 0)
        pm[mine[key[u]] + __popc(peers & ((1u << lane) - 1u))] =
            t + 32 * u + lane;
      __syncwarp();
      if (key[u] >= 0 && lane == 31 - __clz(peers))
        mine[key[u]] += __popc(peers);
      __syncwarp();
    }
  }
}

// One node's perm range [j0, j1) and the first data row of its block.
struct NodeRange {
  int j0, j1;
  const int* pm;
  int64_t row0;
};

__device__ __forceinline__ NodeRange node_range(const int* __restrict__ perm,
                                                const int* __restrict__ off,
                                                int n, int nb, int epb,
                                                int block) {
  const int bi = n / block, k = n - bi * block;
  const int64_t blk = (int64_t)blockIdx.y * nb + bi;
  const int* o = off + blk * (block + 1) + k;
  return {o[0], o[1], perm + blk * epb, blk * epb};
}

// rows of at most 16 bytes: one thread per node, K columns in registers
template <bool BF16, int K>
__global__ void __launch_bounds__(NTR)
    seg_sum_rows_kernel(const void* __restrict__ data,
                        const int* __restrict__ perm,
                        const int* __restrict__ off, float* __restrict__ out,
                        int n_nodes, int nb, int epb, int block) {
  const int n = blockIdx.x * NTR + threadIdx.x;
  if (n >= n_nodes) return;
  const NodeRange r = node_range(perm, off, n, nb, epb, block);
  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.f;
  for (int j = r.j0; j < r.j1; j += SU) {
    int p[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) p[u] = j + u < r.j1 ? r.pm[j + u] : -1;
    float v[SU][K];
#pragma unroll
    for (int u = 0; u < SU; ++u)
#pragma unroll
      for (int c = 0; c < K; ++c)
        v[u][c] = p[u] >= 0 ? load_f<BF16>(data, (r.row0 + p[u]) * K + c)
                            : 0.f;
#pragma unroll
    for (int u = 0; u < SU; ++u)
      if (p[u] >= 0)
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] += v[u][c];
  }
  float* o = out + ((int64_t)blockIdx.y * n_nodes + n) * K;
#pragma unroll
  for (int c = 0; c < K; ++c) o[c] = acc[c];
}

// VEC elements of the data type, loaded as one vector
template <bool BF16, int VEC>
struct RowVec {
  static constexpr int kBytes = VEC * (BF16 ? 2 : 4);
  using T = typename std::conditional<
      kBytes == 16, uint4,
      typename std::conditional<
          kBytes == 8, uint2,
          typename std::conditional<kBytes == 4, uint32_t,
                                    uint16_t>::type>::type>::type;
  __device__ static void add(float (&acc)[VEC], const T& v) {
    const void* pv = &v;
    if constexpr (BF16) {
      const __nv_bfloat16* e = static_cast<const __nv_bfloat16*>(pv);
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[c] += __bfloat162float(e[c]);
    } else {
      const float* e = static_cast<const float*>(pv);
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[c] += e[c];
    }
  }
};

// wider rows: a group of 2^lg lanes per node, VEC columns a lane
template <bool BF16, int VEC>
__global__ void __launch_bounds__(NTC)
    seg_sum_cols_kernel(const void* __restrict__ data,
                        const int* __restrict__ perm,
                        const int* __restrict__ off, float* __restrict__ out,
                        int n_nodes, int nb, int epb, int block, int F,
                        int lg) {
  using R = RowVec<BF16, VEC>;
  using V = typename R::T;
  const int t = blockIdx.x * NTC + threadIdx.x;
  const int n = t >> lg, gl = t & ((1 << lg) - 1);
  if (n >= n_nodes) return;
  const NodeRange r = node_range(perm, off, n, nb, epb, block);
  const V* d = static_cast<const V*>(data);
  const int fv = F / VEC;   // vectors a row
  float* o = out + ((int64_t)blockIdx.y * n_nodes + n) * F;
  for (int cv = gl; cv < fv; cv += 1 << lg) {
    float acc[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] = 0.f;
    for (int j = r.j0; j < r.j1; j += SU) {
      int p[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) p[u] = j + u < r.j1 ? r.pm[j + u] : -1;
      V v[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u)
        if (p[u] >= 0) v[u] = d[(r.row0 + p[u]) * fv + cv];
#pragma unroll
      for (int u = 0; u < SU; ++u)
        if (p[u] >= 0) R::add(acc, v[u]);
    }
    float* oc = o + cv * VEC;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int c = 0; c < VEC; c += 4)
        *reinterpret_cast<float4*>(oc + c) =
            make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(oc) = make_float2(acc[0], acc[1]);
    } else {
      oc[0] = acc[0];
    }
  }
}

template <bool BF16, int K>
cudaError_t launch_seg_rows(const void* data, const int* perm, const int* off,
                            float* out, int B, int nb, int epb, int block,
                            cudaStream_t s) {
  const int n_nodes = nb * block;
  const dim3 grid((n_nodes + NTR - 1) / NTR, B);
  seg_sum_rows_kernel<BF16, K><<<grid, NTR, 0, s>>>(data, perm, off, out,
                                                    n_nodes, nb, epb, block);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t seg_rows_k(const void* data, const int* perm, const int* off,
                       float* out, int B, int nb, int epb, int F, int block,
                       cudaStream_t s) {
  switch (F) {
#define SEG_ROWS_CASE(KK)                                                   \
  case KK:                                                                \
    if constexpr (KK * (BF16 ? 2 : 4) <= 16)                              \
      return launch_seg_rows<BF16, KK>(data, perm, off, out, B, nb, epb,  \
                                       block, s);                         \
    break;
    SEG_ROWS_CASE(1)
    SEG_ROWS_CASE(2)
    SEG_ROWS_CASE(3)
    SEG_ROWS_CASE(4)
    SEG_ROWS_CASE(5)
    SEG_ROWS_CASE(6)
    SEG_ROWS_CASE(7)
    SEG_ROWS_CASE(8)
#undef SEG_ROWS_CASE
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

template <bool BF16, int VEC>
cudaError_t launch_seg_cols(const void* data, const int* perm, const int* off,
                            float* out, int B, int nb, int epb, int F,
                            int block, cudaStream_t s) {
  // the smallest power-of-two group that covers the row's vectors, <= 32
  const int fv = F / VEC;
  int lg = 0;
  while ((1 << lg) < fv && lg < 5) ++lg;
  const int n_nodes = nb * block;
  const int64_t threads = (int64_t)n_nodes << lg;
  const dim3 grid((unsigned)((threads + NTC - 1) / NTC), B);
  seg_sum_cols_kernel<BF16, VEC><<<grid, NTC, 0, s>>>(
      data, perm, off, out, n_nodes, nb, epb, block, F, lg);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t seg_cols(const void* data, const int* perm, const int* off,
                     float* out, int B, int nb, int epb, int F, int block,
                     cudaStream_t s) {
  // the widest vector (<= 16 bytes) that divides the row and to which data
  // is aligned; rows start at multiples of the row's bytes
  constexpr int elt = BF16 ? 2 : 4;
  const uintptr_t align = (uintptr_t)data | (uintptr_t)(F * elt);
  if (align % 16 == 0)
    return launch_seg_cols<BF16, 16 / elt>(data, perm, off, out, B, nb, epb,
                                           F, block, s);
  if (align % 8 == 0)
    return launch_seg_cols<BF16, 8 / elt>(data, perm, off, out, B, nb, epb,
                                          F, block, s);
  if (BF16 && align % 4 != 0)
    return launch_seg_cols<BF16, 1>(data, perm, off, out, B, nb, epb, F,
                                    block, s);
  return launch_seg_cols<BF16, 4 / elt>(data, perm, off, out, B, nb, epb, F,
                                        block, s);
}

template <typename V>
__device__ __forceinline__ V zero_v() {
  if constexpr (sizeof(V) == 16) {
    return make_uint4(0u, 0u, 0u, 0u);
  } else if constexpr (sizeof(V) == 8) {
    return make_uint2(0u, 0u);
  } else {
    return V(0);
  }
}

template <typename V>
__global__ void __launch_bounds__(GT)
    gather_kernel(const V* __restrict__ h, const int* __restrict__ slot,
                  V* __restrict__ out, int nb, int epb, int fv, int block) {
  // one graph per blockIdx.y: every index below fits 32 bits (checked by
  // the wrapper), and 32-bit divisions are several times cheaper than
  // 64-bit ones
  const int b = blockIdx.y;
  const int n = nb * epb * fv;
  const V* hb = h + (int64_t)b * nb * block * fv;
  const int* sb = slot + (int64_t)b * nb * epb;
  V* ob = out + (int64_t)b * n;
  // GU outputs per thread, their loads issued before any is used: one
  // dependent slot-then-row load chain per thread would leave the copy
  // latency-bound at small F
  for (int i0 = blockIdx.x * GT * GU + threadIdx.x; i0 < n;
       i0 += gridDim.x * GT * GU) {
    int src[GU];
#pragma unroll
    for (int u = 0; u < GU; ++u) {
      const int i = i0 + u * GT;
      src[u] = -1;
      if (i < n) {
        const int e = i / fv;
        const int s = sb[e];
        if ((unsigned)s < (unsigned)block)
          src[u] = ((e / epb) * block + s) * fv + (i - e * fv);
      }
    }
    V v[GU];
#pragma unroll
    for (int u = 0; u < GU; ++u) v[u] = src[u] >= 0 ? hb[src[u]] : zero_v<V>();
#pragma unroll
    for (int u = 0; u < GU; ++u)
      if (i0 + u * GT < n) ob[i0 + u * GT] = v[u];
  }
}

template <typename V>
cudaError_t launch_gather(const void* h, const int* slot, void* out, int B,
                          int nb, int epb, int row_bytes, int block,
                          cudaStream_t stream) {
  const int fv = row_bytes / (int)sizeof(V);
  const int64_t per_graph = (int64_t)nb * epb * fv;
  int64_t blocks = (per_graph + GT * GU - 1) / (GT * GU);
  if (blocks > (1 << 20)) blocks = 1 << 20;   // the loop strides the rest
  const dim3 grid((unsigned)blocks, B);
  gather_kernel<V><<<grid, GT, 0, stream>>>(
      static_cast<const V*>(h), slot, static_cast<V*>(out), nb, epb, fv,
      block);
  return cudaGetLastError();
}

// Narrow rows (at most 16 bytes: F <= 4 f32, F <= 8 bf16). One thread per
// slot row: one read of slot[b, e], one bounds test and one division, then
// the row's K words of V (the widest of 16, 8, 4 or 2 bytes that divides the
// row and to which h and out are aligned) as independent loads; GU rows a
// thread in flight. A warp's 32 rows are 32 * row_bytes contiguous bytes of
// out: they are staged in shared memory and written as 16-byte vectors,
// where out's chunk is 16-byte aligned (vec), else word by word.
template <typename V, int K>
__global__ void __launch_bounds__(GT)
    gather_rows_kernel(const V* __restrict__ h, const int* __restrict__ slot,
                       V* __restrict__ out, int nb, int epb, int block,
                       int vec) {
  constexpr int CHUNK_V = 32 * K;   // V words of one warp's 32 rows
  static_assert(K * sizeof(V) <= 16, "narrow rows only");
  __shared__ __align__(16) V stage[GT / 32][GU][CHUNK_V];
  const int b = blockIdx.y;
  const int n = nb * epb;   // slot rows of a graph
  const V* hb = h + (int64_t)b * nb * block * K;
  const int* sb = slot + (int64_t)b * n;
  V* ob = out + (int64_t)b * n * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = blockIdx.x * GT * GU; r0 < n; r0 += gridDim.x * GT * GU) {
    int src[GU];
#pragma unroll
    for (int u = 0; u < GU; ++u) {
      const int r = r0 + u * GT + threadIdx.x;
      src[u] = -1;
      if (r < n) {
        const int s = sb[r];
        if ((unsigned)s < (unsigned)block) src[u] = ((r / epb) * block + s) * K;
      }
    }
    V v[GU][K];
#pragma unroll
    for (int u = 0; u < GU; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[u][k] = src[u] >= 0 ? hb[src[u] + k] : zero_v<V>();
#pragma unroll
    for (int u = 0; u < GU; ++u) {
      const int w0 = r0 + u * GT + warp * 32;   // this warp's first row
      const int r = w0 + lane;
      if (vec && w0 + 32 <= n) {
#pragma unroll
        for (int k = 0; k < K; ++k) stage[warp][u][lane * K + k] = v[u][k];
      } else if (r < n) {
#pragma unroll
        for (int k = 0; k < K; ++k) ob[r * K + k] = v[u][k];
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < GU; ++u) {
      const int w0 = r0 + u * GT + warp * 32;
      if (vec && w0 + 32 <= n) {
        constexpr int NV = CHUNK_V * (int)sizeof(V) / 16;
        const uint4* sv = reinterpret_cast<const uint4*>(stage[warp][u]);
        uint4* ov = reinterpret_cast<uint4*>(ob + w0 * K);
        for (int q = lane; q < NV; q += 32) ov[q] = sv[q];
      }
    }
    __syncwarp();
  }
}

template <typename V, int K>
cudaError_t launch_gather_rows(const void* h, const int* slot, void* out,
                               int B, int nb, int epb, int block, int vec,
                               cudaStream_t stream) {
  const int64_t rows = (int64_t)nb * epb;
  int64_t blocks = (rows + GT * GU - 1) / (GT * GU);
  if (blocks > (1 << 20)) blocks = 1 << 20;   // the loop strides the rest
  const dim3 grid((unsigned)blocks, B);
  gather_rows_kernel<V, K><<<grid, GT, 0, stream>>>(
      static_cast<const V*>(h), slot, static_cast<V*>(out), nb, epb, block,
      vec);
  return cudaGetLastError();
}

template <typename V>
cudaError_t gather_rows_k(const void* h, const int* slot, void* out, int B,
                          int nb, int epb, int k, int block, int vec,
                          cudaStream_t stream) {
  switch (k) {
#define ROWS_CASE(KK)                                                     \
  case KK:                                                                \
    if constexpr (KK * sizeof(V) <= 16)                                   \
      return launch_gather_rows<V, KK>(h, slot, out, B, nb, epb, block,   \
                                       vec, stream);                      \
    break;
    ROWS_CASE(1)
    ROWS_CASE(2)
    ROWS_CASE(3)
    ROWS_CASE(4)
    ROWS_CASE(5)
    ROWS_CASE(6)
    ROWS_CASE(7)
    ROWS_CASE(8)
#undef ROWS_CASE
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
//   slot  [B, nb*epb] int32
//   perm  [B, nb*epb] int32, off [B, nb, block + 1] int32, deg [B, nb*block]
//         f32: written
extern "C" int blocked_plan(const void* slot, void* perm, void* off,
                            void* deg, int B, int nb, int epb, int block,
                            void* stream) {
  if (B < 1 || nb < 1 || epb < 1 || block < 1 || B > 65535 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = plan_smem(block);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(nb, B);
  plan_kernel<<<grid, PT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slot), static_cast<int*>(perm),
      static_cast<int*>(off), static_cast<float*>(deg), nb, epb, block);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = success).
//   data  [B, nb*epb, F] f32 (bf16 == 0) or bf16 (bf16 == 1), contiguous
//   perm, off  the plan of the slots (blocked_plan)
//   out   [B, nb*block, F] f32
extern "C" int blocked_seg_sum(const void* data, const void* perm,
                               const void* off, void* out, int B, int nb,
                               int epb, int F, int block, int bf16,
                               void* stream) {
  if (B < 1 || nb < 1 || epb < 1 || F < 1 || block < 1 || B > 65535 ||
      (int64_t)nb * block * 32 >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pm = static_cast<const int*>(perm);
  const int* of = static_cast<const int*>(off);
  float* o = static_cast<float*>(out);
  const int row_bytes = F * (bf16 ? 2 : 4);
  if (row_bytes <= 16)
    return (int)(bf16 ? seg_rows_k<true>(data, pm, of, o, B, nb, epb, F,
                                         block, s)
                      : seg_rows_k<false>(data, pm, of, o, B, nb, epb, F,
                                          block, s));
  return (int)(bf16 ? seg_cols<true>(data, pm, of, o, B, nb, epb, F, block, s)
                    : seg_cols<false>(data, pm, of, o, B, nb, epb, F, block,
                                      s));
}

// Returns the cudaError_t of the launch (0 = success).
//   h     [B, nb*block, F] of elt_bytes (4: f32, 2: bf16), contiguous
//   slot  [B, nb*epb] int32
//   out   [B, nb*epb, F] of h's type
extern "C" int blocked_gather(const void* h, const void* slot, void* out,
                              int B, int nb, int epb, int F, int block,
                              int elt_bytes, void* stream) {
  if (B < 1 || nb < 1 || epb < 1 || F < 1 || block < 1 || B > 65535 ||
      (elt_bytes != 2 && elt_bytes != 4) ||
      (int64_t)nb * epb * F >= ((int64_t)1 << 30) ||
      (int64_t)nb * block * F >= ((int64_t)1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slot);
  const int row_bytes = F * elt_bytes;
  // every vector access is aligned to its width: the row's bytes and both
  // base addresses must be multiples of it
  const uintptr_t align = (uintptr_t)row_bytes | (uintptr_t)h |
                          (uintptr_t)out;
  if (align % 16 == 0)
    return (int)launch_gather<uint4>(h, sl, out, B, nb, epb, row_bytes,
                                     block, s);
  if (align % 8 == 0)
    return (int)launch_gather<uint2>(h, sl, out, B, nb, epb, row_bytes,
                                     block, s);
  if (align % 4 == 0)
    return (int)launch_gather<uint32_t>(h, sl, out, B, nb, epb, row_bytes,
                                        block, s);
  return (int)launch_gather<uint16_t>(h, sl, out, B, nb, epb, row_bytes,
                                      block, s);
}

// The same function for rows of at most 16 bytes (F * elt_bytes <= 16), one
// thread per row; returns the cudaError_t of the launch (0 = success).
extern "C" int blocked_gather_rows(const void* h, const void* slot,
                                   void* out, int B, int nb, int epb, int F,
                                   int block, int elt_bytes, void* stream) {
  const int row_bytes = F * elt_bytes;
  if (B < 1 || nb < 1 || epb < 1 || F < 1 || block < 1 || B > 65535 ||
      (elt_bytes != 2 && elt_bytes != 4) || row_bytes > 16 ||
      (int64_t)nb * epb * F >= ((int64_t)1 << 30) ||
      (int64_t)nb * block * F >= ((int64_t)1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slot);
  // every word access is aligned to its width: the row's bytes and both
  // base addresses must be multiples of it
  const uintptr_t align = (uintptr_t)row_bytes | (uintptr_t)h |
                          (uintptr_t)out;
  // the 16-byte stores of a warp's 32 rows: out and every graph's slice of
  // it 16-byte aligned (32 rows of an even byte count are 64-byte multiples)
  const int vec = (uintptr_t)out % 16 == 0 &&
                  ((int64_t)nb * epb * row_bytes) % 16 == 0;
  if (align % 16 == 0)
    return (int)gather_rows_k<uint4>(h, sl, out, B, nb, epb, row_bytes / 16,
                                     block, vec, s);
  if (align % 8 == 0)
    return (int)gather_rows_k<uint2>(h, sl, out, B, nb, epb, row_bytes / 8,
                                     block, vec, s);
  if (align % 4 == 0)
    return (int)gather_rows_k<uint32_t>(h, sl, out, B, nb, epb,
                                        row_bytes / 4, block, vec, s);
  return (int)gather_rows_k<uint16_t>(h, sl, out, B, nb, epb, row_bytes / 2,
                                      block, vec, s);
}
