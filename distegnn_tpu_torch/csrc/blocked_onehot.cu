// blocked_onehot.cu — the blocked segment sum and row gather of the blocked
// edge layout, for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (distegnn_tpu_torch/ops/blocked.py: _seg_sum_cuda, _gather_cuda).
//
// Replaces the TPU kernels _seg_sum_kernel and _gather_kernel
// (distegnn_tpu/ops/blocked.py:290 and :306, launched by pallas_call in
// _seg_sum_impl, :336, and _gather_impl, :360). The layout: node block bi of
// graph b owns the edge slots [bi*epb, (bi+1)*epb) of the graph's E = nb*epb
// slots, and slot[b, e] is the block-local receiver of edge e, in
// [0, block), or a sentinel (any other value, `block` in practice) for a
// padding slot.
//
//   seg_sum  out[b, bi*block + k, :] = sum of data[b, e, :] over the slots e
//            of block bi with slot == k; f32 out, f32 accumulation, data f32
//            or bf16. Sentinels add nothing.
//   gather   out[b, e, :] = h[b, bi*block + slot[b, e], :], and 0 at a
//            sentinel; in h's type (a bit copy, f32 or bf16).
//
// The TPU computes both as matmuls against a [tile, block] one-hot built in
// VMEM, because its matrix unit has no cheap scatter. The function itself is
// E*F adds and one indexed read per slot, which is what this file does; one
// launch serves every graph of a batch (a grid axis), where the JAX package
// vmaps one pallas_call per graph.
//
// What bounds them on the H100: memory. The least time is the bytes (the
// [B, E, F] edge array and the slots read once, the [B, N, F] node array
// written once for seg_sum; h read once, slots read once and [B, E, F]
// written once for the gather) over 3.35 TB/s.
//
// seg_sum design (deterministic: no floating-point atomics). One CUDA block
// per (node block, chunk of <= 32 feature columns, graph). The block walks
// its slot slice in chunks of CHUNK slots; per chunk it builds the CSR of the
// chunk in shared memory — per-slot counts (integer atomics, exact), their
// exclusive scan, then a stable placement of the edge positions by one warp
// (__match_any_sync groups equal slots of 32 consecutive edges; ranks within
// a group follow lane order, groups follow edge order) — and then each
// (node k, column c) pair adds its edges' values, in edge order, into an f32
// accumulator in shared memory. Consecutive threads take consecutive columns
// of one node, so each edge row is read coalesced. Every sum runs in a fixed
// order, so the result is bitwise repeatable run to run. Both the slots and
// the edge array are read once per feature chunk (twice at F = 64).
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

namespace {

constexpr int NT = 256;      // threads per block of the segment sum
constexpr int FC = 32;       // feature columns per block of the segment sum
constexpr int CHUNK = 2048;  // slots sorted per pass of the segment sum
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

__host__ __device__ constexpr size_t seg_sum_smem(int block) {
  // perm[CHUNK] + off[block + 1] + fill[block] ints, acc[block * FC] floats
  return (size_t)(CHUNK + 2 * block + 1) * sizeof(int) +
         (size_t)block * FC * sizeof(float);
}

template <bool BF16>
__global__ void __launch_bounds__(NT)
    seg_sum_kernel(const void* __restrict__ data,
                   const int* __restrict__ slot, float* __restrict__ out,
                   int nb, int epb, int F, int block) {
  extern __shared__ int smem[];
  int* perm = smem;                    // chunk positions sorted by slot
  int* off = perm + CHUNK;             // [block + 1] counts, then starts
  int* fill = off + block + 1;         // [block] next free position
  float* acc = reinterpret_cast<float*>(fill + block);   // [block * fc]

  const int bi = blockIdx.x, f0 = blockIdx.y * FC, b = blockIdx.z;
  const int fc = min(FC, F - f0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t e_base = ((int64_t)b * nb + bi) * epb;
  const int* sl = slot + e_base;
  const int npairs = block * fc;
  for (int p = tid; p < npairs; p += NT) acc[p] = 0.f;

  for (int c0 = 0; c0 < epb; c0 += CHUNK) {
    const int n = min(CHUNK, epb - c0);
    for (int k = tid; k <= block; k += NT) off[k] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += NT) {
      const int s = sl[c0 + i];
      if ((unsigned)s < (unsigned)block) atomicAdd(&off[s], 1);
    }
    __syncthreads();

    if (warp == 0) {
      // exclusive scan of the counts: lane owns `per` consecutive slots
      const int per = (block + 31) / 32;
      const int k0 = min(block, lane * per), k1 = min(block, k0 + per);
      int local = 0;
      for (int k = k0; k < k1; ++k) local += off[k];
      int incl = local;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      int run = incl - local;
      __syncwarp();
      for (int k = k0; k < k1; ++k) {
        const int c = off[k];
        off[k] = run;
        fill[k] = run;
        run += c;
      }
      if (lane == 31) off[block] = incl;
      __syncwarp();

      // stable placement, 32 consecutive slots at a time
      for (int t = 0; t < n; t += 32) {
        const int i = t + lane;
        const int s = i < n ? sl[c0 + i] : -1;
        const bool v = (unsigned)s < (unsigned)block;
        const unsigned peers = __match_any_sync(0xffffffffu, v ? s : -1);
        if (v) perm[fill[s] + __popc(peers & ((1u << lane) - 1u))] = i;
        __syncwarp();
        if (v && lane == 31 - __clz(peers)) fill[s] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();

    const int64_t row0 = e_base + c0;
    for (int p = tid; p < npairs; p += NT) {
      const int k = p / fc, c = p - k * fc;
      float a = acc[p];
      const int j1 = off[k + 1];
#pragma unroll 4
      for (int j = off[k]; j < j1; ++j)
        a += load_f<BF16>(data, (row0 + perm[j]) * F + f0 + c);
      acc[p] = a;
    }
    __syncthreads();
  }

  float* o = out + ((int64_t)b * nb + bi) * block * F + f0;
  for (int p = tid; p < npairs; p += NT) {
    const int k = p / fc, c = p - k * fc;
    o[(int64_t)k * F + c] = acc[p];
  }
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
//   data  [B, nb*epb, F] f32 (bf16 == 0) or bf16 (bf16 == 1), contiguous
//   slot  [B, nb*epb] int32
//   out   [B, nb*block, F] f32
extern "C" int blocked_seg_sum(const void* data, const void* slot, void* out,
                               int B, int nb, int epb, int F, int block,
                               int bf16, void* stream) {
  if (B < 1 || nb < 1 || epb < 1 || F < 1 || block < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = seg_sum_smem(block);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nb, (F + FC - 1) / FC, B);
  const int* sl = static_cast<const int*>(slot);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (bf16) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(seg_sum_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    seg_sum_kernel<true><<<grid, NT, smem, s>>>(data, sl, o, nb, epb, F,
                                                block);
  } else {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(seg_sum_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    seg_sum_kernel<false><<<grid, NT, smem, s>>>(data, sl, o, nb, epb, F,
                                                 block);
  }
  return (int)cudaGetLastError();
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
