// prefix_scan.cu — inclusive prefix (or suffix) sum along the edge axis of
// [B, E, F], for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (distegnn_tpu_torch/ops/cumsum.py: _scan_cuda).
//
// Replaces the TPU kernels _prefix_kernel and _suffix_kernel
// (distegnn_tpu/ops/cumsum.py:38 and :62, launched by pallas_call in
// _prefix_pallas, :103). Same function: out[b, i, :] = sum_{j <= i} x[b, j, :]
// (suffix: j >= i), accumulated in f32 whatever the input type (f32 or
// bf16, widened on load), written as f32. Any E, any 1 <= F <= 8192, and a
// leading batch axis so that one call serves the B graphs of a batch.
//
// What bounds it on the H100: memory. It does one add per element, so the
// least time is the bytes — [B, E, F] read once, written once as f32 — over
// 3.35 TB/s (0.27 ms for the train path's [1.64M, 68] f32 stream).
//
// Design, against the TPU kernel: the TPU runs its grid in order and carries
// a [1, F] running total in VMEM from tile to tile. CUDA blocks run in no
// order, so this is a reduce-then-scan in three kernels:
//   1. tile_sums: block (blk, b) sums its block_rows rows per column (rows
//      read with consecutive threads on consecutive addresses, then a
//      fixed-order reduction in shared memory) -> sums[b, blk, :].
//   2. scan_sums: one thread per (b, column) turns the block sums into
//      exclusive carries, in block order (reverse order for the suffix),
//      with a compensated (Kahan) running sum.
//   3. tile_scan: block (blk, b) walks its rows again in chunks of at most
//      smem_elems values staged in shared memory; per chunk each column is
//      cut into S segments (S*F ~ 256 threads), each thread sums its
//      segment, adds the block-local carry and the segment sums before it,
//      and rescans its segment in place; each output is that block-local
//      prefix plus the block's carry; the chunk is stored coalesced and the
//      block-local carry moves on to the next chunk.
// So the input is read twice and the output written once (3 of the bound's
// 2 passes); a single-pass decoupled look-back scan is the faster design
// for a later version. Sums run in a fixed order, so results are
// deterministic run to run.
//
// Accuracy. The cumsum segment lowering takes differences of two prefixes,
// so the error that matters is relative to |prefix|. Like the TPU kernel
// (an in-tile scan plus one add of the running carry), every running total
// here stays block-local and the large carry is added once per output; a
// running total that carried the carry through every row of a block would
// round ~1000 times at |prefix| and stray ~10x further from the exact sum
// than the TPU's algorithm does (measured on the H100).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block of kernels 1 and 3
constexpr int NT_CARRY = 128;    // threads per block of kernel 2
// global loads each thread keeps in flight: one thread at a time waiting on
// device memory would leave the kernel latency-bound, not bandwidth-bound
constexpr int UNROLL = 16;

template <bool BF16>
__device__ __forceinline__ float load_x(const void* __restrict__ x,
                                        int64_t i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

// Kernel 1: per-(graph, block) column sums.
template <bool BF16>
__global__ void __launch_bounds__(NT)
    tile_sums(const void* __restrict__ x, float* __restrict__ sums, int E,
              int F, int block_rows, int n_blk) {
  extern __shared__ float red[];            // [RP * F]
  const int blk = blockIdx.x, b = blockIdx.y;
  const int RP = F < NT ? NT / F : 1;       // row lanes
  const int r0 = blk * block_rows;
  const int r1 = min(E, r0 + block_rows);
  const int64_t base = (int64_t)b * E * F;
  for (int item = threadIdx.x; item < RP * F; item += NT) {
    const int rl = item / F, c = item - (item / F) * F;
    float acc = 0.f;
    // UNROLL loads in flight per thread before their adds
    for (int r = r0 + rl; r < r1; r += UNROLL * RP) {
      float v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int rr = r + k * RP;
        v[k] = rr < r1 ? load_x<BF16>(x, base + (int64_t)rr * F + c) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) acc += v[k];
    }
    red[item] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < F; c += NT) {
    float acc = 0.f;
    for (int rl = 0; rl < RP; ++rl) acc += red[rl * F + c];
    sums[((int64_t)b * n_blk + blk) * F + c] = acc;
  }
}

// Kernel 2: block sums -> exclusive carries, in scan order.
template <bool REV>
__global__ void __launch_bounds__(NT_CARRY)
    scan_sums(const float* __restrict__ sums, float* __restrict__ carries,
              int B, int F, int n_blk) {
  const int idx = blockIdx.x * NT_CARRY + threadIdx.x;
  if (idx >= B * F) return;
  const int b = idx / F, c = idx - (idx / F) * F;
  const int64_t base = (int64_t)b * n_blk * F + c;
  // Kahan: comp holds what the last add rounded away (negated)
  float run = 0.f, comp = 0.f;
  for (int k = 0; k < n_blk; ++k) {
    const int blk = REV ? n_blk - 1 - k : k;
    const float v = sums[base + (int64_t)blk * F];
    carries[base + (int64_t)blk * F] = run - comp;
    const float y = v - comp;
    const float t = run + y;
    comp = (t - run) - y;
    run = t;
  }
}

// Kernel 3: rescan each block's rows with its carry.
template <bool BF16, bool REV>
__global__ void __launch_bounds__(NT)
    tile_scan(const void* __restrict__ x, float* __restrict__ out,
              const float* __restrict__ carries, int E, int F,
              int block_rows, int n_blk, int chunk_rows) {
  extern __shared__ float smem[];
  const int S = F < NT ? NT / F : 1;        // segments per column
  float* data = smem;                       // [chunk_rows * F]
  float* tot = data + (int64_t)chunk_rows * F;   // [S * F]
  float* carry = tot + S * F;               // [F] block-local, before chunk
  float* ncarry = carry + F;                // [F] block-local, after chunk
  float* bcarry = ncarry + F;               // [F] the blocks before this one
  const int blk = blockIdx.x, b = blockIdx.y;
  const int r0 = blk * block_rows;
  const int r1 = min(E, r0 + block_rows);
  const int n_chunks = (r1 - r0 + chunk_rows - 1) / chunk_rows;
  for (int c = threadIdx.x; c < F; c += NT) {
    carry[c] = 0.f;
    bcarry[c] = carries[((int64_t)b * n_blk + blk) * F + c];
  }

  for (int q = 0; q < n_chunks; ++q) {
    const int ch = REV ? n_chunks - 1 - q : q;
    const int c0 = r0 + ch * chunk_rows;
    const int rows = min(chunk_rows, r1 - c0);
    const int n = rows * F;
    const int64_t base = ((int64_t)b * E + c0) * F;
    // the previous chunk's stores and carry update are done
    __syncthreads();
    for (int i0 = threadIdx.x; i0 < n; i0 += UNROLL * NT) {
      float v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int i = i0 + k * NT;
        v[k] = i < n ? load_x<BF16>(x, base + i) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        if (i0 + k * NT < n) data[i0 + k * NT] = v[k];
    }
    __syncthreads();

    // segment length; a stride that is a multiple of 32 words would put
    // every segment of a warp on one shared-memory bank
    int L = (rows + S - 1) / S;
    if (((int64_t)L * F) % 32 == 0) ++L;
    for (int item = threadIdx.x; item < S * F; item += NT) {
      const int s = item / F, c = item - (item / F) * F;
      const int lo = s * L, hi = min(rows, lo + L);
      float acc = 0.f;
      if (REV) {
        for (int r = hi - 1; r >= lo; --r) acc += data[r * F + c];
      } else {
        for (int r = lo; r < hi; ++r) acc += data[r * F + c];
      }
      tot[item] = acc;
    }
    __syncthreads();
    for (int item = threadIdx.x; item < S * F; item += NT) {
      const int s = item / F, c = item - (item / F) * F;
      const int lo = s * L, hi = min(rows, lo + L);
      float run = carry[c];
      const float bc = bcarry[c];
      if (REV) {
        for (int t = S - 1; t > s; --t) run += tot[t * F + c];
        for (int r = hi - 1; r >= lo; --r) {
          run += data[r * F + c];
          data[r * F + c] = bc + run;
        }
        if (s == 0) ncarry[c] = run;
      } else {
        for (int t = 0; t < s; ++t) run += tot[t * F + c];
        for (int r = lo; r < hi; ++r) {
          run += data[r * F + c];
          data[r * F + c] = bc + run;
        }
        if (s == S - 1) ncarry[c] = run;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += NT) out[base + i] = data[i];
    for (int c = threadIdx.x; c < F; c += NT) carry[c] = ncarry[c];
  }
}

template <bool BF16, bool REV>
cudaError_t launch(const void* x, float* out, float* scratch, int B, int E,
                   int F, int block_rows, int smem_elems,
                   cudaStream_t stream) {
  const int n_blk = (E + block_rows - 1) / block_rows;
  float* sums = scratch;
  float* carries = scratch + (int64_t)B * n_blk * F;
  const dim3 grid(n_blk, B);

  const int RP = F < NT ? NT / F : 1;
  tile_sums<BF16><<<grid, NT, (size_t)RP * F * sizeof(float), stream>>>(
      x, sums, E, F, block_rows, n_blk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  scan_sums<REV><<<(B * F + NT_CARRY - 1) / NT_CARRY, NT_CARRY, 0, stream>>>(
      sums, carries, B, F, n_blk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int chunk_rows = smem_elems / F;
  if (chunk_rows < 1) chunk_rows = 1;
  if (chunk_rows > block_rows) chunk_rows = block_rows;
  const int S = F < NT ? NT / F : 1;
  const size_t smem =
      ((size_t)chunk_rows * F + (size_t)S * F + 3 * (size_t)F) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(tile_scan<BF16, REV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  tile_scan<BF16, REV><<<grid, NT, smem, stream>>>(
      x, out, carries, E, F, block_rows, n_blk, chunk_rows);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launches (0 = success).
//   x        [B, E, F] f32 (bf16 == 0) or bf16 (bf16 == 1), contiguous
//   out      [B, E, F] f32
//   scratch  2 * B * ceil(E / block_rows) * F f32 (block sums + carries)
//   reverse  0: prefix sum, 1: suffix sum
extern "C" int prefix_scan(const void* x, void* out, void* scratch, int B,
                           int E, int F, int block_rows, int smem_elems,
                           int bf16, int reverse, void* stream) {
  if (B < 1 || E < 1 || F < 1 || F > smem_elems || block_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  if (bf16) {
    return reverse ? (int)launch<true, true>(x, o, sc, B, E, F, block_rows,
                                             smem_elems, s)
                   : (int)launch<true, false>(x, o, sc, B, E, F, block_rows,
                                              smem_elems, s);
  }
  return reverse ? (int)launch<false, true>(x, o, sc, B, E, F, block_rows,
                                            smem_elems, s)
                 : (int)launch<false, false>(x, o, sc, B, E, F, block_rows,
                                             smem_elems, s);
}
