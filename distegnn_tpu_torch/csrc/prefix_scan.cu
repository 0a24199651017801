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
// order, so this is a single-pass scan with a deterministic carry,
// one kernel that reads x once and writes out once:
//  - Each block takes one tile of R rows of one graph (R * F input values,
//    96 KB: two blocks an SM) by an atomic ticket, in scan order (graph by
//    graph, and within a graph first to last tile, or last to first for
//    the suffix). So every tile before it in the order has already
//    started, and waiting on one never deadlocks.
//  - The tile is copied into shared memory as it is (bf16 stays bf16) by
//    cp.async, and scanned there with tile-local running totals (each
//    column cut into S segments, S*F ~ 256 threads: segment sums, then each
//    segment rescanned from the sum of the segments before it). The
//    segment sums added in scan order are the tile's aggregate A_k,
//    published to global memory with a flag before the tile waits for
//    anything.
//  - The carry. A plain decoupled look-back is not deterministic for floats
//    (the order in which it sums the predecessors depends on which ones
//    have published an inclusive prefix). Here every sum has a fixed order,
//    over a three-level tree in scan order: the tiles' aggregates, the sums
//    of sub-groups of 16 tiles, the sums of super-groups of 16 sub-groups.
//    A sub-group's sum is computed by whichever of its tiles arrives last
//    (an atomic count after each aggregate is published), a super-group's
//    by whichever of its sub-groups' sums arrives last; either way it is
//    the Kahan sum of the same terms in the same order, so its bits do not
//    depend on who computes it, and nobody waits to compute it. A tile's
//    carry is the Kahan sum, in order, of the super-group sums before its
//    super-group, the sub-group sums of its super-group before its
//    sub-group, and the aggregates of its sub-group before it: at most
//    n_tiles / 256 + 30 terms, all published by tiles that hold earlier
//    tickets, with no chain of waits. So the result is bitwise repeatable
//    run to run. The partial sums are published as Kahan pairs (value =
//    run - comp); a tile's terms are cut into S contiguous parts (S
//    threads a column, 8 terms' loads in flight each), added in order.
//  - Each output is the tile-local prefix plus the carry, one add, stored
//    once: f32 tiles are rescanned in place while the carry's terms are
//    awaited and stored in 16-byte pieces; bf16 tiles are rescanned from
//    their input once the carry is known, each thread storing a column
//    (consecutive threads on consecutive columns).
// No allocation: the caller passes scratch for the aggregates, the tree's
// sums and the flags; the flags, counts and ticket are zeroed here by one
// cudaMemsetAsync on the caller's stream.
//
// Accuracy. The cumsum segment lowering takes differences of two prefixes,
// so the error that matters is relative to |prefix|. Like the TPU kernel
// (an in-tile scan plus one add of the running carry), every running total
// here stays tile-local and the large carry, compensated, is added once per
// output; a running total that carried the carry through every row would
// round ~1000 times at |prefix| and stray ~10x further from the exact sum
// than the TPU's algorithm does (measured on the H100).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;   // threads per block
// the carry's tree: SUB tiles a sub-group, SUB sub-groups a super-group
constexpr int SUB = 16;

// Kahan: value = run - comp, comp holding what the adds rounded away
// (negated). Every add in a fixed order, no FMA contraction (none is
// possible: there is no product).
__device__ __forceinline__ void kahan_add(float& run, float& comp, float v) {
  const float y = v - comp;
  const float t = run + y;
  comp = (t - run) - y;
  run = t;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void wait_flag(const int* p) {
  while (ld_acquire(p) == 0) __nanosleep(32);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// One tile's input span x[base .. base + n) (elements of In) -> d[0 .. n)
// in shared memory, as it is (bf16 stays bf16), d = buf + base % VEC so that
// the 16-byte pieces of x (16-byte aligned: the entry point checks) land on
// 16-byte aligned shared memory: the pieces by cp.async (one commit group,
// waited for by wait_tile), the ragged head and tail by plain loads.
template <typename In>
__device__ __forceinline__ void issue_tile(const In* __restrict__ x,
                                           int64_t base, int n, In* d) {
  constexpr int VEC = 16 / sizeof(In);
  const int64_t end = base + n;
  int64_t ga = (base + VEC - 1) / VEC * VEC, gb = end / VEC * VEC;
  if (gb < ga) ga = gb = end;
  for (int64_t g = base + threadIdx.x; g < ga; g += NT) d[g - base] = x[g];
  for (int64_t g = gb + threadIdx.x; g < end; g += NT) d[g - base] = x[g];
  const int nv = (int)((gb - ga) / VEC);
  In* dv = d + (ga - base);
  for (int q = threadIdx.x; q < nv; q += NT)
    cp_async16(dv + (int64_t)VEC * q, x + ga + (int64_t)VEC * q);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_tile() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The carry's terms: the level-2 sums of the graph's super-groups before
// the tile's, then the level-1 sums of its super-group's sub-groups before
// its own, then the aggregates of its sub-group before it. Term i of that
// list, as (pointer, pair): a pair is (run, comp) F apart, added as run then
// -comp; an aggregate is one value.
struct Terms {
  const float* s2;   // [n2, 2, F] of this graph, from the first
  const float* s1;   // the first sub-group sum of the super-group
  const float* a;    // the first aggregate of the sub-group
  int n2, n1, na, F;
  __device__ int count() const { return n2 + n1 + na; }
  __device__ const float* at(int i, bool& pair) const {
    pair = i < n2 + n1;
    if (i < n2) return s2 + (int64_t)i * 2 * F;
    if (i < n2 + n1) return s1 + (int64_t)(i - n2) * 2 * F;
    return a + (int64_t)(i - n2 - n1) * F;
  }
};

// the Kahan sum, at column c, of terms [i0, i1) in order, UW terms' loads
// in flight
__device__ __forceinline__ void sum_terms(const Terms& T, int i0, int i1,
                                          int c, float& run, float& comp) {
  constexpr int UW = 8;
  for (int i = i0; i < i1; i += UW) {
    float v[UW], w[UW];
    bool pr[UW];
#pragma unroll
    for (int u = 0; u < UW; ++u) {
      pr[u] = false;
      if (i + u < i1) {
        const float* q = T.at(i + u, pr[u]);
        v[u] = __ldcg(q + c);
        w[u] = pr[u] ? __ldcg(q + T.F + c) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UW; ++u)
      if (i + u < i1) {
        kahan_add(run, comp, v[u]);
        if (pr[u]) kahan_add(run, comp, -w[u]);
      }
  }
}

// the Kahan sum of n consecutive [F] rows (pairs: [2, F]) from p, in order,
// into out (run) and out + F (comp); columns split over the block
__device__ __forceinline__ void sum_rows(const float* p, int n, bool pair,
                                         int F, float* out) {
  const Terms T{p, p, p, pair ? n : 0, 0, pair ? 0 : n, F};
  for (int c = threadIdx.x; c < F; c += NT) {
    float run = 0.f, comp = 0.f;
    sum_terms(T, 0, n, c, run, comp);
    out[c] = run;
    out[F + c] = comp;
  }
}

// A tile of the scan, from its ticket t: graph b, position k in scan order
// (sub-group h, super-group q), its rows and its span of x / out.
struct TileAt {
  int b, k, h, q, rows, n, shift;
  int64_t base;
  __device__ TileAt(int t, int n_tiles, int E, int F, int R, bool rev,
                    int vec) {
    b = t / n_tiles;
    k = t - b * n_tiles;
    h = k / SUB;
    q = h / SUB;
    const int tile = rev ? n_tiles - 1 - k : k;
    const int r0 = tile * R;
    rows = min(R, E - r0);
    n = rows * F;
    base = ((int64_t)b * E + r0) * F;
    shift = (int)(base % vec);
  }
};

// The single pass: one block a tile, taken by ticket: its front (segment
// sums, aggregate and group sums, published), its rescan, its carry, its
// store. Every wait is on a tile of an earlier ticket, whose front does
// not wait, so the waits always end. Scratch (Scratch below): agg [B, n_tiles, F], s1
// [B, n_sub, 2, F], s2 [B, n_super, 2, F] (f32), the flags of the three
// levels, the arrival counts of the sub- and super-groups and the ticket
// (int, zeroed before the launch).
template <bool BF16, bool REV>
__global__ void __launch_bounds__(NT)
    scan_pass(const void* __restrict__ xv, float* __restrict__ out,
              float* agg, float* s1, float* s2, int* aflag, int* s1flag,
              int* s2flag, int* cnt1, int* cnt2, int* ticket, int E, int F,
              int R, int n_tiles) {
  using In = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int VEC = 16 / sizeof(In);
  const In* __restrict__ x = static_cast<const In*>(xv);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ticket, s_last;
  const int tid = threadIdx.x;
  const int S = F < NT ? NT / F : 1;      // segments per column
  const int n_sub = (n_tiles + SUB - 1) / SUB;
  const int n_super = (n_sub + SUB - 1) / SUB;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const TileAt T(s_ticket, n_tiles, E, F, R, REV, VEC);
  // the tile's input as it is (bf16 stays bf16), its segment sums, the
  // carry's parts (run, comp), part 0 then holding the carry
  const size_t buf_bytes = ((size_t)(R * F + VEC) * sizeof(In) + 15) / 16 * 16;
  In* d = reinterpret_cast<In*>(smem_raw) + T.shift;
  float* tot = reinterpret_cast<float*>(smem_raw + buf_bytes);
  float* prun = tot + S * F;
  float* pcomp = prun + S * F;
  float* carry = prun;
  float* ga = agg + (int64_t)T.b * n_tiles * F;
  float* g1 = s1 + (int64_t)T.b * n_sub * 2 * F;
  float* g2 = s2 + (int64_t)T.b * n_super * 2 * F;
  float* o = out + T.base;
  // segment length; a stride that is a multiple of 32 words would put
  // every segment of a warp on one shared-memory bank
  int L = (T.rows + S - 1) / S;
  if (((int64_t)L * F) % 32 == 0) ++L;

  issue_tile(x, T.base, T.n, d);
  wait_tile();
  __syncthreads();

  // ---- front: the segment sums and the aggregate (the segment sums added
  //      in scan order), published at once; the last tile of its sub-group
  //      to arrive sums the sub-group, the last sub-group of its super-group
  //      the super-group. Nothing here waits: what other tiles wait for is
  //      published before this tile waits for anything.
  for (int item = tid; item < S * F; item += NT) {
    const int s = item / F, c = item - (item / F) * F;
    const int lo = s * L, hi = min(T.rows, lo + L);
    float acc = 0.f;
    if (REV) {
      for (int r = hi - 1; r >= lo; --r) acc += widen(d[r * F + c]);
    } else {
      for (int r = lo; r < hi; ++r) acc += widen(d[r * F + c]);
    }
    tot[item] = acc;
  }
  __syncthreads();
  for (int c = tid; c < F; c += NT) {
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc += tot[(REV ? S - 1 - j : j) * F + c];
    ga[(int64_t)T.k * F + c] = acc;
  }
  if (tid < F) __threadfence();   // the writers' stores, before the flag
  __syncthreads();
  if (tid == 0) {
    st_release(aflag + (int64_t)T.b * n_tiles + T.k, 1);
    const int size = min(SUB, n_tiles - T.h * SUB);
    s_last = atomicAdd(cnt1 + (int64_t)T.b * n_sub + T.h, 1) == size - 1;
    __threadfence();
  }
  __syncthreads();
  if (s_last) {   // the last of its sub-group: the sub-group's sum
    sum_rows(ga + (int64_t)T.h * SUB * F, min(SUB, n_tiles - T.h * SUB),
             false, F, g1 + (int64_t)T.h * 2 * F);
    if (tid < F) __threadfence();
    __syncthreads();
    if (tid == 0) {
      st_release(s1flag + (int64_t)T.b * n_sub + T.h, 1);
      const int size = min(SUB, n_sub - T.q * SUB);
      s_last = atomicAdd(cnt2 + (int64_t)T.b * n_super + T.q, 1) == size - 1;
      __threadfence();
    }
    __syncthreads();
    if (s_last) {   // and of its super-group: the super-group's sum
      sum_rows(g1 + (int64_t)T.q * SUB * 2 * F, min(SUB, n_sub - T.q * SUB),
               true, F, g2 + (int64_t)T.q * 2 * F);
      if (tid < F) __threadfence();
      __syncthreads();
      if (tid == 0) st_release(s2flag + (int64_t)T.b * n_super + T.q, 1);
    }
  }

  // ---- rescan: each segment from the sum of the segments before it. f32
  //      in place now, before the carry is known, so that it overlaps the
  //      waits; bf16 (the input stays bf16) after the carry, below
  const auto rescan = [&]() {
    for (int item = tid; item < S * F; item += NT) {
      const int s = item / F, c = item - (item / F) * F;
      const int lo = s * L, hi = min(T.rows, lo + L);
      float run = 0.f;
      if (REV) {
        for (int j = S - 1; j > s; --j) run += tot[j * F + c];
        for (int r = hi - 1; r >= lo; --r) {
          run += widen(d[r * F + c]);
          if constexpr (BF16) __stcs(o + r * F + c, carry[c] + run);
          else d[r * F + c] = run;
        }
      } else {
        for (int j = 0; j < s; ++j) run += tot[j * F + c];
        for (int r = lo; r < hi; ++r) {
          run += widen(d[r * F + c]);
          if constexpr (BF16) __stcs(o + r * F + c, carry[c] + run);
          else d[r * F + c] = run;
        }
      }
    }
  };
  if constexpr (!BF16) rescan();

  // ---- the carry: the Kahan sum of the tile's terms (Terms) in order, cut
  //      into S contiguous parts (S threads a column), the parts then added
  //      in order; every term from a tile of an earlier ticket
  const Terms W{g2, g1 + (int64_t)T.q * SUB * 2 * F,
                ga + (int64_t)T.h * SUB * F, T.q, T.h - T.q * SUB,
                T.k - T.h * SUB, F};
  for (int i = tid; i < W.n2; i += NT)
    wait_flag(s2flag + (int64_t)T.b * n_super + i);
  if (tid < W.n1) wait_flag(s1flag + (int64_t)T.b * n_sub + T.q * SUB + tid);
  if (tid >= NT / 2 && tid < NT / 2 + W.na)
    wait_flag(aflag + (int64_t)T.b * n_tiles + T.h * SUB + tid - NT / 2);
  __syncthreads();
  const int nt = W.count(), per = (nt + S - 1) / S;
  for (int item = tid; item < S * F; item += NT) {
    const int s = item / F, c = item - (item / F) * F;
    float run = 0.f, comp = 0.f;
    sum_terms(W, s * per, min(nt, (s + 1) * per), c, run, comp);
    prun[item] = run;
    pcomp[item] = comp;
  }
  __syncthreads();
  for (int c = tid; c < F; c += NT) {
    float run = prun[c], comp = pcomp[c];
    for (int j = 1; j < S && j * per < nt; ++j) {
      kahan_add(run, comp, prun[j * F + c]);
      kahan_add(run, comp, -pcomp[j * F + c]);
    }
    carry[c] = run - comp;
  }
  __syncthreads();

  // ---- out = the tile-local prefix + the carry, stored once: bf16 as it
  //      is rescanned (consecutive threads on consecutive columns), f32 in
  //      16-byte pieces (out is 256-byte aligned, so (base + i) % 4 == 0
  //      where d + i is 16-byte aligned)
  if constexpr (BF16) {
    rescan();
  } else {
    const int n = T.n;
    const int ia = min(n, (4 - (int)(T.base % 4)) % 4);
    const int ib = ia + (n - ia) / 4 * 4;
    for (int i = tid; i < ia; i += NT) o[i] = carry[i % F] + d[i];
    for (int i = ib + tid; i < n; i += NT) o[i] = carry[i % F] + d[i];
    for (int v = tid; v < (ib - ia) / 4; v += NT) {
      const int i = ia + 4 * v;
      const float4 w = *reinterpret_cast<const float4*>(d + i);
      int c = i % F;
      float4 y;
      y.x = carry[c] + w.x;
      if (++c == F) c = 0;
      y.y = carry[c] + w.y;
      if (++c == F) c = 0;
      y.z = carry[c] + w.z;
      if (++c == F) c = 0;
      y.w = carry[c] + w.w;
      __stcs(reinterpret_cast<float4*>(o + i), y);
    }
  }
}

// shared memory of a block: the tile's R * F input values (and 16 bytes of
// alignment slack), its [S, F] segment sums, the carry's parts
inline size_t smem_bytes(int R, int F, int in_bytes) {
  const int S = F < NT ? NT / F : 1;
  const size_t buf = ((size_t)(R * F + 16 / in_bytes) * in_bytes + 15) / 16 * 16;
  return buf + 3 * (size_t)S * F * sizeof(float);
}

// the scratch's parts, in the order prefix_scan_scratch_bytes counts them
struct Scratch {
  float* agg;
  float* s1;
  float* s2;
  int* aflag;
  int* s1flag;
  int* s2flag;
  int* cnt1;
  int* cnt2;
  int* ticket;
  size_t ints;   // the int part, zeroed before each launch
  Scratch(void* p, int64_t B, int64_t n_tiles, int64_t F) {
    const int64_t n_sub = (n_tiles + SUB - 1) / SUB;
    const int64_t n_super = (n_sub + SUB - 1) / SUB;
    agg = static_cast<float*>(p);
    s1 = agg + B * n_tiles * F;
    s2 = s1 + B * n_sub * 2 * F;
    aflag = reinterpret_cast<int*>(s2 + B * n_super * 2 * F);
    s1flag = aflag + B * n_tiles;
    s2flag = s1flag + B * n_sub;
    cnt1 = s2flag + B * n_super;
    cnt2 = cnt1 + B * n_sub;
    ticket = cnt2 + B * n_super;
    ints = (size_t)(B * n_tiles + 2 * B * n_sub + 2 * B * n_super + 1);
  }
  static int64_t bytes(int64_t B, int64_t n_tiles, int64_t F) {
    const int64_t n_sub = (n_tiles + SUB - 1) / SUB;
    const int64_t n_super = (n_sub + SUB - 1) / SUB;
    return (B * n_tiles * F + (B * n_sub + B * n_super) * 2 * F) * 4 +
           (B * n_tiles + 2 * B * n_sub + 2 * B * n_super + 1) * 4;
  }
};

template <bool BF16, bool REV>
cudaError_t launch(const void* x, float* out, void* scratch, int B, int E,
                   int F, int R, cudaStream_t stream) {
  const int n_tiles = (E + R - 1) / R;
  const Scratch sc(scratch, B, n_tiles, F);
  cudaError_t err =
      cudaMemsetAsync(sc.aflag, 0, sc.ints * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(R, F, BF16 ? 2 : 4);
  auto kern = scan_pass<BF16, REV>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((int64_t)B * n_tiles), NT, smem, stream>>>(
      x, out, sc.agg, sc.s1, sc.s2, sc.aflag, sc.s1flag, sc.s2flag, sc.cnt1,
      sc.cnt2, sc.ticket, E, F, R, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// The scratch a call needs, in bytes: agg [B, n_tiles, F], s1 [B, n_sub,
// 2, F] and s2 [B, n_super, 2, F] f32, then the int flags and counts, with
// n_tiles = ceil(E / R), n_sub = ceil(n_tiles / 16), n_super =
// ceil(n_sub / 16).
extern "C" long long prefix_scan_scratch_bytes(int B, int E, int F, int R) {
  return Scratch::bytes(B, (E + (int64_t)R - 1) / R, F);
}

// Returns the cudaError_t of the launch (0 = success).
//   x        [B, E, F] f32 (bf16 == 0) or bf16 (bf16 == 1), contiguous,
//            16-byte aligned
//   out      [B, E, F] f32, 16-byte aligned
//   scratch  prefix_scan_scratch_bytes(B, E, F, R) bytes
//   R        rows of a tile (two buffers of R * F input values of shared
//            memory a block)
//   reverse  0: prefix sum, 1: suffix sum
extern "C" int prefix_scan(const void* x, void* out, void* scratch, int B,
                           int E, int F, int R, int bf16, int reverse,
                           void* stream) {
  if (B < 1 || E < 1 || F < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)R * F > (1 << 24) ||
      (int64_t)B * ((E + (int64_t)R - 1) / R) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (bf16) {
    return reverse
               ? (int)launch<true, true>(x, o, scratch, B, E, F, R, s)
               : (int)launch<true, false>(x, o, scratch, B, E, F, R, s);
  }
  return reverse
             ? (int)launch<false, true>(x, o, scratch, B, E, F, R, s)
             : (int)launch<false, false>(x, o, scratch, B, E, F, R, s);
}
