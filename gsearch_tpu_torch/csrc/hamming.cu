// Sketch distance kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Both compute the Hamming fraction of signature slots compared as 32-bit
// patterns: distance = 1 - eq / S, in f32 with IEEE division (the build
// does not pass --use_fast_math), which is bit-exact with the plain torch
// versions in gsearch_tpu_torch/ops/distance.py.
//
// K1 gs_hamming_frac  replaces gsearch_tpu/ops/distance.py:
//   hamming_frac_pallas / _eqcount_kernel.  [Q, S] x [N, S] -> [Q, N], or
//   a batch of such problems (gridDim.z), or with `pairs` the self-pair
//   form x [B, C, S] against itself -> [B, C, C].
//   Bound: one 32-bit compare-and-count per (query, row, slot), i.e.
//   integer issue rate, at large Q * N; the bytes of the database rows at
//   small Q (a request against a small flat index).
//   Design (sm_90a):
//   - a block owns a TQ x TN output tile and loops over its span of S (the
//     TPU's sequential S grid axis) in chunks of 32 slots (128 bytes a
//     row).  Chunks stream through a ring of STAGES shared-memory buffers
//     (dynamic shared memory, 64-104 KB a block, above the 48 KB static
//     limit through cudaFuncSetAttribute) fed by 16-byte cp.async
//     (cp.async.cg, L2 only): chunk c + STAGES - 1 is in flight while chunk
//     c is compared.  cp.async and not TMA: the tiles are plain row-major
//     slabs whose row counts change with the shape (8..256 rows), rows
//     are addressed per batch member, and a 16-byte cp.async with a source
//     size of 0 zero-fills the ragged edges in the same instruction, so no
//     tensor map has to be built on the host for every call.  Rows or
//     slots that are not 16-byte aligned (S % 4 != 0) take 4-byte cp.async.
//   - each thread holds a 4 x 8 tile of counts in registers and reads its
//     operands as 16-byte vectors (4 slots a load): 12 LDS.128 for 128
//     compares, a quarter of the shared-memory traffic per compare of the
//     earlier 2 x 4 scalar design.  The 16-byte group g of stage row r
//     sits at g ^ (r & 7), so the eight threads of a load phase, which
//     read eight consecutive database rows, hit eight different bank
//     quads; threads that read the same query row share its broadcast.
//   - the tile is chosen by shape in the wrapper (ops/distance.py
//     k1_plan): narrow8 (8 x 256) and narrow16 (16 x 256) tiles for
//     request shapes stream the database rows once per 8 or 16 queries;
//     the square wide tile (64 x 64) for large Q, N and batches.  Tiles
//     are enumerated query-tile fastest so neighbouring blocks share a
//     database tile in L2.
//   - S is split over gridDim.y where that shortens the launch: where the
//     tiles cannot fill the SMs, or leave a last wave mostly empty (the
//     plan weighs waves against the extra work of a split block).  Each
//     split block adds its counts atomically into a workspace that is zero
//     on entry, and the last block of a tile (a ticket counter) writes the
//     distances and zeroes its workspace entries and ticket again: one
//     launch, no zero fill and no finish kernel.
//   - pairs: blockIdx.x enumerates only tiles on and above the diagonal
//     (eq(i, j) = eq(j, i)); an off-diagonal tile writes its transpose too.
//     The diagonal comes out as 1 - S/S = 0.0 for any bit pattern.
//   Zero-filled slots past the span are equal in both operands, so every
//   pair counts exactly `pad` of them; each block subtracts it, which keeps
//   the compare loop free of masks.  Rows past Q or N are never written.
//   Counts are integers and the division is IEEE, so every tile and split
//   choice gives the same bits as the plain version.
//   Cost of one slot compare: ISETP.EQ + an add of its predicate (see the
//   SASS count in PERF.md), plus 12 LDS.128 per 128 compares.

// K2 gs_gather_hamming  replaces gsearch_tpu/ops/distance.py:
//   gather_hamming_pallas / _gather_eq_kernel, all four `parts` branches.
//   For query i and candidate j reads db[ids[i, j]] by id: [Qc, R]
//   distances 1 - eq / s_true over L int32 lanes a row.  parts = 1 counts
//   equal lanes (raw 32-bit slots); parts = 2, 4, 8 count equal 16-, 8- and
//   4-bit sub-fields of each lane (the hashed rerank tiers of
//   gsearch_tpu_torch/ops/mxu.py: pack_hash16/8/4), SIMD within the word on
//   x = a ^ b: __vcmpeq2 / __vcmpeq4 set a whole half or byte per equal
//   field, so popc >> 4 (>> 3) counts them; for nibbles t = x | x >> 1,
//   t |= t >> 2 leaves bit 4k set iff nibble k differs, and 8 per word less
//   the differing ones count.  The popcounts are summed over a pair's words
//   and converted once (add_raw, fields_of).  Pad fields never
//   count (database pads 0, query pads 1 in every field), and s_true is the
//   number of real slots, not the lane count.
//   Bound: bytes, each row the ids reference read once: (unique valid ids
//   + Qc) * L * 4, plus the ids and the output (chip_smoke.py k2_bound);
//   one op a lane compare is below the byte time except where few rows
//   repeat very often.  Each pair needs one side's segment moved to the SM
//   for it, so what a form can reach is set by where that side is served
//   from.  Two forms, chosen by shape in the wrapper (ops/distance.py
//   k2_plan):
//   - query-major (form 0, gather_eq_kernel): one warp per (query,
//     candidate) pair, eight candidates of one query a block, so the query
//     row comes from L1 and the candidate row from HBM (or L2 where rows
//     repeat close together); 16-byte loads when both rows are 16-byte
//     aligned, a scalar tail otherwise.  It reads a row once for every
//     query that lists it: at the graph's coarse rerank (~8 listings a row
//     over 262,144 rows) that is 8 GB from HBM.  It has no grouping to pay
//     for, so small launches stay here.
//   - row-grouped (form 1): the valid pairs are grouped by row id in row
//     order, CSR by a counting sort: k2_hist counts listings into an [N]
//     workspace (+inf for invalid ids), k2_scan_tiles / k2_scan_apply turn
//     the counts into each row's span of the pair list (a block scan a
//     4,096-row tile; the last tile block scans the tile sums), k2_scatter
//     fills the spans (any order inside a span: each pair's result is its
//     own).  The compare balances work by pairs, not rows: a warp takes a
//     run of 32 consecutive pairs of the list (lane l holds pair l), loads
//     a row's lane segment (1,024 lanes, 4 KB) into registers where the
//     row changes, after a bulk L2 prefetch (cp.async.bulk.prefetch) issued
//     two changes ahead, and compares it with each pair's query segment.
//     A persistent block of 16 warps takes chunks of 16 consecutive runs
//     from a counter, segment-major: the warps of an SM work on
//     neighbouring rows, and neighbouring rows (one species or family of a
//     collection) are listed by the same few queries, so the queries come
//     from L1 (33 distinct queries in a window of 256 pairs at the coarse
//     rerank, 6 at the full tier).  Where the lanes span several
//     segments, the segments' counts add atomically into a per-pair
//     workspace and the last segment of a run (a ticket) writes the
//     distances and zeroes the workspace, as K1's split does; the [N]
//     counts are zeroed by the warp that holds a row's first pair.  Every
//     workspace is zero on entry and left zero, so no launch fills it; four
//     counters are cleared (a 16-byte memset).  The compare of raw lanes is
//     K1's setp + predicated add: with one compare per loaded word (no
//     register tile, unlike K1) the instruction count, not the bytes, was
//     the limit of the first versions (PERF.md).
//   Ids outside [0, N) give +inf in both forms.  The TPU kernel writes
//   (S - eq) / S, this one 1 - eq / S (the XLA rerank's form); the two can
//   differ by one ulp.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() for the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int K1_KC = 32;         // slots per ring-stage row: 128 bytes
constexpr int K1_G = K1_KC / 4;   // 16-byte groups per stage row
constexpr int K1_RQ = 4;          // queries per thread
constexpr int K1_RN = 8;          // database rows per thread

struct K1Args {
  const int32_t* q;
  const int32_t* db;
  float* out;
  int* counts;   // split only: [batch, nq, n] int32, zero on entry and exit
  int* tickets;  // split only: [batch, tiles] int32, zero on entry and exit
  int nq, n, s;
  int span;      // slots a split covers, a multiple of K1_KC
  int qtiles;    // tiles along the queries (unused for pairs)
  int pairs;     // q == db: only tiles on and above the diagonal
};

// ring index of 16-byte group g of stage row r (see the header note)
__device__ __forceinline__ int k1_slot(int r, int g) { return r * K1_G + (g ^ (r & 7)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += (a == b) as one compare into a predicate and one predicated add
__device__ __forceinline__ void count_eq(int& acc, int a, int b) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.b32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(acc)
      : "r"(a), "r"(b));
}

__device__ __forceinline__ void count_eq4(int& acc, const int4 a, const int4 b) {
  count_eq(acc, a.x, b.x);
  count_eq(acc, a.y, b.y);
  count_eq(acc, a.z, b.z);
  count_eq(acc, a.w, b.w);
}

__device__ __forceinline__ void k1_write(float* out, int n, int s, int q, int r, bool mirror,
                                         int eq) {
  const float d = 1.0f - (float)eq / (float)s;
  out[(size_t)q * n + r] = d;
  if (mirror) out[(size_t)r * n + q] = d;
}

// blockIdx.x: output tile; blockIdx.y: split of S; blockIdx.z: batch member.
template <int WQ, int WN, int STAGES, bool VEC>
__global__ void __launch_bounds__(WQ * WN)
eqcount_kernel(const K1Args a) {
  constexpr int TQ = WQ * K1_RQ, TN = WN * K1_RN, ROWS = TQ + TN, THREADS = WQ * WN;
  extern __shared__ int4 ring[];  // [STAGES][ROWS][K1_G]
  __shared__ int last_block;
  const int t = threadIdx.x;
  const int tn = t % WN;  // database rows n0 + tn + WN * j
  const int tq = t / WN;  // queries q0 + tq + WQ * i
  int qt, nt;
  if (a.pairs) {  // tiles (qt, nt), qt <= nt, nt-major
    const long long l = blockIdx.x;
    long long k = (long long)((sqrt(8.0 * (double)l + 1.0) - 1.0) * 0.5);
    while (k * (k + 1) / 2 > l) --k;
    while ((k + 1) * (k + 2) / 2 <= l) ++k;
    nt = (int)k;
    qt = (int)(l - k * (k + 1) / 2);
  } else {
    qt = blockIdx.x % a.qtiles;
    nt = blockIdx.x / a.qtiles;
  }
  const int q0 = qt * TQ, n0 = nt * TN;
  const size_t b = blockIdx.z;
  const int32_t* qb = a.q + b * a.nq * a.s;
  const int32_t* dbb = a.db + b * a.n * a.s;
  const int s_begin = blockIdx.y * a.span;
  const int s_end = min(a.s, s_begin + a.span);
  const int chunks = (s_end - s_begin + K1_KC - 1) / K1_KC;

  auto stage_chunk = [&](int c) {
    int4* st = ring + (c % STAGES) * (ROWS * K1_G);
    const int s0 = s_begin + c * K1_KC;
    for (int e = t; e < ROWS * K1_G; e += THREADS) {
      const int r = e / K1_G, g = e % K1_G;
      const bool is_q = r < TQ;
      const int gr = is_q ? q0 + r : n0 + r - TQ;
      const bool row_ok = gr < (is_q ? a.nq : a.n);
      const int32_t* row = (is_q ? qb : dbb) + (size_t)(row_ok ? gr : 0) * a.s;
      int4* dst = st + k1_slot(r, g);
      const int col = s0 + 4 * g;
      if (VEC) {
        const bool ok = row_ok && col < s_end;
        cp_async16(dst, row + (ok ? col : 0), ok ? 16 : 0);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = row_ok && col + k < s_end;
          cp_async4(reinterpret_cast<int*>(dst) + k, row + (ok ? col + k : 0), ok ? 4 : 0);
        }
      }
    }
  };

  int acc[K1_RQ][K1_RN];
#pragma unroll
  for (int i = 0; i < K1_RQ; ++i)
#pragma unroll
    for (int j = 0; j < K1_RN; ++j) acc[i][j] = 0;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) stage_chunk(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and chunk c - 1 is consumed
    if (c + STAGES - 1 < chunks) stage_chunk(c + STAGES - 1);
    cp_async_commit();
    const int4* st = ring + (c % STAGES) * (ROWS * K1_G);
#pragma unroll
    for (int g = 0; g < K1_G; ++g) {
      int4 av[K1_RQ], bv[K1_RN];
#pragma unroll
      for (int i = 0; i < K1_RQ; ++i) av[i] = st[k1_slot(tq + WQ * i, g)];
#pragma unroll
      for (int j = 0; j < K1_RN; ++j) bv[j] = st[k1_slot(TQ + tn + WN * j, g)];
#pragma unroll
      for (int i = 0; i < K1_RQ; ++i)
#pragma unroll
        for (int j = 0; j < K1_RN; ++j) count_eq4(acc[i][j], av[i], bv[j]);
    }
  }
  cp_async_wait<0>();

  const int pad = chunks * K1_KC - (s_end - s_begin);  // zero slots, equal in every pair
  const bool mirror = a.pairs && qt != nt;
  float* out = a.out + b * a.nq * a.n;
  if (gridDim.y == 1) {
#pragma unroll
    for (int i = 0; i < K1_RQ; ++i)
#pragma unroll
      for (int j = 0; j < K1_RN; ++j) {
        const int q = q0 + tq + WQ * i, r = n0 + tn + WN * j;
        if (q < a.nq && r < a.n) k1_write(out, a.n, a.s, q, r, mirror, acc[i][j] - pad);
      }
    return;
  }
  int* cnt = a.counts + b * a.nq * a.n;
#pragma unroll
  for (int i = 0; i < K1_RQ; ++i)
#pragma unroll
    for (int j = 0; j < K1_RN; ++j) {
      const int q = q0 + tq + WQ * i, r = n0 + tn + WN * j;
      if (q < a.nq && r < a.n) atomicAdd(cnt + (size_t)q * a.n + r, acc[i][j] - pad);
    }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    int* ticket = a.tickets + b * gridDim.x + blockIdx.x;
    last_block = atomicAdd(ticket, 1) == (int)gridDim.y - 1;
    if (last_block) *ticket = 0;  // every other split of the tile has counted in
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < K1_RQ; ++i)
#pragma unroll
    for (int j = 0; j < K1_RN; ++j) {
      const int q = q0 + tq + WQ * i, r = n0 + tn + WN * j;
      if (q < a.nq && r < a.n)
        k1_write(out, a.n, a.s, q, r, mirror, atomicExch(cnt + (size_t)q * a.n + r, 0));
    }
}

// the tile variants, in the order of ops/distance.py K1_TILES
// (WQ x WN threads, each 4 queries x 8 rows; STAGES ring buffers)
template <int WQ_, int WN_, int STAGES_>
struct K1Tile {
  static constexpr int WQ = WQ_, WN = WN_, STAGES = STAGES_;
  static constexpr int TQ = WQ * K1_RQ, TN = WN * K1_RN;
  static constexpr size_t SMEM = (size_t)STAGES * (TQ + TN) * K1_G * sizeof(int4);
};
using K1Wide = K1Tile<16, 8, 4>;      // 64 x 64, 128 threads, 64 KB
using K1Narrow16 = K1Tile<4, 32, 3>;  // 16 x 256, 128 threads, 102 KB
using K1Narrow8 = K1Tile<2, 32, 3>;   // 8 x 256, 64 threads, 99 KB

template <typename T, bool VEC>
cudaError_t k1_run(const K1Args& a, dim3 grid, int device, cudaStream_t st) {
  static bool ready[64] = {};  // the shared-memory attribute, set once a device
  if (device < 0 || device >= 64 || !ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(eqcount_kernel<T::WQ, T::WN, T::STAGES, VEC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)T::SMEM);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) ready[device] = true;
  }
  eqcount_kernel<T::WQ, T::WN, T::STAGES, VEC><<<grid, T::WQ * T::WN, T::SMEM, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t k1_dispatch(const K1Args& a, dim3 grid, bool vec, int device, cudaStream_t st) {
  return vec ? k1_run<T, true>(a, grid, device, st) : k1_run<T, false>(a, grid, device, st);
}

constexpr int K2_WARPS = 8;  // candidates per block, one warp each

// A raw count of two lanes whose sum over a pair's words gives its equal
// fields (see the header note): parts = 1 equal lanes (K1's compare into a
// predicate and a predicated add); 2 and 4 the set bits of equal halves or
// bytes (16 or 8 a field); 8 the differing nibbles.
template <int PARTS>
__device__ __forceinline__ void add_raw(unsigned& e, int a, int b) {
  if constexpr (PARTS == 1) {
    int acc = (int)e;
    count_eq(acc, a, b);
    e = (unsigned)acc;
  } else {
    const unsigned x = (unsigned)(a ^ b);
    if constexpr (PARTS == 2) {
      e += __popc(__vcmpeq2(x, 0u));
    } else if constexpr (PARTS == 4) {
      e += __popc(__vcmpeq4(x, 0u));
    } else {
      unsigned t = x | (x >> 1);
      t |= t >> 2;
      e += __popc(t & 0x11111111u);
    }
  }
}

// equal fields from a pair's summed raw count over `words` lanes
template <int PARTS>
__device__ __forceinline__ unsigned fields_of(unsigned raw, int words) {
  if constexpr (PARTS == 1) return raw;
  if constexpr (PARTS == 2) return raw >> 4;
  if constexpr (PARTS == 4) return raw >> 3;
  return 8u * (unsigned)words - raw;
}

// blockIdx.x: eight candidates of a query; blockIdx.y: a span of the lanes.
// With several spans, the spans' counts add into eqw [pairs] and the last
// span of a pair (tickets [pairs]) writes its distance; both are zero on
// entry and left zero.
template <int PARTS>
__global__ void __launch_bounds__(K2_WARPS * 32)
gather_eq_kernel(const int32_t* __restrict__ db, const int32_t* __restrict__ q,
                 const int32_t* __restrict__ ids, float* __restrict__ out, int* eqw, int* tickets,
                 int n, int lanes, int s_true, int qc, int r, int blocks_per_query, int span) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x / blocks_per_query;
  const int j = (blockIdx.x % blocks_per_query) * K2_WARPS + warp;
  if (i >= qc || j >= r) return;  // warp-uniform
  const size_t o = (size_t)i * r + j;
  const int id = ids[o];
  if (id < 0 || id >= n) {  // warp-uniform
    if (lane == 0 && blockIdx.y == 0) out[o] = __int_as_float(0x7f800000);
    return;
  }
  const int c0 = blockIdx.y * span, c1 = min(lanes, c0 + span);
  const int32_t* row = db + (size_t)id * lanes + c0;
  const int32_t* qrow = q + (size_t)i * lanes + c0;
  unsigned eq = 0;
  int done = 0;
  if ((((uintptr_t)row | (uintptr_t)qrow) & 15) == 0) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    const int4* q4 = reinterpret_cast<const int4*>(qrow);
    const int nv = (c1 - c0) >> 2;
#pragma unroll 4
    for (int v = lane; v < nv; v += 32) {
      const int4 a = __ldg(row4 + v);
      const int4 b = __ldg(q4 + v);
      add_raw<PARTS>(eq, a.x, b.x);
      add_raw<PARTS>(eq, a.y, b.y);
      add_raw<PARTS>(eq, a.z, b.z);
      add_raw<PARTS>(eq, a.w, b.w);
    }
    done = nv << 2;
  }
  for (int c = done + lane; c < c1 - c0; c += 32) add_raw<PARTS>(eq, __ldg(row + c), __ldg(qrow + c));
  eq = fields_of<PARTS>(__reduce_add_sync(0xffffffffu, eq), max(0, c1 - c0));
  if (lane != 0) return;
  if (gridDim.y == 1) {
    out[o] = 1.0f - (float)eq / (float)s_true;
    return;
  }
  atomicAdd(eqw + o, (int)eq);
  __threadfence();
  if (atomicAdd(tickets + o, 1) != (int)gridDim.y - 1) return;
  tickets[o] = 0;  // every other span of the pair has counted in
  __threadfence();
  out[o] = 1.0f - (float)atomicExch(eqw + o, 0) / (float)s_true;
}

// ---- K2, row-grouped form ----------------------------------------------------

constexpr int K2R_SEG = 1024;       // lanes a segment: 4 KB of a row
constexpr int K2R_RUN = 32;         // pairs a warp's run (one a lane)
constexpr int K2R_WARPS = 16;       // warps a compare block: one block an SM
constexpr int K2R_THREADS = 256;    // threads a hist / scatter block
constexpr int K2R_SCAN = 1024;      // threads a scan block
constexpr int K2R_TILE = 4 * K2R_SCAN;  // rows a scan block (4 a thread)
// the counters, cleared by the launcher: scan blocks done, valid pairs,
// compare chunks handed out
enum { K2R_TICKET = 0, K2R_TOTAL = 1, K2R_NEXT = 2 };

// the grouping's device state; cnt, eq and tickets are zero on entry and
// left zero
struct K2Group {
  int* cnt;      // [n] listings of a row, then its span's start, then the fill cursor
  int* eq;       // [pairs] counts summed over segments (several only)
  int* tickets;  // [runs] segments done (several only)
  int* ctr;      // [4] the counters
  int* tiles;    // [scan blocks] listings of a tile of rows, then the tile's start
  int* plist;    // [pairs] pair indices in row order
  int* prow;     // [pairs] their rows
};

// count each valid pair's row; out-of-range ids are written +inf here and
// take no further part
__global__ void __launch_bounds__(K2R_THREADS)
k2_hist(const int32_t* __restrict__ ids, float* __restrict__ out, K2Group g, int n, int pairs) {
  const int p = blockIdx.x * K2R_THREADS + threadIdx.x;
  if (p >= pairs) return;
  const int id = ids[p];
  if (id < 0 || id >= n)
    out[p] = __int_as_float(0x7f800000);
  else
    atomicAdd(g.cnt + id, 1);
}

// inclusive sum over the warp
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += t;
  }
  return x;
}

// exclusive sum over a K2R_SCAN-thread block; `total` gets the block's sum
__device__ __forceinline__ int block_scan(int x, int& total) {
  __shared__ int sums[33];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int inc = warp_scan(x, lane);
  if (lane == 31) sums[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    const int w = sums[lane];
    const int wi = warp_scan(w, lane);
    sums[lane] = wi - w;
    if (lane == 31) sums[32] = wi;
  }
  __syncthreads();
  total = sums[32];
  const int ex = sums[wid] + inc - x;
  __syncthreads();  // sums is reused by the next call
  return ex;
}

// listings of each tile of K2R_TILE rows; the last block to finish turns
// the tile sums into the tiles' starts and counts the valid pairs
__global__ void __launch_bounds__(K2R_SCAN) k2_scan_tiles(K2Group g, int n) {
  __shared__ int last;
  const int base = blockIdx.x * K2R_TILE + 4 * threadIdx.x;
  int s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) s += base + k < n ? g.cnt[base + k] : 0;
  int total;
  block_scan(s, total);
  if (threadIdx.x == 0) g.tiles[blockIdx.x] = total;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(g.ctr + K2R_TICKET, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int k0 = 0; k0 < (int)gridDim.x; k0 += K2R_SCAN) {  // block-uniform
    const int k = k0 + threadIdx.x;
    const int v = k < (int)gridDim.x ? __ldcg(g.tiles + k) : 0;
    const int ex = block_scan(v, total);
    if (k < (int)gridDim.x) g.tiles[k] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) g.ctr[K2R_TOTAL] = carry;
}

// each listed row's span of the pair list, in row order: cnt[row] = start
__global__ void __launch_bounds__(K2R_SCAN) k2_scan_apply(K2Group g, int n) {
  const int base = blockIdx.x * K2R_TILE + 4 * threadIdx.x;
  int c[4], s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[k] = base + k < n ? g.cnt[base + k] : 0;
    s += c[k];
  }
  int total;
  int start = g.tiles[blockIdx.x] + block_scan(s, total);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (c[k] > 0) g.cnt[base + k] = start;
    start += c[k];
  }
}

// the pair list in row order (any order inside a row's span: each pair's
// result is its own)
__global__ void __launch_bounds__(K2R_THREADS)
k2_scatter(const int32_t* __restrict__ ids, K2Group g, int n, int pairs) {
  const int p = blockIdx.x * K2R_THREADS + threadIdx.x;
  if (p >= pairs) return;
  const int id = ids[p];
  if (id < 0 || id >= n) return;
  const int pos = atomicAdd(g.cnt + id, 1);
  g.plist[pos] = p;
  g.prow[pos] = id;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Asks L2 for `bytes` (a multiple of 16) at a 16-byte aligned address:
// one bulk prefetch, no registers, no completion to wait for.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p), "r"(bytes) : "memory");
}

// One warp's run of K2R_RUN consecutive pairs of the row-ordered list, in
// lane segment `seg`.  Lane l holds pair l's index and row; the row
// segment is loaded into registers where the row changes (streaming loads:
// it is not read again), after an L2 prefetch issued two row changes ahead,
// and compared with each pair's query segment (cached loads: the
// neighbouring runs of the block list the same queries).
template <int PARTS, bool VEC>
__device__ __forceinline__ void k2_run(const int32_t* __restrict__ db, const int32_t* __restrict__ q,
                                       float* __restrict__ out, const K2Group& g, int lanes,
                                       int s_true, int r, int nseg, int seg, int run, int total,
                                       int lane) {
  constexpr int NR = VEC ? K2R_SEG / 128 : K2R_SEG / 32;  // row registers a lane
  using Word = typename std::conditional<VEC, int4, int>::type;
  const int s0 = seg * K2R_SEG, len = min(K2R_SEG, lanes - s0);
  const int nw = VEC ? len / 4 : len;  // words of the segment
  const int k0 = run * K2R_RUN, np = min(K2R_RUN, total - k0);
  const int mrow = lane < np ? g.prow[k0 + lane] : -1;
  const int mpair = lane < np ? g.plist[k0 + lane] : 0;
  int prev = __shfl_up_sync(0xffffffffu, mrow, 1);
  if (lane == 0) prev = k0 > 0 ? g.prow[k0 - 1] : -2;
  // a row's first pair overall zeroes k2_scatter's cursor, done with
  if (seg == 0 && lane < np && mrow != prev) g.cnt[mrow] = 0;
  // the pairs where the warp loads a row: lane 0 and each change of row
  const unsigned loads = __ballot_sync(0xffffffffu, lane < np && (lane == 0 || mrow != prev));
  const bool loader = (loads >> lane) & 1;
  const int my_load = __popc(loads & lanes_below());
  const int32_t* my_src = db + (size_t)(mrow < 0 ? 0 : mrow) * lanes + s0;
  if (VEC && loader && my_load < 2) prefetch_l2(my_src, 4 * len);
  Word rv[NR];
  unsigned my_eq = 0;
  int nload = 0;
  // this lane's raw count of a pair's segment (`full`: the segment is
  // whole, every word in range, no masks)
  auto count = [&](int pair, auto full) {
    const Word* qs = reinterpret_cast<const Word*>(q + (size_t)(pair / r) * lanes + s0);
    Word b[NR];
#pragma unroll
    for (int u = 0; u < NR; ++u)
      if (full.value || lane + 32 * u < nw) b[u] = __ldg(qs + lane + 32 * u);
    unsigned e = 0;
#pragma unroll
    for (int u = 0; u < NR; ++u)
      if (full.value || lane + 32 * u < nw) {
        if constexpr (VEC) {
          add_raw<PARTS>(e, rv[u].x, b[u].x);
          add_raw<PARTS>(e, rv[u].y, b[u].y);
          add_raw<PARTS>(e, rv[u].z, b[u].z);
          add_raw<PARTS>(e, rv[u].w, b[u].w);
        } else {
          add_raw<PARTS>(e, rv[u], b[u]);
        }
      }
    return e;
  };
  const bool whole = nw == 32 * NR;
  for (int j = 0; j < np;) {
    if ((loads >> j) & 1) {  // warp-uniform
      if (VEC && loader && my_load == nload + 2) prefetch_l2(my_src, 4 * len);
      ++nload;
      const int row = __shfl_sync(0xffffffffu, mrow, j);
      const Word* src = reinterpret_cast<const Word*>(db + (size_t)row * lanes + s0);
#pragma unroll
      for (int u = 0; u < NR; ++u)
        if (lane + 32 * u < nw) rv[u] = __ldcs(src + lane + 32 * u);
    }
    const int pair = __shfl_sync(0xffffffffu, mpair, j);
    const unsigned e = fields_of<PARTS>(__reduce_add_sync(0xffffffffu, whole ? count(pair, std::true_type())
                                                                           : count(pair, std::false_type())),
                                        len);
    if (lane == j) my_eq = e;
    ++j;
  }
  const bool mine = lane < np;
  if (nseg == 1) {
    if (mine) out[mpair] = 1.0f - (float)my_eq / (float)s_true;
    return;
  }
  if (mine) atomicAdd(g.eq + mpair, (int)my_eq);
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    last = atomicAdd(g.tickets + run, 1) == nseg - 1;
    if (last) g.tickets[run] = 0;  // every other segment of the run has counted in
  }
  if (__shfl_sync(0xffffffffu, last, 0)) {
    __threadfence();
    if (mine) out[mpair] = 1.0f - (float)atomicExch(g.eq + mpair, 0) / (float)s_true;
  }
}

// A persistent grid, one block an SM.  The runs are cut into chunks of
// K2R_WARPS consecutive runs (warp w takes the chunk's run w), handed to
// the blocks in order from a counter, segment-major: the warps of an SM
// compare neighbouring rows, which list the same queries, so the queries'
// segments are read from L1, and the live query slab is one segment's.
template <int PARTS, bool VEC>
__global__ void __launch_bounds__(K2R_WARPS * 32, 1)
k2_compare(const int32_t* __restrict__ db, const int32_t* __restrict__ q, float* __restrict__ out,
           K2Group g, int lanes, int s_true, int r, int nseg) {
  __shared__ int work;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int total = g.ctr[K2R_TOTAL];
  const int runs = (total + K2R_RUN - 1) / K2R_RUN;
  const int chunks = (runs + K2R_WARPS - 1) / K2R_WARPS;
  const long long works = (long long)chunks * nseg;
  for (;;) {
    if (threadIdx.x == 0) work = atomicAdd(g.ctr + K2R_NEXT, 1);
    __syncthreads();
    const long long w = work;
    __syncthreads();
    if (w >= works) return;
    const int seg = (int)(w / chunks);
    const int run = (int)(w % chunks) * K2R_WARPS + warp;
    if (run < runs) k2_run<PARTS, VEC>(db, q, out, g, lanes, s_true, r, nseg, seg, run, total, lane);
  }
}

// the compare kernel's grid, the blocks resident on the card, found once
// per (device, parts, vec) with L1 preferred over shared memory
template <int PARTS, bool VEC>
cudaError_t k2_compare_run(const int32_t* db, const int32_t* q, float* out, const K2Group& g,
                           int lanes, int s_true, int r, int nseg, int device, cudaStream_t st) {
  static int grid[64] = {};
  int blocks = device >= 0 && device < 64 ? grid[device] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(k2_compare<PARTS, VEC>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (err != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k2_compare<PARTS, VEC>,
                                                        K2R_WARPS * 32, 0);
    if (err != cudaSuccess) return err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (device >= 0 && device < 64) grid[device] = blocks;
  }
  k2_compare<PARTS, VEC><<<blocks, K2R_WARPS * 32, 0, st>>>(db, q, out, g, lanes, s_true, r, nseg);
  return cudaGetLastError();
}

template <int PARTS>
cudaError_t k2_compare_dispatch(bool vec, const int32_t* db, const int32_t* q, float* out,
                                const K2Group& g, int lanes, int s_true, int r, int nseg,
                                int device, cudaStream_t st) {
  return vec ? k2_compare_run<PARTS, true>(db, q, out, g, lanes, s_true, r, nseg, device, st)
             : k2_compare_run<PARTS, false>(db, q, out, g, lanes, s_true, r, nseg, device, st);
}

}  // namespace

// q [batch, nq, s], db [batch, n, s] -> out [batch, nq, n]; pairs: q == db
// and nq == n.  tile: 0 wide, 1 narrow16, 2 narrow8 (pairs: wide only).
// span: slots a split covers (a multiple of 32); when it splits S, counts
// ([batch, nq, n] int32) and tickets ([batch, tiles] int32) must be zero,
// and the kernel leaves them zero.
extern "C" int gs_hamming_frac(const void* q, const void* db, void* out, void* counts,
                               void* tickets, int batch, int nq, int n, int s, int tile,
                               int span, int pairs, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int tq, tn;
  switch (tile) {
    case 0: tq = K1Wide::TQ; tn = K1Wide::TN; break;
    case 1: tq = K1Narrow16::TQ; tn = K1Narrow16::TN; break;
    case 2: tq = K1Narrow8::TQ; tn = K1Narrow8::TN; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (batch < 1 || nq < 1 || n < 1 || s < 1 || span < K1_KC || span % K1_KC != 0)
    return (int)cudaErrorInvalidValue;
  if (pairs && (tile != 0 || q != db || nq != n)) return (int)cudaErrorInvalidValue;
  const long long qtiles = (nq + tq - 1) / tq, ntiles = (n + tn - 1) / tn;
  const long long tiles = pairs ? ntiles * (ntiles + 1) / 2 : qtiles * ntiles;
  const long long splits = (s + (long long)span - 1) / span;
  if (tiles > 0x7fffffffLL || splits > 65535 || batch > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (splits > 1 && (counts == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  K1Args a;
  a.q = (const int32_t*)q;
  a.db = (const int32_t*)db;
  a.out = (float*)out;
  a.counts = (int*)counts;
  a.tickets = (int*)tickets;
  a.nq = nq;
  a.n = n;
  a.s = s;
  a.span = span;
  a.qtiles = (int)qtiles;
  a.pairs = pairs;
  const bool vec = s % 4 == 0 && (((uintptr_t)q | (uintptr_t)db) & 15) == 0;
  const dim3 grid((unsigned)tiles, (unsigned)splits, (unsigned)batch);
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 0: err = k1_dispatch<K1Wide>(a, grid, vec, device, st); break;
    case 1: err = k1_dispatch<K1Narrow16>(a, grid, vec, device, st); break;
    default: err = k1_dispatch<K1Narrow8>(a, grid, vec, device, st); break;
  }
  return (int)err;
}

// db [n, lanes], q [qc, lanes] int32, ids [qc, r] int32 -> out [qc, r] f32;
// parts in {1, 2, 4, 8} fields a lane; form 0 query-major, its lanes cut
// into `splits` spans, or 1 row-grouped.  The int32 workspaces: `zeroed`,
// zero on entry and left zero, 2 * qc * r entries for a split query-major
// launch, n + qc * r + ceil(qc * r / 32) for the row-grouped form, which
// also takes `scratch`, 2 * qc * r + 4 + ceil(n / 4096) entries of any
// content.
extern "C" int gs_gather_hamming(const void* db, const void* q, const void* ids,
                                 void* out, int n, int lanes, int s_true, int parts,
                                 int qc, int r, int form, int splits, void* zeroed,
                                 void* scratch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (parts != 1 && parts != 2 && parts != 4 && parts != 8) return (int)cudaErrorInvalidValue;
  if (form == 1) {
    const long long pairs = (long long)qc * r;
    if (pairs > 0x3fffffffLL || n < 1 || lanes < 1 || zeroed == nullptr || scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    const int np = (int)pairs;
    K2Group g;
    g.cnt = (int*)zeroed;
    g.eq = g.cnt + n;
    g.tickets = g.eq + np;
    g.plist = (int*)scratch;
    g.prow = g.plist + np;
    g.ctr = g.prow + np;
    g.tiles = g.ctr + 4;
    cudaStream_t st = (cudaStream_t)stream;
    err = cudaMemsetAsync(g.ctr, 0, 4 * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    const int pblocks = (np + K2R_THREADS - 1) / K2R_THREADS;
    const int tiles = (n + K2R_TILE - 1) / K2R_TILE;
    const int32_t* id = (const int32_t*)ids;
    float* o = (float*)out;
    k2_hist<<<pblocks, K2R_THREADS, 0, st>>>(id, o, g, n, np);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k2_scan_tiles<<<tiles, K2R_SCAN, 0, st>>>(g, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k2_scan_apply<<<tiles, K2R_SCAN, 0, st>>>(g, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k2_scatter<<<pblocks, K2R_THREADS, 0, st>>>(id, g, n, np);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int nseg = (lanes + K2R_SEG - 1) / K2R_SEG;
    const int32_t *d = (const int32_t*)db, *qq = (const int32_t*)q;
    const bool vec = lanes % 4 == 0 && (((uintptr_t)db | (uintptr_t)q) & 15) == 0;
    switch (parts) {
      case 1: return (int)k2_compare_dispatch<1>(vec, d, qq, o, g, lanes, s_true, r, nseg, device, st);
      case 2: return (int)k2_compare_dispatch<2>(vec, d, qq, o, g, lanes, s_true, r, nseg, device, st);
      case 4: return (int)k2_compare_dispatch<4>(vec, d, qq, o, g, lanes, s_true, r, nseg, device, st);
      default: return (int)k2_compare_dispatch<8>(vec, d, qq, o, g, lanes, s_true, r, nseg, device, st);
    }
  }
  if (form != 0 || splits < 1 || splits > 65535 || (splits > 1 && zeroed == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks_per_query = (r + K2_WARPS - 1) / K2_WARPS;
  const long long blocks = (long long)qc * blocks_per_query;
  if (blocks > 0x7fffffffLL || (splits > 1 && (long long)qc * r > 0x3fffffffLL))
    return (int)cudaErrorInvalidConfiguration;
  const int span = ((lanes + splits - 1) / splits + 127) / 128 * 128;  // whole 16-byte rounds
  const dim3 grid((unsigned)blocks, (unsigned)splits), block(K2_WARPS * 32);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t *d = (const int32_t*)db, *qq = (const int32_t*)q, *id = (const int32_t*)ids;
  float* o = (float*)out;
  int* eqw = (int*)zeroed;
  int* tk = eqw == nullptr ? nullptr : eqw + (size_t)qc * r;
  switch (parts) {
    case 1:
      gather_eq_kernel<1><<<grid, block, 0, st>>>(d, qq, id, o, eqw, tk, n, lanes, s_true, qc, r,
                                                  blocks_per_query, span);
      break;
    case 2:
      gather_eq_kernel<2><<<grid, block, 0, st>>>(d, qq, id, o, eqw, tk, n, lanes, s_true, qc, r,
                                                  blocks_per_query, span);
      break;
    case 4:
      gather_eq_kernel<4><<<grid, block, 0, st>>>(d, qq, id, o, eqw, tk, n, lanes, s_true, qc, r,
                                                  blocks_per_query, span);
      break;
    default:
      gather_eq_kernel<8><<<grid, block, 0, st>>>(d, qq, id, o, eqw, tk, n, lanes, s_true, qc, r,
                                                  blocks_per_query, span);
      break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
