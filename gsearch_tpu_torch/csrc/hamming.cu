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
//   t |= t >> 2 leaves bit 4k set iff nibble k differs.  Pad fields never
//   count (database pads 0, query pads 1 in every field), and s_true is the
//   number of real slots, not the lane count.
//   Bound: bytes, Qc * R * S * 4 (3.9 GB for 1024 queries x 80 candidates
//   at S = 12000; a quarter of that for the 8-bit tier).  Design: one warp
//   per candidate row, eight candidates of one query per block so the query
//   row is served from L1/L2; 16-byte
//   loads when both rows are 16-byte aligned, a scalar tail otherwise; a
//   warp-shuffle reduction.  Ids outside [0, N) give +inf.  The TPU kernel
//   writes (S - eq) / S, this one 1 - eq / S (the XLA rerank's form); the
//   two can differ by one ulp.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() for the launch.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Equal fields of two lanes (see the header note).
template <int PARTS>
__device__ __forceinline__ int eq_fields(int a, int b) {
  if (PARTS == 1) return a == b;
  const unsigned x = (unsigned)(a ^ b);
  if (PARTS == 2) return __popc(__vcmpeq2(x, 0u)) >> 4;
  if (PARTS == 4) return __popc(__vcmpeq4(x, 0u)) >> 3;
  unsigned t = x | (x >> 1);
  t |= t >> 2;
  return 8 - __popc(t & 0x11111111u);
}

template <int PARTS>
__global__ void __launch_bounds__(K2_WARPS * 32)
gather_eq_kernel(const int32_t* __restrict__ db, const int32_t* __restrict__ q,
                 const int32_t* __restrict__ ids, float* __restrict__ out,
                 int n, int lanes, int s_true, int qc, int r, int blocks_per_query) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x / blocks_per_query;
  const int j = (blockIdx.x % blocks_per_query) * K2_WARPS + warp;
  if (i >= qc || j >= r) return;  // warp-uniform
  const size_t o = (size_t)i * r + j;
  const int id = ids[o];
  if (id < 0 || id >= n) {  // warp-uniform
    if (lane == 0) out[o] = __int_as_float(0x7f800000);
    return;
  }
  const int32_t* row = db + (size_t)id * lanes;
  const int32_t* qrow = q + (size_t)i * lanes;
  int eq = 0;
  int done = 0;
  if ((((uintptr_t)row | (uintptr_t)qrow) & 15) == 0) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    const int4* q4 = reinterpret_cast<const int4*>(qrow);
    const int nv = lanes >> 2;
#pragma unroll 4
    for (int v = lane; v < nv; v += 32) {
      const int4 a = __ldg(row4 + v);
      const int4 b = __ldg(q4 + v);
      eq += eq_fields<PARTS>(a.x, b.x) + eq_fields<PARTS>(a.y, b.y) +
            eq_fields<PARTS>(a.z, b.z) + eq_fields<PARTS>(a.w, b.w);
    }
    done = nv << 2;
  }
  for (int c = done + lane; c < lanes; c += 32)
    eq += eq_fields<PARTS>(__ldg(row + c), __ldg(qrow + c));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) eq += __shfl_down_sync(0xffffffffu, eq, off);
  if (lane == 0) out[o] = 1.0f - (float)eq / (float)s_true;
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
// parts in {1, 2, 4, 8} fields a lane.
extern "C" int gs_gather_hamming(const void* db, const void* q, const void* ids,
                                 void* out, int n, int lanes, int s_true, int parts,
                                 int qc, int r, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks_per_query = (r + K2_WARPS - 1) / K2_WARPS;
  const long long blocks = (long long)qc * blocks_per_query;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks), block(K2_WARPS * 32);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t *d = (const int32_t*)db, *qq = (const int32_t*)q, *id = (const int32_t*)ids;
  float* o = (float*)out;
  switch (parts) {
    case 1:
      gather_eq_kernel<1><<<grid, block, 0, st>>>(d, qq, id, o, n, lanes, s_true, qc, r,
                                                  blocks_per_query);
      break;
    case 2:
      gather_eq_kernel<2><<<grid, block, 0, st>>>(d, qq, id, o, n, lanes, s_true, qc, r,
                                                  blocks_per_query);
      break;
    case 4:
      gather_eq_kernel<4><<<grid, block, 0, st>>>(d, qq, id, o, n, lanes, s_true, qc, r,
                                                  blocks_per_query);
      break;
    case 8:
      gather_eq_kernel<8><<<grid, block, 0, st>>>(d, qq, id, o, n, lanes, s_true, qc, r,
                                                  blocks_per_query);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
