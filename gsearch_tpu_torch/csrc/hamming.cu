// Sketch distance kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Both compute the Hamming fraction of signature slots compared as 32-bit
// patterns: distance = 1 - eq / S, in f32 with IEEE division (the build
// does not pass --use_fast_math), which is bit-exact with the plain torch
// versions in gsearch_tpu_torch/ops/distance.py.
//
// K1 gs_hamming_frac  replaces gsearch_tpu/ops/distance.py:
//   hamming_frac_pallas / _eqcount_kernel.  [Q, S] x [N, S] -> [Q, N].
//   Bound: at small Q the database bytes read (N*S*4); at large Q integer
//   compare throughput (Q*N*S compares).  Design: a block owns a 32 x 64
//   (query x row) tile and loops over its span of S inside the block (the
//   TPU's sequential S grid axis); 64-column chunks of both operands are
//   staged in shared memory with one padding column so the compare loop
//   reads without bank conflicts, and each thread keeps a 2 x 4 grid of
//   counts in registers.  When the tiles alone cannot fill the card (small
//   Q * N, as in a request against a few thousand genomes) S is split over
//   gridDim.z blocks that add their counts atomically into a zeroed int32
//   scratch, and a second kernel writes the distances; counts are integers,
//   so the split does not change a bit.  Ragged edges are bounds masks: rows
//   past Q or N are never written, columns past S are never compared, so no
//   pad sentinels.  A batch of independent [Q, S] x [N, S] problems (the
//   graph index's candidate pair blocks, [B, C, S'] x [B, C, S']) shares one
//   launch: gridDim.z = batch * splits, each block offsets its operands by
//   its batch index.
//
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

constexpr int K1_TQ = 32;       // queries per block tile
constexpr int K1_TN = 64;       // database rows per block tile
constexpr int K1_SK = 64;       // slots per shared-memory chunk
constexpr int K1_THREADS = 256; // 16 x 16 threads, 2 x 4 outputs each

// blockIdx.z = batch member * splits + split.  kSplit: this block covers S
// columns [split * span, ...) and adds its counts into `counts`; otherwise it
// covers all of S and writes distances.
template <bool kSplit>
__global__ void __launch_bounds__(K1_THREADS)
eqcount_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ db,
               float* __restrict__ out, int* __restrict__ counts, int nq, int n,
               int s, int span, int splits) {
  __shared__ int32_t sq[K1_TQ][K1_SK + 1];
  __shared__ int32_t sd[K1_TN][K1_SK + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // database rows tx + 16 * j
  const int ty = tid / 16;  // queries ty + 16 * i
  const int q0 = blockIdx.y * K1_TQ;
  const int n0 = blockIdx.x * K1_TN;
  const size_t b = blockIdx.z / splits;  // batch member
  q += b * nq * s;
  db += b * n * s;
  out += b * nq * n;
  if (kSplit) counts += b * nq * n;
  const int s_begin = (blockIdx.z % splits) * span;
  const int s_end = min(s, s_begin + span);
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  for (int s0 = s_begin; s0 < s_end; s0 += K1_SK) {
    const int width = min(K1_SK, s_end - s0);
    for (int e = tid; e < K1_TQ * K1_SK; e += K1_THREADS) {
      const int r = e / K1_SK, c = e % K1_SK;
      const int gq = q0 + r;
      sq[r][c] = (gq < nq && c < width) ? q[(size_t)gq * s + s0 + c] : 0;
    }
    for (int e = tid; e < K1_TN * K1_SK; e += K1_THREADS) {
      const int r = e / K1_SK, c = e % K1_SK;
      const int gn = n0 + r;
      sd[r][c] = (gn < n && c < width) ? db[(size_t)gn * s + s0 + c] : 0;
    }
    __syncthreads();
    for (int c = 0; c < width; ++c) {
      const int a0 = sq[ty][c];
      const int a1 = sq[ty + 16][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = sd[tx + 16 * j][c];
        acc[0][j] += (a0 == b);
        acc[1][j] += (a1 == b);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gq < nq && gn < n) {
        if (kSplit)
          atomicAdd(counts + (size_t)gq * n + gn, acc[i][j]);
        else
          out[(size_t)gq * n + gn] = 1.0f - (float)acc[i][j] / (float)s;
      }
    }
  }
}

__global__ void finish_kernel(const int* __restrict__ counts, float* __restrict__ out,
                              size_t total, int s) {
  for (size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x; k < total;
       k += (size_t)gridDim.x * blockDim.x)
    out[k] = 1.0f - (float)counts[k] / (float)s;
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

// q [batch, nq, s], db [batch, n, s] -> out [batch, nq, n].  splits > 1
// needs `counts`, a [batch, nq, n] int32 scratch zeroed on the stream.
extern "C" int gs_hamming_frac(const void* q, const void* db, void* out, void* counts,
                               int batch, int nq, int n, int s, int splits, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  // each split covers a whole number of shared-memory chunks
  const int chunks = (s + K1_SK - 1) / K1_SK;
  const int span = ((chunks + splits - 1) / splits) * K1_SK;
  const int nsplit = (s + span - 1) / span;
  if ((long long)batch * nsplit > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((n + K1_TN - 1) / K1_TN, (nq + K1_TQ - 1) / K1_TQ, batch * nsplit);
  if (nsplit == 1) {
    eqcount_kernel<false><<<grid, K1_THREADS, 0, st>>>(
        (const int32_t*)q, (const int32_t*)db, (float*)out, nullptr, nq, n, s, span, 1);
    return (int)cudaGetLastError();
  }
  eqcount_kernel<true><<<grid, K1_THREADS, 0, st>>>(
      (const int32_t*)q, (const int32_t*)db, (float*)out, (int*)counts, nq, n, s, span,
      nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)batch * nq * n;
  const unsigned blocks = (unsigned)((total + 255) / 256 < 65535 ? (total + 255) / 256 : 65535);
  finish_kernel<<<blocks, 256, 0, st>>>((const int*)counts, (float*)out, total, s);
  return (int)cudaGetLastError();
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
