// Codon-HMM Viterbi decoder for Hopper (sm_90a), bound to Python with ctypes.
//
// gs_viterbi  replaces gsearch_tpu/models/genepred.py: _viterbi (:790), the
//   per-base lax.scan step (:815-825) and the reverse backtrace scan
//   (:828-835) that XLA compiles into one program.  (No Pallas kernel: the
//   reference leaves this loop to XLA; in eager torch each of its steps
//   would be ~8 launches on a [B, 11, 11] tensor.)
//   Inputs, one row a window: emissions e [B, W, 11] f32, the four
//   position bonuses [B, W] f32 (start: to F1, rev begin: to R1, stop:
//   from F3, rev end: from R3), dp0 [B, 11] f32 and the static transition
//   table tb [11, 11] f32 (from, to).  Output: the state path [B, W] int8;
//   bp [B, W, 11] int8 is the backpointer workspace, written and read in
//   the launch.
//
//   Exactness.  The step adds in the reference's order, candidate
//     cand[f][t] = ((dp[f] + tb[f][t]) + a[f] * (t == NC)) + (f == NC) * c[t]
//   with a = the from-side bonuses (F3: stop, R3: rev end, else 0) and c
//   the to-side ones (F1: start, R1: rev begin, else 0); the products are
//   by 0 or 1 and exact, so a contraction into an FMA rounds as the
//   separate add does.  The max over f keeps the LOWEST f among equal
//   values (a strict > scan, as jnp.argmax), then + e[t]; the final argmax
//   also takes the lowest state.  Ties are common: under N runs and the
//   255 padding every state pays -1e9 a base, dp reaches ~1e12, where the
//   f32 ulp is ~1e5, so states round to equal values; only this order and
//   tie rule give the reference's path there.  The build does not pass
//   --use_fast_math.
//
//   Bound.  Bytes: e, the bonuses, dp0 read once and the path written
//   once, 61 bytes a base (the backpointers, 11 bytes a base written and
//   read, are the design's own traffic); about 0.1 ms for a 5 Mb genome's
//   windows at 3.35 TB/s.  Latency: W dependent steps a window, each a
//   shuffle round, an add chain and an 11-way max: the serial chain, not
//   bytes or operations, bounds a launch.
//
//   Design (simple first): one warp a window, lane t < 11 owns state t.
//   A step gathers dp of all 11 states by shuffles, forms its column of
//   candidates, takes the max, adds e and stores its int8 backpointer to
//   global memory.  Emissions and bonuses come in chunks of 32 positions,
//   staged through shared memory; the next chunk's loads are issued into
//   registers before the current chunk's steps, so their latency hides
//   behind 32 steps.  After the last step the warp walks the backpointers
//   back in 32-position chunks staged the same way (lane 0 walks, the warp
//   writes the chunk's path).  Left on the table: lanes 11-31 idle (two or
//   three windows a warp), 11 bytes of backpointers a base where 44 bits
//   would do, the emission precompute as separate torch launches before
//   this one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NS = 11;                       // states
constexpr int NC = 0, F1 = 1, F3 = 3, R1 = 4, R3 = 6;
constexpr int CHUNK = 32;                    // positions staged at once
constexpr int WARPS = 4;                     // windows a block
constexpr unsigned FULL = 0xffffffffu;

struct Stage {
  float e[CHUNK * NS];
  float bon[4][CHUNK];                       // start, stop, rev begin, rev end
  int8_t bp[CHUNK * NS];
  int8_t path[CHUNK];
};

__global__ void __launch_bounds__(WARPS * 32)
viterbi_kernel(const float* __restrict__ e, const float* __restrict__ start_b,
               const float* __restrict__ stop_b, const float* __restrict__ rbeg_b,
               const float* __restrict__ rend_b, const float* __restrict__ dp0,
               const float* __restrict__ tb, int8_t* __restrict__ bp,
               int8_t* __restrict__ path, int nwin, int w) {
  __shared__ Stage stage[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int win = blockIdx.x * WARPS + warp;
  if (win >= nwin) return;  // the whole warp leaves together
  Stage& s = stage[warp];
  const int t = lane < NS ? lane : NS - 1;   // lanes past 10 shadow state 10
  const size_t base = (size_t)win * w;

  float col[NS];                             // tb[f][t]
#pragma unroll
  for (int f = 0; f < NS; ++f) col[f] = tb[f * NS + t];
  const float nc_to = t == NC ? 1.0f : 0.0f;
  float dp = dp0[(size_t)win * NS + t];

  // ---- forward pass ------------------------------------------------------
  float re[NS], rb[4];
  auto fetch = [&](int i0) {
    const int n = min(CHUNK, w - i0);
    const float* ep = e + (base + i0) * NS;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const int k = lane + 32 * m;
      re[m] = k < n * NS ? ep[k] : 0.0f;
    }
    const size_t p = base + i0 + lane;
    const bool ok = lane < n;
    rb[0] = ok ? start_b[p] : 0.0f;
    rb[1] = ok ? stop_b[p] : 0.0f;
    rb[2] = ok ? rbeg_b[p] : 0.0f;
    rb[3] = ok ? rend_b[p] : 0.0f;
  };
  fetch(0);
  for (int i0 = 0; i0 < w; i0 += CHUNK) {
    __syncwarp();
#pragma unroll
    for (int m = 0; m < NS; ++m) s.e[lane + 32 * m] = re[m];
#pragma unroll
    for (int k = 0; k < 4; ++k) s.bon[k][lane] = rb[k];
    __syncwarp();
    if (i0 + CHUNK < w) fetch(i0 + CHUNK);
    const int n = min(CHUNK, w - i0);
    int8_t* bpp = bp + (base + i0) * NS;
    for (int j = 0; j < n; ++j) {
      float d[NS];
#pragma unroll
      for (int f = 0; f < NS; ++f) d[f] = __shfl_sync(FULL, dp, f);
      const float start = s.bon[0][j], stop = s.bon[1][j];
      const float rbeg = s.bon[2][j], rend = s.bon[3][j];
      const float c_t = t == F1 ? start : (t == R1 ? rbeg : 0.0f);
      float best = 0.0f;
      int arg = 0;
#pragma unroll
      for (int f = 0; f < NS; ++f) {
        const float a_f = f == F3 ? stop : (f == R3 ? rend : 0.0f);
        const float nc_from = f == NC ? 1.0f : 0.0f;
        const float v = ((d[f] + col[f]) + a_f * nc_to) + nc_from * c_t;
        if (f == 0 || v > best) {
          best = v;
          arg = f;
        }
      }
      dp = best + s.e[j * NS + t];
      if (lane < NS) bpp[j * NS + lane] = (int8_t)arg;
    }
  }

  // ---- backtrace ---------------------------------------------------------
  int st = 0;
  {
    float best = 0.0f;
#pragma unroll
    for (int f = 0; f < NS; ++f) {
      const float v = __shfl_sync(FULL, dp, f);
      if (f == 0 || v > best) {
        best = v;
        st = f;
      }
    }
  }
  __syncwarp();  // the backpointer stores above are visible to the warp
  int8_t rbp[NS];
  auto fetch_bp = [&](int i0) {
    const int n = min(CHUNK, w - i0);
    const int8_t* src = bp + (base + i0) * NS;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const int k = lane + 32 * m;
      rbp[m] = k < n * NS ? src[k] : (int8_t)0;
    }
  };
  const int last = (w - 1) / CHUNK * CHUNK;
  fetch_bp(last);
  for (int i0 = last; i0 >= 0; i0 -= CHUNK) {
    __syncwarp();
#pragma unroll
    for (int m = 0; m < NS; ++m) s.bp[lane + 32 * m] = rbp[m];
    __syncwarp();
    if (i0 >= CHUNK) fetch_bp(i0 - CHUNK);
    const int n = min(CHUNK, w - i0);
    if (lane == 0) {
      for (int j = n - 1; j >= 0; --j) {
        s.path[j] = (int8_t)st;
        st = s.bp[j * NS + st];
      }
    }
    __syncwarp();
    if (lane < n) path[base + i0 + lane] = s.path[lane];
  }
}

}  // namespace

// e [nwin, w, 11], the four bonuses [nwin, w], dp0 [nwin, 11], tb [11, 11]
// (all f32, contiguous) -> path [nwin, w] int8; bp [nwin, w, 11] int8 is
// scratch of any content.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() for the launch.
extern "C" int gs_viterbi(const void* e, const void* start_b, const void* stop_b,
                          const void* rbeg_b, const void* rend_b, const void* dp0,
                          const void* tb, void* bp, void* path, int nwin, int w,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nwin < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)nwin + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  viterbi_kernel<<<(unsigned)blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)e, (const float*)start_b, (const float*)stop_b, (const float*)rbeg_b,
      (const float*)rend_b, (const float*)dp0, (const float*)tb, (int8_t*)bp, (int8_t*)path,
      nwin, w);
  return (int)cudaGetLastError();
}
