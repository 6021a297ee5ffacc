// Codon-HMM Viterbi decode of gene prediction for Hopper (sm_90a), bound to
// Python with ctypes.  One step loop, two front ends:
//
// gs_genepred_decode  replaces gsearch_tpu/models/genepred.py:838-855
//   (`_decode_windows`): the one XLA program from a window's 2-bit codes to
//   its state path, i.e. the emission / bonus precompute (:567-744), the
//   Viterbi lax.scan (:790, step :815-825) and the reverse backtrace scan
//   (:828-835).  Inputs: codes [B, W] u8 (255 or any value >= 4 marks an
//   invalid base), the tables (codon [64]; dicodon, reverse dicodon
//   [64 x 64]; noncoding [4 x 4]; context [4, 61, 64] with its calibration
//   [4, 2]; start prior [64]; each but codon optional), five f32 scalars,
//   dp0 [B, 11] and the transition table tb [11, 11] (from, to).  Output:
//   the path [B, W] int8.  Emissions and bonuses never reach device memory.
// gs_viterbi  the same decoder fed emissions e [B, W, 11] and the four
//   bonus vectors [B, W] from memory (how the tests plant random emissions
//   and ties that codes cannot produce).
//
// Exactness.  The precompute is the plain version's formula for formula
// (models/genepred.py `_precompute_scores`): the same wrapped reads where
// torch.roll wraps (stop and rev-end hits, the start prior and the rolled
// context sums read positions W-3..W-1 at i < 3; an invalid base reads as
// A, so "TA" + N is a stop), the context window padded with invalid taps
// and summed j = 0..60 in order, and every product or sum the plain
// version rounds twice taken with __fmul_rn / __fadd_rn, so nvcc's FMA
// contraction cannot fuse them.  The step adds as the reference does,
//   cand[f][t] = ((dp[f] + tb[f][t]) + a[f] * (t == NC)) + (f == NC) * c[t]
// (a: stop on F3, rev end on R3; c: start on F1, rev begin on R1); the
// other 100 candidates add exact zeros, which this step leaves out (x + 0
// is x: no candidate is -0).  The max over f keeps the lowest f among
// equal values and the final argmax the lowest state.  Ties are common:
// under N runs and the 255 padding every state pays -1e9 a base and dp
// reaches ~1e12, where the f32 ulp is ~1e5; all 121 candidates, the -1e9
// edges included, are kept.  The build does not pass --use_fast_math.
//
// Bound.  Bytes: codes read and the path written, 2 B a base, plus the
// tables (about 0.005 ms for a 5.5 Mb genome's 896 windows at 3.35 TB/s);
// operations: the precompute and 121 x 3 + 110 + 11 f32 operations a base
// (about 0.07 ms at 67 TFLOP/s).  Neither binds: W dependent steps a
// window do, each an exchange of the 11 dp values, an add, a max over 11
// and the emission add, so a launch takes W times the step's latency, and
// the backtrace W dependent lookups more.
//
// Design.  One warp decodes two windows, one a half-warp, lane t < 11 of
// a half owning state t: a step's instructions serve both windows, so at
// 896 windows one warp a scheduler issues and none waits for another.
// ceil(B / 2 / SMs) warps a block (at most 8) keep 896 windows to one
// wave.  The tables and tb sit in dynamic shared memory once a block (the
// context rows padded with a zero column, the value of an invalid tap);
// each window's codes are staged whole, with 48 wrapped codes each side
// for torch.roll's wrap.  Every 32 steps all 32 lanes compute the next 32
// positions' emissions and bonuses of both windows, one position a lane,
// into the windows' stages; the context sums are taken only where a
// boundary codon hits (about one position in twenty a table), compacted
// by ballots so a few lanes sum one each.  A step reads its inputs from
// the stage, exchanges dp through shared memory (one store, three
// broadcast float4 loads, faster than 11 shuffles on the H100), adds,
// takes the max as a depth-4 tree of fmaxf (the argmax's compares beside
// it, off the dp chain) and stores its argmax byte to shared memory; after
// the chunk each lane packs one step's 11 bytes into 4-bit fields, 8 B a
// base, stored coalesced.  The backtrace spreads a chunk's 32 words into
// registers first, so a step of the walk is the few bit operations of
// `back`, with no load and no shuffle on its chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NS = 11;                       // states
constexpr int NC = 0, F1 = 1, F3 = 3, R1 = 4, R3 = 6;
constexpr int CHUNK = 32;                    // positions staged at once
constexpr int MAX_WARPS = 8;                 // warps a block (two windows each), at most
constexpr int TAPS = 61, HALF = 30;          // context window
constexpr int NO_TRI = 64;                   // a tap that adds 0: column 64 of a staged row
constexpr int CTX_ROW = 65;                  // a staged context row: 64 trinucleotides and 0
constexpr int MARGIN = 48;                   // wrapped codes staged each side of a window
constexpr unsigned ID_LO = 0x76543210u, ID_HI = 0xa98u;  // backpointers of no step: the identity
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_BIG = -1e9f;
constexpr float LOG_QUARTER = -1.38629436111989061883f;  // f32(log(0.25))

// block tables, floats: tb, codon, prior, nc, aff, then di, rdi and the
// context rows if on
constexpr int TB_OFF = 0, CODON_OFF = 128, PRIOR_OFF = 192, NC_OFF = 256, AFF_OFF = 272;
constexpr int DI_OFF = 288;

struct Stage {                               // one window's
  float e[CHUNK * NS];                       // emissions, position-major
  float4 bon[CHUNK];                         // start, stop, rev begin, rev end
  float x[2][12];                            // the dp exchange, by step parity
  uint8_t arg[CHUNK][16];                    // each step's backpointers, state t at byte t
  int item[4 * CHUNK];                       // context sums to take: position * 4 + table
  float score[4 * CHUNK];
};

struct Args {
  // decode_kernel<true>: the precompute's inputs
  const uint8_t* codes;
  const float *codon, *di, *rdi, *nc, *ctx, *aff, *prior;
  float start_b, stop_b, ctx_w, ctx_cap, ctx_neg_cap;
  // decode_kernel<false>: emissions and bonuses from memory
  const float *e, *start, *stop, *rbeg, *rend;
  const float *dp0, *tb;
  uint2* bp;                                 // [B, W] backpointers, 4 bits a state, scratch
  int8_t* path;
  int nwin, w, block_floats, region_bytes, warp_bytes;
};

__device__ inline bool is_start(int x) { return (x == 14) | (x == 46) | (x == 62); }  // ATG GTG TTG
__device__ inline bool is_stop(int x) { return (x == 48) | (x == 50) | (x == 56); }   // TAA TAG TGA

// sum over j of ctx[t][j][tri[pos - 30 + j]], in order j = 0..60 from 0,
// where tri[r] is the trinucleotide starting at r, invalid (adding 0) off
// the window or over an invalid base; `row` is table t staged in rows of
// CTX_ROW, `sc` the window's codes with their margins
__device__ inline float ctx_sum(const float* row, const uint8_t* sc, int pos, int l) {
  const int r0 = pos - HALF;
  int x1 = sc[r0], x2 = sc[r0 + 1];
  float acc = 0.0f;
#pragma unroll 4
  for (int j = 0; j < TAPS; ++j) {
    const int r = r0 + j;
    const int x0 = x1;
    x1 = x2;
    x2 = sc[r + 2];
    // bitwise, not short-circuit: no branch a tap
    const bool ok = ((unsigned)r <= (unsigned)(l - 3)) & ((x0 | x1 | x2) < 4);
    acc = __fadd_rn(acc, row[j * CTX_ROW + (ok ? x0 * 16 + x1 * 4 + x2 : NO_TRI)]);
  }
  return acc;
}

// Emissions and bonuses of positions i0 .. i0 + 31 of both windows of the
// warp, lane p taking i0 + p of each, into the windows' stages
// (`_precompute_scores`, one position).  The two windows go side by side
// through each part, so their load chains overlap.  Window g's staged codes
// are at codes + g * stride (a pointer derived from the shared-memory base,
// so the loads stay shared-memory loads).
__device__ __forceinline__ void fused_stage(const Args& a, const float* tab, const float* ctx_s,
                                            Stage* stage, const uint8_t* codes, int stride,
                                            int i0, int lane) {
  const int l = a.w;
  const bool live = i0 + lane < l;
  const int i = live ? i0 + lane : l - 1;
  int cc[2][9];
  bool iv[2][9];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int d = -5; d <= 3; ++d) {          // torch.roll's wrap within the row: the margins
      const int x = codes[g * stride + i + d];
      iv[g][d + 5] = x >= 4;
      cc[g][d + 5] = x >= 4 ? 0 : x;
    }
  }
#define C(d) cc[g][(d) + 5]
#define I(d) iv[g][(d) + 5]
  const float* codon_t = tab + CODON_OFF;
  const float* di_t = tab + DI_OFF;
  const float* rdi_t = di_t + 4096;
  int codon[2], rcodon[2];
  bool codon_bad[2];
  float m3[2], r3[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    codon[g] = C(-2) * 16 + C(-1) * 4 + C(0);
    codon_bad[g] = I(0) | I(-1) | I(-2) | (i < 2);
    rcodon[g] = (3 - C(0)) * 16 + (3 - C(-1)) * 4 + (3 - C(-2));
    m3[g] = codon_t[codon[g]];
    r3[g] = codon_t[rcodon[g]];
  }
  if (a.di) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int prev = C(-5) * 16 + C(-4) * 4 + C(-3);
      const bool prev_bad = I(-3) | I(-4) | I(-5) | (i < 5);
      m3[g] = prev_bad ? m3[g] : di_t[prev * 64 + codon[g]];
      if (a.rdi) {
        r3[g] = prev_bad ? r3[g] : rdi_t[prev * 64 + codon[g]];
      } else {
        const int rprev = (3 - C(3)) * 16 + (3 - C(2)) * 4 + (3 - C(1));
        const bool rprev_bad = I(1) | I(2) | I(3) | (i >= l - 3);
        r3[g] = rprev_bad ? r3[g] : di_t[rprev * 64 + rcodon[g]];
      }
    }
  }
  float log_nc[2];
  bool hit[2][4];
  int cod_start[2], rcodon_m1[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    log_nc[g] = I(0) ? NEG_BIG : LOG_QUARTER;
    if (a.nc) {
      const bool prev_ok = !I(-1) & (i >= 1);
      log_nc[g] = I(0) ? NEG_BIG : (prev_ok ? tab[NC_OFF + C(-1) * 4 + C(0)] : LOG_QUARTER);
    }
    const bool fwd_bad = I(0) | I(1) | I(2) | (i >= l - 2);
    cod_start[g] = C(0) * 16 + C(1) * 4 + C(2);
    const int codon_m1 = C(-3) * 16 + C(-2) * 4 + C(-1);        // the codon ending at i - 1
    const int rcod_start = (3 - C(2)) * 16 + (3 - C(1)) * 4 + (3 - C(0));
    rcodon_m1[g] = (3 - C(-1)) * 16 + (3 - C(-2)) * 4 + (3 - C(-3));
    hit[g][0] = live & is_start(cod_start[g]) & !fwd_bad;
    hit[g][1] = live & is_stop(codon_m1);
    hit[g][2] = live & is_stop(rcod_start) & !fwd_bad;
    hit[g][3] = live & is_start(rcodon_m1[g]);
  }
  float score[2][4] = {};
  if (a.ctx) {
    // stop / rev-end scores are the context sums at i - 3 (rolled, wrapping)
    const int q3 = i >= 3 ? i - 3 : i - 3 + l;
    int slot[2][4], n[2] = {0, 0};
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned m = __ballot_sync(FULL, hit[g][t]);
        slot[g][t] = n[g] + __popc(m & below);
        if (hit[g][t]) stage[g].item[slot[g][t]] = ((t & 1) ? q3 : i) * 4 + t;
        n[g] += __popc(m);
      }
    }
    __syncwarp();
    const float* aff = tab + AFF_OFF;
    for (int k = lane; k < n[0] + n[1]; k += 32) {
      const int g = k < n[0] ? 0 : 1, kk = k - g * n[0];
      const int it = stage[g].item[kk], pos = it >> 2, t = it & 3;
      float v = ctx_sum(ctx_s + t * TAPS * CTX_ROW, codes + g * stride, pos, l);
      v = __fmul_rn(v, aff[2 * t]);
      v = __fadd_rn(v, aff[2 * t + 1]);
      stage[g].score[kk] = fminf(fmaxf(__fmul_rn(a.ctx_w, v), -a.ctx_neg_cap), a.ctx_cap);
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int t = 0; t < 4; ++t) score[g][t] = hit[g][t] ? stage[g].score[slot[g][t]] : 0.0f;
  }
  const float sb = a.start_b, pb = a.stop_b;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    float pri_f = 0.0f, pri_r = 0.0f;
    if (a.prior) {
      pri_f = hit[g][0] ? tab[PRIOR_OFF + cod_start[g]] : 0.0f;
      pri_r = hit[g][3] ? tab[PRIOR_OFF + rcodon_m1[g]] : 0.0f;
    }
    // hit ? strength (+ score) : -strength, then the prior (0 when off)
    const float* sg = score[g];
    const bool* hg = hit[g];
    const float b0 = __fadd_rn(hg[0] ? (a.ctx ? __fadd_rn(sb, sg[0]) : sb) : -sb, pri_f);
    const float b1 = hg[1] ? (a.ctx ? __fadd_rn(pb, sg[1]) : pb) : -pb;
    const float b2 = hg[2] ? (a.ctx ? __fadd_rn(pb, sg[2]) : pb) : -pb;
    const float b3 = __fadd_rn(hg[3] ? (a.ctx ? __fadd_rn(sb, sg[3]) : sb) : -sb, pri_r);
    const float lq = I(0) ? NEG_BIG : LOG_QUARTER;
    const float zoi = I(0) ? NEG_BIG : 0.0f;
    const float f3 = codon_bad[g] ? NEG_BIG : m3[g];
    const float rr3 = codon_bad[g] ? NEG_BIG : r3[g];
    float* e = stage[g].e + lane * NS;       // state order NC F1 F2 F3 R1 R2 R3 FI1 FI2 RI1 RI2
    e[0] = log_nc[g];
    e[1] = zoi;
    e[2] = zoi;
    e[3] = f3;
    e[4] = zoi;
    e[5] = zoi;
    e[6] = rr3;
    e[7] = lq;
    e[8] = lq;
    e[9] = lq;
    e[10] = lq;
    stage[g].bon[lane] = make_float4(b0, b1, b2, b3);
  }
#undef C
#undef I
}

// the max over v and the lowest index holding it: a depth-4 tree of fmaxf
// (the dp chain), the index's compares beside it, the left (lower) side
// kept on equality
__device__ inline float max_arg(const float v[NS], int& arg) {
  float m1[6];
  int a1[6];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    m1[k] = fmaxf(v[2 * k], v[2 * k + 1]);
    a1[k] = v[2 * k + 1] > v[2 * k] ? 2 * k + 1 : 2 * k;
  }
  m1[5] = v[10];
  a1[5] = 10;
  float m2[3];
  int a2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m2[k] = fmaxf(m1[2 * k], m1[2 * k + 1]);
    a2[k] = m1[2 * k + 1] > m1[2 * k] ? a1[2 * k + 1] : a1[2 * k];
  }
  const float m3 = fmaxf(m2[0], m2[1]);
  const int a3 = m2[1] > m2[0] ? a2[1] : a2[0];
  arg = m2[2] > m3 ? a2[2] : a3;
  return fmaxf(m3, m2[2]);
}

// four bytes < 16 -> their nibbles, byte 0 lowest
__device__ inline unsigned nibbles(unsigned x) {
  x = (x | (x >> 4)) & 0x00ff00ffu;
  return (x | (x >> 8)) & 0x0000ffffu;
}

__device__ inline void load11(const float* row, float d[NS]) {
  const float4 p = reinterpret_cast<const float4*>(row)[0];
  const float4 q = reinterpret_cast<const float4*>(row)[1];
  const float4 r = reinterpret_cast<const float4*>(row)[2];
  d[0] = p.x; d[1] = p.y; d[2] = p.z; d[3] = p.w;
  d[4] = q.x; d[5] = q.y; d[6] = q.z; d[7] = q.w;
  d[8] = r.x; d[9] = r.y; d[10] = r.z;
}

// the candidates into state t, added in the reference's order:
// (dp[f] + tb[f][t]), then the from-side bonus on the NC column and the
// to-side one on the NC row (+0 where the reference's one-hot is 0)
__device__ inline void candidates(const float d[NS], const float col[NS], float4 b, bool is_nc,
                                  bool is_f1, bool is_r1, float v[NS]) {
#pragma unroll
  for (int f = 0; f < NS; ++f) v[f] = d[f] + col[f];
  v[NC] += is_f1 ? b.x : (is_r1 ? b.z : 0.0f);   // start, rev begin
  v[F3] += is_nc ? b.y : 0.0f;                    // stop
  v[R3] += is_nc ? b.w : 0.0f;                    // rev end
}

// One warp decodes two windows, one a half-warp: lane 16 h + t < 16 h + 11
// owns state t of window h (lanes 11-15 of a half shadow state 10).
// where the staged context rows start in the block's tables
__host__ __device__ inline int ctx_offset(const Args& a) {
  return DI_OFF + (a.di ? 4096 : 0) + (a.rdi ? 4096 : 0);
}

template <bool FUSED>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1) decode_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  for (int k = threadIdx.x; k < NS * NS; k += blockDim.x) tab[TB_OFF + k] = a.tb[k];
  if (FUSED) {
    for (int k = threadIdx.x; k < 64; k += blockDim.x) {
      tab[CODON_OFF + k] = a.codon[k];
      if (a.prior) tab[PRIOR_OFF + k] = a.prior[k];
      if (a.nc && k < 16) tab[NC_OFF + k] = a.nc[k];
      if (a.aff && k < 8) tab[AFF_OFF + k] = a.aff[k];
    }
    if (a.di) {
      for (int k = threadIdx.x; k < 4096; k += blockDim.x) {
        tab[DI_OFF + k] = a.di[k];
        if (a.rdi) tab[DI_OFF + 4096 + k] = a.rdi[k];
      }
    }
    if (a.ctx) {
      float* ctx_s = tab + ctx_offset(a);
      for (int k = threadIdx.x; k < 4 * TAPS * CTX_ROW; k += blockDim.x) {
        const int row = k / CTX_ROW, x = k - row * CTX_ROW;
        ctx_s[k] = x < 64 ? a.ctx[row * 64 + x] : 0.0f;
      }
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int win0 = 2 * (blockIdx.x * (blockDim.x >> 5) + warp);
  if (win0 >= a.nwin) return;                // the whole warp leaves together
  const bool has1 = win0 + 1 < a.nwin;       // else half 1 repeats window 0 and writes nothing
  const int w = a.w;
  const int h = lane >> 4, hl = lane & 15;
  char* wbase = reinterpret_cast<char*>(tab + a.block_floats) + (size_t)warp * a.warp_bytes;
  Stage* stage = reinterpret_cast<Stage*>(wbase);                      // [2]
  // a window's codes, with MARGIN wrapped codes each side
  uint8_t* region = reinterpret_cast<uint8_t*>(wbase + 2 * sizeof(Stage));
  auto codes_of = [&](int g) { return region + g * a.region_bytes + MARGIN; };
  const size_t base[2] = {(size_t)win0 * w, (size_t)(has1 ? win0 + 1 : win0) * w};

  if (FUSED) {
    for (int g = 0; g < 2; ++g) {
      const uint8_t* src = a.codes + base[g];
      uint8_t* sc = codes_of(g);
      if ((w & 15) == 0 && (reinterpret_cast<uintptr_t>(a.codes) & 15) == 0) {
        for (int k = lane; k < w / 16; k += 32)
          reinterpret_cast<uint4*>(sc)[k] = reinterpret_cast<const uint4*>(src)[k];
      } else {
        for (int k = lane; k < w; k += 32) sc[k] = src[k];
      }
      for (int k = lane; k < MARGIN; k += 32) {
        sc[k - MARGIN] = src[((k - MARGIN) % w + w) % w];
        sc[w + k] = src[k % w];
      }
    }
    __syncwarp();
  }

  const int t = hl < NS ? hl : NS - 1;
  const int slot = hl < 12 ? hl : 11;        // the lane's column of a dp row
  Stage& s = stage[h];
  float col[NS];                             // tb[f][t]
#pragma unroll
  for (int f = 0; f < NS; ++f) col[f] = tab[TB_OFF + f * NS + t];
  const bool is_nc = t == NC, is_f1 = t == F1, is_r1 = t == R1;
  float dp = a.dp0[base[h] / w * NS + t];

  // ---- forward pass ------------------------------------------------------
  float re[2][NS], rb[2][4];                 // the memory front end's next chunk
  auto fetch = [&](int i0) {
    const int n = min(CHUNK, w - i0);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const float* ep = a.e + (base[g] + i0) * NS;
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const int k = lane + 32 * m;
        re[g][m] = k < n * NS ? ep[k] : 0.0f;
      }
      const size_t p = base[g] + i0 + lane;
      const bool ok = lane < n;
      rb[g][0] = ok ? a.start[p] : 0.0f;
      rb[g][1] = ok ? a.stop[p] : 0.0f;
      rb[g][2] = ok ? a.rbeg[p] : 0.0f;
      rb[g][3] = ok ? a.rend[p] : 0.0f;
    }
  };
  if (!FUSED) fetch(0);
  // step j of a chunk: dp exchanged, the max over the candidates into state
  // t (the new dp) and its argmax byte
  auto step = [&](int j) {
    float d[NS];
    __syncwarp();
    load11(s.x[j & 1], d);
    const float4 b = s.bon[j];
    const float ej = s.e[j * NS + t];
    float v[NS];
    candidates(d, col, b, is_nc, is_f1, is_r1, v);
    int arg;
    dp = max_arg(v, arg) + ej;
    s.x[(j + 1) & 1][slot] = dp;             // the next step's row
    s.arg[j][slot] = (uint8_t)arg;
  };
  for (int i0 = 0; i0 < w; i0 += CHUNK) {
    const int n = min(CHUNK, w - i0);
    if (FUSED) {
      fused_stage(a, tab, tab + ctx_offset(a), stage, codes_of(0), a.region_bytes, i0, lane);
    } else {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
#pragma unroll
        for (int m = 0; m < NS; ++m) stage[g].e[lane + 32 * m] = re[g][m];
        stage[g].bon[lane] = make_float4(rb[g][0], rb[g][1], rb[g][2], rb[g][3]);
      }
    }
    s.x[0][slot] = dp;
    __syncwarp();
    if (!FUSED && i0 + CHUNK < w) fetch(i0 + CHUNK);
    if (n == CHUNK) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) step(j);
    } else {
      for (int j = 0; j < n; ++j) step(j);
    }
    __syncwarp();
    // the chunk's backpointers, 4 bits a state (states 0-7 in lo, 8-10 in
    // hi), stored coalesced: lane p packs step p of both windows
    if (lane < n) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (g == 1 && !has1) break;
        const uint4 r = *reinterpret_cast<const uint4*>(stage[g].arg[lane]);
        a.bp[base[g] + i0 + lane] = make_uint2(nibbles(r.x) | nibbles(r.y) << 16, nibbles(r.z));
      }
    }
    __syncwarp();
  }
  __syncwarp();  // every lane's backpointer stores are visible to the warp

  // ---- backtrace, each half its window ------------------------------------
  // A chunk's 32 words are spread from the lanes that loaded them (positions
  // hl and hl + 16; the identity past the window's end) into registers
  // first, so a step of the walk is the few bit operations of `back`.
  int st;
  {
    float d[NS];
#pragma unroll
    for (int f = 0; f < NS; ++f) d[f] = __shfl_sync(FULL, dp, f, 16);
    max_arg(d, st);
  }
  auto back = [](unsigned lo, unsigned hi, int cur) {
    return (int)(((cur < 8 ? lo : hi) >> (4 * (cur & 7))) & 15u);
  };
  const uint2* bw = a.bp + base[h];
  const bool writes = h == 0 || has1;
  int8_t* out = a.path + base[h];
  auto words = [&](int i0, uint2& w0, uint2& w1) {
    const int n = min(CHUNK, w - i0);
    w0 = hl < n ? bw[i0 + hl] : make_uint2(ID_LO, ID_HI);
    w1 = hl + 16 < n ? bw[i0 + hl + 16] : make_uint2(ID_LO, ID_HI);
  };
  const int last = (w - 1) / CHUNK * CHUNK;
  uint2 c0, c1;
  words(last, c0, c1);
  for (int i0 = last; i0 >= 0; i0 -= CHUNK) {
    uint2 n0 = c0, n1 = c1;
    if (i0 >= CHUNK) words(i0 - CHUNK, n0, n1);
    unsigned lo[CHUNK], hi[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const uint2 cw = j >= 16 ? c1 : c0;
      lo[j] = __shfl_sync(FULL, cw.x, j & 15, 16);
      hi[j] = __shfl_sync(FULL, cw.y, j & 15, 16);
    }
    int m0 = 0, m1 = 0;                      // the path at positions hl and hl + 16
#pragma unroll
    for (int j = CHUNK - 1; j >= 0; --j) {
      if (hl == (j & 15)) {
        if (j >= 16) m1 = st;
        else m0 = st;
      }
      st = back(lo[j], hi[j], st);
    }
    const int n = min(CHUNK, w - i0);
    if (writes) {
      if (hl < n) out[i0 + hl] = (int8_t)m0;
      if (hl + 16 < n) out[i0 + hl + 16] = (int8_t)m1;
    }
    c0 = n0;
    c1 = n1;
  }
}

template <bool FUSED>
int launch(Args& a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.nwin < 1 || a.w < 8) return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  a.block_floats = FUSED ? ctx_offset(a) + (a.ctx ? 4 * TAPS * CTX_ROW : 0) : DI_OFF;
  const long long fixed = 4LL * a.block_floats;
  auto r16 = [](long long n) { return (n + 15) & ~15LL; };
  const long long codes_bytes = FUSED ? r16(a.w) + 2 * MARGIN : 0;
  const long long region = codes_bytes;
  const long long warp_bytes = 2LL * ((long long)sizeof(Stage) + region);
  if (fixed + warp_bytes > optin) return (int)cudaErrorInvalidValue;  // windows too long to stage
  a.region_bytes = (int)region;
  a.warp_bytes = (int)warp_bytes;
  // one wave: the warps (two windows each) spread over the SMs, as many a
  // block as that needs (at most 8) and shared memory allows
  const long long pairs = ((long long)a.nwin + 1) / 2;
  int warps = (int)min((long long)MAX_WARPS, (pairs + sms - 1) / sms);
  while (fixed + (long long)warps * a.warp_bytes > optin) --warps;
  const long long blocks = (pairs + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int bytes = (int)(fixed + (long long)warps * a.warp_bytes);
  err = cudaFuncSetAttribute(decode_kernel<FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<FUSED><<<(unsigned)blocks, warps * 32, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// e [nwin, w, 11], the four bonuses [nwin, w], dp0 [nwin, 11], tb [11, 11]
// (all f32, contiguous) -> path [nwin, w] int8; bp [nwin, w] of 8 bytes is
// scratch of any content.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() for the launch (w >= 8).
extern "C" int gs_viterbi(const void* e, const void* start_b, const void* stop_b,
                          const void* rbeg_b, const void* rend_b, const void* dp0,
                          const void* tb, void* bp, void* path, int nwin, int w,
                          int device, void* stream) {
  Args a = {};
  a.e = (const float*)e;
  a.start = (const float*)start_b;
  a.stop = (const float*)stop_b;
  a.rbeg = (const float*)rbeg_b;
  a.rend = (const float*)rend_b;
  a.dp0 = (const float*)dp0;
  a.tb = (const float*)tb;
  a.bp = (uint2*)bp;
  a.path = (int8_t*)path;
  a.nwin = nwin;
  a.w = w;
  return launch<false>(a, device, stream);
}

// codes [nwin, w] u8 and the tables (f32, contiguous; codon [64] required,
// the others null when off; aff [4, 2] required with ctx; rdi is read only
// with di, as the plain version does), the five scalars, dp0 [nwin, 11],
// tb [11, 11] -> path [nwin, w] int8; bp as for gs_viterbi.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int gs_genepred_decode(const void* codes, const void* codon, const void* di,
                                  const void* rdi, const void* nc, const void* ctx,
                                  const void* aff, const void* prior, float start_b,
                                  float stop_b, float ctx_w, float ctx_cap, float ctx_neg_cap,
                                  const void* dp0, const void* tb, void* bp, void* path,
                                  int nwin, int w, int device, void* stream) {
  if (!codon || (ctx && !aff)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.codes = (const uint8_t*)codes;
  a.codon = (const float*)codon;
  a.di = (const float*)di;
  a.rdi = di ? (const float*)rdi : nullptr;
  a.nc = (const float*)nc;
  a.ctx = (const float*)ctx;
  a.aff = ctx ? (const float*)aff : nullptr;
  a.prior = (const float*)prior;
  a.start_b = start_b;
  a.stop_b = stop_b;
  a.ctx_w = ctx_w;
  a.ctx_cap = ctx_cap;
  a.ctx_neg_cap = ctx_neg_cap;
  a.dp0 = (const float*)dp0;
  a.tb = (const float*)tb;
  a.bp = (uint2*)bp;
  a.path = (int8_t*)path;
  a.nwin = nwin;
  a.w = w;
  return launch<true>(a, device, stream);
}
