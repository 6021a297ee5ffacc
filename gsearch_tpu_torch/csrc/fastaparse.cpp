// Native FASTA parse + encode for gsearch_tpu_torch's host ingest.
//
// One pass over an (already decompressed) FASTA buffer, emitting uint8
// symbol codes (DNA 0..3 / AA 0..19, 255 = invalid) with single-separator
// joins between records, "capsid" records skipped and records shorter than
// min_seq_size dropped; or, for DNA in one-block mode, the packed 2-bit
// form with the positions of invalid codes (PackedCodes).  The outputs are
// those of gsearch_tpu's native/fastaparse.cpp, which this file copies, and
// of the pure-Python parser in gsearch_tpu_torch/io/fasta.py.
//
// Exposed via a C ABI for ctypes.  Built at first use by
// gsearch_tpu_torch/io/native.py (g++ -O3 -march=native -shared -fPIC)
// into build/gsearch_tpu_torch/.

#include <cstdint>
#include <cstring>
#include <cstddef>

#if defined(__AVX512BW__) && defined(__AVX512VBMI2__)
#include <immintrin.h>
#define FASTAPARSE_AVX512 1
#endif

namespace {

constexpr uint8_t INVALID = 255;

struct Tables {
    uint8_t dna[256];
    uint8_t aa[256];
    Tables() {
        std::memset(dna, INVALID, sizeof(dna));
        std::memset(aa, INVALID, sizeof(aa));
        const char* d = "ACGT";
        for (int i = 0; i < 4; ++i) {
            dna[(uint8_t)d[i]] = (uint8_t)i;
            dna[(uint8_t)(d[i] + 32)] = (uint8_t)i;  // lowercase
        }
        dna[(uint8_t)'U'] = 3; dna[(uint8_t)'u'] = 3;
        const char* a = "ACDEFGHIKLMNPQRSTVWY";
        for (int i = 0; i < 20; ++i) {
            aa[(uint8_t)a[i]] = (uint8_t)i;
            aa[(uint8_t)(a[i] + 32)] = (uint8_t)i;
        }
    }
};
const Tables kTables;

inline bool header_has_capsid(const uint8_t* h, size_t n) {
    static const char kw[] = "capsid";
    if (n < 6) return false;
    for (size_t i = 0; i + 6 <= n; ++i) {
        if (std::memcmp(h + i, kw, 6) == 0) return true;
    }
    return false;
}

}  // namespace

extern "C" {

// Parse a FASTA buffer into one concatenated code array ("one block" mode,
// reference: process_file_in_one_block, dnafiles.rs:200-276).
//
//   data/len      : decompressed FASTA bytes
//   out           : caller buffer of capacity out_cap (>= len is always enough)
//   is_aa         : 0 = DNA (2-bit alphabet), 1 = AA (20 residues)
//   min_seq_size  : records shorter than this are dropped
//   out_len       : number of codes written (separators included)
//   first_id      : first kept record's id token (NUL-terminated, id_cap bytes)
//   total_bases   : residues encoded, separators excluded
//
// Returns number of kept records, or -1 if out_cap is too small.
long fasta_concat_codes(const uint8_t* data, size_t len,
                        uint8_t* out, size_t out_cap,
                        int is_aa, long min_seq_size,
                        size_t* out_len, char* first_id, size_t id_cap,
                        size_t* total_bases) {
    const uint8_t* table = is_aa ? kTables.aa : kTables.dna;
    size_t w = 0;          // write cursor
    size_t total = 0;
    long kept = 0;
    bool first_done = false;
    size_t i = 0;
    // skip pre-header junk
    while (i < len && data[i] != '>') ++i;
    while (i < len) {
        // at '>': parse header line
        ++i;
        size_t hstart = i;
        while (i < len && data[i] != '\n') ++i;
        size_t hend = i;  // header = [hstart, hend)
        if (i < len) ++i; // skip newline
        bool skip = header_has_capsid(data + hstart, hend - hstart);
        // sequence span: until next '>' at line start or EOF
        size_t rec_start = w + (kept > 0 ? 1 : 0);  // leave room for separator
        size_t seq_len = 0;
        size_t scan = i;
        // first pass to count; second to write (branch-light single pass
        // instead: write optimistically, roll back if dropped)
        size_t wr = rec_start;
        while (scan < len && data[scan] != '>') {
            uint8_t c = data[scan++];
            if (c == '\n' || c == '\r') continue;
            if (wr >= out_cap) return -1;
            out[wr++] = table[c];
            ++seq_len;
        }
        i = scan;
        if (!skip && (long)seq_len >= min_seq_size && seq_len > 0) {
            if (kept > 0) {
                out[w] = INVALID;  // record separator = hard k-mer break
            }
            w = wr;
            total += seq_len;
            ++kept;
            if (!first_done) {
                size_t idn = 0;
                while (hstart + idn < hend && idn + 1 < id_cap) {
                    uint8_t c = data[hstart + idn];
                    if (c == ' ' || c == '\t') break;
                    first_id[idn++] = (char)c;
                }
                first_id[idn] = '\0';
                first_done = true;
            }
        }
        // else: dropped — w unchanged, the optimistic writes are ignored
    }
    *out_len = w;
    *total_bases = total;
    return kept;
}

// Per-record mode (reference: process_file_by_sequence, dnafiles.rs:43-107):
// writes codes back-to-back and fills record offset/length tables.
// Returns kept record count, or -1 on capacity overflow.
long fasta_records_codes(const uint8_t* data, size_t len,
                         uint8_t* out, size_t out_cap,
                         int is_aa, long min_seq_size,
                         size_t* offsets, size_t* lengths, long max_records,
                         char* ids, size_t id_stride, /* ids: max_records * id_stride */
                         size_t* out_len) {
    const uint8_t* table = is_aa ? kTables.aa : kTables.dna;
    size_t w = 0;
    long kept = 0;
    size_t i = 0;
    while (i < len && data[i] != '>') ++i;
    while (i < len) {
        ++i;
        size_t hstart = i;
        while (i < len && data[i] != '\n') ++i;
        size_t hend = i;
        if (i < len) ++i;
        bool skip = header_has_capsid(data + hstart, hend - hstart);
        size_t start = w;
        size_t wr = w;
        size_t seq_len = 0;
        size_t scan = i;
        while (scan < len && data[scan] != '>') {
            uint8_t c = data[scan++];
            if (c == '\n' || c == '\r') continue;
            if (wr >= out_cap) return -1;
            out[wr++] = table[c];
            ++seq_len;
        }
        i = scan;
        if (!skip && (long)seq_len >= min_seq_size && seq_len > 0 && kept < max_records) {
            offsets[kept] = start;
            lengths[kept] = seq_len;
            char* idp = ids + kept * id_stride;
            size_t idn = 0;
            while (hstart + idn < hend && idn + 1 < id_stride) {
                uint8_t c = data[hstart + idn];
                if (c == ' ' || c == '\t') break;
                idp[idn++] = (char)c;
            }
            idp[idn] = '\0';
            w = wr;
            ++kept;
        }
    }
    *out_len = w;
    return kept;
}

}  // extern "C"

// Fused parse + 2-bit pack ("one block" mode): parse a FASTA buffer
// directly into the sketcher's exception upload form — packed 2-bit codes
// (4/byte) + the positions of invalid codes (record separators, Ns).
//
// Single real pass over the input on a ~1 GB/s-membw 1-core host:
// sequence spans are compacted (newlines stripped) in L1-resident 16 KB
// chunks, then encoded+packed 64 bases -> 16 bytes with AVX-512 when the
// build host has it (branchless ACGT map: x=(c>>1)&3; code=x^(x>>1) —
// identical to the table's A=0 C=1 G=2 T=3, lowercase + U included).
// Records are packed optimistically straight into out_p2 and rolled back
// (counter restore) when dropped by min_seq_size; "capsid" records skip
// by memchr without any decode work (dnafiles.rs:67).
//
//   out_p2      : capacity >= (len/4 + 1) bytes
//   inv/max_exc : invalid-code positions (NOT prefilled; first *out_ninv
//                 entries are valid on return)
//   out_codes   : total codes in the row, separators included
//
// Returns kept records; -1 = p2 capacity too small; -2 = more than
// max_exc invalid positions (caller falls back to the unfused path).

namespace {

constexpr size_t kChunk = 16384;

struct PackState {
    uint8_t* out;
    size_t cap;        // bytes of out
    int32_t* inv;
    long max_exc;
    size_t pos = 0;    // committed codes (row position)
    long ninv = 0;
    uint8_t pending = 0;  // partial byte of out[pos/4]
};

// Strip '\n'/'\r' from src[0..n) into dst (needs n+64 capacity); returns
// the kept count.  AVX-512 VBMI2 compress-store where available.
inline size_t compact_span(const uint8_t* src, size_t n, uint8_t* dst) {
    size_t i = 0, w = 0;
#ifdef FASTAPARSE_AVX512
    const __m512i nl = _mm512_set1_epi8('\n');
    const __m512i cr = _mm512_set1_epi8('\r');
    for (; i + 64 <= n; i += 64) {
        __m512i v = _mm512_loadu_si512(src + i);
        __mmask64 keep = _mm512_cmpneq_epi8_mask(v, nl)
                       & _mm512_cmpneq_epi8_mask(v, cr);
        _mm512_mask_compressstoreu_epi8(dst + w, keep, v);
        w += (size_t)__builtin_popcountll((unsigned long long)keep);
    }
#endif
    for (; i < n; ++i) {
        uint8_t c = src[i];
        if (c != '\n' && c != '\r') dst[w++] = c;
    }
    return w;
}

// Emit one raw FASTA byte (scalar path: alignment head/tail).
// Returns -2 on inv overflow, 0 otherwise.
inline long emit_raw(PackState& st, uint8_t raw) {
    uint8_t c = kTables.dna[raw];
    if (c >= 4) {
        if (st.ninv >= st.max_exc) return -2;
        st.inv[st.ninv++] = (int32_t)st.pos;
        c = 0;
    }
    size_t sh = (st.pos & 3) * 2;
    if (sh == 0) st.pending = c;
    else st.pending |= (uint8_t)(c << sh);
    ++st.pos;
    if ((st.pos & 3) == 0) st.out[(st.pos >> 2) - 1] = st.pending;
    return 0;
}

// Encode + pack m newline-free bytes.  Returns 0 / -1 (cap) / -2 (exc).
inline long append_codes(PackState& st, const uint8_t* src, size_t m) {
    if ((st.pos + m) / 4 + 2 > st.cap) return -1;
    size_t j = 0;
    while ((st.pos & 3) && j < m) {
        long rc = emit_raw(st, src[j++]);
        if (rc) return rc;
    }
#ifdef FASTAPARSE_AVX512
    const __m512i up = _mm512_set1_epi8((char)0xDF);
    const __m512i A = _mm512_set1_epi8('A'), C = _mm512_set1_epi8('C');
    const __m512i G = _mm512_set1_epi8('G'), T = _mm512_set1_epi8('T');
    const __m512i U = _mm512_set1_epi8('U');
    const __m512i three = _mm512_set1_epi8(3), one = _mm512_set1_epi8(1);
    const __m512i w_pair = _mm512_set1_epi16(0x0401);
    const __m512i w_quad = _mm512_set1_epi32(0x00100001);
    for (; j + 64 <= m; j += 64) {
        __m512i v = _mm512_loadu_si512(src + j);
        __m512i u = _mm512_and_si512(v, up);
        __mmask64 valid = _mm512_cmpeq_epi8_mask(u, A)
                        | _mm512_cmpeq_epi8_mask(u, C)
                        | _mm512_cmpeq_epi8_mask(u, G)
                        | _mm512_cmpeq_epi8_mask(u, T)
                        | _mm512_cmpeq_epi8_mask(u, U);
        if (valid != ~0ULL) {  // rare: Ns etc.
            uint64_t bad = ~(uint64_t)valid;
            while (bad) {
                int b = __builtin_ctzll(bad);
                bad &= bad - 1;
                if (st.ninv >= st.max_exc) return -2;
                st.inv[st.ninv++] = (int32_t)(st.pos + (size_t)b);
            }
        }
        // x = (c>>1)&3 maps A->0 C->1 G->3 T/U->2; x^(x>>1) swaps 2<->3
        __m512i x = _mm512_and_si512(_mm512_srli_epi16(v, 1), three);
        __m512i code = _mm512_xor_si512(
            x, _mm512_and_si512(_mm512_srli_epi16(x, 1), one));
        code = _mm512_maskz_mov_epi8(valid, code);  // invalid -> 0
        __m512i pairs = _mm512_maddubs_epi16(code, w_pair);   // c0 + 4c1
        __m512i quads = _mm512_madd_epi16(pairs, w_quad);     // + 16c2 + 64c3
        _mm_storeu_si128((__m128i*)(st.out + (st.pos >> 2)),
                         _mm512_cvtepi32_epi8(quads));
        st.pos += 64;
    }
#endif
    for (; j < m; ++j) {
        long rc = emit_raw(st, src[j]);
        if (rc) return rc;
    }
    return 0;
}

}  // namespace

extern "C"
long fasta_concat_pack2(const uint8_t* data, size_t len,
                        uint8_t* out_p2, size_t out_p2_cap,
                        int32_t* inv, long max_exc,
                        long min_seq_size,
                        size_t* out_codes, char* first_id, size_t id_cap,
                        size_t* total_bases, long* out_ninv) {
    static thread_local uint8_t cbuf[kChunk + 64];
    PackState st{out_p2, out_p2_cap, inv, max_exc};
    size_t total = 0;
    long kept = 0;
    bool first_done = false;
    size_t i = 0;
    {
        const void* gt = memchr(data, '>', len);
        i = gt ? (size_t)((const uint8_t*)gt - data) : len;
    }
    while (i < len) {
        ++i;
        size_t hstart = i;
        const void* nl = memchr(data + i, '\n', len - i);
        size_t hend = nl ? (size_t)((const uint8_t*)nl - data) : len;
        i = hend < len ? hend + 1 : len;
        if (header_has_capsid(data + hstart, hend - hstart)) {
            const void* gt = memchr(data + i, '>', len - i);
            i = gt ? (size_t)((const uint8_t*)gt - data) : len;
            continue;
        }
        // optimistic commit: save state, pack straight into out_p2, roll
        // the counters back if the record is dropped
        size_t pos0 = st.pos;
        long ninv0 = st.ninv;
        uint8_t pend0 = st.pending;
        if (kept > 0) {
            // separator: one INVALID code (hard k-mer break)
            if (st.ninv >= st.max_exc) return -2;
            st.inv[st.ninv++] = (int32_t)st.pos;
            size_t sh = (st.pos & 3) * 2;
            if (sh == 0) st.pending = 0;
            ++st.pos;
            if ((st.pos & 3) == 0) st.out[(st.pos >> 2) - 1] = st.pending;
        }
        size_t seq_len = 0;
        size_t scan = i;
        while (scan < len && data[scan] != '>') {
            size_t cend = scan + kChunk;
            if (cend > len) cend = len;
            const void* gt = memchr(data + scan, '>', cend - scan);
            if (gt) cend = (size_t)((const uint8_t*)gt - data);
            size_t m = compact_span(data + scan, cend - scan, cbuf);
            long rc = append_codes(st, cbuf, m);
            if (rc) return rc;
            seq_len += m;
            scan = cend;
            if (gt) break;
        }
        i = scan;
        if ((long)seq_len < min_seq_size || seq_len == 0) {
            st.pos = pos0;       // dropped: ignore the optimistic writes
            st.ninv = ninv0;
            st.pending = pend0;
            continue;
        }
        if (!first_done) {
            size_t idn = 0;
            while (hstart + idn < hend && idn + 1 < id_cap) {
                uint8_t c = data[hstart + idn];
                if (c == ' ' || c == '\t') break;
                first_id[idn++] = (char)c;
            }
            first_id[idn] = '\0';
            first_done = true;
        }
        total += seq_len;
        ++kept;
    }
    if (st.pos & 3) st.out[st.pos >> 2] = st.pending;  // flush partial byte
    *out_codes = st.pos;
    *total_bases = total;
    *out_ninv = st.ninv;
    return kept;
}
