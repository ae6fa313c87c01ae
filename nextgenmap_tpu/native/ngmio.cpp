// Native host-side IO hot paths for nextgenmap_tpu.
//
// Reference analog: the reference's host runtime is 100% C++ — kseq.h FASTQ
// parsing (ref:src/kseq.h, component 25) and SAMWriter record assembly
// (ref:src/SAMWriter.cpp, component 11).  This build keeps the device
// pipeline in JAX but, per the same division of labor, runs the two
// host hot loops natively: (1) FASTQ/FASTA chunk parsing + 2-bit encoding
// into the fixed-shape [B, L] batch buffers the jitted step consumes, and
// (2) SAM record formatting (CIGAR RLE, MD/NM walk, line assembly) from the
// fixed-shape device results.
//
// Compiled on demand by nextgenmap_tpu/native/__init__.py (g++ -O3 -shared);
// exposed via ctypes.  Pure-Python fallbacks remain in io/fastq.py & io/sam.py
// and the test suite asserts byte-equality between the two paths.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// base-code tables (match io/encode.py: A0 C1 G2 T3, N/other 4)

static uint8_t CODE[256];
static char DECODE[5] = {'A', 'C', 'G', 'T', 'N'};

static void init_tables() {
    static bool done = false;
    if (done) return;
    memset(CODE, 4, sizeof(CODE));
    CODE[(int)'A'] = 0; CODE[(int)'a'] = 0;
    CODE[(int)'C'] = 1; CODE[(int)'c'] = 1;
    CODE[(int)'G'] = 2; CODE[(int)'g'] = 2;
    CODE[(int)'T'] = 3; CODE[(int)'t'] = 3;
    done = true;
}

// ---------------------------------------------------------------------------
// FASTQ/FASTA chunk parser.
//
// Parses complete records out of `buf[0:len]` (text already gunzipped by the
// caller), filling up to `max_reads` rows:
//   codes   [max_reads, Lmax] uint8, PAD(4)-filled
//   lengths [max_reads] int32
//   names   byte arena; name_off[i] gives each name's offset (NUL-terminated)
//   quals   byte arena (same layout, empty string when FASTA)
// Returns the number of records parsed; *consumed = bytes of buf consumed
// (the caller re-feeds the unconsumed tail prepended to the next chunk).
// `final_chunk` != 0 means EOF: a trailing record without newline is taken.

int ngm_parse_reads(
    const char* buf, int64_t len, int final_chunk,
    int max_reads, int Lmax,
    uint8_t* codes, int32_t* lengths,
    char* name_arena, int64_t name_cap, int64_t* name_off,
    char* qual_arena, int64_t qual_cap, int64_t* qual_off,
    int64_t* consumed)
{
    init_tables();
    int64_t p = 0, nread = 0, npos = 0, qpos = 0;
    while (nread < max_reads) {
        int64_t rec_start = p;
        // skip blank lines
        while (p < len && (buf[p] == '\n' || buf[p] == '\r')) p++;
        if (p >= len) { rec_start = p; break; }
        char tag = buf[p];
        if (tag != '@' && tag != '>') { p++; continue; }  // garbage; skip

        // header line
        int64_t h0 = p + 1, h1 = h0;
        while (h1 < len && buf[h1] != '\n') h1++;
        if (h1 >= len && !final_chunk) { *consumed = rec_start; return (int)nread; }
        int64_t name_end = h0;
        while (name_end < h1 && buf[name_end] != ' ' && buf[name_end] != '\t'
               && buf[name_end] != '\r') name_end++;
        int64_t nlen = name_end - h0;

        if (tag == '@') {
            // FASTQ: seq line, '+' line, qual line
            int64_t s0 = h1 + 1, s1 = s0;
            while (s1 < len && buf[s1] != '\n') s1++;
            int64_t plus = s1 + 1, pe = plus;
            while (pe < len && buf[pe] != '\n') pe++;
            int64_t q0 = pe + 1, q1 = q0;
            while (q1 < len && buf[q1] != '\n') q1++;
            if (q1 >= len && !final_chunk) { *consumed = rec_start; return (int)nread; }
            if (q0 > len) { *consumed = rec_start; return (int)nread; }
            int64_t slen = s1 - s0;
            if (slen && buf[s0 + slen - 1] == '\r') slen--;
            int64_t qlen = (q1 <= len ? q1 : len) - q0;
            if (qlen && buf[q0 + qlen - 1] == '\r') qlen--;
            int L = (int)(slen < Lmax ? slen : Lmax);
            if (npos + nlen + 1 > name_cap || qpos + L + 1 > qual_cap) {
                *consumed = rec_start; return (int)nread;
            }
            uint8_t* row = codes + (int64_t)nread * Lmax;
            memset(row, 4, Lmax);
            for (int i = 0; i < L; i++) row[i] = CODE[(uint8_t)buf[s0 + i]];
            lengths[nread] = L;
            name_off[nread] = npos;
            memcpy(name_arena + npos, buf + h0, nlen);
            name_arena[npos + nlen] = 0;
            npos += nlen + 1;
            qual_off[nread] = qpos;
            int cq = (int)(qlen < L ? qlen : L);
            memcpy(qual_arena + qpos, buf + q0, cq);
            qual_arena[qpos + cq] = 0;
            qpos += cq + 1;
            nread++;
            p = q1 + 1;
        } else {
            // FASTA: sequence runs to the next '>' (multi-line)
            int64_t s = h1 + 1;
            int64_t e = s;
            while (e < len && buf[e] != '>') e++;
            if (e >= len && !final_chunk) { *consumed = rec_start; return (int)nread; }
            uint8_t* row = codes + (int64_t)nread * Lmax;
            memset(row, 4, Lmax);
            int L = 0;
            for (int64_t i = s; i < e && L < Lmax; i++) {
                char c = buf[i];
                if (c == '\n' || c == '\r') continue;
                row[L++] = CODE[(uint8_t)c];
            }
            if (npos + nlen + 1 > name_cap || qpos + 1 > qual_cap) {
                *consumed = rec_start; return (int)nread;
            }
            lengths[nread] = L;
            name_off[nread] = npos;
            memcpy(name_arena + npos, buf + h0, nlen);
            name_arena[npos + nlen] = 0;
            npos += nlen + 1;
            qual_off[nread] = qpos;
            qual_arena[qpos] = 0;
            qpos += 1;
            nread++;
            p = e;
        }
        *consumed = p;
    }
    if (nread == 0) *consumed = p;
    return (int)nread;
}

// ---------------------------------------------------------------------------
// SAM record formatting.
//
// Builds complete SAM lines for a whole batch — mapped AND unmapped rows, in
// row order — into one output text buffer (reference analog SAMWriter.cpp:
// native for *everything*).  Inputs are the device result arrays (host
// numpy); the traceback op buffer is END->START order with codes M=0 I=1 D=2.
// clip_mode: 0 soft (S ops, full SEQ), 1 hard (H ops, trimmed SEQ),
// 2 silent (no clip ops, trimmed SEQ).  Unmapped rows (is_mapped[r]==0) emit
// the SAM unmapped form: CIGAR '*', no AS/NM/MD/XI tags, full untrimmed SEQ;
// RNAME/POS/RNEXT/PNEXT may carry the mapped mate's coordinates (pair
// collation convention) — the caller encodes that in the arenas/arrays.
// Returns bytes written, or -1 if out_cap would overflow (caller retries
// with a bigger buffer).

static inline char* put_u32(char* w, uint32_t v) {
    char tmp[12]; int n = 0;
    if (v == 0) { *w++ = '0'; return w; }
    while (v) { tmp[n++] = (char)('0' + v % 10); v /= 10; }
    while (n) *w++ = tmp[--n];
    return w;
}
static inline char* put_i32(char* w, int32_t v) {
    if (v < 0) { *w++ = '-'; return put_u32(w, (uint32_t)(-(int64_t)v)); }
    return put_u32(w, (uint32_t)v);
}

int64_t ngm_format_sam(
    int n,
    const char* name_arena, const int64_t* name_off,
    const uint8_t* aligned_codes, const int32_t* read_len, int Lmax,
    const char* qual_arena, const int64_t* qual_off, const uint8_t* qual_rev,
    const int32_t* flag, const uint8_t* is_mapped, const int64_t* chrom_pos,
    const char* rnames_arena, const int64_t* rname_off,
    const int32_t* mapq, const int32_t* score,
    const uint8_t* ops, const int32_t* n_ops, int ops_stride,
    const int32_t* q_start, const int32_t* q_end,
    const uint8_t* genome, const int64_t* gpos_abs,
    const char* rnext_arena, const int64_t* rnext_off,
    const int64_t* pnext, const int64_t* tlen,
    const float* identity,
    const char* rg_suffix, int clip_mode,
    char* out, int64_t out_cap)
{
    init_tables();
    // MD scratch sized to the op budget: <= 12 bytes per column (digits +
    // base), no silent clamp (a truncated MD corrupts downstream pileups)
    int64_t md_cap = 12 * (int64_t)ops_stride + 64;
    char* mdbuf = new char[md_cap];
    char* w = out;
    char* end = out + out_cap - 64;
    for (int r = 0; r < n; r++) {
        int L = read_len[r];
        int no = n_ops[r];
        int mappedr = is_mapped[r];
        const uint8_t* op = ops + (int64_t)r * ops_stride;
        // worst case record size estimate
        if (w + 2L * L + no * 4 + 256 > end) { delete[] mdbuf; return -1; }

        // QNAME FLAG RNAME POS MAPQ
        const char* nm = name_arena + name_off[r];
        while (*nm) *w++ = *nm++;
        *w++ = '\t'; w = put_i32(w, flag[r]); *w++ = '\t';
        const char* rn = rnames_arena + rname_off[r];
        while (*rn) *w++ = *rn++;
        *w++ = '\t'; w = put_i32(w, (int32_t)(chrom_pos[r] + 1));
        *w++ = '\t'; w = put_i32(w, mapq[r]); *w++ = '\t';

        // CIGAR from END->START op buffer (reverse = START->END)
        int qs = q_start[r], qe = q_end[r];
        char clip = clip_mode == 1 ? 'H' : 'S';
        if (no == 0 || !mappedr) { *w++ = '*'; }
        else {
            if (qs > 0 && clip_mode != 2) { w = put_i32(w, qs); *w++ = clip; }
            int i = no - 1;
            while (i >= 0) {
                int j = i;
                uint8_t o = op[i];
                while (j >= 0 && op[j] == o) j--;
                w = put_i32(w, i - j);
                *w++ = (o == 0 ? 'M' : (o == 1 ? 'I' : 'D'));
                i = j;
            }
            int tail = L - 1 - qe;
            if (tail > 0 && clip_mode != 2) { w = put_i32(w, tail); *w++ = clip; }
        }
        *w++ = '\t';

        // RNEXT PNEXT TLEN
        const char* rx = rnext_arena + rnext_off[r];
        while (*rx) *w++ = *rx++;
        *w++ = '\t'; w = put_i32(w, (int32_t)pnext[r]);
        *w++ = '\t'; w = put_i32(w, (int32_t)tlen[r]); *w++ = '\t';

        // SEQ (aligned orientation; hard/silent clip trims; unmapped = full)
        const uint8_t* qc = aligned_codes + (int64_t)r * Lmax;
        int s0 = (clip_mode && mappedr) ? qs : 0;
        int s1 = (clip_mode && mappedr) ? qe + 1 : L;
        for (int i = s0; i < s1; i++) *w++ = DECODE[qc[i] > 4 ? 4 : qc[i]];
        *w++ = '\t';

        // QUAL (reversed if qual_rev; clip trims); empty arena -> '*'
        const char* qa = qual_arena + qual_off[r];
        int qlen = (int)strlen(qa);
        if (qlen == 0) { *w++ = '*'; }
        else if (qual_rev[r]) {
            for (int i = s1 - 1; i >= s0; i--) *w++ = qa[qlen - 1 - i];
        } else {
            for (int i = s0; i < s1; i++) *w++ = qa[i];
        }

        if (mappedr) {
            // AS + NM + MD tags from the op walk against the genome
            *w++ = '\t'; *w++ = 'A'; *w++ = 'S'; *w++ = ':'; *w++ = 'i'; *w++ = ':';
            w = put_i32(w, score[r]);
            // MD/NM walk (START->END over reversed ops)
            int64_t g = gpos_abs[r];
            int qi = qs;
            int nm_cnt = 0;
            char* md = mdbuf;
            int run = 0;
            int i = no - 1;
            while (i >= 0) {
                uint8_t o = op[i];
                if (o == 0) {
                    uint8_t qb = qc[qi], gb = genome[g];
                    if (qb == gb) run++;  // N==N counts as MD match (parity
                                          // with the Python writer)
                    else {
                        md = put_i32(md, run);
                        *md++ = DECODE[gb > 4 ? 4 : gb];
                        run = 0; nm_cnt++;
                    }
                    qi++; g++; i--;
                } else if (o == 1) {
                    int j = i;
                    while (j >= 0 && op[j] == 1) j--;
                    nm_cnt += i - j; qi += i - j; i = j;
                } else {
                    int j = i;
                    while (j >= 0 && op[j] == 2) j--;
                    md = put_i32(md, run); run = 0;
                    *md++ = '^';
                    for (int t = 0; t < i - j; t++) {
                        uint8_t gb = genome[g + t];
                        *md++ = DECODE[gb > 4 ? 4 : gb];
                    }
                    nm_cnt += i - j; g += i - j; i = j;
                }
            }
            md = put_i32(md, run);
            char* mdw = w;
            *mdw++ = '\t'; *mdw++ = 'N'; *mdw++ = 'M'; *mdw++ = ':';
            *mdw++ = 'i'; *mdw++ = ':';
            mdw = put_i32(mdw, nm_cnt);
            *mdw++ = '\t'; *mdw++ = 'M'; *mdw++ = 'D'; *mdw++ = ':';
            *mdw++ = 'Z'; *mdw++ = ':';
            int64_t mdl = md - mdbuf;
            if (mdw + mdl > end) { delete[] mdbuf; return -1; }
            memcpy(mdw, mdbuf, mdl);
            w = mdw + mdl;
            // XI:f identity tag (parity with the Python writer)
            *w++ = '\t'; *w++ = 'X'; *w++ = 'I'; *w++ = ':'; *w++ = 'f'; *w++ = ':';
            w += snprintf(w, 16, "%.4f", identity[r]);
        }
        const char* rg = rg_suffix;
        while (*rg) *w++ = *rg++;
        *w++ = '\n';
        if (w > end) { delete[] mdbuf; return -1; }
    }
    delete[] mdbuf;
    return w - out;
}

// ---------------------------------------------------------------------------
// K-mer index build passes (reference analog: the CompactPrefixTable two-pass
// build, ref:src/CompactPrefixTable.cpp — the HOT first-run path for gigabase
// genomes; the vectorized numpy build takes tens of minutes at 600M positions,
// these native passes take seconds).
//
// collapse: 0 none, 1 C->T (bisulfite fwd), 2 G->A (bisulfite rc).
// Positions are filled in ascending genome order per k-mer row (the CSR
// determinism spec relies on this), so the fill pass is sequential.

static inline uint8_t collapse_code(uint8_t c, int collapse) {
    if (collapse == 1 && c == 1) return 3;  // C -> T
    if (collapse == 2 && c == 2) return 0;  // G -> A
    return c;
}

// canonical != 0: the bucket is min(kmer, revcomp(kmer)) and the stored
// position is (start << 1) | flip — matching kmer_values_canonical / the
// device build's v3 entry encoding.

void ngm_index_count(
    const uint8_t* codes, int64_t n, int k, int skip, int collapse,
    int canonical, int64_t* counts /* [4^k] */)
{
    const uint64_t mask = (1ULL << (2 * k)) - 1;
    const int rshift = 2 * (k - 1);
    uint64_t v = 0, rv = 0;
    int valid = 0;  // consecutive ACGT codes ending at i
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = collapse_code(codes[i], collapse);
        if (c < 4) {
            v = ((v << 2) | c) & mask;
            rv = (rv >> 2) | ((uint64_t)(3 - c) << rshift);
            valid++;
        } else {
            valid = 0;
        }
        int64_t start = i - k + 1;
        if (valid >= k && start % skip == 0) {
            uint64_t key = (canonical && rv < v) ? rv : v;
            counts[key]++;
        }
    }
}

void ngm_index_fill(
    const uint8_t* codes, int64_t n, int k, int skip, int collapse,
    int canonical, const uint8_t* dropped /* [4^k] bool */,
    int64_t* cursor /* [4^k] */, uint32_t* positions)
{
    const uint64_t mask = (1ULL << (2 * k)) - 1;
    const int rshift = 2 * (k - 1);
    uint64_t v = 0, rv = 0;
    int valid = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = collapse_code(codes[i], collapse);
        if (c < 4) {
            v = ((v << 2) | c) & mask;
            rv = (rv >> 2) | ((uint64_t)(3 - c) << rshift);
            valid++;
        } else {
            valid = 0;
        }
        int64_t start = i - k + 1;
        if (valid >= k && start % skip == 0) {
            int flip = canonical && rv < v;
            uint64_t key = flip ? rv : v;
            if (dropped[key]) continue;
            uint32_t pos = canonical
                ? (((uint32_t)start << 1) | (uint32_t)flip)
                : (uint32_t)start;
            positions[cursor[key]++] = pos;
        }
    }
}

// ---------------------------------------------------------------------------
// CSR position-range sharding passes (parallel/index_shard.py::ShardedIndex).
// Splitting a gigabase CSR (1.2B entries) with numpy repeat/bincount costs
// ~10 minutes and ~20 GB; these two passes stream the CSR once per shard.

void ngm_shard_count(
    const int64_t* offsets, int64_t nb, const uint32_t* positions,
    int64_t lo, int64_t hi, int64_t* counts /* [nb] */)
{
    for (int64_t r = 0; r < nb; r++) {
        int64_t c = 0;
        for (int64_t i = offsets[r]; i < offsets[r + 1]; i++) {
            uint32_t p = positions[i];
            if (p >= lo && p < hi) c++;
        }
        counts[r] = c;
    }
}

void ngm_shard_fill(
    const int64_t* offsets, int64_t nb, const uint32_t* positions,
    int64_t lo, int64_t hi, const int64_t* out_off /* [nb+1] */,
    int32_t* out_pos /* rebased to lo */)
{
    for (int64_t r = 0; r < nb; r++) {
        int64_t w = out_off[r];
        for (int64_t i = offsets[r]; i < offsets[r + 1]; i++) {
            uint32_t p = positions[i];
            if (p >= lo && p < hi) out_pos[w++] = (int32_t)(p - lo);
        }
    }
}

}  // extern "C"
