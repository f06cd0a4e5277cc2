// Native host-side IO for repkiller-tpu (SURVEY.md §1 L0/L5).
//
// The reference ecosystem's C/C++ lives in its readers/writers and codec
// (GECKO FASTA readers, word packing, CSV emit — SURVEY.md §2.1 "CSV
// loader"/"Writers", §2.2 "FASTA ingestion"/"2-bit codec"); the TPU-native
// framework keeps the same split: device compute is JAX/XLA/Pallas, host
// byte-crunching is this C++ library (ctypes-bound, numpy fallback when
// the shared object is unavailable).
//
// Every function here must be BIT-IDENTICAL to its numpy reference:
//   rk_fasta_*    == repkiller_tpu/io/fasta.py read_fasta (codes/offsets)
//   rk_pack_2bit  == repkiller_tpu/io/codec.py pack_2bit
//   rk_revcomp    == repkiller_tpu/io/codec.py revcomp_codes
//   rk_write_frags_csv == repkiller_tpu/report/csv_writer.py (byte-equal)
// asserted by tests/unit/test_native_io.py.

#include <algorithm>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// A=0 C=1 G=2 T=3, everything else (incl. N, ambiguity, whitespace) = 4.
// Lowercase soft-mask accepted. Mirrors codec._LUT.
struct Lut {
    uint8_t m[256];
    Lut() {
        memset(m, 4, sizeof(m));
        const char* b = "ACGT";
        for (int i = 0; i < 4; i++) {
            m[(unsigned char)b[i]] = (uint8_t)i;
            m[(unsigned char)(b[i] + 32)] = (uint8_t)i;
        }
    }
};
const Lut LUT;

inline bool is_space(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
           c == '\f';
}

// Walk the FASTA byte buffer line by line (\n, \r, \r\n — bytes.splitlines
// semantics), calling on_header(begin,end) / on_seq(begin,end) with each
// line already stripped of surrounding whitespace. Blank lines skipped.
template <class FH, class FS>
void walk(const char* buf, int64_t n, FH&& on_header, FS&& on_seq) {
    int64_t i = 0;
    while (i < n) {
        int64_t j = i;
        while (j < n && buf[j] != '\n' && buf[j] != '\r') j++;
        int64_t a = i, b = j;
        while (a < b && is_space((unsigned char)buf[a])) a++;
        while (b > a && is_space((unsigned char)buf[b - 1])) b--;
        if (b > a) {
            if (buf[a] == '>') on_header(buf + a, buf + b);
            else on_seq(buf + a, buf + b);
        }
        if (j < n && buf[j] == '\r' && j + 1 < n && buf[j + 1] == '\n') j++;
        i = j + 1;
    }
}

// The CSV writer's rows. A row holds "Frag", 13 fields after commas and
// a newline: four coordinates (int32 + 1, taken in int64: at most 11
// characters), the strand (1), six int32 fields (11 each) and two
// similarities ("%.2f" of at most 100 * 2^31 in magnitude: 16).
constexpr int64_t kMaxRow = 4 + 13 + 4 * 11 + 1 + 6 * 11 + 2 * 16 + 1;
// Rows a further thread takes on: smaller tables take the calling thread.
constexpr int64_t kBlockRows = 1 << 13;

struct Columns {
    const int32_t *xs, *ys, *xe, *ye, *strand, *group, *length, *score,
        *idents, *rec_x, *rec_y;
    int32_t seq_y;  // seqy without rec_y
};

struct Text {
    char* data = nullptr;
    int64_t size = 0;
    ~Text() { free(data); }
};

// Decimal text of v; most fields fit 32 unsigned bits, whose conversion
// divides faster.
inline char* put_int(char* p, int64_t v) {
    if ((uint64_t)v <= UINT32_MAX)
        return std::to_chars(p, p + 20, (uint32_t)v).ptr;
    return std::to_chars(p, p + 20, v).ptr;
}

// printf("%.2f", 100.0 * idn / ln), 0.00 when ln == 0. printf rounds the
// double's exact value to hundredths, half to even. For idn >= 0, ln > 0
// and under 2^20 hundredths, the rational 10000 idn / ln = q + rem / ln
// rounds the same way: the double lies within 2^-53 of it relatively,
// under 2^-33 hundredths, while the rational lies at least 1 / (2 ln) >
// 2^-32 hundredths from the midpoint q + 1/2 unless 2 rem == ln. Exact
// ties and every other row take snprintf.
inline char* put_similarity(char* p, int32_t idn, int32_t ln) {
    if (ln == 0) {
        memcpy(p, "0.00", 4);
        return p + 4;
    }
    if (idn >= 0 && ln > 0) {
        int64_t num = 10000 * (int64_t)idn, q = num / ln, rem = num % ln;
        if (q < (1 << 20) && 2 * rem != ln) {
            q += 2 * rem > ln;
            p = put_int(p, q / 100);
            *p++ = '.';
            *p++ = (char)('0' + q % 100 / 10);
            *p++ = (char)('0' + q % 10);
            return p;
        }
    }
    return p + snprintf(p, 24, "%.2f", 100.0 * idn / ln);
}

char* put_row(char* p, const Columns& c, int64_t i) {
    memcpy(p, "Frag,", 5);
    p += 5;
    for (const int32_t* col : {c.xs, c.ys, c.xe, c.ye}) {
        p = put_int(p, (int64_t)col[i] + 1);
        *p++ = ',';
    }
    *p++ = c.strand[i] == 0 ? 'f' : 'r';
    *p++ = ',';
    p = put_int(p, c.group ? c.group[i] : 0);
    for (const int32_t* col : {c.length, c.score, c.idents}) {
        *p++ = ',';
        p = put_int(p, col[i]);
    }
    *p++ = ',';
    char* sim = p;
    p = put_similarity(p, c.idents[i], c.length[i]);
    int64_t w = p - sim;
    *p++ = ',';
    memcpy(p, sim, (size_t)w);
    p += w;
    *p++ = ',';
    p = put_int(p, c.rec_x ? c.rec_x[i] : 0);
    *p++ = ',';
    p = put_int(p, c.rec_y ? c.rec_y[i] : c.seq_y);
    *p++ = '\n';
    return p;
}

// Rows [a, b) into `out`, sized for the longest rows (pages never
// touched stay unmapped); out.data stays null if that fails.
void format_rows(const Columns& c, int64_t a, int64_t b, Text& out) {
    out.data = (char*)malloc((size_t)((b - a) * kMaxRow + 32));
    if (!out.data) return;
    char* p = out.data;
    for (int64_t i = a; i < b; i++) p = put_row(p, c, i);
    out.size = p - out.data;
}

}  // namespace

extern "C" {

// Pass 1: sizes. Returns total code length INCLUDING `spacer` N codes
// between consecutive records; *n_records = record count (an implicit
// unnamed record is counted when sequence precedes any header). The
// spacer must be long enough that x-drop kills any extension crossing it
// (io/fasta.py picks it from the scoring config).
int64_t rk_fasta_sizes(const char* buf, int64_t n, int64_t spacer,
                       int64_t* n_records) {
    int64_t records = 0, seq_bytes = 0;
    bool any = false;
    walk(buf, n,
         [&](const char*, const char*) { records++; any = true; },
         [&](const char* a, const char* b) {
             if (!any) { records++; any = true; }  // implicit seq0
             seq_bytes += (int64_t)(b - a);
         });
    *n_records = records;
    return records ? seq_bytes + (records - 1) * spacer : 0;
}

// Pass 2: fill codes (`spacer` N codes between records), per-record
// offsets and lengths (sized by pass 1). Returns records written.
int64_t rk_fasta_parse(const char* buf, int64_t n, int64_t spacer,
                       uint8_t* codes, int64_t* offsets, int64_t* lengths) {
    int64_t pos = 0, rec = -1;
    auto open_record = [&]() {
        if (rec >= 0) {
            lengths[rec] = pos - offsets[rec];
            for (int64_t s = 0; s < spacer; s++) codes[pos++] = 4;
        }
        rec++;
        offsets[rec] = pos;
    };
    walk(buf, n,
         [&](const char*, const char*) { open_record(); },
         [&](const char* a, const char* b) {
             if (rec < 0) open_record();
             for (const char* p = a; p < b; p++)
                 codes[pos++] = LUT.m[(unsigned char)*p];
         });
    if (rec >= 0) lengths[rec] = pos - offsets[rec];
    return rec + 1;
}

// 2-bit pack: 16 bases/uint32 word little-endian within the word, N packs
// as 0 with its validity bit (1 bit/base, 32/word) cleared. Threaded over
// word ranges (the reference's pthread/OpenMP analog, SURVEY.md §2.1).
void rk_pack_2bit(const uint8_t* codes, int64_t n, uint32_t* packed,
                  uint32_t* nmask, int32_t n_threads) {
    int64_t nwords = (n + 15) / 16;
    int64_t mwords = (n + 31) / 32;
    if (n_threads < 1) n_threads = 1;
    auto pack_range = [&](int64_t w0, int64_t w1) {
        for (int64_t w = w0; w < w1; w++) {
            uint32_t acc = 0;
            int64_t base = w * 16, lim = base + 16 < n ? base + 16 : n;
            for (int64_t i = base; i < lim; i++) {
                uint8_t c = codes[i];
                acc |= (uint32_t)(c < 4 ? c : 0) << (2 * (i - base));
            }
            packed[w] = acc;
        }
    };
    auto mask_range = [&](int64_t w0, int64_t w1) {
        for (int64_t w = w0; w < w1; w++) {
            uint32_t acc = 0;
            int64_t base = w * 32, lim = base + 32 < n ? base + 32 : n;
            for (int64_t i = base; i < lim; i++)
                if (codes[i] < 4) acc |= 1u << (i - base);
            nmask[w] = acc;
        }
    };
    if (n_threads == 1 || nwords < 1 << 16) {
        pack_range(0, nwords);
        mask_range(0, mwords);
        return;
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) {
        int64_t a = nwords * t / n_threads, b = nwords * (t + 1) / n_threads;
        int64_t ma = mwords * t / n_threads, mb = mwords * (t + 1) / n_threads;
        ts.emplace_back([=]() { pack_range(a, b); mask_range(ma, mb); });
    }
    for (auto& t : ts) t.join();
}

// Reverse complement; N (>=4) unchanged, involution.
void rk_revcomp(const uint8_t* codes, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = codes[n - 1 - i];
        out[i] = c < 4 ? (uint8_t)(3 - c) : c;
    }
}

// Fragment CSV writer: `header` (Python renders it: names and lengths
// live there), then one row per fragment in the GECKO-shaped dialect of
// report/csv_writer.py, byte for byte:
//   Frag,xs+1,ys+1,xe+1,ye+1,f|r,group,len,score,idents,sim,sim,seqx,seqy
// seqx is rec_x[i] (0 without it), seqy rec_y[i] (self_cmp ? 0 : 1
// without it). The rows are cut into contiguous ranges, one a thread: a
// thread for each kBlockRows rows begun, at most max_threads. Each is
// formatted into the thread's own buffer; the header and the buffers then
// go out in row order: to the file at `path`, or, when `path` is null, to
// `sink` one piece at a time. *threads gets the threads that formatted
// rows. Returns the bytes written, or -1 on an I/O or allocation error.
typedef void (*rk_sink)(const char* data, int64_t size);

int64_t rk_write_frags_csv(const char* path, rk_sink sink, const char* header,
                           int64_t n, const int32_t* xs, const int32_t* ys,
                           const int32_t* xe, const int32_t* ye,
                           const int32_t* strand, const int32_t* group,
                           const int32_t* length, const int32_t* score,
                           const int32_t* idents, const int32_t* rec_x,
                           const int32_t* rec_y, int32_t self_cmp,
                           int32_t max_threads, int32_t* threads) {
    const Columns c{xs, ys, xe, ye, strand, group, length, score, idents,
                    rec_x, rec_y, self_cmp ? 0 : 1};
    int64_t blocks = (n + kBlockRows - 1) / kBlockRows;
    int64_t nt = std::max<int64_t>(1, std::min<int64_t>(max_threads, blocks));
    std::vector<Text> parts(nt);
    std::vector<std::thread> ts;
    ts.reserve(nt);
    int64_t t = 1;
    try {
        for (; t < nt; t++)
            ts.emplace_back(format_rows, std::cref(c), n * t / nt,
                            n * (t + 1) / nt, std::ref(parts[t]));
    } catch (const std::system_error&) {
        // no thread to be had: the calling thread formats the rest
    }
    format_rows(c, 0, n / nt, parts[0]);
    for (int64_t r = t; r < nt; r++)
        format_rows(c, n * r / nt, n * (r + 1) / nt, parts[r]);
    for (auto& th : ts) th.join();
    *threads = (int32_t)(ts.size() + 1);
    int64_t total = (int64_t)strlen(header);
    for (const Text& p : parts) {
        if (!p.data) return -1;
        total += p.size;
    }
    if (!path) {
        sink(header, (int64_t)strlen(header));
        for (const Text& p : parts) sink(p.data, p.size);
        return total;
    }
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    bool ok = fputs(header, f) >= 0;
    for (const Text& p : parts)
        ok = ok && fwrite(p.data, 1, (size_t)p.size, f) == (size_t)p.size;
    ok = fclose(f) == 0 && ok;
    return ok ? total : -1;
}

}  // extern "C"
