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

#include <cstdint>
#include <cstdio>
#include <cstring>
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

// Fragment CSV body writer. `header` is the pre-rendered header text
// (Python renders it — names/lengths live there); rows are appended in
// the GECKO-shaped dialect of report/csv_writer.py, byte-identically:
//   Frag,xs+1,ys+1,xe+1,ye+1,f|r,group,len,score,idents,sim,sim,0,seqy
// Returns rows written, or -1 on IO error.
int64_t rk_write_frags_csv(const char* path, const char* header, int64_t n,
                           const int32_t* xs, const int32_t* ys,
                           const int32_t* xe, const int32_t* ye,
                           const int32_t* strand, const int32_t* group,
                           const int32_t* length, const int32_t* score,
                           const int32_t* idents, int32_t self_cmp) {
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    fputs(header, f);
    std::vector<char> buf(1 << 20);
    setvbuf(f, buf.data(), _IOFBF, buf.size());
    for (int64_t i = 0; i < n; i++) {
        double sim = length[i] ? 100.0 * idents[i] / length[i] : 0.0;
        fprintf(f, "Frag,%d,%d,%d,%d,%s,%d,%d,%d,%d,%.2f,%.2f,%d,%d\n",
                xs[i] + 1, ys[i] + 1, xe[i] + 1, ye[i] + 1,
                strand[i] == 0 ? "f" : "r", group ? group[i] : 0,
                length[i], score[i], idents[i], sim, sim, 0,
                self_cmp ? 0 : 1);
    }
    int rc = fclose(f);
    return rc == 0 ? n : -1;
}

}  // extern "C"
