// gbmio: native IO kernels for genomic panels.
//
// The PyTorch port's own copy of genomicbreedingmodels_tpu/native/src/gbmio.cpp
// (same C ABI, same code); the port builds it, never the JAX package's file.
//
// The reference ecosystem performs all file IO in (external) Julia core code
// and exchanges matrices with its R/BGLR backend through temp TSV files
// (reference src/bayes.jl:59-65, :94-99). This framework keeps file exchange
// as a first-class, *fast* path instead: a multithreaded TSV numeric-block
// parser (std::from_chars, no locale, no allocation per token) and a PLINK
// .bed 2-bit codec, both exposed through a minimal C ABI for ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread gbmio.cpp -o libgbmio.so
// (native/lib.py does this at first use, into build/gbm_torch_native/).

#include <atomic>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Read an entire file into a buffer. Returns false on failure.
bool read_file(const char* path, std::vector<char>& buf) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    if (sz < 0) { std::fclose(f); return false; }
    std::fseek(f, 0, SEEK_SET);
    buf.resize(static_cast<size_t>(sz));
    size_t got = sz ? std::fread(buf.data(), 1, static_cast<size_t>(sz), f) : 0;
    std::fclose(f);
    return got == static_cast<size_t>(sz);
}

// Index newline positions (start offsets of each line).
void index_lines(const std::vector<char>& buf, std::vector<size_t>& starts) {
    starts.clear();
    starts.push_back(0);
    for (size_t i = 0; i < buf.size(); ++i) {
        if (buf[i] == '\n' && i + 1 < buf.size()) starts.push_back(i + 1);
    }
    // Drop a trailing empty line (file ends with '\n').
    if (!starts.empty() && starts.back() >= buf.size()) starts.pop_back();
}

inline bool parse_double(const char* b, const char* e, double& out) {
    // Skip leading spaces.
    while (b < e && (*b == ' ' || *b == '\r')) ++b;
    if (b >= e) return false;
    // NaN / NA markers.
    if ((e - b) >= 2 && (b[0] == 'N' || b[0] == 'n')) {
        out = std::numeric_limits<double>::quiet_NaN();
        return true;
    }
    auto res = std::from_chars(b, e, out);
    return res.ec == std::errc();
}

int hw_threads(int requested) {
    if (requested > 0) return requested;
    unsigned hc = std::thread::hardware_concurrency();
    return hc ? static_cast<int>(hc) : 2;
}

}  // namespace

extern "C" {

// Dimensions of the table at `path`: number of lines and number of
// tab-separated fields on the first line. Returns 0 on success.
int gbmio_tsv_dims(const char* path, long* n_rows, long* n_cols) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    std::vector<size_t> starts;
    index_lines(buf, starts);
    *n_rows = static_cast<long>(starts.size());
    long cols = 0;
    if (!starts.empty()) {
        size_t i = starts[0];
        cols = 1;
        while (i < buf.size() && buf[i] != '\n') {
            if (buf[i] == '\t') ++cols;
            ++i;
        }
    }
    *n_cols = cols;
    return 0;
}

// Parse the numeric block of a TSV table: rows [skip_rows, skip_rows+n_rows),
// columns [skip_cols, skip_cols+n_cols) into out (row-major n_rows x n_cols).
// Threads split the row range. Returns 0 on success, -1 on IO error, -2 on
// shape mismatch, -3 on parse error (first bad row recorded in *bad_row).
int gbmio_tsv_parse(const char* path, long skip_rows, long skip_cols,
                    double* out, long n_rows, long n_cols, int n_threads,
                    long* bad_row) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    std::vector<size_t> starts;
    index_lines(buf, starts);
    if (static_cast<long>(starts.size()) < skip_rows + n_rows) return -2;
    *bad_row = -1;

    std::atomic<long> first_bad{-1};
    int nt = hw_threads(n_threads);
    long chunk = (n_rows + nt - 1) / nt;
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) {
        long r0 = t * chunk;
        long r1 = std::min(n_rows, r0 + chunk);
        if (r0 >= r1) break;
        threads.emplace_back([&, r0, r1]() {
            for (long r = r0; r < r1; ++r) {
                size_t i = starts[static_cast<size_t>(skip_rows + r)];
                size_t end = (static_cast<size_t>(skip_rows + r + 1) < starts.size())
                                 ? starts[static_cast<size_t>(skip_rows + r) + 1] - 1
                                 : buf.size();
                long col = 0, kept = 0;
                size_t tok = i;
                for (size_t j = i; j <= end; ++j) {
                    if (j == end || buf[j] == '\t' || buf[j] == '\n') {
                        if (col >= skip_cols && kept < n_cols) {
                            double v;
                            if (!parse_double(buf.data() + tok, buf.data() + j, v)) {
                                long expect = -1;
                                first_bad.compare_exchange_strong(expect, r);
                                return;
                            }
                            out[r * n_cols + kept] = v;
                            ++kept;
                        }
                        ++col;
                        tok = j + 1;
                    }
                }
                if (kept != n_cols) {
                    long expect = -1;
                    first_bad.compare_exchange_strong(expect, r);
                    return;
                }
            }
        });
    }
    for (auto& th : threads) th.join();
    if (first_bad.load() >= 0) {
        *bad_row = first_bad.load();
        return -3;
    }
    return 0;
}

// Decode a PLINK .bed payload (SNP-major, 2 bits/sample) into allele
// frequencies out[n_samples * n_snps] (row-major, sample x snp).
// Genotype codes: 00 -> 0.0 (hom A1), 10 -> 0.5 (het), 11 -> 1.0 (hom A2),
// 01 -> NaN (missing). `buf` excludes the 3 magic bytes.
int gbmio_bed_decode(const uint8_t* buf, long n_samples, long n_snps,
                     double* out, int n_threads) {
    const long bytes_per_snp = (n_samples + 3) / 4;
    static const double lut[4] = {0.0, std::numeric_limits<double>::quiet_NaN(), 0.5, 1.0};
    int nt = hw_threads(n_threads);
    long chunk = (n_snps + nt - 1) / nt;
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) {
        long s0 = t * chunk;
        long s1 = std::min(n_snps, s0 + chunk);
        if (s0 >= s1) break;
        threads.emplace_back([&, s0, s1]() {
            for (long s = s0; s < s1; ++s) {
                const uint8_t* col = buf + s * bytes_per_snp;
                for (long i = 0; i < n_samples; ++i) {
                    uint8_t code = (col[i >> 2] >> ((i & 3) * 2)) & 0x3;
                    out[i * n_snps + s] = lut[code];
                }
            }
        });
    }
    for (auto& th : threads) th.join();
    return 0;
}

// Decode a PLINK .bed payload straight to int8 dosages {0, 1, 2}
// (-1 = missing) — the exact-MXU int8 Gram path wants dosages, not
// frequencies, and the int8 output is 8x smaller than the f64 one.
// `out_snp_major` != 0: out[n_snps * n_samples] stays SNP-major (the .bed
// native order — pure LUT decode, 4 dosages per payload byte, no transpose;
// the device transposes int8 ~1000x faster than 2 host cores can).
// `out_snp_major` == 0: out[n_samples * n_snps] sample-major via a second,
// tiled-transpose phase. Returns the number of missing calls via
// *n_missing (callers that need complete panels can test it cheaply).
int gbmio_bed_decode_i8(const uint8_t* buf, long n_samples, long n_snps,
                        int8_t* out, int n_threads, long* n_missing,
                        int out_snp_major) {
    const long bytes_per_snp = (n_samples + 3) / 4;
    const long n_pad = bytes_per_snp * 4;
    // lut32[b] = the 4 int8 dosages packed little-endian; miss_cnt[b] = how
    // many of the 4 two-bit codes in byte b are the missing code (01).
    static uint32_t lut32[256];
    static uint8_t miss_cnt[256];
    static std::once_flag lut_once;
    std::call_once(lut_once, []() {
        static const int8_t code_lut[4] = {0, -1, 1, 2};
        for (int b = 0; b < 256; ++b) {
            uint32_t v = 0;
            int m = 0;
            for (int k = 0; k < 4; ++k) {
                int code = (b >> (2 * k)) & 0x3;
                v |= (static_cast<uint32_t>(static_cast<uint8_t>(code_lut[code]))
                      << (8 * k));
                if (code == 1) ++m;
            }
            lut32[b] = v;
            miss_cnt[b] = static_cast<uint8_t>(m);
        }
    });
    std::vector<int8_t> scratch;
    if (!out_snp_major) scratch.resize(static_cast<size_t>(n_snps) * n_pad);
    int nt = hw_threads(n_threads);
    std::atomic<long> missing_total{0};
    const long tail_start = (bytes_per_snp - 1) * 4;  // samples in the last byte
    {
        long chunk = (n_snps + nt - 1) / nt;
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t) {
            long s0 = t * chunk;
            long s1 = std::min(n_snps, s0 + chunk);
            if (s0 >= s1) break;
            threads.emplace_back([&, s0, s1]() {
                long miss = 0;
                for (long s = s0; s < s1; ++s) {
                    const uint8_t* col = buf + s * bytes_per_snp;
                    uint8_t* dst = reinterpret_cast<uint8_t*>(
                        out_snp_major ? out + s * n_samples : scratch.data() + s * n_pad);
                    for (long b = 0; b < bytes_per_snp - 1; ++b) {
                        uint32_t v = lut32[col[b]];
                        std::memcpy(dst + b * 4, &v, 4);
                        miss += miss_cnt[col[b]];
                    }
                    // Last byte: only n_samples - tail_start codes are real.
                    uint32_t v = lut32[col[bytes_per_snp - 1]];
                    long valid = std::min<long>(4, n_samples - tail_start);
                    if (out_snp_major) {
                        std::memcpy(dst + tail_start, &v, static_cast<size_t>(valid));
                    } else {
                        std::memcpy(dst + tail_start, &v, 4);
                    }
                    for (long k = 0; k < valid; ++k)
                        if (static_cast<int8_t>((v >> (8 * k)) & 0xff) == -1) ++miss;
                }
                missing_total.fetch_add(miss, std::memory_order_relaxed);
            });
        }
        for (auto& th : threads) th.join();
    }
    if (out_snp_major) {
        if (n_missing) *n_missing = missing_total.load();
        return 0;
    }
    {
        // Tiled transpose scratch(snp-major, n_pad) -> out(sample-major).
        // Threads own disjoint SAMPLE blocks (disjoint out rows); the inner
        // loop runs over snps so writes are contiguous in `out`.
        const long T = 128;
        long chunk = (n_samples + nt - 1) / nt;
        chunk = ((chunk + T - 1) / T) * T;  // tile-aligned thread splits
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t) {
            long i0 = t * chunk;
            long i1 = std::min(n_samples, i0 + chunk);
            if (i0 >= i1) break;
            threads.emplace_back([&, i0, i1]() {
                for (long ib = i0; ib < i1; ib += T) {
                    long ie = std::min(i1, ib + T);
                    for (long sb = 0; sb < n_snps; sb += T) {
                        long se = std::min(n_snps, sb + T);
                        for (long i = ib; i < ie; ++i) {
                            int8_t* dst = out + i * n_snps;
                            const int8_t* src = scratch.data() + i;
                            for (long s = sb; s < se; ++s)
                                dst[s] = src[s * n_pad];
                        }
                    }
                }
            });
        }
        for (auto& th : threads) th.join();
    }
    if (n_missing) *n_missing = missing_total.load();
    return 0;
}

// Encode allele frequencies into a PLINK .bed payload (excluding magic).
// Frequencies are rounded to the nearest of {0, 0.5, 1}; NaN -> missing.
int gbmio_bed_encode(const double* freqs, long n_samples, long n_snps,
                     uint8_t* out, int n_threads) {
    const long bytes_per_snp = (n_samples + 3) / 4;
    std::memset(out, 0, static_cast<size_t>(bytes_per_snp * n_snps));
    int nt = hw_threads(n_threads);
    long chunk = (n_snps + nt - 1) / nt;
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) {
        long s0 = t * chunk;
        long s1 = std::min(n_snps, s0 + chunk);
        if (s0 >= s1) break;
        threads.emplace_back([&, s0, s1]() {
            for (long s = s0; s < s1; ++s) {
                uint8_t* col = out + s * bytes_per_snp;
                for (long i = 0; i < n_samples; ++i) {
                    double v = freqs[i * n_snps + s];
                    uint8_t code;
                    if (std::isnan(v)) code = 0x1;          // missing
                    else if (v < 0.25) code = 0x0;          // 0.0
                    else if (v < 0.75) code = 0x2;          // 0.5
                    else code = 0x3;                        // 1.0
                    col[i >> 2] |= static_cast<uint8_t>(code << ((i & 3) * 2));
                }
            }
        });
    }
    for (auto& th : threads) th.join();
    return 0;
}

// Quantize an f64 matrix onto the q/scale integer grid in ONE fused pass:
// out[i] = rint(x[i] * scale) when EVERY value sits within `tol` of its grid
// point and inside [0, 255]; returns 1 on success, 0 (early-exit) otherwise.
// Replaces a 4-pass numpy check (f64→f32 copy, rint, |diff| max, astype)
// with one pass at memory bandwidth; decides a uint8 dosage upload (4× fewer
// bytes over the host→device link).
int gbmio_quantize_grid(const double* x, long n_elems, double scale,
                        double tol, uint8_t* out, int n_threads) {
    int nt = hw_threads(n_threads);
    long chunk = (n_elems + nt - 1) / nt;
    std::atomic<int> ok{1};
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) {
        long i0 = t * chunk;
        long i1 = std::min(n_elems, i0 + chunk);
        if (i0 >= i1) break;
        threads.emplace_back([&, i0, i1]() {
            const double inv = 1.0 / scale;
            for (long i = i0; i < i1; ++i) {
                if ((i & 0xFFFF) == 0 && !ok.load(std::memory_order_relaxed))
                    return;  // another thread found an off-grid value
                double q = std::nearbyint(x[i] * scale);
                if (q < 0.0 || q > 255.0 || std::fabs(x[i] - q * inv) > tol) {
                    ok.store(0, std::memory_order_relaxed);
                    return;
                }
                out[i] = static_cast<uint8_t>(q);
            }
        });
    }
    for (auto& th : threads) th.join();
    return ok.load();
}

// Column means of an (n x p) row-major matrix, NaN-aware, threaded over
// column blocks. Used by the streaming loader to center panels at read time.
int gbmio_col_means(const double* x, long n, long p, double* means, int n_threads) {
    int nt = hw_threads(n_threads);
    long chunk = (p + nt - 1) / nt;
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) {
        long c0 = t * chunk;
        long c1 = std::min(p, c0 + chunk);
        if (c0 >= c1) break;
        threads.emplace_back([&, c0, c1]() {
            std::vector<double> sum(static_cast<size_t>(c1 - c0), 0.0);
            std::vector<long> cnt(static_cast<size_t>(c1 - c0), 0);
            for (long i = 0; i < n; ++i) {
                const double* row = x + i * p;
                for (long c = c0; c < c1; ++c) {
                    double v = row[c];
                    if (!std::isnan(v)) { sum[c - c0] += v; ++cnt[c - c0]; }
                }
            }
            for (long c = c0; c < c1; ++c)
                means[c] = cnt[c - c0] ? sum[c - c0] / cnt[c - c0]
                                       : std::numeric_limits<double>::quiet_NaN();
        });
    }
    for (auto& th : threads) th.join();
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// VCF: parse the GT fields of simple (single-ALT, diploid) records into
// allele-frequency dosages. Threads split the record range; each record row
// writes column r of out (n_samples x n_records, row-major n_samples rows).
// Genotype mapping: 0/0 -> 0.0, 0/1 or 1/0 -> 0.5, 1/1 -> 1.0, missing or
// half-missing -> NaN; separators '/' and '|' both accepted; multi-allelic
// codes (>1) count as alt copies clamped to 2.
// ---------------------------------------------------------------------------

extern "C" {

// First pass: count data records and samples. Returns 0 on success.
int gbmio_vcf_dims(const char* path, long* n_records, long* n_samples,
                   long* header_line_index) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    std::vector<size_t> starts;
    index_lines(buf, starts);
    long records = 0, samples = -1, header_idx = -1;
    for (size_t li = 0; li < starts.size(); ++li) {
        size_t i = starts[li];
        if (buf[i] == '#') {
            if (i + 1 < buf.size() && buf[i + 1] != '#') {
                // #CHROM header: count tab-separated fields beyond FORMAT.
                long fields = 1;
                for (size_t j = i; j < buf.size() && buf[j] != '\n'; ++j)
                    if (buf[j] == '\t') ++fields;
                samples = fields - 9;
                header_idx = static_cast<long>(li);
            }
            continue;
        }
        ++records;
    }
    if (samples < 0) return -2;
    *n_records = records;
    *n_samples = samples;
    *header_line_index = header_idx;
    return 0;
}

// Second pass: fill out (n_samples x n_records) and per-record metadata
// offsets are not extracted here (Python reads CHROM/POS/REF/ALT cheaply).
int gbmio_vcf_parse(const char* path, double* out, long n_records,
                    long n_samples, int n_threads, long* bad_record) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    std::vector<size_t> starts;
    index_lines(buf, starts);
    std::vector<size_t> rec_starts;
    rec_starts.reserve(static_cast<size_t>(n_records));
    for (size_t li = 0; li < starts.size(); ++li) {
        if (buf[starts[li]] != '#') rec_starts.push_back(starts[li]);
    }
    if (static_cast<long>(rec_starts.size()) != n_records) return -2;
    *bad_record = -1;
    std::atomic<long> first_bad{-1};
    int nt = hw_threads(n_threads);
    long chunk = (n_records + nt - 1) / nt;
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) {
        long r0 = t * chunk;
        long r1 = std::min(n_records, r0 + chunk);
        if (r0 >= r1) break;
        threads.emplace_back([&, r0, r1]() {
            for (long r = r0; r < r1; ++r) {
                size_t i = rec_starts[static_cast<size_t>(r)];
                size_t end = i;
                while (end < buf.size() && buf[end] != '\n') ++end;
                // Skip 9 fixed columns (CHROM..FORMAT).
                long col = 0;
                size_t j = i;
                while (j < end && col < 9) {
                    if (buf[j] == '\t') ++col;
                    ++j;
                }
                long s = 0;
                while (j < end && s < n_samples) {
                    // GT is the first sub-field (up to ':' or '\t').
                    int a0 = -2, a1 = -2;  // -2 unset, -1 missing
                    int cur = -2;
                    bool done_gt = false;
                    size_t k = j;
                    for (; k <= end; ++k) {
                        char c = (k == end) ? '\t' : buf[k];
                        if (c == '\t' || c == ':') {
                            if (!done_gt) {
                                if (a0 == -2) a0 = cur;
                                else if (a1 == -2) a1 = cur;
                                done_gt = true;
                            }
                            if (c == ':') {
                                // skip remainder of this sample field
                                while (k < end && buf[k] != '\t') ++k;
                            }
                            break;
                        } else if (c == '/' || c == '|') {
                            if (a0 == -2) a0 = cur;
                            cur = -2;
                        } else if (c == '.') {
                            cur = -1;
                        } else if (c >= '0' && c <= '9') {
                            cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
                        }
                    }
                    if (!done_gt) { a1 = cur; }
                    if (a1 == -2) a1 = cur;
                    double v;
                    if (a0 < 0 || a1 < 0) {
                        v = std::numeric_limits<double>::quiet_NaN();
                    } else {
                        int alt = (a0 > 0 ? 1 : 0) + (a1 > 0 ? 1 : 0);
                        v = alt * 0.5;
                    }
                    out[s * n_records + r] = v;
                    ++s;
                    j = k + 1;
                }
                if (s != n_samples) {
                    long expect = -1;
                    first_bad.compare_exchange_strong(expect, r);
                    return;
                }
            }
        });
    }
    for (auto& th : threads) th.join();
    if (first_bad.load() >= 0) { *bad_record = first_bad.load(); return -3; }
    return 0;
}

}  // extern "C"
