// Native ETL hot loops of deep_recommenders_torch (host side).
//
// The device only sees encoded id tensors, so real-corpus ETL runs on the
// host, where a Python line loop over ratings.dat takes tens of seconds on
// ml-1m. These C++ loops provide:
//   - parse_ml1m_ratings: "uid::mid::rating::ts" line parser -> int64 cols
//   - crc32_bucket: batched CRC-32 % buckets over a packed string buffer
//   - pack_bags: padded (N, L) multi-hot bag packing from CSR-style input
// Bound with ctypes (a plain C interface); see native/__init__.py, which
// builds this file and loader.cpp into one library.
//
// The CRC-32 is the IEEE one that zlib and Python's zlib.crc32 compute
// (reflected polynomial 0xEDB88320, initial value and final xor
// 0xFFFFFFFF), from a table built here, so the library needs no zlib.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

struct Crc32Table {
    uint32_t entry[256];
    Crc32Table() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c & 1u) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
            entry[i] = c;
        }
    }
};

const Crc32Table kCrc32;

uint32_t crc32(const unsigned char* data, int64_t len) {
    uint32_t c = 0xFFFFFFFFu;
    for (int64_t i = 0; i < len; ++i)
        c = kCrc32.entry[(c ^ data[i]) & 0xFFu] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

}  // namespace

extern "C" {

// Parse up to max_rows lines of "a::b::c::d" integers from path.
// Returns the number of rows parsed, or -1 on open failure.
int64_t parse_ml1m_ratings(const char* path, int64_t* uid, int64_t* mid,
                           int64_t* rating, int64_t* ts, int64_t max_rows) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char line[256];
    int64_t n = 0;
    while (n < max_rows && fgets(line, sizeof(line), f)) {
        char* p = line;
        int64_t vals[4] = {0, 0, 0, 0};
        int field = 0;
        while (*p && field < 4) {
            // Parse an integer.
            int64_t v = 0;
            bool neg = false;
            if (*p == '-') { neg = true; ++p; }
            while (*p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
            vals[field++] = neg ? -v : v;
            // Skip the "::" separator (or anything up to next digit/EOL).
            while (*p && (*p < '0' || *p > '9') && *p != '\n') ++p;
            if (*p == '\n') break;
        }
        if (field == 4) {
            uid[n] = vals[0];
            mid[n] = vals[1];
            rating[n] = vals[2];
            ts[n] = vals[3];
            ++n;
        }
    }
    fclose(f);
    return n;
}

// CRC32 % buckets over n strings packed in `buf` with byte offsets
// `offsets` (length n+1). Matches Python's zlib.crc32(bytes) % buckets.
void crc32_bucket(const char* buf, const int64_t* offsets, int64_t n,
                  int64_t buckets, int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const unsigned char* start =
            reinterpret_cast<const unsigned char*>(buf + offsets[i]);
        uint32_t h = crc32(start, offsets[i + 1] - offsets[i]);
        out[i] = static_cast<int32_t>(h % static_cast<uint32_t>(buckets));
    }
}

// Pack CSR-style bags (flat values + row offsets, length n_rows+1) into a
// padded (n_rows, max_len) id matrix + float weights (1.0 for real slots).
void pack_bags(const int32_t* flat, const int64_t* offsets, int64_t n_rows,
               int64_t max_len, int32_t* ids_out, float* wt_out) {
    for (int64_t r = 0; r < n_rows; ++r) {
        int64_t lo = offsets[r], hi = offsets[r + 1];
        int64_t len = hi - lo;
        if (len > max_len) len = max_len;
        int64_t base = r * max_len;
        for (int64_t j = 0; j < len; ++j) {
            ids_out[base + j] = flat[lo + j];
            wt_out[base + j] = 1.0f;
        }
        for (int64_t j = len; j < max_len; ++j) {
            ids_out[base + j] = 0;
            wt_out[base + j] = 0.0f;
        }
    }
}

}  // extern "C"
