// Host codec of the PyTorch port: the parts of the runtime that C++ does
// better than Python on the host.
//
//   * fast_read_floats  - weight/embedding CSV parsing (whitespace- or
//                         comma-separated floats)
//   * crt_lift_center   - exact centered CRT reconstruction of decrypt
//                         output from <=4 RNS limbs via unsigned __int128
//                         (the per-coefficient bigint loop in Python is the
//                         host decrypt's cost)
//   * blob write/read   - ciphertext checkpoint pages with a trailing
//                         CRC-32 (the "native" sidecar page format)
//
// A plain shared library with a C interface, built by g++ at first use
// (ops/cuda_build.py) and bound with ctypes (io/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// float parsing
// ---------------------------------------------------------------------------

// Parse whitespace/comma-separated floats from file. Returns count parsed,
// or -1 on open failure. out may be null to query the count.
long fast_read_floats(const char* path, double* out, long cap) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = (char*)std::malloc(sz + 1);
    if (!buf) { std::fclose(f); return -1; }
    long rd = (long)std::fread(buf, 1, sz, f);
    std::fclose(f);
    buf[rd] = 0;
    long n = 0;
    char* p = buf;
    while (*p) {
        while (*p && (*p == ',' || *p == ' ' || *p == '\n' || *p == '\r' ||
                      *p == '\t')) p++;
        if (!*p) break;
        char* end = nullptr;
        double v = std::strtod(p, &end);
        if (end == p) { p++; continue; }
        if (out && n < cap) out[n] = v;
        n++;
        p = end;
    }
    std::free(buf);
    return n;
}

// ---------------------------------------------------------------------------
// centered CRT lift
// ---------------------------------------------------------------------------

// residues: (L, n) row-major u32; primes: (L,) u64; weights: (L,) u64 pairs
// (hi, lo) of Qi * (Qi^-1 mod qi) mod Q precomputed host-side as 128-bit.
// Q given as (hi, lo). Output: centered value as double, out[n].
void crt_lift_center(const uint32_t* residues, long L, long n,
                     const uint64_t* w_hi, const uint64_t* w_lo,
                     uint64_t q_hi, uint64_t q_lo, double* out) {
    typedef unsigned __int128 u128;
    const u128 Q = ((u128)q_hi << 64) | q_lo;
    const u128 half = Q >> 1;
    for (long j = 0; j < n; ++j) {
        u128 acc = 0;
        for (long i = 0; i < L; ++i) {
            u128 w = ((u128)w_hi[i] << 64) | w_lo[i];
            // (r * w) mod Q ; r < 2^30, w < Q < 2^120 -> product may exceed
            // 128 bits if Q > 2^98. Guard: reduce w first (w < Q), then do
            // shift-and-add multiply in 128 bits with modular folding.
            u128 r = residues[i * n + j];
            u128 term = 0;
            u128 base = w % Q;
            while (r) {
                if (r & 1) { term += base; if (term >= Q) term -= Q; }
                base <<= 1; if (base >= Q) base -= Q;
                r >>= 1;
            }
            acc += term;
            if (acc >= Q) acc -= Q;
        }
        // hi * 2^64 + lo in doubles rounds twice where Python's int ->
        // float rounds once: the two agree below 2^53 (every decrypt's
        // coefficients) and may differ in the last bit above it
        double v;
        if (acc > half) {
            u128 neg = Q - acc;
            v = -((double)(uint64_t)(neg >> 64) * 1.8446744073709552e19 +
                  (double)(uint64_t)neg);
        } else {
            v = (double)(uint64_t)(acc >> 64) * 1.8446744073709552e19 +
                (double)(uint64_t)acc;
        }
        out[j] = v;
    }
}

// ---------------------------------------------------------------------------
// blob IO with crc32
// ---------------------------------------------------------------------------

static uint32_t crc32_table[256];
static int crc32_init_done = 0;

static void crc32_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc32_table[i] = c;
    }
    crc32_init_done = 1;
}

uint32_t crc32_bytes(const uint8_t* data, long n) {
    if (!crc32_init_done) crc32_init();
    uint32_t c = 0xFFFFFFFFu;
    for (long i = 0; i < n; i++)
        c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// Write a u32 page with trailing crc32. Returns 0 on success.
int write_blob_u32(const char* path, const uint32_t* data, long n) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    uint64_t n64 = (uint64_t)n;
    if (std::fwrite(&n64, 8, 1, f) != 1) { std::fclose(f); return -2; }
    if (n && std::fwrite(data, 4, n, f) != (size_t)n) { std::fclose(f); return -2; }
    uint32_t crc = crc32_bytes((const uint8_t*)data, n * 4);
    if (std::fwrite(&crc, 4, 1, f) != 1) { std::fclose(f); return -2; }
    std::fclose(f);
    return 0;
}

// Read a u32 page; verifies crc. Returns element count, -1 open fail,
// -2 short read, -3 crc mismatch. data may be null to query count.
long read_blob_u32(const char* path, uint32_t* data, long cap) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    uint64_t n64 = 0;
    if (std::fread(&n64, 8, 1, f) != 1) { std::fclose(f); return -2; }
    long n = (long)n64;
    if (!data) { std::fclose(f); return n; }
    if (cap < n) { std::fclose(f); return -2; }
    if (n && std::fread(data, 4, n, f) != (size_t)n) { std::fclose(f); return -2; }
    uint32_t crc_file = 0;
    if (std::fread(&crc_file, 4, 1, f) != 1) { std::fclose(f); return -2; }
    std::fclose(f);
    if (crc32_bytes((const uint8_t*)data, n * 4) != crc_file) return -3;
    return n;
}

}  // extern "C"
