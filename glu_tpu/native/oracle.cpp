// Native host-side oracle library.
//
// The reference library's first-party code is native C++ (host orchestration
// in glu/*.hpp; its test oracles are STL algorithms: std::accumulate,
// std::exclusive_scan, std::stable_sort — reference test/reduce_tests.cpp,
// test/blelloch_scan_tests.cpp, test/radix_sort_tests.cpp). This is the
// JAX library's native analog: exact reference implementations of every
// operator contract, fast enough to verify multi-hundred-million-element
// device results (a stable LSD radix sort here runs ~20x faster than
// numpy's stable argsort at 268M pairs).
//
// Exposed as a plain C ABI for ctypes (the environment has no pybind11).
// Build: g++ -O3 -march=native -shared -fPIC oracle.cpp -o libgluoracle.so

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Stable LSD radix sort of (u32 key, u32 value) pairs, 8-bit digits x 4
// passes (the digit width is an oracle-internal choice; the *contract* —
// stable ascending order — matches the reference's 4-bit x 8,
// glu/RadixSort.hpp:289).
void glu_oracle_radix_sort_kv(uint32_t* keys, uint32_t* vals, uint64_t n) {
    if (n <= 1) return;
    std::vector<uint32_t> kbuf(n), vbuf(n);
    uint32_t* ks[2] = {keys, kbuf.data()};
    uint32_t* vs[2] = {vals, vbuf.data()};
    uint64_t hist[256];
    for (int pass = 0; pass < 4; ++pass) {
        const int shift = pass * 8;
        uint32_t* ksrc = ks[pass & 1];
        uint32_t* vsrc = vs[pass & 1];
        uint32_t* kdst = ks[(pass + 1) & 1];
        uint32_t* vdst = vs[(pass + 1) & 1];
        std::memset(hist, 0, sizeof(hist));
        for (uint64_t i = 0; i < n; ++i) hist[(ksrc[i] >> shift) & 0xFF]++;
        uint64_t sum = 0;
        for (int d = 0; d < 256; ++d) {
            uint64_t c = hist[d];
            hist[d] = sum;
            sum += c;
        }
        for (uint64_t i = 0; i < n; ++i) {
            const uint32_t k = ksrc[i];
            const uint64_t pos = hist[(k >> shift) & 0xFF]++;
            kdst[pos] = k;
            vdst[pos] = vsrc[i];
        }
    }
    // 4 passes is even: result is back in the caller's buffers.
}

// Partial sort by the low 4*num_steps key bits (reference num_steps
// semantics, RadixSort.hpp:273,332): stable sort by masked key.
void glu_oracle_radix_sort_kv_partial(uint32_t* keys, uint32_t* vals,
                                      uint64_t n, int num_steps) {
    if (n <= 1) return;
    const uint64_t mask =
        num_steps >= 8 ? 0xFFFFFFFFull : ((1ull << (4 * num_steps)) - 1);
    std::vector<uint32_t> masked(n);
    for (uint64_t i = 0; i < n; ++i) masked[i] = keys[i] & (uint32_t)mask;
    // sort (masked, key, value) triples stably by masked key: reuse the
    // full sorter on (masked, index) then permute.
    std::vector<uint32_t> idx(n);
    for (uint64_t i = 0; i < n; ++i) idx[i] = (uint32_t)i;
    glu_oracle_radix_sort_kv(masked.data(), idx.data(), n);
    std::vector<uint32_t> ok(n), ov(n);
    for (uint64_t i = 0; i < n; ++i) {
        ok[i] = keys[idx[i]];
        ov[i] = vals[idx[i]];
    }
    std::memcpy(keys, ok.data(), n * 4);
    std::memcpy(vals, ov.data(), n * 4);
}

// Exclusive prefix sum over adjacent equal-length partitions
// (reference BlellochScan contract, glu/BlellochScan.hpp:125-138);
// u32 wraparound arithmetic.
void glu_oracle_exclusive_scan(const uint32_t* in, uint32_t* out,
                               uint64_t count, uint64_t num_partitions) {
    const uint64_t part = count / num_partitions;
    for (uint64_t p = 0; p < num_partitions; ++p) {
        uint32_t acc = 0;
        const uint64_t base = p * part;
        for (uint64_t i = 0; i < part; ++i) {
            out[base + i] = acc;
            acc += in[base + i];
        }
    }
}

// Reductions (reference Reduce contract, glu/Reduce.hpp:42-48); u32 ops
// wrap mod 2^32.
uint32_t glu_oracle_reduce_u32(const uint32_t* in, uint64_t n, int op) {
    uint32_t acc;
    switch (op) {
        case 0:  // sum
            acc = 0;
            for (uint64_t i = 0; i < n; ++i) acc += in[i];
            return acc;
        case 1:  // mul
            acc = 1;
            for (uint64_t i = 0; i < n; ++i) acc *= in[i];
            return acc;
        case 2:  // min
            acc = 0xFFFFFFFFu;
            for (uint64_t i = 0; i < n; ++i) acc = in[i] < acc ? in[i] : acc;
            return acc;
        default:  // max
            acc = 0;
            for (uint64_t i = 0; i < n; ++i) acc = in[i] > acc ? in[i] : acc;
            return acc;
    }
}

// is_sorted check (reference check_sorted, test/radix_sort_tests.cpp:45-51)
int glu_oracle_is_sorted(const uint32_t* in, uint64_t n) {
    for (uint64_t i = 1; i < n; ++i)
        if (in[i - 1] > in[i]) return 0;
    return 1;
}

// Exclusive prefix scan under op (0=sum, 1=mul, 2=min, 3=max) over adjacent
// equal-length partitions — oracle for the scan's operator generalization
// (the reference hardcodes `+`, glu/BlellochScan.hpp:99-100); u32 sums and
// products wrap mod 2^32.
void glu_oracle_exclusive_scan_op(const uint32_t* in, uint32_t* out,
                                  uint64_t count, uint64_t num_partitions,
                                  int op) {
    const uint64_t part = count / num_partitions;
    const uint32_t ident =
        op == 0 ? 0u : op == 1 ? 1u : op == 2 ? 0xFFFFFFFFu : 0u;
    for (uint64_t p = 0; p < num_partitions; ++p) {
        uint32_t acc = ident;
        const uint64_t base = p * part;
        for (uint64_t i = 0; i < part; ++i) {
            const uint32_t x = in[base + i];
            out[base + i] = acc;
            switch (op) {
                case 0: acc += x; break;
                case 1: acc *= x; break;
                case 2: acc = x < acc ? x : acc; break;
                default: acc = x > acc ? x : acc; break;
            }
        }
    }
}

// Stable sort by 64-bit keys given as (hi, lo) u32 halves with u32 values —
// oracle for the multi-word-key extension (radix_sort_u64_parts). 8-bit LSD
// over lo then hi (8 passes total), three payload streams.
void glu_oracle_radix_sort_u64(uint32_t* hi, uint32_t* lo, uint32_t* vals,
                               uint64_t n) {
    if (n <= 1) return;
    std::vector<uint32_t> hbuf(n), lbuf(n), vbuf(n);
    uint32_t* hs[2] = {hi, hbuf.data()};
    uint32_t* ls[2] = {lo, lbuf.data()};
    uint32_t* vs[2] = {vals, vbuf.data()};
    uint64_t hist[256];
    for (int pass = 0; pass < 8; ++pass) {
        const int shift = (pass & 3) * 8;
        const int word_hi = pass >= 4;  // low word first: LSD composition
        uint32_t* hsrc = hs[pass & 1];
        uint32_t* lsrc = ls[pass & 1];
        uint32_t* vsrc = vs[pass & 1];
        uint32_t* hdst = hs[(pass + 1) & 1];
        uint32_t* ldst = ls[(pass + 1) & 1];
        uint32_t* vdst = vs[(pass + 1) & 1];
        std::memset(hist, 0, sizeof(hist));
        for (uint64_t i = 0; i < n; ++i)
            hist[((word_hi ? hsrc[i] : lsrc[i]) >> shift) & 0xFF]++;
        uint64_t sum = 0;
        for (int d = 0; d < 256; ++d) {
            uint64_t c = hist[d];
            hist[d] = sum;
            sum += c;
        }
        for (uint64_t i = 0; i < n; ++i) {
            const uint64_t pos =
                hist[((word_hi ? hsrc[i] : lsrc[i]) >> shift) & 0xFF]++;
            hdst[pos] = hsrc[i];
            ldst[pos] = lsrc[i];
            vdst[pos] = vsrc[i];
        }
    }
    // 8 passes is even: result is back in the caller's buffers.
}

}  // extern "C"
