// Host runtime of the port: exact 64-bit modular NTT for the batch encoder.
//
// The reference's client-side encode/decode runs inside SEAL's native C++
// (BatchEncoder, `AtomicSealBfvVector.cs:1114-1170`).  The device kernels
// cover moduli < 2^31; plain moduli however reach ~40 bits (LoLaDense's
// 34359771137, CryptoNets' 549764251649), whose slot NTT needs
// 64x64->128-bit products: exactly what this file provides through
// unsigned __int128.  The NTTs are those of `cryptonets_tpu/runtime/
// hostcrypto.cpp`; the `_rows` entry points run one over many rows.
//
// Built at first use by `hostcrypto.py` (c++ -O3 -shared -fPIC); a failed
// build raises, nothing falls back to object integers.

#include <cstdint>

extern "C" {

static inline uint64_t mulmod(uint64_t a, uint64_t b, uint64_t t) {
    return (uint64_t)((unsigned __int128)a * b % t);
}

// Forward negacyclic NTT (Longa-Naehrig CT): standard order in,
// bit-reversed out.  tw = psi powers in bit-reversed order, length n.
void ntt_forward_u64(uint64_t* x, const uint64_t* tw, uint64_t t, int logn) {
    const long n = 1L << logn;
    long m = 1, half = n >> 1;
    for (int s = 0; s < logn; ++s) {
        for (long i = 0; i < m; ++i) {
            const uint64_t w = tw[m + i];
            uint64_t* lo = x + 2 * i * half;
            uint64_t* hi = lo + half;
            for (long j = 0; j < half; ++j) {
                const uint64_t u = lo[j];
                const uint64_t v = mulmod(hi[j], w, t);
                lo[j] = u + v >= t ? u + v - t : u + v;
                hi[j] = u >= v ? u - v : u + t - v;
            }
        }
        m <<= 1;
        half >>= 1;
    }
}

// Inverse (GS): bit-reversed in, standard out; itw = inverse psi powers
// (bit-reversed), n_inv = n^-1 mod t.
void ntt_inverse_u64(uint64_t* x, const uint64_t* itw, uint64_t n_inv,
                     uint64_t t, int logn) {
    const long n = 1L << logn;
    long h = n >> 1, half = 1;
    for (int s = 0; s < logn; ++s) {
        for (long i = 0; i < h; ++i) {
            const uint64_t w = itw[h + i];
            uint64_t* lo = x + 2 * i * half;
            uint64_t* hi = lo + half;
            for (long j = 0; j < half; ++j) {
                const uint64_t u = lo[j];
                const uint64_t v = hi[j];
                const uint64_t sum = u + v;
                lo[j] = sum >= t ? sum - t : sum;
                const uint64_t diff = u >= v ? u - v : u + t - v;
                hi[j] = mulmod(diff, w, t);
            }
        }
        h >>= 1;
        half <<= 1;
    }
    for (long j = 0; j < n; ++j) x[j] = mulmod(x[j], n_inv, t);
}

// The same transforms over `rows` consecutive rows of x [rows][n]: one
// call for a piece of rows (the binding runs pieces in threads).
void ntt_forward_rows_u64(uint64_t* x, long rows, const uint64_t* tw,
                          uint64_t t, int logn) {
    for (long r = 0; r < rows; ++r) ntt_forward_u64(x + (r << logn), tw, t, logn);
}

void ntt_inverse_rows_u64(uint64_t* x, long rows, const uint64_t* itw,
                          uint64_t n_inv, uint64_t t, int logn) {
    for (long r = 0; r < rows; ++r)
        ntt_inverse_u64(x + (r << logn), itw, n_inv, t, logn);
}

// Residue reduction helper: values[n] mod each of k moduli -> out[k][n]
// (uint32); values here are < 2^63.
void reduce_residues_u64(const uint64_t* values, long n,
                         const uint32_t* moduli, long k, uint32_t* out) {
    for (long i = 0; i < k; ++i) {
        const uint64_t q = moduli[i];
        uint32_t* row = out + i * n;
        for (long j = 0; j < n; ++j) row[j] = (uint32_t)(values[j] % q);
    }
}

}  // extern "C"
