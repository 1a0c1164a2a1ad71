// Exact modular reduction with R = 2**32 for odd moduli q below 2**31,
// shared by modmac.cu (K6) and bconv.cu (K7).  A modulus's constants come
// from `crypto/modular.py` `mont_table`: int32 [L, 4] a limb of q,
// -q^-1 mod 2**32, R**2 mod q and 0 (16 bytes a limb).
#pragma once

#include <cstdint>

namespace mont {

// s < q * 2**32 -> s * 2**-32 mod q, canonical (one REDC: the low word of
// s + m q is zero, the high word is below 2q)
__device__ __forceinline__ uint32_t redc(uint64_t s, uint32_t q,
                                         uint32_t qinv_neg) {
  const uint32_t m = static_cast<uint32_t>(s) * qinv_neg;
  const uint64_t t = (s + static_cast<uint64_t>(m) * q) >> 32;
  return static_cast<uint32_t>(t >= q ? t - q : t);
}

// s + p for s, p < q * 2**32, kept below q * 2**32 (= qR): a lazy sum of
// products below 2**62, with no remainder until the end.  s + p < 2 qR
// < 2**64.
__device__ __forceinline__ uint64_t lazy_add(uint64_t s, uint64_t p,
                                             uint64_t qR) {
  s += p;
  return s >= qR ? s - qR : s;
}

}  // namespace mont
