// K6 `mod_mac`: the modular multiply-accumulate over a stacked axis, for
// each output c in {0, 1} (one or two key operands sharing one read of a):
//
//   out[z, r1, ra, rb, c, l, n] = ( acc_c[z, r1, ra, rb, l, src(n)]
//       + sum_j a[j, r1, ra, rb, l, src(n)] * b_c[z, j, r1, l, n] * R^-1 )
//       mod q_l,   R = 2**32,  src(n) = perm[z, n] or n.
//
// Replaces what XLA fused on the TPU out of the key-switch inner product
// (`cryptonets_tpu/crypto/bfv.py:1118-1125`, `:1177-1182`, the digit and
// group loops `:1099-1117`, `:1145-1162`), the hoisted baby steps' gather
// and inner product (`cryptonets_tpu/api/bsgs.py:219-229`) and the BSGS
// giant chunks (`:296-304`): `mod_sum(mont_mul(...))` and the gathers and
// `add_mod` around it.  Bound by bytes: each term is one 32 x 32 -> 64 bit
// multiply and a 64-bit add against 4 bytes of a and 4 of each key.
//
// Design: one thread an output coefficient (n, the row's index, fastest),
// both outputs from one read of a.  Operands are addressed by the strides
// the wrapper passes (int64 elements), so the callers' views (the stacked
// axis where it lies, keys broadcast by stride 0, the record axis of a
// batch folded into ra) are read in place.  The J products are summed
// lazily in 64 bits below q * 2**32 (each below q**2 < q * 2**32), and one
// Montgomery reduction gives sum * R^-1 mod q, canonical: bit-equal to the
// plain twin's `mod_sum(mont_mul(...))`.  Keys and a gather's index are read
// per coefficient; the keys of a limb stay in L2 across the rows.

#include <cuda_runtime.h>

#include <cstdint>

#include "montgomery.cuh"

namespace {

constexpr int kThreads = 256;

struct MacParams {
  const int32_t* a;
  const int32_t* b[2];
  const int32_t* acc[2];
  const int64_t* perm;
  int32_t* out;
  const uint32_t* mods;   // [L, 4]: q, -q^-1 mod 2**32, R**2 mod q, 0
  uint32_t Z, R1, RA, RB, J, L, logn;
  int64_t a_sj, a_s1, a_sa, a_sb, a_sl;
  int64_t b_sz[2], b_sj[2], b_s1[2], b_sl[2];
  int64_t c_sz[2], c_s1[2], c_sa[2], c_sb[2], c_sl[2];
  uint64_t total;   // Z * R1 * RA * RB * L << logn
};

template <int NOUT>
__global__ void __launch_bounds__(kThreads) mod_mac_kernel(const MacParams p) {
  const uint64_t idx = uint64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= p.total) return;
  const uint32_t N = 1u << p.logn;
  const uint32_t n = uint32_t(idx) & (N - 1);
  uint32_t row = uint32_t(idx >> p.logn);   // < 2**31 (the wrapper checks)
  const uint32_t l = row % p.L;
  row /= p.L;
  const uint32_t rb = row % p.RB;
  row /= p.RB;
  const uint32_t ra = row % p.RA;
  row /= p.RA;
  const uint32_t r1 = row % p.R1;
  const uint32_t z = row / p.R1;

  const uint32_t src = p.perm ? uint32_t(p.perm[uint64_t(z) * N + n]) : n;
  const uint32_t q = __ldg(p.mods + 4 * l);
  const uint32_t qinv = __ldg(p.mods + 4 * l + 1);
  const uint64_t qR = uint64_t(q) << 32;

  const int32_t* a = p.a + r1 * p.a_s1 + ra * p.a_sa + rb * p.a_sb +
                     l * p.a_sl + src;
  const int32_t* b[NOUT];
  uint64_t s[NOUT];
#pragma unroll
  for (int c = 0; c < NOUT; ++c) {
    b[c] = p.b[c] + z * p.b_sz[c] + r1 * p.b_s1[c] + l * p.b_sl[c] + n;
    s[c] = 0;
  }
  for (uint32_t j = 0; j < p.J; ++j) {
    const uint64_t x = uint32_t(__ldg(a));
    a += p.a_sj;
#pragma unroll
    for (int c = 0; c < NOUT; ++c) {
      s[c] = mont::lazy_add(s[c], x * uint32_t(__ldg(b[c])), qR);
      b[c] += p.b_sj[c];
    }
  }

  // out is contiguous [Z, R1, RA, RB, NOUT, L, N]
  const uint64_t o_sl = N, o_sc = uint64_t(p.L) * N, o_sb = NOUT * o_sc;
  int32_t* out = p.out + (((uint64_t(z) * p.R1 + r1) * p.RA + ra) * p.RB + rb) * o_sb +
                 l * o_sl + n;
#pragma unroll
  for (int c = 0; c < NOUT; ++c) {
    uint32_t r = mont::redc(s[c], q, qinv);
    if (p.acc[c]) {
      const int32_t* acc = p.acc[c] + z * p.c_sz[c] + r1 * p.c_s1[c] +
                           ra * p.c_sa[c] + rb * p.c_sb[c] + l * p.c_sl[c] + src;
      r = mont::add_mod(uint32_t(__ldg(acc)), r, q);
    }
    out[c * o_sc] = int32_t(r);
  }
}

}  // namespace

// The wrapper's parameter block, int64 each, in this order (see
// `kernels/modmac.py` `_launch`).
enum {
  kDevice, kA, kB0, kB1, kAcc0, kAcc1, kPerm, kOut, kMods,
  kZ, kR1, kRA, kRB, kJ, kL, kLogn, kNout,
  kASj, kAS1, kASa, kASb, kASl,
  kB0Sz, kB0Sj, kB0S1, kB0Sl,
  kB1Sz, kB1Sj, kB1S1, kB1Sl,
  kC0Sz, kC0S1, kC0Sa, kC0Sb, kC0Sl,
  kC1Sz, kC1S1, kC1Sa, kC1Sb, kC1Sl,
  kParams
};

extern "C" int mod_mac_param_count() { return kParams; }

extern "C" int mod_mac(const long long* v, void* stream) {
  MacParams p;
  p.a = reinterpret_cast<const int32_t*>(v[kA]);
  p.b[0] = reinterpret_cast<const int32_t*>(v[kB0]);
  p.b[1] = reinterpret_cast<const int32_t*>(v[kB1]);
  p.acc[0] = reinterpret_cast<const int32_t*>(v[kAcc0]);
  p.acc[1] = reinterpret_cast<const int32_t*>(v[kAcc1]);
  p.perm = reinterpret_cast<const int64_t*>(v[kPerm]);
  p.out = reinterpret_cast<int32_t*>(v[kOut]);
  p.mods = reinterpret_cast<const uint32_t*>(v[kMods]);
  p.Z = uint32_t(v[kZ]);
  p.R1 = uint32_t(v[kR1]);
  p.RA = uint32_t(v[kRA]);
  p.RB = uint32_t(v[kRB]);
  p.J = uint32_t(v[kJ]);
  p.L = uint32_t(v[kL]);
  p.logn = uint32_t(v[kLogn]);
  const int nout = int(v[kNout]);
  p.a_sj = v[kASj];
  p.a_s1 = v[kAS1];
  p.a_sa = v[kASa];
  p.a_sb = v[kASb];
  p.a_sl = v[kASl];
  for (int c = 0; c < 2; ++c) {
    const int b0 = c ? kB1Sz : kB0Sz, c0 = c ? kC1Sz : kC0Sz;
    p.b_sz[c] = v[b0];
    p.b_sj[c] = v[b0 + 1];
    p.b_s1[c] = v[b0 + 2];
    p.b_sl[c] = v[b0 + 3];
    p.c_sz[c] = v[c0];
    p.c_s1[c] = v[c0 + 1];
    p.c_sa[c] = v[c0 + 2];
    p.c_sb[c] = v[c0 + 3];
    p.c_sl[c] = v[c0 + 4];
  }
  p.total = (uint64_t(p.Z) * p.R1 * p.RA * p.RB * p.L) << p.logn;
  if (p.total == 0) return 0;
  const uint64_t blocks = (p.total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffull) return int(cudaErrorInvalidConfiguration);

  int current = 0;
  cudaGetDevice(&current);
  const int device = int(v[kDevice]);
  if (current != device) cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nout == 2)
    mod_mac_kernel<2><<<unsigned(blocks), kThreads, 0, s>>>(p);
  else
    mod_mac_kernel<1><<<unsigned(blocks), kThreads, 0, s>>>(p);
  const int err = int(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return err;
}

extern "C" const char* mod_mac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
