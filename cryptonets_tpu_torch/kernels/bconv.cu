// K7 `fast_bconv`: the RNS fast base conversion
//
//   out[ra, rb, l, n] = sum_i y[ra, rb, i, n] * c[i, l]  mod m_l
//
// for y already multiplied by the inverse punctured products and the
// [Lf, Lt] table c of punctured products reduced mod each target m_l.
// Replaces what XLA fused on the TPU out of BEHZ's `_fast_bconv`
// (`cryptonets_tpu/crypto/bfv.py:952-958`: the lift to Bsk, the fast floor,
// Shenoy-Kumaresan's conversions B -> q and B -> m_sk, the gamma and
// two-plane decrypts, the mod-down P -> q) and the hybrid key switch's group
// extension (`:1163-1175`).  Bound by bytes: Lf reads and one write of 4
// bytes an output limb's coefficient against Lf products.
//
// Design: one thread an output coefficient, the table in shared memory
// (read from the int64 [Lf, Lt, 1] table of the callers, by its strides, so
// a limb shard's slice of it needs no copy).  y is addressed by strides:
// a group's slice of the source limbs and a batch's record axis are read
// in place.  The Lf products (each below 2**31 m_l) are summed lazily in
// 64 bits below m_l * 2**32; two Montgomery reductions, the second against
// R**2 mod m_l, give the sum mod m_l, canonical: bit-equal to the plain
// twin's `mod_sum(mul_const_mod(...))`.  y's rows are read once for each
// target limb, from L1/L2 after the first.

#include <cuda_runtime.h>

#include <cstdint>

#include "montgomery.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTable = 1024;   // Lf * Lt

struct BconvParams {
  const int32_t* y;
  const int64_t* c;
  int32_t* out;
  const uint32_t* mods;   // [Lt, 4]: m, -m^-1 mod 2**32, R**2 mod m, 0
  uint32_t RA, RB, Lf, Lt, logn;
  int64_t y_sa, y_sb, y_sl, c_sf, c_st;
  uint64_t total;   // RA * RB * Lt << logn
};

__global__ void __launch_bounds__(kThreads) fast_bconv_kernel(const BconvParams p) {
  __shared__ uint32_t tab[kMaxTable];
  for (uint32_t e = threadIdx.x; e < p.Lf * p.Lt; e += kThreads) {
    const uint32_t i = e / p.Lt, t = e % p.Lt;
    tab[e] = uint32_t(p.c[i * p.c_sf + t * p.c_st]);
  }
  __syncthreads();
  const uint64_t idx = uint64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= p.total) return;
  const uint32_t n = uint32_t(idx) & ((1u << p.logn) - 1);
  uint32_t row = uint32_t(idx >> p.logn);   // < 2**31 (the wrapper checks)
  const uint32_t l = row % p.Lt;
  row /= p.Lt;
  const uint32_t rb = row % p.RB;
  const uint32_t ra = row / p.RB;

  const uint32_t m = __ldg(p.mods + 4 * l);
  const uint32_t minv = __ldg(p.mods + 4 * l + 1);
  const uint32_t r2 = __ldg(p.mods + 4 * l + 2);
  const uint64_t mR = uint64_t(m) << 32;
  const int32_t* y = p.y + ra * p.y_sa + rb * p.y_sb + n;
  uint64_t s = 0;
  for (uint32_t i = 0; i < p.Lf; ++i) {
    const uint64_t x = uint32_t(__ldg(y));
    y += p.y_sl;
    s = mont::lazy_add(s, x * tab[i * p.Lt + l], mR);
  }
  // s R^-1, then (s R^-1) R**2 R^-1 = s, both mod m
  const uint32_t x = mont::redc(s, m, minv);
  p.out[idx] = int32_t(mont::redc(uint64_t(x) * r2, m, minv));
}

}  // namespace

// The wrapper's parameter block, int64 each, in this order (see
// `kernels/bconv.py` `_launch`).
enum {
  kDevice, kY, kC, kOut, kMods, kRA, kRB, kLf, kLt, kLogn,
  kYSa, kYSb, kYSl, kCSf, kCSt,
  kParams
};

extern "C" int fast_bconv_param_count() { return kParams; }

extern "C" int fast_bconv_max_table() { return kMaxTable; }

extern "C" int fast_bconv(const long long* v, void* stream) {
  BconvParams p;
  p.y = reinterpret_cast<const int32_t*>(v[kY]);
  p.c = reinterpret_cast<const int64_t*>(v[kC]);
  p.out = reinterpret_cast<int32_t*>(v[kOut]);
  p.mods = reinterpret_cast<const uint32_t*>(v[kMods]);
  p.RA = uint32_t(v[kRA]);
  p.RB = uint32_t(v[kRB]);
  p.Lf = uint32_t(v[kLf]);
  p.Lt = uint32_t(v[kLt]);
  p.logn = uint32_t(v[kLogn]);
  p.y_sa = v[kYSa];
  p.y_sb = v[kYSb];
  p.y_sl = v[kYSl];
  p.c_sf = v[kCSf];
  p.c_st = v[kCSt];
  if (p.Lf * p.Lt > uint32_t(kMaxTable)) return int(cudaErrorInvalidValue);
  p.total = (uint64_t(p.RA) * p.RB * p.Lt) << p.logn;
  if (p.total == 0) return 0;
  const uint64_t blocks = (p.total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffull) return int(cudaErrorInvalidConfiguration);

  int current = 0;
  cudaGetDevice(&current);
  const int device = int(v[kDevice]);
  if (current != device) cudaSetDevice(device);
  fast_bconv_kernel<<<unsigned(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  const int err = int(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return err;
}

extern "C" const char* fast_bconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
