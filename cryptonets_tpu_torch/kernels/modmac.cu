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
// Design: the keys b_c[z, j, r1, l, n] do not depend on the rows (ra,
// rb), so a thread owns V adjacent coefficients of one (z, r1, l) and a
// tile of RT rows rb: it loads each key element once (16 bytes for V =
// 4) and applies it to the RT rows, keeping C x RT x V lazy sums in
// registers.  RT is at most 4 for one output and 2 for two: measured on
// an H100, more rows cost more in occupancy (107 registers at C = 2, RT
// = 4) than they save in key reads, which L2 serves anyway: the row
// tiles of one coefficient tile are adjacent in the grid, so the keys
// they share come from L2 once.  Block indices split
// by shifts and a multiply-high (`FastDiv`), with no division.  A gather
// index is int32, loaded once a thread for all its rows; the gathered
// reads of a (and acc) stay reads from global memory, coalesced for the
// NTT-domain automorphisms the path gathers by.  The J loop is unrolled
// by two to keep loads in flight.  Operands are addressed by the strides
// the wrapper passes (int64 elements), so the callers' views (the stacked
// axis where it lies, keys broadcast by stride 0, the record axis of a
// batch folded into ra) are read in place.  The J products are summed
// lazily in 64 bits below q * 2**32 (each below q**2 < q * 2**32), from
// acc * 2**32 where there is an accumulator (loaded up front, with the
// keys' first loads), and one Montgomery reduction gives acc + sum * R^-1
// mod q, canonical: bit-equal to the plain twin's `add_mod(acc,
// mod_sum(mont_mul(...)))`.  The launch plan (V, RT, the
// threads of a block, the grid) is `kernels/modmac.py` `plan`.
//
// `ct_tensor_kernel<SQ, V>` (`kernels/modmac.py` `ct_tensor`), beside K6 and
// not of its family: the NTT-domain tensor product of the BEHZ multiply,
// c0 = x0 y0, c1 = x0 y1 + x1 y0, c2 = x1 y1 mod q_l, from x, y [R, 2, L,
// N] into [R, 3, L, N] in one pass (SQ: y = x, x0^2, 2 x0 x1, x1^2 from one
// read).  A thread owns V coefficients of one (row, limb); each product
// (c1's two summed lazily, below 2 q**2 < q 2**32) is reduced by two REDCs,
// the second by R**2 mod q, so the result is the canonical a b mod q of
// the twin's `mont_mul(x, to_mont(y))`.  Bound by bytes: 4 (SQ: 2) reads
// and 3 writes of 4 bytes an output coefficient.

#include <cuda_runtime.h>

#include <cstdint>

#include "montgomery.cuh"

namespace {

constexpr int kThreads = 128;

// x / d for x < 2**31 by a multiply-high: (umulhi(x, mul) + x) >> shift,
// mul = floor(2**32 (2**shift - d) / d) + 1, shift = ceil(log2 d)
// (`kernels/modmac.py` `fast_div`)
struct FastDiv {
  uint32_t mul, shift;
};

__device__ __forceinline__ uint32_t fdiv(uint32_t x, FastDiv d) {
  return (__umulhi(x, d.mul) + x) >> d.shift;
}

struct MacParams {
  const int32_t* a;
  const int32_t* b[2];
  const int32_t* acc[2];
  const int32_t* perm;    // int32 [Z, N] or null
  int32_t* out;
  const uint32_t* mods;   // [L, 4]: q, -q^-1 mod 2**32, R**2 mod q, 0
  uint32_t R1, RA, RB, J, L, logn, log_tiles, RBT;
  FastDiv by_rbt, by_r1;
  int64_t a_sj, a_s1, a_sa, a_sb, a_sl;
  int64_t b_sz[2], b_sj[2], b_s1[2], b_sl[2];
  int64_t c_sz[2], c_s1[2], c_sa[2], c_sb[2], c_sl[2];
};

// V adjacent int32 as one load or store (16 bytes for V = 4)
template <int V>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const int32_t* p, uint32_t* x) { x[0] = uint32_t(__ldg(p)); }
  __device__ static void store(int32_t* p, const uint32_t* x) { p[0] = int32_t(x[0]); }
};
template <>
struct Vec<4> {
  __device__ static void load(const int32_t* p, uint32_t* x) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    x[0] = uint32_t(v.x), x[1] = uint32_t(v.y), x[2] = uint32_t(v.z), x[3] = uint32_t(v.w);
  }
  __device__ static void store(int32_t* p, const uint32_t* x) {
    *reinterpret_cast<int4*>(p) = make_int4(int32_t(x[0]), int32_t(x[1]),
                                            int32_t(x[2]), int32_t(x[3]));
  }
};

// C outputs, RT rows a thread, V coefficients a thread
template <int C, int RT, int V>
__global__ void __launch_bounds__(kThreads) mod_mac_kernel(const MacParams p) {
  // blockIdx.x = rbt + RBT * ((l << log_tiles) | tile), y = z * R1 + r1, z = ra
  const uint32_t u = fdiv(blockIdx.x, p.by_rbt);
  const uint32_t rbt = blockIdx.x - u * p.RBT;
  const uint32_t tile = u & ((1u << p.log_tiles) - 1);
  const uint32_t l = u >> p.log_tiles;
  const uint32_t z = fdiv(blockIdx.y, p.by_r1);
  const uint32_t r1 = blockIdx.y - z * p.R1;
  const uint32_t ra = blockIdx.z;
  const uint32_t n = (tile * kThreads + threadIdx.x) * V;
  const uint32_t rb0 = rbt * RT;
  const uint32_t rows = min(uint32_t(RT), p.RB - rb0);   // block-uniform
  const uint32_t N = 1u << p.logn;
  if (n >= N) return;

  uint32_t src[V];
  if (p.perm) {
    Vec<V>::load(p.perm + uint64_t(z) * N + n, src);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) src[v] = n + v;
  }
  const uint32_t q = __ldg(p.mods + 4 * l);
  const uint32_t qinv = __ldg(p.mods + 4 * l + 1);
  const uint64_t qR = uint64_t(q) << 32;

  const int32_t* a = p.a + r1 * p.a_s1 + ra * p.a_sa + rb0 * p.a_sb + l * p.a_sl;
  const int32_t* b[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    b[c] = p.b[c] + z * p.b_sz[c] + r1 * p.b_s1[c] + l * p.b_sl[c] + n;

  // an accumulator enters its sums as acc R (below q R), loaded before
  // the J loop: the one REDC at the end gives acc + sum R^-1 mod q
  uint64_t s[C][RT][V];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      uint32_t x[V] = {};
      if (p.acc[c] && r < rows) {
        const int32_t* ac = p.acc[c] + z * p.c_sz[c] + r1 * p.c_s1[c] + ra * p.c_sa[c] +
                            (rb0 + r) * p.c_sb[c] + l * p.c_sl[c];
        if (p.perm) {
#pragma unroll
          for (int v = 0; v < V; ++v) x[v] = uint32_t(__ldg(ac + src[v]));
        } else {
          Vec<V>::load(ac + n, x);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) s[c][r][v] = uint64_t(x[v]) << 32;
    }
  }

#pragma unroll 2
  for (uint32_t j = 0; j < p.J; ++j) {
    uint32_t k[C][V];
#pragma unroll
    for (int c = 0; c < C; ++c) Vec<V>::load(b[c] + j * p.b_sj[c], k[c]);
    const int32_t* aj = a + j * p.a_sj;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < rows) {
        const int32_t* ar = aj + r * p.a_sb;
        uint32_t x[V];
        if (p.perm) {
#pragma unroll
          for (int v = 0; v < V; ++v) x[v] = uint32_t(__ldg(ar + src[v]));
        } else {
          Vec<V>::load(ar + n, x);
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int v = 0; v < V; ++v)
            s[c][r][v] = mont::lazy_add(s[c][r][v], uint64_t(x[v]) * k[c][v], qR);
      }
    }
  }

  // out is contiguous [Z, R1, RA, RB, C, L, N]
  const uint64_t row0 = ((uint64_t(blockIdx.y) * p.RA + ra) * p.RB + rb0) * C;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        uint32_t o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = mont::redc(s[c][r][v], q, qinv);
        Vec<V>::store(p.out + (((row0 + uint64_t(r) * C + c) * p.L + l) << p.logn) + n, o);
      }
    }
  }
}

template <int C, int RT>
cudaError_t launch_rt(int V, dim3 grid, const MacParams& p, cudaStream_t s) {
  if (V == 4)
    mod_mac_kernel<C, RT, 4><<<grid, kThreads, 0, s>>>(p);
  else
    mod_mac_kernel<C, RT, 1><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(int RT, int V, dim3 grid, const MacParams& p, cudaStream_t s) {
  switch (RT) {
    case 1: return launch_rt<C, 1>(V, grid, p, s);
    case 2: return launch_rt<C, 2>(V, grid, p, s);
    case 4:
      if constexpr (C == 1) return launch_rt<C, 4>(V, grid, p, s);
  }
  return cudaErrorInvalidValue;
}

template <int C, int RT, int V>
int describe(int* out) {
  const auto kernel = mod_mac_kernel<C, RT, V>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return int(err);
  out[0] = attr.numRegs;
  out[1] = int(attr.localSizeBytes);
  out[2] = kThreads;
  out[3] = int(attr.sharedSizeBytes);
  out[4] = blocks;
  return 0;
}

template <int C, int RT>
int describe_rt(int V, int* out) {
  return V == 4 ? describe<C, RT, 4>(out) : describe<C, RT, 1>(out);
}

// ------------------------------------------------------------ ct_tensor
struct TensorParams {
  const int32_t* x;
  const int32_t* y;       // null for the square
  int32_t* out;           // contiguous [R, 3, L, N]
  const uint32_t* mods;   // [L, 4]: q, -q^-1 mod 2**32, R**2 mod q, 0
  uint32_t L, logn, log_tiles;
};

// s < q 2**32 -> s mod q: s R^-1 by one REDC, then times R**2 R^-1
__device__ __forceinline__ uint32_t reduce2(uint64_t s, uint32_t q, uint32_t qinv, uint32_t r2) {
  return mont::redc(uint64_t(mont::redc(s, q, qinv)) * r2, q, qinv);
}

template <bool SQ, int V>
__global__ void __launch_bounds__(kThreads) ct_tensor_kernel(const TensorParams p) {
  const uint32_t tile = blockIdx.x & ((1u << p.log_tiles) - 1);
  const uint32_t r = blockIdx.x >> p.log_tiles;
  const uint32_t l = blockIdx.y;
  const uint32_t n = (tile * kThreads + threadIdx.x) * V;
  if (n >= (1u << p.logn)) return;
  const uint32_t q = __ldg(p.mods + 4 * l);
  const uint32_t qinv = __ldg(p.mods + 4 * l + 1);
  const uint32_t r2 = __ldg(p.mods + 4 * l + 2);
  const uint64_t poly = uint64_t(p.L) << p.logn;   // one polynomial of a row
  const uint64_t at = (uint64_t(l) << p.logn) + n;
  uint32_t x0[V], x1[V], y0[V], y1[V];
  Vec<V>::load(p.x + 2 * r * poly + at, x0);
  Vec<V>::load(p.x + (2 * r + 1) * poly + at, x1);
  if constexpr (!SQ) {
    Vec<V>::load(p.y + 2 * r * poly + at, y0);
    Vec<V>::load(p.y + (2 * r + 1) * poly + at, y1);
  }
  uint32_t c0[V], c1[V], c2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint32_t b0 = SQ ? x0[v] : y0[v], b1 = SQ ? x1[v] : y1[v];
    const uint64_t mid = SQ ? 2 * (uint64_t(x0[v]) * x1[v])
                            : uint64_t(x0[v]) * b1 + uint64_t(x1[v]) * b0;
    c0[v] = reduce2(uint64_t(x0[v]) * b0, q, qinv, r2);
    c1[v] = reduce2(mid, q, qinv, r2);
    c2[v] = reduce2(uint64_t(x1[v]) * b1, q, qinv, r2);
  }
  int32_t* out = p.out + 3 * r * poly + at;
  Vec<V>::store(out, c0);
  Vec<V>::store(out + poly, c1);
  Vec<V>::store(out + 2 * poly, c2);
}

template <bool SQ>
cudaError_t tensor_launch(int V, dim3 grid, const TensorParams& p, cudaStream_t s) {
  if (V == 4)
    ct_tensor_kernel<SQ, 4><<<grid, kThreads, 0, s>>>(p);
  else
    ct_tensor_kernel<SQ, 1><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <bool SQ, int V>
int tensor_describe(int* out) {
  const auto kernel = ct_tensor_kernel<SQ, V>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return int(err);
  out[0] = attr.numRegs;
  out[1] = int(attr.localSizeBytes);
  out[2] = kThreads;
  out[3] = int(attr.sharedSizeBytes);
  out[4] = blocks;
  return 0;
}

}  // namespace

// Five ints into `out` for the instance (C outputs, RT rows, V
// coefficients a thread) on the current device: registers and local
// (spilled) bytes a thread, threads and static shared bytes of a block,
// resident blocks an SM.
extern "C" int mod_mac_kernel_info(int C, int RT, int V, int* out) {
  switch (C * 100 + RT) {
    case 101: return describe_rt<1, 1>(V, out);
    case 102: return describe_rt<1, 2>(V, out);
    case 104: return describe_rt<1, 4>(V, out);
    case 201: return describe_rt<2, 1>(V, out);
    case 202: return describe_rt<2, 2>(V, out);
  }
  return int(cudaErrorInvalidValue);
}

// The wrapper's parameter block, int64 each, in this order (see
// `kernels/modmac.py` `_launch`).
enum {
  kDevice, kA, kB0, kB1, kAcc0, kAcc1, kPerm, kOut, kMods,
  kR1, kRA, kRB, kJ, kL, kLogn, kNout,
  kV, kRT, kLogTiles, kRBT, kRbtMul, kRbtShift, kR1Mul, kR1Shift,
  kGridX, kGridY, kGridZ,
  kASj, kAS1, kASa, kASb, kASl,
  kB0Sz, kB0Sj, kB0S1, kB0Sl,
  kB1Sz, kB1Sj, kB1S1, kB1Sl,
  kC0Sz, kC0S1, kC0Sa, kC0Sb, kC0Sl,
  kC1Sz, kC1S1, kC1Sa, kC1Sb, kC1Sl,
  kParams
};

extern "C" int mod_mac_param_count() { return kParams; }

extern "C" int mod_mac_threads() { return kThreads; }

extern "C" int mod_mac(const long long* v, void* stream) {
  MacParams p;
  p.a = reinterpret_cast<const int32_t*>(v[kA]);
  p.b[0] = reinterpret_cast<const int32_t*>(v[kB0]);
  p.b[1] = reinterpret_cast<const int32_t*>(v[kB1]);
  p.acc[0] = reinterpret_cast<const int32_t*>(v[kAcc0]);
  p.acc[1] = reinterpret_cast<const int32_t*>(v[kAcc1]);
  p.perm = reinterpret_cast<const int32_t*>(v[kPerm]);
  p.out = reinterpret_cast<int32_t*>(v[kOut]);
  p.mods = reinterpret_cast<const uint32_t*>(v[kMods]);
  p.R1 = uint32_t(v[kR1]);
  p.RA = uint32_t(v[kRA]);
  p.RB = uint32_t(v[kRB]);
  p.J = uint32_t(v[kJ]);
  p.L = uint32_t(v[kL]);
  p.logn = uint32_t(v[kLogn]);
  const int nout = int(v[kNout]);
  p.log_tiles = uint32_t(v[kLogTiles]);
  p.RBT = uint32_t(v[kRBT]);
  p.by_rbt = FastDiv{uint32_t(v[kRbtMul]), uint32_t(v[kRbtShift])};
  p.by_r1 = FastDiv{uint32_t(v[kR1Mul]), uint32_t(v[kR1Shift])};
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
  const dim3 grid{unsigned(v[kGridX]), unsigned(v[kGridY]), unsigned(v[kGridZ])};
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;

  int current = 0;
  cudaGetDevice(&current);
  const int device = int(v[kDevice]);
  if (current != device) cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int RT = int(v[kRT]), V = int(v[kV]);
  const cudaError_t err = nout == 2 ? launch_c<2>(RT, V, grid, p, s)
                                    : launch_c<1>(RT, V, grid, p, s);
  if (current != device) cudaSetDevice(current);
  return int(err);
}

extern "C" const char* mod_mac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Five ints for the tensor kernel's instance (square or not, V), as
// `mod_mac_kernel_info` gives them.
extern "C" int ct_tensor_kernel_info(int square, int V, int* out) {
  if (square) return V == 4 ? tensor_describe<true, 4>(out) : tensor_describe<true, 1>(out);
  return V == 4 ? tensor_describe<false, 4>(out) : tensor_describe<false, 1>(out);
}

// x, y (0: the square), out, mods, L, logn, V, log_tiles, grid x, grid y
// (= L), device: int64 each (`kernels/modmac.py` `_launch_tensor`)
extern "C" int ct_tensor(const long long* v, void* stream) {
  TensorParams p;
  p.x = reinterpret_cast<const int32_t*>(v[0]);
  p.y = reinterpret_cast<const int32_t*>(v[1]);
  p.out = reinterpret_cast<int32_t*>(v[2]);
  p.mods = reinterpret_cast<const uint32_t*>(v[3]);
  p.L = uint32_t(v[4]);
  p.logn = uint32_t(v[5]);
  const int V = int(v[6]);
  p.log_tiles = uint32_t(v[7]);
  const dim3 grid{unsigned(v[8]), unsigned(v[9]), 1u};
  if (grid.x == 0 || grid.y == 0) return 0;
  int current = 0;
  cudaGetDevice(&current);
  const int device = int(v[10]);
  if (current != device) cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = p.y ? tensor_launch<false>(V, grid, p, s)
                              : tensor_launch<true>(V, grid, p, s);
  if (current != device) cudaSetDevice(current);
  return int(err);
}
