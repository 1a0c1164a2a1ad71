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
// Design: a thread owns a source column, V adjacent coefficients (16-byte
// accesses for V = 4) of one row (ra, rb): it loads its Lf residues once
// into registers (the loop over them unrolled, Lf a template parameter up
// to kMaxLf; a larger Lf reads them per target from L1), then for each of
// its block's targets sums the Lf products in registers and writes the V
// outputs, a warp's stores contiguous.  The table arrives prepared once
// per table (`kernels/bconv.py` `BconvTable`): u32 c[i, l] R mod m_l,
// Montgomery form, so one REDC of the lazy sum (below m_l 2**32, each
// product below 2**31 m_l) gives sum y_i c_i mod m_l, canonical: bit-equal
// to the plain twin's `mod_sum(mul_const_mod(...))`.  A block stages its
// targets' table columns and moduli in shared memory (read as warp-wide
// broadcasts), with shifts for the index split.  The grid is x = (rb <<
// log_tiles) | tile, y = ra, z = the target chunk: no division.  y and the
// table are read through their strides (a group's slice of the source
// limbs, a batch's record axis, a limb shard's slice of the table); the
// moduli are read per target, so one launch may carry targets of two
// chains (Shenoy-Kumaresan's B -> q and B -> m_sk).  The launch plan (V,
// the target chunk) is `kernels/bconv.py` `plan`.
//
// The BEHZ modes (`fast_bconv_kernel_behz<MODE, LF, V>`, `kernels/bconv.py`
// `behz` on a `BehzMode`): the three conversions of the BEHZ ciphertext
// multiply, each with the scalings and corrections around it done in
// registers, so no int64 intermediate of the multiply reaches device
// memory (the modes' plain twin `behz_plain` computes the same from the
// same tables with int64 passes).  A thread loads its Lf source residues
// once and scales each by w_i mod q_i (a Shoup product: the m~ (q/q_i)^-1,
// t (q/q_i)^-1 or (B/b_i)^-1 of the mode); a correction e that one
// coefficient needs for every target is formed in registers from the
// scaled residues (the lift's centred r = -(conv mod m~) q^-1 mod m~,
// m~ = 2**16, from the wrap-around sum of y_i (q/q_i) mod 2**16;
// Shenoy-Kumaresan's centred alpha = (conv_msk - fl_msk) B^-1 mod m_sk,
// one more target reduced first; the floor's t c_bsk is read per target
// instead); each target's lazy sum then starts from e times the target's
// constant for e's sign, so the one REDC gives the corrected residue: the
// table is prepared with the mode's factor folded in (m~^-1, -q^-1),
// canonical, bit-equal to the twin.  Rows are contiguous [R, Lin, N]; the
// lift writes its source limbs [lo, lo + out0) through ahead of the Bsk
// limbs ([R, out0 + |Bsk|, N], the NTT's combined chain: every q limb, or
// a limb-sharded rank's own from the gathered ones), the floor reads c_q
// and c_bsk out of one such row.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "montgomery.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTable = 1024;   // Lf * Lt
constexpr int kMaxLf = 16;        // source residues held in registers
constexpr int kMaxChunk = 256;    // targets a block

struct BconvParams {
  const int32_t* y;
  const int32_t* c;       // u32 c[i, l] R mod m_l, by strides
  int32_t* out;           // contiguous [RA, RB, Lt, N]
  const uint32_t* mods;   // [Lt, 4]: m, -m^-1 mod 2**32, R**2 mod m, 0
  uint32_t RB, Lf, Lt, logn, log_tiles, chunk, log_chunk_p2;
  int64_t y_sa, y_sb, y_sl, c_sf, c_st;
};

template <int V>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const int32_t* p, uint32_t* x) { x[0] = uint32_t(__ldg(p)); }
  __device__ static void store(int32_t* p, const uint32_t* x) { p[0] = int32_t(x[0]); }
};
template <>
struct Vec<2> {
  __device__ static void load(const int32_t* p, uint32_t* x) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    x[0] = uint32_t(v.x), x[1] = uint32_t(v.y);
  }
  __device__ static void store(int32_t* p, const uint32_t* x) {
    *reinterpret_cast<int2*>(p) = make_int2(int32_t(x[0]), int32_t(x[1]));
  }
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

// LF source limbs in registers (0: any Lf, read per target), V
// coefficients a thread
template <int LF, int V>
__global__ void __launch_bounds__(kThreads) fast_bconv_kernel(const BconvParams p) {
  __shared__ uint32_t tab[kMaxTable];   // [Lf, nt] of this block's targets
  __shared__ uint2 mod[kMaxChunk];      // (m, -m^-1) a target
  const uint32_t Lf = LF ? uint32_t(LF) : p.Lf;
  const uint32_t t0 = blockIdx.z * p.chunk;
  const uint32_t nt = min(p.chunk, p.Lt - t0);
  // entry e = (i << log_chunk_p2) | t, t < nt
  const uint32_t tmask = (1u << p.log_chunk_p2) - 1;
  for (uint32_t e = threadIdx.x; e < (Lf << p.log_chunk_p2); e += kThreads) {
    const uint32_t i = e >> p.log_chunk_p2, t = e & tmask;
    if (t < nt) tab[i * nt + t] = uint32_t(__ldg(p.c + i * p.c_sf + (t0 + t) * p.c_st));
  }
  for (uint32_t t = threadIdx.x; t < nt; t += kThreads)
    mod[t] = make_uint2(__ldg(p.mods + 4 * (t0 + t)), __ldg(p.mods + 4 * (t0 + t) + 1));
  __syncthreads();

  const uint32_t tile = blockIdx.x & ((1u << p.log_tiles) - 1);
  const uint32_t rb = blockIdx.x >> p.log_tiles;
  const uint32_t ra = blockIdx.y;
  const uint32_t n = (tile * kThreads + threadIdx.x) * V;
  if (n >= (1u << p.logn)) return;
  const int32_t* y = p.y + ra * p.y_sa + rb * p.y_sb + n;
  int32_t* out = p.out + ((((uint64_t(ra) * p.RB + rb) * p.Lt + t0)) << p.logn) + n;

  uint32_t x[LF ? LF : 1][V];
  if constexpr (LF > 0) {
#pragma unroll
    for (int i = 0; i < LF; ++i) Vec<V>::load(y + i * p.y_sl, x[i]);
  }
  for (uint32_t t = 0; t < nt; ++t) {
    const uint2 mt = mod[t];
    const uint64_t mR = uint64_t(mt.x) << 32;
    uint64_t s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = 0;
    if constexpr (LF > 0) {
#pragma unroll
      for (int i = 0; i < LF; ++i) {
        const uint32_t w = tab[i * nt + t];
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = mont::lazy_add(s[v], uint64_t(x[i][v]) * w, mR);
      }
    } else {
      for (uint32_t i = 0; i < Lf; ++i) {
        uint32_t xi[V];
        Vec<V>::load(y + i * p.y_sl, xi);
        const uint32_t w = tab[i * nt + t];
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = mont::lazy_add(s[v], uint64_t(xi[v]) * w, mR);
      }
    }
    uint32_t o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = mont::redc(s[v], mt.x, mt.y);
    Vec<V>::store(out + (uint64_t(t) << p.logn), o);
  }
}

template <int LF>
cudaError_t launch_v(int V, dim3 grid, const BconvParams& p, cudaStream_t s) {
  if (V == 4)
    fast_bconv_kernel<LF, 4><<<grid, kThreads, 0, s>>>(p);
  else
    fast_bconv_kernel<LF, 1><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <int... LFs>
cudaError_t launch_lf(uint32_t Lf, int V, dim3 grid, const BconvParams& p, cudaStream_t s,
                      std::integer_sequence<int, LFs...>) {
  cudaError_t err = cudaErrorInvalidValue;
  const bool held = ((Lf == uint32_t(LFs + 1) ? (err = launch_v<LFs + 1>(V, grid, p, s), true)
                                               : false) || ...);
  return held ? err : launch_v<0>(V, grid, p, s);
}

template <int LF, int V>
int describe(int* out) {
  const auto kernel = fast_bconv_kernel<LF, V>;
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

template <int... LFs>
int describe_lf(uint32_t Lf, int V, int* out, std::integer_sequence<int, LFs...>) {
  int err = int(cudaErrorInvalidValue);
  const bool held = ((Lf == uint32_t(LFs + 1)
                          ? (err = V == 4 ? describe<LFs + 1, 4>(out) : describe<LFs + 1, 1>(out),
                             true)
                          : false) || ...);
  return held ? err : (V == 4 ? describe<0, 4>(out) : describe<0, 1>(out));
}

// ------------------------------------------------------------ BEHZ modes
enum : int { kLift = 1, kFloor = 2, kSk = 3 };
constexpr int kMaxModeLf = 64;   // source limbs of a mode launch

struct ModeParams {
  const int32_t* x;      // rows [R, Lin, N], contiguous
  int32_t* out;          // rows [R, Lout, N], contiguous
  const uint4* src;      // [Lf]: q_i, w_i, Shoup companion of w_i, aux_i
  const uint32_t* tab;   // [Lf, Lt] contiguous, the mode's factor folded in
  const uint4* tgt;      // [Lt]: m_l, -m_l^-1 mod 2**32, k_pos_l, k_neg_l
  uint32_t Lf, Lt, Lin, Lout, out0, lo, logn, log_tiles, chunk, log_chunk_p2;
  uint32_t c0, c1, c2;   // lift: -q^-1 mod m~; SK: m_sk, -m_sk^-1, B^-1 R mod m_sk
};

// x w mod q for x < 2**32, w < q < 2**31, ws = floor(w 2**32 / q)
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t ws, uint32_t q) {
  const uint32_t r = x * w - __umulhi(x, ws) * q;
  return r >= q ? r - q : r;
}

// MODE kLift, kFloor or kSk; LF source limbs in registers (0: any Lf,
// loaded and scaled again per target); V coefficients a thread
template <int MODE, int LF, int V>
__global__ void __launch_bounds__(kThreads) fast_bconv_kernel_behz(const ModeParams p) {
  __shared__ uint32_t tab[kMaxTable];   // [Lf, nt] of this block's targets
  __shared__ uint4 tgt[kMaxChunk];
  __shared__ uint4 src[kMaxModeLf];
  const uint32_t Lf = LF ? uint32_t(LF) : p.Lf;
  const uint32_t t0 = blockIdx.z * p.chunk;
  const uint32_t nt = min(p.chunk, p.Lt - t0);
  const uint32_t tmask = (1u << p.log_chunk_p2) - 1;
  for (uint32_t e = threadIdx.x; e < (Lf << p.log_chunk_p2); e += kThreads) {
    const uint32_t i = e >> p.log_chunk_p2, t = e & tmask;
    if (t < nt) tab[i * nt + t] = __ldg(p.tab + i * p.Lt + t0 + t);
  }
  for (uint32_t t = threadIdx.x; t < nt; t += kThreads) tgt[t] = __ldg(p.tgt + t0 + t);
  for (uint32_t i = threadIdx.x; i < Lf; i += kThreads) src[i] = __ldg(p.src + i);
  __syncthreads();

  const uint32_t tile = blockIdx.x & ((1u << p.log_tiles) - 1);
  const uint32_t r = blockIdx.x >> p.log_tiles;
  const uint32_t n = (tile * kThreads + threadIdx.x) * V;
  if (n >= (1u << p.logn)) return;
  const int32_t* x = p.x + ((uint64_t(r) * p.Lin) << p.logn) + n;
  int32_t* out = p.out + ((uint64_t(r) * p.Lout) << p.logn) + n;
  // the lift writes its source limbs [lo, lo + out0) through, ahead of the targets
  const bool through = MODE == kLift && blockIdx.z == 0;

  // y_i = x_i w_i mod q_i, held in registers for LF > 0
  uint32_t y[LF ? LF : 1][V];
  auto scale = [&](uint32_t i, uint32_t* v) {
    const uint4 s = src[i];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = shoup(v[j], s.y, s.z, s.x);
  };
  if constexpr (LF > 0) {
#pragma unroll
    for (int i = 0; i < LF; ++i) {
      Vec<V>::load(x + (uint64_t(i) << p.logn), y[i]);
      if (through && uint32_t(i) - p.lo < p.out0)
        Vec<V>::store(out + (uint64_t(i - p.lo) << p.logn), y[i]);
      scale(i, y[i]);
    }
  } else if (through) {
    for (uint32_t i = 0; i < p.out0; ++i) {
      uint32_t v[V];
      Vec<V>::load(x + (uint64_t(p.lo + i) << p.logn), v);
      Vec<V>::store(out + (uint64_t(i) << p.logn), v);
    }
  }
  // f(i, y_i) for every source limb, from registers or loaded again
  auto for_sources = [&](auto&& f) {
    if constexpr (LF > 0) {
#pragma unroll
      for (int i = 0; i < LF; ++i) f(uint32_t(i), y[i]);
    } else {
      for (uint32_t i = 0; i < Lf; ++i) {
        uint32_t v[V];
        Vec<V>::load(x + (uint64_t(i) << p.logn), v);
        scale(i, v);
        f(i, v);
      }
    }
  };

  // the correction e of each coefficient and its sign (the lift's r, SK's alpha)
  uint32_t e[V];
  bool neg[V];
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = 0, neg[j] = false;
  if constexpr (MODE == kLift) {
    uint32_t s[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = 0;
    for_sources([&](uint32_t i, const uint32_t* v) {
      const uint32_t pm = src[i].w;      // q / q_i mod 2**16
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] += v[j] * pm;   // wraps: mod 2**32
    });
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t rr = (s[j] * p.c0) & 0xFFFFu;
      neg[j] = rr >= 0x8000u;
      e[j] = neg[j] ? 0x10000u - rr : rr;
    }
  } else if constexpr (MODE == kSk) {
    const uint64_t mR = uint64_t(p.c0) << 32;
    uint32_t fm[V];
    Vec<V>::load(x + (uint64_t(Lf) << p.logn), fm);   // fl's m_sk residue
    uint64_t s[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = uint64_t(p.c0 - fm[j]) * p.c2;
    for_sources([&](uint32_t i, const uint32_t* v) {
      const uint32_t w = src[i].w;       // (B / b_i) B^-1 R mod m_sk
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = mont::lazy_add(s[j], uint64_t(v[j]) * w, mR);
    });
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t a = mont::redc(s[j], p.c0, p.c1);
      neg[j] = a > (p.c0 >> 1);
      e[j] = neg[j] ? p.c0 - a : a;
    }
  }

  for (uint32_t t = 0; t < nt; ++t) {
    const uint4 m = tgt[t];
    const uint64_t mR = uint64_t(m.x) << 32;
    uint64_t s[V];
    if constexpr (MODE == kFloor) {       // c_bsk t q^-1 R (k_pos)
      uint32_t cb[V];
      Vec<V>::load(x + (uint64_t(Lf + t0 + t) << p.logn), cb);
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = uint64_t(cb[j]) * m.z;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = uint64_t(e[j]) * (neg[j] ? m.w : m.z);
    }
    for_sources([&](uint32_t i, const uint32_t* v) {
      const uint32_t w = tab[i * nt + t];
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = mont::lazy_add(s[j], uint64_t(v[j]) * w, mR);
    });
    uint32_t o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = mont::redc(s[j], m.x, m.y);
    Vec<V>::store(out + (uint64_t(p.out0 + t0 + t) << p.logn), o);
  }
}

// the most coefficients a thread for LF source limbs: 4 up to 8 limbs, 2
// above (and for any Lf), so the held residues stay within the registers
template <int LF>
constexpr int kModeV = LF >= 1 && LF <= 8 ? 4 : 2;

template <int MODE, int LF>
cudaError_t mode_launch_v(int V, dim3 grid, const ModeParams& p, cudaStream_t s) {
  if (V == kModeV<LF>)
    fast_bconv_kernel_behz<MODE, LF, kModeV<LF>><<<grid, kThreads, 0, s>>>(p);
  else if (V == 1)
    fast_bconv_kernel_behz<MODE, LF, 1><<<grid, kThreads, 0, s>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <int MODE, int... LFs>
cudaError_t mode_launch_lf(uint32_t Lf, int V, dim3 grid, const ModeParams& p, cudaStream_t s,
                           std::integer_sequence<int, LFs...>) {
  cudaError_t err = cudaErrorInvalidValue;
  const bool held = ((Lf == uint32_t(LFs + 1)
                          ? (err = mode_launch_v<MODE, LFs + 1>(V, grid, p, s), true)
                          : false) || ...);
  return held ? err : mode_launch_v<MODE, 0>(V, grid, p, s);
}

template <int MODE, int LF, int V>
int mode_describe(int* out) {
  const auto kernel = fast_bconv_kernel_behz<MODE, LF, V>;
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

template <int MODE, int LF>
int mode_describe_v(int V, int* out) {
  if (V == kModeV<LF>) return mode_describe<MODE, LF, kModeV<LF>>(out);
  if (V == 1) return mode_describe<MODE, LF, 1>(out);
  return int(cudaErrorInvalidValue);
}

template <int MODE, int... LFs>
int mode_describe_lf(uint32_t Lf, int V, int* out, std::integer_sequence<int, LFs...>) {
  int err = int(cudaErrorInvalidValue);
  const bool held = ((Lf == uint32_t(LFs + 1)
                          ? (err = mode_describe_v<MODE, LFs + 1>(V, out), true)
                          : false) || ...);
  return held ? err : mode_describe_v<MODE, 0>(V, out);
}

template <int MODE>
cudaError_t mode_launch(uint32_t Lf, int V, dim3 grid, const ModeParams& p, cudaStream_t s) {
  return mode_launch_lf<MODE>(Lf, V, grid, p, s, std::make_integer_sequence<int, kMaxLf>{});
}

template <int MODE>
int mode_info(uint32_t Lf, int V, int* out) {
  return mode_describe_lf<MODE>(Lf, V, out, std::make_integer_sequence<int, kMaxLf>{});
}

}  // namespace

// Five ints into `out` for the instance that serves Lf source limbs with
// V coefficients a thread, on the current device: registers and local
// (spilled) bytes a thread, threads and static shared bytes of a block,
// resident blocks an SM.
extern "C" int fast_bconv_kernel_info(int Lf, int V, int* out) {
  return describe_lf(uint32_t(Lf), V, out, std::make_integer_sequence<int, kMaxLf>{});
}

// The wrapper's parameter block, int64 each, in this order (see
// `kernels/bconv.py` `_launch`).
enum {
  kDevice, kY, kC, kOut, kMods, kRB, kLf, kLt, kLogn,
  kV, kLogTiles, kChunk, kLogChunkP2, kGridX, kGridY, kGridZ,
  kYSa, kYSb, kYSl, kCSf, kCSt,
  kParams
};

extern "C" int fast_bconv_param_count() { return kParams; }

extern "C" int fast_bconv_max_table() { return kMaxTable; }

extern "C" int fast_bconv_threads() { return kThreads; }

extern "C" int fast_bconv_max_chunk() { return kMaxChunk; }

extern "C" int fast_bconv(const long long* v, void* stream) {
  BconvParams p;
  p.y = reinterpret_cast<const int32_t*>(v[kY]);
  p.c = reinterpret_cast<const int32_t*>(v[kC]);
  p.out = reinterpret_cast<int32_t*>(v[kOut]);
  p.mods = reinterpret_cast<const uint32_t*>(v[kMods]);
  p.RB = uint32_t(v[kRB]);
  p.Lf = uint32_t(v[kLf]);
  p.Lt = uint32_t(v[kLt]);
  p.logn = uint32_t(v[kLogn]);
  p.log_tiles = uint32_t(v[kLogTiles]);
  p.chunk = uint32_t(v[kChunk]);
  p.log_chunk_p2 = uint32_t(v[kLogChunkP2]);
  p.y_sa = v[kYSa];
  p.y_sb = v[kYSb];
  p.y_sl = v[kYSl];
  p.c_sf = v[kCSf];
  p.c_st = v[kCSt];
  if (uint64_t(p.Lf) << p.log_chunk_p2 > uint64_t(2 * kMaxTable) ||
      uint64_t(p.Lf) * p.chunk > uint64_t(kMaxTable) || p.chunk > uint32_t(kMaxChunk))
    return int(cudaErrorInvalidValue);
  const dim3 grid{unsigned(v[kGridX]), unsigned(v[kGridY]), unsigned(v[kGridZ])};
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;

  int current = 0;
  cudaGetDevice(&current);
  const int device = int(v[kDevice]);
  if (current != device) cudaSetDevice(device);
  const cudaError_t err = launch_lf(p.Lf, int(v[kV]), grid, p,
                                    static_cast<cudaStream_t>(stream),
                                    std::make_integer_sequence<int, kMaxLf>{});
  if (current != device) cudaSetDevice(current);
  return int(err);
}

extern "C" const char* fast_bconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The BEHZ modes' parameter block, int64 each, in this order (see
// `kernels/bconv.py` `_launch_behz`).
enum {
  kMDevice, kMX, kMOut, kMSrc, kMTab, kMTgt, kMMode, kMLf, kMLt, kMLin, kMLout,
  kMOut0, kMLo, kMLogn, kMV, kMLogTiles, kMChunk, kMLogChunkP2, kMGridX, kMGridZ,
  kMC0, kMC1, kMC2,
  kModeParams
};

extern "C" int fast_bconv_behz_param_count() { return kModeParams; }

extern "C" int fast_bconv_behz_max_lf() { return kMaxModeLf; }

// mode 1 (lift), 2 (floor) or 3 (Shenoy-Kumaresan): the instance's five
// ints as `fast_bconv_kernel_info` gives them
extern "C" int fast_bconv_behz_kernel_info(int mode, int Lf, int V, int* out) {
  switch (mode) {
    case kLift: return mode_info<kLift>(uint32_t(Lf), V, out);
    case kFloor: return mode_info<kFloor>(uint32_t(Lf), V, out);
    case kSk: return mode_info<kSk>(uint32_t(Lf), V, out);
  }
  return int(cudaErrorInvalidValue);
}

extern "C" int fast_bconv_behz(const long long* v, void* stream) {
  ModeParams p;
  p.x = reinterpret_cast<const int32_t*>(v[kMX]);
  p.out = reinterpret_cast<int32_t*>(v[kMOut]);
  p.src = reinterpret_cast<const uint4*>(v[kMSrc]);
  p.tab = reinterpret_cast<const uint32_t*>(v[kMTab]);
  p.tgt = reinterpret_cast<const uint4*>(v[kMTgt]);
  p.Lf = uint32_t(v[kMLf]);
  p.Lt = uint32_t(v[kMLt]);
  p.Lin = uint32_t(v[kMLin]);
  p.Lout = uint32_t(v[kMLout]);
  p.out0 = uint32_t(v[kMOut0]);
  p.lo = uint32_t(v[kMLo]);
  p.logn = uint32_t(v[kMLogn]);
  p.log_tiles = uint32_t(v[kMLogTiles]);
  p.chunk = uint32_t(v[kMChunk]);
  p.log_chunk_p2 = uint32_t(v[kMLogChunkP2]);
  p.c0 = uint32_t(v[kMC0]);
  p.c1 = uint32_t(v[kMC1]);
  p.c2 = uint32_t(v[kMC2]);
  if (p.Lf == 0 || p.Lf > uint32_t(kMaxModeLf) || p.chunk == 0 ||
      uint64_t(p.Lf) << p.log_chunk_p2 > uint64_t(2 * kMaxTable) ||
      uint64_t(p.Lf) * p.chunk > uint64_t(kMaxTable) || p.chunk > uint32_t(kMaxChunk) ||
      uint64_t(p.lo) + p.out0 > p.Lin)
    return int(cudaErrorInvalidValue);
  const dim3 grid{unsigned(v[kMGridX]), 1u, unsigned(v[kMGridZ])};
  if (grid.x == 0 || grid.z == 0) return 0;

  int current = 0;
  cudaGetDevice(&current);
  const int device = int(v[kMDevice]);
  if (current != device) cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int V = int(v[kMV]);
  cudaError_t err = cudaErrorInvalidValue;
  switch (int(v[kMMode])) {
    case kLift: err = mode_launch<kLift>(p.Lf, V, grid, p, s); break;
    case kFloor: err = mode_launch<kFloor>(p.Lf, V, grid, p, s); break;
    case kSk: err = mode_launch<kSk>(p.Lf, V, grid, p, s); break;
  }
  if (current != device) cudaSetDevice(current);
  return int(err);
}
