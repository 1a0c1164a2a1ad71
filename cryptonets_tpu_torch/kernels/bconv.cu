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
