// `slot_map`: the slot buffers of the device encode, built on the card
//
//   out[p, (r V + v) C + c, j] = floor_mod(rint(x[r, c n + s_j, v]), t_p),
//   s_j = pos[j], and 0 where c n + s_j >= dim
//
// for the reader's scaled values x [R, dim, V] (float64, R records), the
// inverse index map pos [n] (the slot each buffer position holds) and the
// plain primes t_p: exactly `encode_bufs` of `slot_ints` of each record
// (`api/factory.py`, `nn/forward.py`), the records in turn.  Replaces no
// TPU kernel: the JAX package builds these buffers on the host too, in
// numpy (`cryptonets_tpu/nn/jit.py:115` `slot_bufs`,
// `cryptonets_tpu/api/factory.py:677` `encode_bufs`); here they are built
// inside the record's CUDA graph, so the host hands over the values and
// no longer transposes, rounds, reduces and gathers them between replays.
//
// Bound by bytes: 8 bytes read an input value, 4 P bytes written a
// buffer position (CryptoNets: 51 MB in, 77 MB out, 38 us at 3.35 TB/s).
// Design: each value is read once and each output written once.  A block
// owns kTileJ buffer positions and kTileV columns of one block c of one
// record.  Phase 1: a warp reads row s_j of x across 64 columns (two
// 256-byte runs), rounds to nearest even (`__double2ll_rn`, as `np.round`)
// and stores the int64 into shared memory, transposed.  Phase 2: a thread
// takes 4 adjacent positions of one column and writes them as one 16-byte
// store into each of the P planes, all from one shared read.  At least
// three blocks an SM (`__launch_bounds__`).  The floor modulus of an
// int64 by t_p is a Barrett reduction of |a| with m = floor(2**64 / t_p),
// passed in the launch's parameters (one 64 x 64 high product, one
// correction, the sign fixed after), in place of a 64-bit `%` by a
// runtime divisor, which is a long subroutine.  The modulus is not the
// bound: on an H100 a floor modulus in double precision timed within 4 %
// of this one, and no tile of 32 to 128 positions by 32 to 128 columns
// was faster than 64 by 64: about 1.5 times a plain copy of the bytes.  The
// launch plan (the grid) is `kernels/slotmap.py` `plan`.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileJ = 64;   // buffer positions a block
constexpr int kTileV = 64;   // columns a block: twice a warp's lanes in phase 1
constexpr int kMaxP = 8;     // plain primes
constexpr int kQuads = kTileJ / 4;   // threads a column in phase 2

struct SlotMapParams {
  const double* x;
  const int32_t* pos;   // [n]: the slot of each buffer position
  int32_t* out;         // contiguous [P, R V C, n]
  int64_t x_sr, x_sd, x_sv;
  uint32_t dim, V, C, n, P, v_tiles;
  uint32_t t[kMaxP];
  uint64_t m[kMaxP];    // floor(2**64 / t)
};

// a mod t, in [0, t), for any int64 a and odd t < 2**31: u = |a| < 2**64,
// q = hi(u m) is floor(u / t) or one less, so u - q t < 2 t
__device__ __forceinline__ int32_t floor_mod(int64_t a, uint32_t t, uint64_t m) {
  const uint64_t u = a < 0 ? 0ull - uint64_t(a) : uint64_t(a);
  uint64_t r = u - __umul64hi(u, m) * t;
  if (r >= t) r -= t;
  return int32_t(a < 0 && r != 0 ? t - r : r);
}

__global__ void __launch_bounds__(kThreads, 3) slot_map_kernel(const SlotMapParams p) {
  __shared__ int64_t vals[kTileV][kTileJ + 1];   // [column, position], padded
  const uint32_t j0 = blockIdx.x * kTileJ;
  const uint32_t c = blockIdx.y / p.v_tiles;
  const uint32_t v0 = (blockIdx.y - c * p.v_tiles) * kTileV;
  const uint32_t r = blockIdx.z;
  const uint32_t lane = threadIdx.x & 31;

#pragma unroll
  for (int h = 0; h < kTileV / 32; ++h) {
    const uint32_t v = v0 + 32 * h + lane;
    const double* xr = p.x + int64_t(r) * p.x_sr + int64_t(v) * p.x_sv;
#pragma unroll
    for (int i = 0; i < kTileJ / (kThreads / 32); ++i) {   // loads in flight
      const uint32_t jj = (threadIdx.x >> 5) + i * (kThreads / 32);
      const uint32_t j = j0 + jj;
      int64_t a = 0;
      if (j < p.n && v < p.V) {
        const uint64_t d = uint64_t(c) * p.n + uint32_t(__ldg(p.pos + j));
        if (d < p.dim) a = __double2ll_rn(__ldg(xr + int64_t(d) * p.x_sd));
      }
      vals[32 * h + lane][jj] = a;
    }
  }
  __syncthreads();

  const uint32_t q = threadIdx.x % kQuads;
  const uint32_t j = j0 + 4 * q;
  if (j >= p.n) return;   // n is a multiple of 4: the quad lies inside
  const uint64_t plane = uint64_t(gridDim.z) * p.V * p.C * p.n;
  for (uint32_t vv = threadIdx.x / kQuads; vv < kTileV && v0 + vv < p.V;
       vv += kThreads / kQuads) {
    const int64_t* s = &vals[vv][4 * q];
    const int64_t a0 = s[0], a1 = s[1], a2 = s[2], a3 = s[3];
    int32_t* o = p.out + ((uint64_t(r) * p.V + v0 + vv) * p.C + c) * p.n + j;
    for (uint32_t k = 0; k < p.P; ++k) {
      const uint32_t t = p.t[k];
      const uint64_t m = p.m[k];
      *reinterpret_cast<int4*>(o + k * plane) =
          make_int4(floor_mod(a0, t, m), floor_mod(a1, t, m), floor_mod(a2, t, m),
                    floor_mod(a3, t, m));
    }
  }
}

}  // namespace

// The wrapper's parameter block, int64 each, in this order (see
// `kernels/slotmap.py` `_launch`); then kMaxP primes and kMaxP Barrett
// constants (unused ones 0).
enum {
  kDevice, kX, kPos, kOut, kXSr, kXSd, kXSv,
  kDim, kV, kC, kN, kP, kVTiles, kGridX, kGridY, kGridZ,
  kPrimes,
  kParams = kPrimes + 2 * kMaxP
};

extern "C" int slot_map_param_count() { return kParams; }

extern "C" int slot_map_tile(int which) {
  return which == 0 ? kTileJ : which == 1 ? kTileV : which == 2 ? kThreads : kMaxP;
}

// Five ints into `out`: registers and local (spilled) bytes a thread,
// threads and static shared bytes of a block, resident blocks an SM, on
// the current device.
extern "C" int slot_map_kernel_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, slot_map_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, slot_map_kernel, kThreads, 0);
  if (err != cudaSuccess) return int(err);
  out[0] = attr.numRegs;
  out[1] = int(attr.localSizeBytes);
  out[2] = kThreads;
  out[3] = int(attr.sharedSizeBytes);
  out[4] = blocks;
  return 0;
}

extern "C" int slot_map(const long long* v, void* stream) {
  SlotMapParams p;
  p.x = reinterpret_cast<const double*>(v[kX]);
  p.pos = reinterpret_cast<const int32_t*>(v[kPos]);
  p.out = reinterpret_cast<int32_t*>(v[kOut]);
  p.x_sr = v[kXSr];
  p.x_sd = v[kXSd];
  p.x_sv = v[kXSv];
  p.dim = uint32_t(v[kDim]);
  p.V = uint32_t(v[kV]);
  p.C = uint32_t(v[kC]);
  p.n = uint32_t(v[kN]);
  p.P = uint32_t(v[kP]);
  p.v_tiles = uint32_t(v[kVTiles]);
  if (p.P == 0 || p.P > uint32_t(kMaxP) || p.n % 4 != 0) return int(cudaErrorInvalidValue);
  for (int k = 0; k < kMaxP; ++k) {
    p.t[k] = uint32_t(v[kPrimes + k]);
    p.m[k] = uint64_t(v[kPrimes + kMaxP + k]);
  }
  const dim3 grid{unsigned(v[kGridX]), unsigned(v[kGridY]), unsigned(v[kGridZ])};
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;

  int current = 0;
  cudaGetDevice(&current);
  const int device = int(v[kDevice]);
  if (current != device) cudaSetDevice(device);
  slot_map_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return int(err);
}

extern "C" const char* slot_map_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
