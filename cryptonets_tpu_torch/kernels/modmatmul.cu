// Exact modular contraction for Hopper (sm_90a) on the int8 tensor cores,
// hand-written CUDA C++.
//
//   out[p, m, j] = sum_o W[m, o] * x[p, o, j]  mod q_limb(j)
//
// Replaces exact_mod_contract (cryptonets_tpu/kernels/modmatmul.py), which
// splits both operands into 7-bit int8 digit planes for the TPU's matrix
// unit.  Here u8 x u8 -> s32 is native: each residue (< 2^31) splits into
// four unsigned bytes, W = sum_i 2^(8i) W_i and x = sum_j 2^(8j) X_j, and
// the 16 plane-pair products fall into 7 shift groups s = i + j (1, 2, 3,
// 4, 3, 2, 1 pairs).  A group's sum over KC values of o is at most
// 4 * 255^2 * KC, exact in the s32 accumulator for KC <= KF_MAX = 8256
// (4 * 255^2 * 8256 = 2147385600 < 2^31 <= 4 * 255^2 * 8257).  Each group
// sum is folded into a canonical per-output accumulator by one Shoup
// product with 2^(8s) mod q (and its companion) and an add mod q, so the
// result is canonical: bit-equal to the plain version and the reference.
//
// Layout: x is [P, O, inner] uint32 (int32 storage of the same bits),
// inner = C * s * k * N positions with the ring index fastest and the limb
// next, so position j belongs to limb (j / N) % k.  out is [P, M, inner].
// The weights come prepared once per layer (modmatmul.py
// `prepare_contract`): per limb, per tile of NW outputs and per chunk of
// KC values of o, the four planes [4][NW][ROW bytes] (ROW = 32 for chunks
// of 32, else 128), o contiguous (K-major) and swizzled as this kernel
// keeps them in shared memory, plus the fold constants (2^(8s) mod q,
// companion) [k][7][2].
//
// Design.  The product is wgmma.mma_async.m64nNWk32.s32.u8.u8 with both
// operands in shared memory, positions as its M dimension (one warpgroup,
// 64 positions of one limb a block: the tile divides N) and outputs m as
// its N dimension: D[pos, m] = sum_o X[pos, o] * W[o, m].  NW pads M to
// 8, 16, 32, 64 or 112 (5 -> 8, 10 -> 16, 100 -> 112), not to 64 or 128.
// Blocks that share positions and differ in the tile of m (M > 112) are
// neighbours, so the second pass over x hits the L2 cache.  For each
// chunk of KC values of o:
//   1. the block copies the chunk's prepared weight planes into shared
//      memory (cp.async, 16 bytes a copy) and reads x [KC o x 64
//      positions] once (a
//      warp item is 8 positions x 16 values of o: full 32-byte sectors),
//      splits each group of four u32 into four u8 words by __byte_perm (a
//      4 x 4 byte transpose) and stores the four plane tiles [pos][o];
//      every plane tile is [rows][128 bytes], 1024-byte aligned, 16-byte
//      chunk c of row r at c ^ (r & 7): the K-major 128-byte swizzle the
//      wgmma descriptors name (no bank conflict on the stores either);
//      chunks of 32 (O <= 32) use rows of 32 bytes and the 32-byte
//      swizzle (chunk c ^ (r / 4) % 2): 10 KB of shared memory a block at
//      the small widths, so 8 blocks share an SM;
//   2. for each shift group s: one s32 accumulator set (NW / 2 registers
//      a thread) runs over the group's plane pairs and the chunk's k32
//      steps as back-to-back wgmma (the first one overwrites), then one
//      fold into the canonical u32 accumulators (NW / 2 registers).
// Seven accumulator sets would not fit the registers: the groups go
// through a pipeline of depth<NW>() sets (two below width 112, one at
// 112), so one group's fold runs while the next group's products are on
// the tensor cores.  The weight planes arrive while the block splits x.
// Each x value is read from device memory once for the whole tile of
// outputs.
//
// Bound (modmat_bound in chip_smoke.py): at Dense(100) the function's
// 16 plane pairs a term on the int8 tensor cores (0.47 ms) against moving
// x and out once (0.39 ms).  The fold costs about 7 integer instructions
// an output a group and a chunk (KC = 128: 0.05 multiplies a term).

#include <cstdint>
#include <cuda_runtime.h>

#include "u8mma.cuh"

namespace {

constexpr int PLANES = 4;
constexpr int GROUPS = 7;
constexpr int TILE = 64;     // positions of a block: one wgmma M
constexpr int THREADS = 128; // one warpgroup

// Accumulator sets in flight: two below width 112, so that one group's
// fold overlaps the next group's products on the tensor cores; one at
// width 112, where a second set of 56 registers would spill.
template <int NW>
__host__ __device__ constexpr int depth() {
  return NW < 112 ? 2 : 1;
}

// The products of shift group S over a chunk (ksteps k32 steps) into acc:
// the group's plane pairs (i, S - i), the first product overwriting.
template <int NW, int ROW, int S>
__device__ __forceinline__ void issue_group(int (&acc)[NW / 2], uint32_t xs,
                                            uint32_t ws, int ksteps) {
  constexpr int I_LO = S > 3 ? S - 3 : 0, I_HI = S < 3 ? S : 3;
  wgmma_fence();
#pragma unroll
  for (int i = I_LO; i <= I_HI; ++i) {
    const uint64_t da = desc<ROW>(xs + (S - i) * TILE * ROW);
    const uint64_t db = desc<ROW>(ws + i * NW * ROW);
    for (int ks = 0; ks < ksteps; ++ks)  // k advances 32 bytes a step
      wgmma<NW>(acc, da + 2 * ks, db + 2 * ks, i > I_LO || ks > 0);
  }
  wgmma_commit();
}

// Group S done (at most `depth - 1` later groups still in flight), then
// canon += acc * 2^(8S) mod q, one Shoup product an output; and the next
// group that fits the pipeline issued into the set just freed.
template <int NW, int ROW, int S>
__device__ __forceinline__ void fold_group(
    int (&acc)[depth<NW>()][NW / 2], uint32_t (&canon)[NW / 2], uint32_t xs,
    uint32_t ws, int ksteps, uint32_t q, const uint32_t* sfold) {
  constexpr int D = depth<NW>();
  constexpr int R = NW / 2;
  constexpr int LAST = S + D - 1 < GROUPS - 1 ? S + D - 1 : GROUPS - 1;
  wgmma_wait<LAST - S>();
#pragma unroll
  for (int e = 0; e < R; ++e) fence_operand(acc[S % D][e]);
  const uint32_t cs = sfold[2 * S], csh = sfold[2 * S + 1];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const uint32_t av = static_cast<uint32_t>(acc[S % D][e]);
    uint32_t t = av * cs - __umulhi(av, csh) * q;  // [0, 2q)
    t = min(t, t - q);
    const uint32_t u = canon[e] + t;
    canon[e] = min(u, u - q);
  }
  if constexpr (S + D < GROUPS)
    issue_group<NW, ROW, S + D>(acc[S % D], xs, ws, ksteps);
}

// The launch bound asks for 8 blocks an SM for the small instances (32-byte
// rows, widths up to 16: 10 KB of shared memory, 64 registers), else 2.
template <int NW, int ROW>
__global__ void __launch_bounds__(THREADS, (ROW == 32 && NW <= 16) ? 8 : 2)
    mod_contract_kernel(const uint32_t* __restrict__ x,
                        uint32_t* __restrict__ out,
                        const uint4* __restrict__ planes,
                        const uint32_t* __restrict__ fold,
                        const uint32_t* __restrict__ mods, int M, int O,
                        long long inner, int k, int N, int mt, int kc,
                        int chunks) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint32_t sfold[2 * GROUPS];
  constexpr int R = NW / 2;                        // accumulators a thread
  constexpr int WVEC = PLANES * NW * ROW / 16;     // uint4 a chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the plane tiles start on a 1024-byte boundary (a swizzle atom is
  // 8 rows: 1024 or 256 bytes)
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t xs = (raw + 1023u) & ~1023u;
  const uint32_t ws = xs + PLANES * TILE * ROW;
  uint8_t* smem = smem_raw + (xs - raw);

  const int mti = static_cast<int>(blockIdx.x % mt);
  const long long j0 = static_cast<long long>(blockIdx.x / mt) * TILE;
  const int p = blockIdx.y;
  const int limb = static_cast<int>((j0 / N) % k);
  const uint32_t q = mods[limb];
  if (threadIdx.x < 2 * GROUPS)
    sfold[threadIdx.x] = fold[limb * GROUPS * 2 + threadIdx.x];
  const uint32_t* xp = x + static_cast<size_t>(p) * O * inner + j0;
  const uint4* wblob =
      planes + (static_cast<size_t>(limb) * mt + mti) * chunks * WVEC;

  constexpr int D = depth<NW>();
  uint32_t canon[R];
  int acc[D][R];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    canon[e] = 0u;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d][e] = 0;
  }

  for (int c = 0; c < chunks; ++c) {
    const int o0 = c * kc;
    __syncthreads();  // the previous chunk is no longer read
    {
      const uint4* src = wblob + static_cast<size_t>(c) * WVEC;
      for (int i = threadIdx.x; i < WVEC; i += THREADS)
        copy16(ws + 16 * i, src + i);
    }
    // x -> four u8 plane tiles; kc / 8 items a warp, U at a time
    constexpr int PGROUPS = TILE / 8;
    constexpr int U = ROW == 32 ? 4 : 8;
    const int items = PGROUPS * (kc >> 4);
    for (int it0 = warp; it0 < items; it0 += U * (THREADS / 32)) {
      uint32_t v[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int it = it0 + u * (THREADS / 32);
        const int pos = (it % PGROUPS) * 8 + (lane & 7);
        const int o = o0 + ((it / PGROUPS) * 4 + (lane >> 3)) * 4;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[u][t] = (it < items && o + t < O)
                        ? __ldg(xp + static_cast<size_t>(o + t) * inner + pos)
                        : 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int it = it0 + u * (THREADS / 32);
        if (it >= items) break;
        const int pos = (it % PGROUPS) * 8 + (lane & 7);
        const int kb = ((it / PGROUPS) * 4 + (lane >> 3)) * 4;
        // 4 x 4 byte transpose: plane j gets byte j of the four values
        const uint32_t ab_lo = __byte_perm(v[u][0], v[u][1], 0x5140);
        const uint32_t ab_hi = __byte_perm(v[u][0], v[u][1], 0x7362);
        const uint32_t cd_lo = __byte_perm(v[u][2], v[u][3], 0x5140);
        const uint32_t cd_hi = __byte_perm(v[u][2], v[u][3], 0x7362);
        const uint32_t pl[4] = {__byte_perm(ab_lo, cd_lo, 0x5410),
                                __byte_perm(ab_lo, cd_lo, 0x7632),
                                __byte_perm(ab_hi, cd_hi, 0x5410),
                                __byte_perm(ab_hi, cd_hi, 0x7632)};
        const uint32_t at = swz<ROW>(pos, kb);
#pragma unroll
        for (int j = 0; j < PLANES; ++j)
          *reinterpret_cast<uint32_t*>(smem + j * TILE * ROW + at) = pl[j];
      }
    }
    copy_wait();
    fence_async_shared();
    __syncthreads();

    // the shift groups through a pipeline of depth<NW>() accumulator sets
    const int ksteps = kc >> 5;
#define MM_ISSUE(S) \
    if constexpr (S < D) issue_group<NW, ROW, S>(acc[S], xs, ws, ksteps);
    MM_ISSUE(0) MM_ISSUE(1) MM_ISSUE(2) MM_ISSUE(3) MM_ISSUE(4) MM_ISSUE(5)
    MM_ISSUE(6)
#undef MM_ISSUE
#define MM_FOLD(S) \
    fold_group<NW, ROW, S>(acc, canon, xs, ws, ksteps, q, sfold);
    MM_FOLD(0) MM_FOLD(1) MM_FOLD(2) MM_FOLD(3) MM_FOLD(4) MM_FOLD(5)
    MM_FOLD(6)
#undef MM_FOLD
  }

  // accumulator fragment: register 4n + r of a thread holds row
  // 16 * warp + lane / 4 + 8 * (r / 2), column 8n + 2 * (lane % 4) + r % 2
  uint32_t* op = out + static_cast<size_t>(p) * M * inner + j0;
  const int m_base = mti * NW + (lane & 3) * 2;
  const int pos_base = warp * 16 + (lane >> 2);
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int m = m_base + (e >> 2) * 8 + (e & 1);
    const int pos = pos_base + ((e >> 1) & 1) * 8;
    if (m < M) op[static_cast<size_t>(m) * inner + pos] = canon[e];
  }
}

template <int NW, int ROW>
constexpr size_t smem_bytes() {
  // plane tiles of x and of W, and room to align them to 1024 bytes
  return static_cast<size_t>(PLANES) * ROW * (TILE + NW) + 1024;
}

// The dynamic shared-memory allowance above 48 KB, once per instance and
// device.
template <int NW, int ROW>
cudaError_t ready() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(mod_contract_kernel<NW, ROW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<NW, ROW>()));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int NW, int ROW>
cudaError_t launch(const uint32_t* x, uint32_t* out, const uint4* planes,
                   const uint32_t* fold, const uint32_t* mods, int P, int M,
                   int O, long long inner, int k, int N, int mt, int kc,
                   int chunks, cudaStream_t stream) {
  const long long blocks = inner / TILE * mt;
  if (N < TILE || blocks > 0x7fffffffLL || P > 65535 || kc % 32 ||
      kc > ROW || kc <= 0)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = ready<NW, ROW>();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(P));
  mod_contract_kernel<NW, ROW>
      <<<grid, THREADS, smem_bytes<NW, ROW>(), stream>>>(
      x, out, planes, fold, mods, M, O, inner, k, N, mt, kc, chunks);
  return cudaGetLastError();
}

template <int NW, int ROW>
int describe(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mod_contract_kernel<NW, ROW>);
  if (err == cudaSuccess) err = ready<NW, ROW>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, mod_contract_kernel<NW, ROW>, THREADS,
        smem_bytes<NW, ROW>());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = THREADS;
  out[3] = static_cast<int>(smem_bytes<NW, ROW>());
  out[4] = blocks;
  return 0;
}

}  // namespace

#define MM_EACH_NW(F, ROW) \
  F(8, ROW) F(16, ROW) F(32, ROW) F(64, ROW) F(112, ROW)

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch.  `nw` is the
// width of a block's tile of outputs (8, 16, 32, 64 or 112), `mt` the
// count of such tiles over M, `kc` the values of o a chunk (32, whose
// plane rows are 32 bytes, or a multiple of 32 up to 128, in rows of 128
// bytes) and `chunks` = ceil(O / kc); `planes` and `fold` are laid out by
// `prepare_contract`.  N is a power of two >= 64 and inner a
// multiple of k * N (the wrapper checks both).
extern "C" int mod_contract(const void* x, void* out, const void* planes,
                            const void* fold, const void* mods, int P, int M,
                            int O, long long inner, int k, int N, int nw,
                            int mt, int kc, int chunks, void* stream) {
  const auto* xs = static_cast<const uint32_t*>(x);
  auto* os = static_cast<uint32_t*>(out);
  const auto* pl = static_cast<const uint4*>(planes);
  const auto* fl = static_cast<const uint32_t*>(fold);
  const auto* ms = static_cast<const uint32_t*>(mods);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (nw * 1000 + (kc == 32 ? 32 : 128)) {
#define MM_CASE(w, row)                                                   \
  case w * 1000 + row:                                                    \
    return static_cast<int>(launch<w, row>(xs, os, pl, fl, ms, P, M, O,   \
                                           inner, k, N, mt, kc, chunks, st));
    MM_EACH_NW(MM_CASE, 32)
    MM_EACH_NW(MM_CASE, 128)
#undef MM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Five ints into `out` for the instance of (`nw`, rows of `row` bytes) on
// the current device: registers and local (spilled) bytes a thread,
// threads and dynamic shared bytes of a block, resident blocks an SM.
extern "C" int mod_contract_kernel_info(int nw, int row, int* out) {
  switch (nw * 1000 + row) {
#define MM_CASE(w, r) \
  case w * 1000 + r: return describe<w, r>(out);
    MM_EACH_NW(MM_CASE, 32)
    MM_EACH_NW(MM_CASE, 128)
#undef MM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* mod_contract_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
