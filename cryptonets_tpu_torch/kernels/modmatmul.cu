// Exact modular contraction for Hopper (sm_90a), hand-written CUDA C++.
//
//   out[p, m, j] = sum_o W[m, o] * x[p, o, j]  mod q_limb(j)
//
// Replaces exact_mod_contract (cryptonets_tpu/kernels/modmatmul.py), which
// splits both operands into 7-bit int8 digit planes and runs 25 einsums
// because the TPU's matrix unit has no integers.  This card has a 32-bit
// multiply-high and 64-bit adds, so the planes are gone: the host reduces
// W per limb to w[k, M, O] in [0, q) with Shoup companions
// w' = floor(w * 2^32 / q), and each product is reduced on the spot.
//
// Layout: x is [P, O, inner] uint32 (the port stores residues as int32
// with the same bits), inner = C * s * k * N positions with the ring index
// fastest and the limb next, so position j belongs to limb (j / N) % k.
// out is [P, M, inner].
//
// Design: one thread per position j and a tile of TM outputs m held in
// registers as 64-bit sums.  For each o the thread loads x once (adjacent
// threads read adjacent j: coalesced) and for each m of the tile takes
//   r = x*w - umulhi(x, w')*q        (mod 2^32; r in [0, 2q), q < 2^31)
// and adds r to the 64-bit sum of m: exact for any O < 2^31.  One 64-bit
// remainder at the end gives the canonical residue, so the result is
// bit-equal to the plain version and to the reference.  The (w, w') pairs
// of one limb, one tile of m and a chunk of OC values of o lie in shared
// memory and are read as broadcasts.  A block covers positions of one
// limb only (the block size divides N).  Blocks that share their
// positions and differ in the tile of m are neighbours in the grid, so
// the M / TM passes over x mostly hit the L2 cache.
//
// Bound: 3 32-bit multiplies per term (umulhi and two mullo) against one
// read of x and one write of out; from M of about 8 upwards the integer
// pipe, not the memory, bounds it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OC = 64;  // values of o per shared-memory chunk

template <int TM>
__global__ void mod_contract_kernel(const uint32_t* __restrict__ x,
                                    uint32_t* __restrict__ out,
                                    const uint32_t* __restrict__ w,
                                    const uint32_t* __restrict__ w_sh,
                                    const uint32_t* __restrict__ mods,
                                    int M, int O, long long inner, int k,
                                    int N, int m_tiles) {
  __shared__ uint2 sw[OC][TM];
  const int mt = static_cast<int>(blockIdx.x % m_tiles);
  const long long j0 =
      static_cast<long long>(blockIdx.x / m_tiles) * blockDim.x;
  const int p = blockIdx.y;
  const int limb = static_cast<int>((j0 / N) % k);
  const uint32_t q = mods[limb];
  const int m0 = mt * TM;
  const size_t j = static_cast<size_t>(j0) + threadIdx.x;
  const uint32_t* xp = x + static_cast<size_t>(p) * O * inner + j;
  const size_t wrow = static_cast<size_t>(limb) * M;

  unsigned long long acc[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t) acc[t] = 0;

  for (int o0 = 0; o0 < O; o0 += OC) {
    const int oc = O - o0 < OC ? O - o0 : OC;
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < oc * TM; i += blockDim.x) {
      const int t = i / oc, o = i % oc;
      uint2 c = make_uint2(0u, 0u);  // a tile past M multiplies by zero
      if (m0 + t < M) {
        const size_t at = (wrow + m0 + t) * O + o0 + o;
        c = make_uint2(w[at], w_sh[at]);
      }
      sw[o][t] = c;
    }
    __syncthreads();
    const uint32_t* xo = xp + static_cast<size_t>(o0) * inner;
#pragma unroll 4
    for (int o = 0; o < oc; ++o) {
      const uint32_t xv = xo[static_cast<size_t>(o) * inner];
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        const uint2 c = sw[o][t];
        const uint32_t hi = __umulhi(xv, c.y);
        acc[t] += static_cast<uint32_t>(xv * c.x - hi * q);
      }
    }
  }

  uint32_t* op = out + (static_cast<size_t>(p) * M + m0) * inner + j;
#pragma unroll
  for (int t = 0; t < TM; ++t)
    if (m0 + t < M)
      op[static_cast<size_t>(t) * inner] = static_cast<uint32_t>(acc[t] % q);
}

template <int TM>
cudaError_t launch(const uint32_t* x, uint32_t* out, const uint32_t* w,
                   const uint32_t* w_sh, const uint32_t* mods, int P, int M,
                   int O, long long inner, int k, int N, cudaStream_t stream) {
  const int threads = N < 256 ? N : 256;
  const int m_tiles = (M + TM - 1) / TM;
  const long long blocks = inner / threads * m_tiles;
  if (blocks > 0x7fffffffLL || P > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(P));
  mod_contract_kernel<TM><<<grid, threads, 0, stream>>>(
      x, out, w, w_sh, mods, M, O, inner, k, N, m_tiles);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch.  `tile` is the
// count of outputs m a thread holds: 5, 8 or 10.  N is a power of two and
// inner a multiple of k * N (the wrapper checks both).
extern "C" int mod_contract(const void* x, void* out, const void* w,
                            const void* w_sh, const void* mods, int P, int M,
                            int O, long long inner, int k, int N, int tile,
                            void* stream) {
  const auto* xs = static_cast<const uint32_t*>(x);
  auto* os = static_cast<uint32_t*>(out);
  const auto* ws = static_cast<const uint32_t*>(w);
  const auto* wsh = static_cast<const uint32_t*>(w_sh);
  const auto* ms = static_cast<const uint32_t*>(mods);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tile == 5)
    err = launch<5>(xs, os, ws, wsh, ms, P, M, O, inner, k, N, st);
  else if (tile == 8)
    err = launch<8>(xs, os, ws, wsh, ms, P, M, O, inner, k, N, st);
  else if (tile == 10)
    err = launch<10>(xs, os, ws, wsh, ms, P, M, O, inner, k, N, st);
  return static_cast<int>(err);
}

extern "C" const char* mod_contract_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
