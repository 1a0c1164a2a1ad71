// Negacyclic NTT kernels for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas kernels PallasNTTContext._fwd_kernel and
// PallasNTTContext._inv_kernel (cryptonets_tpu/kernels/pallas_ntt.py),
// launched there by PallasNTTContext._transform.  Same Longa-Naehrig
// factorisation as cryptonets_tpu/crypto/ntt.py: the forward transform is
// Cooley-Tukey from standard order to bit-reversed order, the inverse is
// Gentleman-Sande from bit-reversed back to standard order and ends with a
// scale by n^-1.  Every butterfly leaves canonical residues in [0, q), so
// the kernels are bit-equal to the plain twins in ntt.py and to the
// reference whatever the order in which the butterflies run.
//
// Layout: x is [rows, n] uint32 (the port stores residues as int32 with
// the same bits), row r holds limb r % L.  Twiddles are the compact
// bit-reversed power tables psi[L, n] / ipsi[L, n] with their Shoup
// companions floor(w * 2^32 / q).  Stage s of the forward transform pairs
// the coefficients whose indices differ in bit b = logn - 1 - s, with the
// twiddle psi[2^s + (i >> (b + 1))]; stage s of the inverse pairs bit
// b = s with ipsi[2^(logn - 1 - s) + (i >> (b + 1))].  Both read the table
// at 2^(logn - 1 - b) + (i >> (b + 1)) for the bit b they pair.
//
// Bound: one read and one write of the data per transform, so bytes, not
// the 32-bit multiplies.  Design (one template, `ntt_row`, for both
// directions; one block of T = n / E threads per row):
//  * Registers hold the row.  Each thread owns E = 2^R coefficients (E = 16
//    from n = 32 to 16384, 32 at n = 32768, E = n below).  A pass runs the
//    stages of a window of R bits of the index on the thread's registers.
//    The windows are cut from the end where the direction starts: the
//    forward's from the top, [logn - R, logn), [logn - 2R, logn - R), ...,
//    the inverse's from the bottom, [0, R), [R, 2R), ...; where R does not
//    divide logn the last pass takes the shorter rest.  The E coefficients
//    of a thread in a pass span the R bits [c, c + R), c = min(window
//    start, logn - R); the thread index gives the bits below c and above.
//  * Between two passes the row goes once through shared memory, with one
//    barrier: two buffers alternate (one buffer and a second barrier at
//    n = 32768, where two do not fit).  The row is padded there so that
//    the lanes of a warp hit 32 distinct banks on both sides of every
//    exchange, with a constant address offset for each coefficient
//    (`smem_word`).
//  * The first pass reads its coefficients from device memory, the last
//    writes them there.  The forward reads coalesced across the warp
//    (stride n / E within a thread) and writes each thread's E contiguous
//    outputs as 16-byte stores; the inverse reads 16-byte vectors and
//    writes coalesced, times n^-1.
//  * A pass loads each twiddle it needs once (2^R - 1 of them and their
//    companions for a full window) into registers, as 16-byte vectors
//    where a stage needs four or more, and issues those loads before the
//    barrier of its exchange; each twiddle serves all its butterflies.
//
// Shoup multiply by a constant w < q: hi = umulhi(x, w'), r = x*w - hi*q
// (mod 2^32) lies in [0, 2q), min(r, r - q) is canonical.
// Valid for any x < 2^32 and q < 2^31.  Lazy residues in [0, 4q) would
// overflow 32 bits at the 31-bit primes of the ciphertext chain.
//
// Lift load (`LIFT`, the same template): the first pass reads a plain
// coefficient row once for every limb and lifts it into the limb's residue
// before the first butterfly; the passes and the store are unchanged.  It
// replaces no TPU kernel: it replaces the XLA (there PyTorch) glue of the
// BSGS diagonal encode (`api/bsgs.py` `_encode_diag_chunk`), a broadcast
// copy, a select and the int64 Montgomery passes.
//  * Forward: output row r of [S, L, n], limb r % L, reads source row r / L
//    of [S, n] (coefficients below 2^31, the broadcast over the limbs
//    without a copy) and multiplies each by R mod q (R = 2^32) with its
//    Shoup companion: the NTT is linear, so the output is the Montgomery
//    form to_mont(NTT(x)) bit for bit.  One block a limb: the L blocks
//    that read one source row are launched side by side (limb fastest), so
//    the row comes from HBM once and from L2 L - 1 times.  (A block that
//    looped over 2, 4 or all of the limbs of its row was no faster.)
//  * Inverse: output row of [L, S, n] (the limb-major layout the forward
//    lift reads as its [L * S, n] source), block b of limb b % L reads
//    source row b / L of [S, n], signed values in (-q, q), and adds q to a
//    negative one.  Limb fastest as well.
//  Bound: bytes, 4 B a source coefficient (read from HBM once) and 4 B an
//  output, half the plain transform's; the Shoup product adds one multiply
//  a coefficient to the butterflies' logn / 2.  The passes are the plain
//  transform's, and run at its rate on the same output rows.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The reductions below take the smaller of r and r -/+ q as unsigned
// words: the wrong one has wrapped past 2^32 - q, so min picks the residue.
__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w,
                                              uint32_t w_sh, uint32_t q) {
  const uint32_t r = x * w - __umulhi(x, w_sh) * q;   // in [0, 2q)
  return min(r, r - q);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;  // < 2q < 2^32
  return min(s, s - q);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t d = a - b;  // a - b, or a - b + 2^32 where a < b
  return min(d, d + q);
}

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The pass plan of a row of 2^LOGN coefficients.
template <int LOGN>
struct Plan {
  static constexpr int R = LOGN <= 4 ? LOGN : (LOGN == 15 ? 5 : 4);
  static constexpr int E = 1 << R;                  // coefficients a thread
  static constexpr int T = 1 << (LOGN - R);         // threads a row
  static constexpr int PASSES = (LOGN + R - 1) / R;
  static constexpr bool TWO_BUFFERS = LOGN <= 14;
  static constexpr int BUFFER = (1 << LOGN) + (1 << LOGN >> 4);  // padded row
  static constexpr size_t SMEM =
      PASSES == 1 ? 0 : (TWO_BUFFERS ? 2 : 1) * sizeof(uint32_t) * BUFFER;
  // at most 64 registers a thread, so 2048 threads' worth fit an SM
  static constexpr int MIN_BLOCKS = cmin(1024 / T, 32);
};

// Index in the row of the thread's coefficient e when its span starts at
// C.  The three terms have disjoint bits, so the index is a per-thread
// base plus a constant for each e, which the compiler folds into the
// address of the load or store.
template <int LOGN, int C>
__device__ __forceinline__ int coeff_index(int tid, int e) {
  constexpr int R = Plan<LOGN>::R;
  return ((tid >> C) << (C + R)) + (e << C) + (tid & ((1 << C) - 1));
}

// Shared-memory word of coefficient i in the exchange from span C0 to
// span C1: the row with a padding word after every 2^R words where one of
// the spans is 0, and two after every 32 words otherwise (one at R = 5).
// Either way the 32 lanes of a warp hit 32 distinct banks on both sides
// of the exchange, and the word of base + e-part is word(base) +
// word(e-part) (disjoint bits), so each access keeps a constant offset.
template <int LOGN, int C0, int C1>
__host__ __device__ constexpr int smem_word(int i) {
  constexpr int R = Plan<LOGN>::R;
  return C0 == 0 || C1 == 0 ? i + (i >> R) : i + ((i >> 5) << (5 - R));
}

// Pass W of a direction: the bits [lo, hi) of its window, the start c of
// the thread's span, and its stages in the order it runs them: stage K
// pairs bit bit(K) of the row, bit bit(K) - c of the thread's index e, and
// needs count(K) twiddles, held at offset(K) of the pass's registers.
template <bool INV, int LOGN, int W>
struct Window {
  using P = Plan<LOGN>;
  static constexpr int lo = INV ? W * P::R : LOGN - cmin(LOGN, (W + 1) * P::R);
  static constexpr int hi = INV ? cmin(LOGN, (W + 1) * P::R) : LOGN - W * P::R;
  static constexpr int c = cmin(lo, LOGN - P::R);
  static constexpr int width = hi - lo;
  __host__ __device__ static constexpr int bit(int k) {
    return INV ? lo + k : hi - 1 - k;
  }
  __host__ __device__ static constexpr int count(int k) {
    return P::E >> (bit(k) - c + 1);
  }
  __host__ __device__ static constexpr int offset(int k) {
    return k == 0 ? 0 : offset(k - 1) + count(k - 1);
  }
  static constexpr int TWIDDLES = offset(width);
};

// COUNT consecutive table words from p (aligned to COUNT words, up to 4)
// into w[OFF, OFF + COUNT), as 16- or 8-byte loads where they fit.
template <int COUNT, int OFF, int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[N],
                                           const uint32_t* __restrict__ p) {
  if constexpr (COUNT >= 4) {
#pragma unroll
    for (int j = 0; j < COUNT / 4; ++j) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + j);
      w[OFF + 4 * j] = t.x, w[OFF + 4 * j + 1] = t.y;
      w[OFF + 4 * j + 2] = t.z, w[OFF + 4 * j + 3] = t.w;
    }
  } else if constexpr (COUNT == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    w[OFF] = t.x, w[OFF + 1] = t.y;
  } else {
    w[OFF] = __ldg(p);
  }
}

// The twiddles of stage K onwards of window W, and their companions.  The
// thread's twiddles of one stage are consecutive in the table and start
// at a multiple of their count.
template <bool INV, int LOGN, int W, int K = 0>
__device__ __forceinline__ void load_twiddles(
    uint32_t (&w)[Window<INV, LOGN, W>::TWIDDLES],
    uint32_t (&w_sh)[Window<INV, LOGN, W>::TWIDDLES],
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
    int tid) {
  using Wn = Window<INV, LOGN, W>;
  if constexpr (K < Wn::width) {
    constexpr int b = Wn::bit(K), c = Wn::c;
    const int base = (1 << (LOGN - 1 - b)) +
                     ((tid >> c) << (c + Plan<LOGN>::R - 1 - b));
    load_words<Wn::count(K), Wn::offset(K)>(w, tw + base);
    load_words<Wn::count(K), Wn::offset(K)>(w_sh, tw_sh + base);
    load_twiddles<INV, LOGN, W, K + 1>(w, w_sh, tw, tw_sh, tid);
  }
}

// Stage K onwards of window W: the butterflies on the registers.
template <bool INV, int LOGN, int W, int K = 0>
__device__ __forceinline__ void stages(
    uint32_t (&a)[Plan<LOGN>::E],
    const uint32_t (&w)[Window<INV, LOGN, W>::TWIDDLES],
    const uint32_t (&w_sh)[Window<INV, LOGN, W>::TWIDDLES], uint32_t q) {
  using Wn = Window<INV, LOGN, W>;
  if constexpr (K < Wn::width) {
    constexpr int lb = Wn::bit(K) - Wn::c;
#pragma unroll
    for (int g = 0; g < Wn::count(K); ++g) {
      const uint32_t tw = w[Wn::offset(K) + g], tw_sh = w_sh[Wn::offset(K) + g];
#pragma unroll
      for (int l = 0; l < (1 << lb); ++l) {
        uint32_t& u = a[(g << (lb + 1)) | l];
        uint32_t& v = a[(g << (lb + 1)) | (1 << lb) | l];
        if constexpr (INV) {
          const uint32_t d = sub_mod(u, v, q);
          u = add_mod(u, v, q);
          v = mul_shoup(d, tw, tw_sh, q);
        } else {
          const uint32_t t = mul_shoup(v, tw, tw_sh, q);
          v = sub_mod(u, t, q);
          u = add_mod(u, t, q);
        }
      }
    }
    stages<INV, LOGN, W, K + 1>(a, w, w_sh, q);
  }
}

// Passes p >= 1: the row goes through shared memory from the layout of
// pass p - 1 to that of pass p; the pass's twiddle loads are issued before
// the barrier, while the coefficients' registers are free.
template <bool INV, int LOGN, int Pass>
__device__ __forceinline__ void passes_from(uint32_t (&a)[Plan<LOGN>::E],
                                            uint32_t* smem,
                                            const uint32_t* __restrict__ tw,
                                            const uint32_t* __restrict__ tw_sh,
                                            uint32_t q, int tid) {
  using P = Plan<LOGN>;
  if constexpr (Pass < P::PASSES) {
    constexpr int c0 = Window<INV, LOGN, Pass - 1>::c;
    constexpr int c1 = Window<INV, LOGN, Pass>::c;
    uint32_t* s = smem + (P::TWO_BUFFERS ? (Pass & 1) * P::BUFFER : 0);
    if constexpr (!P::TWO_BUFFERS && Pass > 1) __syncthreads();
    uint32_t* put = s + smem_word<LOGN, c0, c1>(coeff_index<LOGN, c0>(tid, 0));
#pragma unroll
    for (int e = 0; e < P::E; ++e) put[smem_word<LOGN, c0, c1>(e << c0)] = a[e];
    uint32_t t[Window<INV, LOGN, Pass>::TWIDDLES];
    uint32_t t_sh[Window<INV, LOGN, Pass>::TWIDDLES];
    load_twiddles<INV, LOGN, Pass>(t, t_sh, tw, tw_sh, tid);
    __syncthreads();
    const uint32_t* get = s + smem_word<LOGN, c0, c1>(coeff_index<LOGN, c1>(tid, 0));
#pragma unroll
    for (int e = 0; e < P::E; ++e) a[e] = get[smem_word<LOGN, c0, c1>(e << c1)];
    stages<INV, LOGN, Pass>(a, t, t_sh, q);
    passes_from<INV, LOGN, Pass + 1>(a, smem, tw, tw_sh, q, tid);
  }
}

template <int LOGN, int C>
__device__ __forceinline__ void load_row(uint32_t (&a)[Plan<LOGN>::E],
                                         const uint32_t* __restrict__ src,
                                         int tid) {
  constexpr int E = Plan<LOGN>::E;
  if constexpr (C == 0 && E >= 4) {   // E contiguous words: 16-byte loads
    const uint4* v = reinterpret_cast<const uint4*>(src + tid * E);
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const uint4 t = __ldg(v + k);
      a[4 * k] = t.x, a[4 * k + 1] = t.y, a[4 * k + 2] = t.z, a[4 * k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = __ldg(src + coeff_index<LOGN, C>(tid, e));
  }
}

template <int LOGN, int C>
__device__ __forceinline__ void store_row(const uint32_t (&a)[Plan<LOGN>::E],
                                          uint32_t* __restrict__ dst,
                                          int tid) {
  constexpr int E = Plan<LOGN>::E;
  if constexpr (C == 0 && E >= 4) {
    uint4* v = reinterpret_cast<uint4*>(dst + tid * E);
#pragma unroll
    for (int k = 0; k < E / 4; ++k)
      v[k] = make_uint4(a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[coeff_index<LOGN, C>(tid, e)] = a[e];
  }
}

// One row, either direction: source row x, output row y, limb `limb`.
// LIFT: the lift load (above); rmod / rmod_sh are the forward lift's
// R mod q and its companion, ninv / ninv_sh the inverse's n^-1.
template <bool INV, bool LIFT, int LOGN>
__device__ __forceinline__ void ntt_row(const uint32_t* __restrict__ x,
                                        uint32_t* __restrict__ y, int limb,
                                        const uint32_t* __restrict__ mods,
                                        const uint32_t* __restrict__ tw_all,
                                        const uint32_t* __restrict__ tw_sh_all,
                                        const uint32_t* __restrict__ ninv,
                                        const uint32_t* __restrict__ ninv_sh,
                                        const uint32_t* __restrict__ rmod,
                                        const uint32_t* __restrict__ rmod_sh) {
  using P = Plan<LOGN>;
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const uint32_t q = __ldg(mods + limb);
  const uint32_t* tw = tw_all + (static_cast<size_t>(limb) << LOGN);
  const uint32_t* tw_sh = tw_sh_all + (static_cast<size_t>(limb) << LOGN);
  uint32_t a[P::E];
  uint32_t t[Window<INV, LOGN, 0>::TWIDDLES];
  uint32_t t_sh[Window<INV, LOGN, 0>::TWIDDLES];
  load_twiddles<INV, LOGN, 0>(t, t_sh, tw, tw_sh, tid);
  load_row<LOGN, Window<INV, LOGN, 0>::c>(a, x, tid);
  if constexpr (LIFT && INV) {        // v in (-q, q): v + q where v < 0
#pragma unroll
    for (int e = 0; e < P::E; ++e) a[e] = min(a[e], a[e] + q);
  } else if constexpr (LIFT) {        // x < 2^31 -> x R mod q
    const uint32_t r = __ldg(rmod + limb), r_sh = __ldg(rmod_sh + limb);
#pragma unroll
    for (int e = 0; e < P::E; ++e) a[e] = mul_shoup(a[e], r, r_sh, q);
  }
  stages<INV, LOGN, 0>(a, t, t_sh, q);
  passes_from<INV, LOGN, 1>(a, smem, tw, tw_sh, q, tid);
  if constexpr (INV) {
    const uint32_t nv = __ldg(ninv + limb), nv_sh = __ldg(ninv_sh + limb);
#pragma unroll
    for (int e = 0; e < P::E; ++e) a[e] = mul_shoup(a[e], nv, nv_sh, q);
  }
  store_row<LOGN, Window<INV, LOGN, P::PASSES - 1>::c>(a, y, tid);
}

// Row r of [rows, n] on limb r % L; LIFT: the forward lift, block b of
// limb b % L from source row b / L into output row b.
template <int LOGN, bool LIFT>
__global__ void __launch_bounds__(Plan<LOGN>::T, Plan<LOGN>::MIN_BLOCKS)
ntt_forward_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ mods,
                   const uint32_t* __restrict__ psi,
                   const uint32_t* __restrict__ psi_sh,
                   const uint32_t* __restrict__ rmod,
                   const uint32_t* __restrict__ rmod_sh, int L) {
  const size_t row = blockIdx.x;
  const int limb = static_cast<int>(blockIdx.x % static_cast<unsigned>(L));
  const size_t src = LIFT ? blockIdx.x / static_cast<unsigned>(L) : row;
  ntt_row<false, LIFT, LOGN>(x + (src << LOGN), y + (row << LOGN), limb, mods,
                             psi, psi_sh, nullptr, nullptr, rmod, rmod_sh);
}

// Row r of [rows, n] on limb r % L; LIFT: the inverse lift, block b of
// limb b % L from source row b / L into output row (b % L) S + b / L.
template <int LOGN, bool LIFT>
__global__ void __launch_bounds__(Plan<LOGN>::T, Plan<LOGN>::MIN_BLOCKS)
ntt_inverse_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ mods,
                   const uint32_t* __restrict__ ipsi,
                   const uint32_t* __restrict__ ipsi_sh,
                   const uint32_t* __restrict__ ninv,
                   const uint32_t* __restrict__ ninv_sh, int L) {
  const size_t row = blockIdx.x;
  const int limb = static_cast<int>(blockIdx.x % static_cast<unsigned>(L));
  if constexpr (!LIFT) {
    ntt_row<true, false, LOGN>(x + (row << LOGN), y + (row << LOGN), limb,
                               mods, ipsi, ipsi_sh, ninv, ninv_sh, nullptr,
                               nullptr);
  } else {
    const size_t s = blockIdx.x / static_cast<unsigned>(L);
    const size_t S = gridDim.x / static_cast<unsigned>(L);
    ntt_row<true, true, LOGN>(x + (s << LOGN),
                              y + ((limb * S + s) << LOGN), limb, mods, ipsi,
                              ipsi_sh, ninv, ninv_sh, nullptr, nullptr);
  }
}

// The shared-memory allowance above 48 KB, set once per kernel instance
// and device (not on every launch).  KIND tells apart the instances that
// share a signature (plain and lift).
template <int LOGN, int KIND, typename Kernel>
cudaError_t ready(Kernel kernel) {
  constexpr size_t smem = Plan<LOGN>::SMEM;
  if constexpr (smem <= 48 * 1024) {
    return cudaSuccess;
  } else {
    static std::atomic<unsigned> done{0};   // one bit per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
    return err;
  }
}

// KIND of `ready` and `describe`: 2 inverse + lift
template <bool INV, bool LIFT>
constexpr int kind() { return 2 * INV + LIFT; }

template <int LOGN, bool LIFT>
int launch_forward(const void* x, void* y, const void* mods, const void* psi,
                   const void* psi_sh, const void* rmod, const void* rmod_sh,
                   long long blocks, int L, void* stream) {
  using P = Plan<LOGN>;
  cudaError_t err = ready<LOGN, kind<false, LIFT>()>(ntt_forward_kernel<LOGN, LIFT>);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_forward_kernel<LOGN, LIFT><<<static_cast<unsigned>(blocks), P::T, P::SMEM,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(mods), static_cast<const uint32_t*>(psi),
      static_cast<const uint32_t*>(psi_sh), static_cast<const uint32_t*>(rmod),
      static_cast<const uint32_t*>(rmod_sh), L);
  return static_cast<int>(cudaGetLastError());
}

template <int LOGN, bool LIFT>
int launch_inverse(const void* x, void* y, const void* mods,
                   const void* ipsi, const void* ipsi_sh, const void* ninv,
                   const void* ninv_sh, long long blocks, int L, void* stream) {
  using P = Plan<LOGN>;
  cudaError_t err = ready<LOGN, kind<true, LIFT>()>(ntt_inverse_kernel<LOGN, LIFT>);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inverse_kernel<LOGN, LIFT><<<static_cast<unsigned>(blocks), P::T, P::SMEM,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(mods), static_cast<const uint32_t*>(ipsi),
      static_cast<const uint32_t*>(ipsi_sh),
      static_cast<const uint32_t*>(ninv),
      static_cast<const uint32_t*>(ninv_sh), L);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler and the card made of one instance: registers a
// thread, local (spilled) bytes a thread, threads a block, dynamic shared
// bytes a block, resident blocks an SM, coefficients a thread, passes.
template <int LOGN, int KIND, typename Kernel>
int describe(Kernel kernel, int* out) {
  using P = Plan<LOGN>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = ready<LOGN, KIND>(kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, P::T,
                                                        P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = P::T;
  out[3] = static_cast<int>(P::SMEM);
  out[4] = blocks;
  out[5] = P::E;
  out[6] = P::PASSES;
  return 0;
}

template <int LOGN>
int describe_any(int inverse, int lift, int* out) {
  if (inverse)
    return lift ? describe<LOGN, kind<true, true>()>(ntt_inverse_kernel<LOGN, true>, out)
                : describe<LOGN, kind<true, false>()>(ntt_inverse_kernel<LOGN, false>, out);
  return lift ? describe<LOGN, kind<false, true>()>(ntt_forward_kernel<LOGN, true>, out)
              : describe<LOGN, kind<false, false>()>(ntt_forward_kernel<LOGN, false>, out);
}

}  // namespace

#define NTT_EACH_LOGN(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12) F(13) F(14) F(15)

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns the cudaError_t of the launch.
extern "C" int ntt_forward(const void* x, void* y, const void* mods,
                           const void* psi, const void* psi_sh,
                           long long rows, int L, int logn, void* stream) {
  switch (logn) {
#define NTT_CASE(k)                                                          \
  case k: return launch_forward<k, false>(x, y, mods, psi, psi_sh, nullptr, \
                                          nullptr, rows, L, stream);
    NTT_EACH_LOGN(NTT_CASE)
#undef NTT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int ntt_inverse(const void* x, void* y, const void* mods,
                           const void* ipsi, const void* ipsi_sh,
                           const void* ninv, const void* ninv_sh,
                           long long rows, int L, int logn, void* stream) {
  switch (logn) {
#define NTT_CASE(k)                                                        \
  case k: return launch_inverse<k, false>(x, y, mods, ipsi, ipsi_sh, ninv, \
                                          ninv_sh, rows, L, stream);
    NTT_EACH_LOGN(NTT_CASE)
#undef NTT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forward lift: x [src_rows, n] -> y [src_rows, L, n].
extern "C" int ntt_forward_lift(const void* x, void* y, const void* mods,
                                const void* psi, const void* psi_sh,
                                const void* rmod, const void* rmod_sh,
                                long long src_rows, int L, int logn,
                                void* stream) {
  switch (logn) {
#define NTT_CASE(k)                                                       \
  case k: return launch_forward<k, true>(x, y, mods, psi, psi_sh, rmod,  \
                                         rmod_sh, src_rows * L, L, stream);
    NTT_EACH_LOGN(NTT_CASE)
#undef NTT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The inverse lift: x [src_rows, n] signed -> y [L, src_rows, n].
extern "C" int ntt_inverse_lift(const void* x, void* y, const void* mods,
                                const void* ipsi, const void* ipsi_sh,
                                const void* ninv, const void* ninv_sh,
                                long long src_rows, int L, int logn,
                                void* stream) {
  switch (logn) {
#define NTT_CASE(k)                                                       \
  case k: return launch_inverse<k, true>(x, y, mods, ipsi, ipsi_sh, ninv, \
                                         ninv_sh, src_rows * L, L, stream);
    NTT_EACH_LOGN(NTT_CASE)
#undef NTT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Seven ints into `out` (see `describe`) for the instance of `logn`, the
// inverse if `inverse` is not 0, the lift load if `lift` is not 0, on the
// current device.
extern "C" int ntt_kernel_info(int logn, int inverse, int lift, int* out) {
  switch (logn) {
#define NTT_CASE(k) \
  case k: return describe_any<k>(inverse, lift, out);
    NTT_EACH_LOGN(NTT_CASE)
#undef NTT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ntt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
