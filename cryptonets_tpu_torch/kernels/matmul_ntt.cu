// Four-step negacyclic NTT for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces MatmulNTTContext._forward, MatmulNTTContext._inverse and their
// product _exact_modmat (cryptonets_tpu/kernels/matmul_ntt.py).  With
// N = N1 * N2, i = i2 * N1 + i1 and j = j2 * N1 + j1, all mod q of the
// row's limb:
//
//   forward  X[j2, j1] = sum_i1 ( tw[j2, i1] *
//                          sum_i2 Wa[j2, i2] * pre[i] * x[i2, i1] ) * Wb[i1, j1]
//   inverse  x[a, c]   = post[a * N1 + c] *
//                          sum_j2 Wai[a, j2] * twi[j2, c] *
//                            sum_j1 X[j2, j1] * Wbi[j1, c]
//
// with pre = psi^i, Wa = omega^(N1 i2 j2), tw = omega^(i1 j2),
// Wb = omega^(N2 i1 j1), omega = psi^2, the inverse tables their inverses
// and post = psi^-i * N^-1 (no second scaling).  The output ordering is
// this transform's own, not the bit-reversed one of ntt.cu.  Every output
// is the canonical residue in [0, q), so the kernels are bit-equal to the
// plain versions in matmul_ntt.py and to the reference.
//
// The reference splits every operand into four 8-bit float planes and runs
// 16 matrix products per step because its matrix unit multiplies floats.
// None of that is the function's: this card has a 32-bit multiply-high, so
// each term is one Shoup product r = x*w - umulhi(x, w')*q in [0, 2q),
// summed exactly in 64 bits (at most 128 terms below 2^32), and one Barrett
// reduction by floor(2^64 / q) ends each sum.
//
// Layout: x is [rows, N] uint32 (the port stores residues as int32 with
// the same bits), row r holds limb r % L.  Every table entry is a pair
// (w, w') with w' = floor(w * 2^32 / q), read as one 8-byte load:
// pre/tw/post [L, N], Wa [L, N2, N2], Wb [L, N1, N1].
//
// Design: one thread block per row, the row in shared memory twice over
// (8 N bytes: 64 KB at N = 8192, 128 KB at N = 16384), two passes with a
// barrier between them.  In the pass that multiplies from the left a
// thread owns four outputs of one matrix row, so one table entry (the same
// for a whole warp, a broadcast) serves four terms; in the pass that
// multiplies from the right it owns four outputs of one column, so one
// coalesced table load serves four terms whose data is a shared-memory
// broadcast.  The matrices (2 x 64 KB a limb at N2 = 128) stay in device
// memory and are read through the caches: blocks of one limb are
// neighbours in the grid, so a matrix is fetched from device memory about
// once.
//
// Bound: this kernel is bound by integer operations.  It does N * (N1 + N2)
// terms a row at 3 32-bit multiplies a term (umulhi and two mullo) against
// one read and one write of the row, some thirty times the butterflies'
// multiplies.  The function itself needs less: one 32 x 32 -> 64 bit
// product a term (2 multiplies) with one reduction per sum, and less still
// on the int8 tensor cores (16 plane pairs of 8-bit digits a term, exact
// 32-bit sums), which is the card's least time for this work and close to
// the time the bytes take.  The design spends no multiply outside the terms
// but the N twiddles and the Barrett step of each pass; the third multiply
// a term buys sums that fit 64 bits without a carry chain.  A design for
// the tensor cores is the step after this one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4;  // outputs a thread owns in one sum

// x * w mod q in [0, 2q) for any x < 2^32, c = (w, floor(w * 2^32 / q))
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint2 c,
                                               uint32_t q) {
  return x * c.x - __umulhi(x, c.y) * q;
}

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint2 c, uint32_t q) {
  const uint32_t r = shoup_lazy(x, c, q);
  return r >= q ? r - q : r;
}

// s mod q for any s < 2^64, m = floor(2^64 / q): the quotient estimate is
// short by at most one
__device__ __forceinline__ uint32_t barrett(unsigned long long s,
                                            unsigned long long m,
                                            uint32_t q) {
  const unsigned long long r = s - __umul64hi(s, m) * q;
  return static_cast<uint32_t>(r >= q ? r - q : r);
}

// dst[a, c] = scale[a, c] * sum_b W[a, b] * src[b, c]   (src, dst [N2, N1])
__device__ __forceinline__ void left_pass(const uint32_t* src, uint32_t* dst,
                                          const uint2* __restrict__ W,
                                          const uint2* __restrict__ scale,
                                          int N1, int N2, uint32_t q,
                                          unsigned long long m) {
  const int cols = N1 / TILE;  // column groups: c, c + cols, ...
  for (int u = threadIdx.x; u < N2 * cols; u += blockDim.x) {
    const int a = u / cols, c = u % cols;
    const uint2* wrow = W + static_cast<size_t>(a) * N2;
    unsigned long long acc[TILE];
#pragma unroll
    for (int t = 0; t < TILE; ++t) acc[t] = 0;
#pragma unroll 4
    for (int b = 0; b < N2; ++b) {
      const uint2 w = __ldg(wrow + b);
      const uint32_t* xs = src + b * N1 + c;
#pragma unroll
      for (int t = 0; t < TILE; ++t) acc[t] += shoup_lazy(xs[t * cols], w, q);
    }
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const int at = a * N1 + c + t * cols;
      dst[at] = shoup(barrett(acc[t], m, q), __ldg(scale + at), q);
    }
  }
}

// dst[a, c] = scale[a, c] * sum_b src[a, b] * W[b, c]   (src, dst [N2, N1],
// scale may be null)
__device__ __forceinline__ void right_pass(const uint32_t* src, uint32_t* dst,
                                           const uint2* __restrict__ W,
                                           const uint2* __restrict__ scale,
                                           int N1, int N2, uint32_t q,
                                           unsigned long long m) {
  const int rows = N2 / TILE;  // row groups: a, a + rows, ...
  for (int u = threadIdx.x; u < rows * N1; u += blockDim.x) {
    const int a = u / N1, c = u % N1;
    unsigned long long acc[TILE];
#pragma unroll
    for (int t = 0; t < TILE; ++t) acc[t] = 0;
#pragma unroll 4
    for (int b = 0; b < N1; ++b) {
      const uint2 w = __ldg(W + static_cast<size_t>(b) * N1 + c);
      const uint32_t* xs = src + a * N1 + b;
#pragma unroll
      for (int t = 0; t < TILE; ++t)
        acc[t] += shoup_lazy(xs[t * rows * N1], w, q);
    }
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const int at = (a + t * rows) * N1 + c;
      const uint32_t r = barrett(acc[t], m, q);
      dst[at] = scale ? shoup(r, __ldg(scale + at), q) : r;
    }
  }
}

// Block b of the grid takes row (b % B) * L + b / B, B = rows / L: the
// blocks of one limb are neighbours.
template <bool INVERSE>
__global__ void matmul_ntt_kernel(const uint32_t* __restrict__ x,
                                  uint32_t* __restrict__ y,
                                  const uint32_t* __restrict__ mods,
                                  const uint2* __restrict__ t_vec,   // pre | twi
                                  const uint2* __restrict__ t_left,  // Wa | Wai
                                  const uint2* __restrict__ t_mid,   // tw | post
                                  const uint2* __restrict__ t_right, // Wb | Wbi
                                  long long batches, int L, int N1, int N2) {
  extern __shared__ uint32_t smem[];
  const int N = N1 * N2;
  uint32_t* s0 = smem;
  uint32_t* s1 = smem + N;
  const int limb = static_cast<int>(blockIdx.x / batches);
  const size_t row = static_cast<size_t>(blockIdx.x % batches) * L + limb;
  const uint32_t q = mods[limb];
  const unsigned long long m = ~0ull / q;  // floor(2^64 / q): q is odd
  const uint32_t* src = x + row * N;
  uint32_t* dst = y + row * N;
  const uint2* vec = t_vec + static_cast<size_t>(limb) * N;
  const uint2* mid = t_mid + static_cast<size_t>(limb) * N;
  const uint2* left = t_left + static_cast<size_t>(limb) * N2 * N2;
  const uint2* right = t_right + static_cast<size_t>(limb) * N1 * N1;
  if (!INVERSE) {
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      s0[i] = shoup(src[i], __ldg(vec + i), q);  // psi^i x
    __syncthreads();
    left_pass(s0, s1, left, mid, N1, N2, q, m);  // tw * (Wa y)
    __syncthreads();
    right_pass(s1, dst, right, nullptr, N1, N2, q, m);  // (.) Wb
  } else {
    for (int i = threadIdx.x; i < N; i += blockDim.x) s0[i] = src[i];
    __syncthreads();
    right_pass(s0, s1, right, vec, N1, N2, q, m);  // twi * (X Wbi)
    __syncthreads();
    left_pass(s1, dst, left, mid, N1, N2, q, m);  // post * (Wai .)
  }
}

template <bool INVERSE>
cudaError_t launch(const void* x, void* y, const void* mods,
                   const void* t_vec, const void* t_left, const void* t_mid,
                   const void* t_right, long long rows, int L, int N1, int N2,
                   void* stream) {
  const long long N = static_cast<long long>(N1) * N2;
  if (N1 < TILE || N2 < TILE || (N1 & (N1 - 1)) || (N2 & (N2 - 1)) ||
      L <= 0 || rows % L != 0 || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(uint32_t) * static_cast<size_t>(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_ntt_kernel<INVERSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int units = static_cast<int>(N / TILE);
  const int threads = units < 512 ? units : 512;
  matmul_ntt_kernel<INVERSE><<<static_cast<unsigned>(rows), threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(mods), static_cast<const uint2*>(t_vec),
      static_cast<const uint2*>(t_left), static_cast<const uint2*>(t_mid),
      static_cast<const uint2*>(t_right), rows / L, L, N1, N2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns the cudaError_t of the launch.  N1 and
// N2 are powers of two, at least 4, with 8 * N1 * N2 bytes within the
// shared memory a block may take (the wrapper checks the rest).
extern "C" int matmul_ntt_forward(const void* x, void* y, const void* mods,
                                  const void* pre, const void* wa,
                                  const void* tw, const void* wb,
                                  long long rows, int L, int N1, int N2,
                                  void* stream) {
  return static_cast<int>(
      launch<false>(x, y, mods, pre, wa, tw, wb, rows, L, N1, N2, stream));
}

extern "C" int matmul_ntt_inverse(const void* x, void* y, const void* mods,
                                  const void* twi, const void* wai,
                                  const void* post, const void* wbi,
                                  long long rows, int L, int N1, int N2,
                                  void* stream) {
  return static_cast<int>(
      launch<true>(x, y, mods, twi, wai, post, wbi, rows, L, N1, N2, stream));
}

extern "C" const char* matmul_ntt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
