// Four-step negacyclic NTT for Hopper (sm_90a) on the int8 tensor cores,
// hand-written CUDA C++.
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
// and post = psi^-i * N^-1.  The output ordering is this transform's own,
// not the bit-reversed one of ntt.cu.  Every output is the canonical
// residue in [0, q), so the kernels are bit-equal to the plain versions in
// matmul_ntt.py and to the reference.
//
// Arithmetic.  As in K4 (modmatmul.cu), each residue (< 2^31) splits into
// four u8 planes and a product of two matrices of residues is 16 plane-pair
// products on the tensor cores (wgmma m64nNk32.s32.u8.u8), in 7 shift
// groups s = i + j.  The sums here are short (K = N2 or N1 terms, at most
// 128), so a group sum S_s < 4 * 128 * 255^2 < 2^25 and the groups are
// combined exactly instead of folded one by one (K4 spends a Shoup product
// an output a group, as much as the products here):
//   hi = S_4 + 2^8 S_5 + 2^16 S_6 < 2^42,  lo = S_0 + ... + 2^24 S_3 < 2^51,
// one 32 x 32 -> 64 bit multiply-add a group.  The groups run in the order
// 6, 5, ..., 0: once hi is in, hi = h1 2^32 + h0 becomes
// h0 (2^32 mod q) + h1 (2^64 mod q), two Shoup products in [0, 2q), and lo
// adds onto that; the sum v < 2^51 ends as v1 (2^32 mod q) + v0, two more
// Shoup products and three conditional subtractions (`reduce64`).  Only
// 32-bit multiplies: no 64-bit Barrett step.
//
// Layout.  x, y are [rows, N] uint32 (int32 storage), row r of limb r % L.
// Everything else comes prepared once per chain (matmul_ntt.py
// `host_tables`), with the forward's twist pre = psi^(N1 b + c) and the
// inverse's post = psi^-(N1 a + c) N^-1 folded in: Wa' = Wa diag(psi^(N1 b))
// and tw' = tw psi^c, Wai' = diag(psi^(-N1 a)) Wai and twi' = twi psi^-c
// N^-1.  tw' and twi' are [L, N] pairs (w, floor(w * 2^32 / q)); the DFT
// matrices are u8 planes in exactly the layout this kernel keeps in shared
// memory: Wa', Wai' [L][4][MP][ROW_L] (the A operand, rows a, K = N2 bytes),
// Wb, Wbi [L][4][NP][ROW_R] (the B operand, rows = output columns, K = N1
// bytes); a plane tile is K-major rows of ROW = max(32, K) bytes under the
// ROW-byte swizzle (u8mma.cuh), zero past the ring.  MP = 64 * MT pads N2
// to the warpgroups' 64 rows, NP = max(8, N1) pads N1 to a wgmma width.
// The limb constants are [L][8] u32 (`limb_constants`).
//
// Design: one block a row, MT = max(1, N2 / 64) tiles of 64 rows a, each
// owned through both products by one or two warpgroups.  The block copies the row's limb's DFT planes
// into shared memory (cp.async) while it loads the row and splits it into
// four plane tiles; then
//   forward: left product Wa' @ y (A = Wa' planes, B = the data, which u8
//            wgmma takes K-major only, so the split transposes [i2][i1]
//            into rows i1: K4's 4 x 4 __byte_perm transpose), combine,
//            times tw', split again in the natural [a][c] layout (already
//            K-major for the right product), right product . Wb, combine,
//            store;
//   inverse: right product y . Wbi (natural split), combine, times twi',
//            transposed split, left product Wai' @ ., combine, store.
// The data planes of the two products share one buffer.  Output columns go
// in chunks of at most 32 (wgmma N), split between up to two warpgroups
// a tile of rows, so a block has up to four warpgroups (512 threads at
// n = 8192 and 16384: one block an SM, 128 registers a thread) and a row's
// integer work spreads over 16 warps; two accumulator sets in flight, so
// one group's combine overlaps the next group's products.
//
// Bound (chip_smoke.py `modmat_bound`): 16 plane pairs a term on the int8
// tensor cores, N * (N1 + N2) terms a row (0.0114 ms at [64, 7, 8192]),
// against moving the row twice (0.0094 ms).  The kernel's own plan
// (`mmntt_design_ms`) adds the integer work an output (the combine, the
// reductions, the twiddle and the splits), which takes longer than the
// plane pairs.

#include <cstdint>
#include <cuda_runtime.h>

#include "u8mma.cuh"

namespace {

constexpr int PLANES = 4;
constexpr int GROUPS = 7;
constexpr int WG_THREADS = 128;  // a warpgroup
constexpr int DEPTH = 2;         // accumulator sets in flight

// The geometry of the ring of 2^LOGN: N = N1 * N2 (matmul_ntt.py split4),
// the data [N2][N1].
template <int LOGN>
struct Ring {
  static constexpr int N2 = 1 << ((LOGN + 1) / 2);
  static constexpr int N1 = 1 << (LOGN - (LOGN + 1) / 2);
  static constexpr int N = N1 * N2;
  static constexpr int MT = N2 > 64 ? N2 / 64 : 1;  // tiles of 64 rows a
  static constexpr int MP = 64 * MT;                // rows a, padded
  static constexpr int NP = N1 > 8 ? N1 : 8;        // output columns, padded
  static constexpr int NC = NP < 32 ? NP : 32;      // columns a chunk
  // groups of output columns: up to four warpgroups a block
  static constexpr int CG = NP / NC < 4 / MT ? NP / NC : 4 / MT;
  static constexpr int NCH = NP / (NC * CG);        // chunks a warpgroup
  static constexpr int WG = MT * CG;                // warpgroups
  static constexpr int THREADS = WG_THREADS * WG;
  static constexpr int ROW_L = N2 > 32 ? N2 : 32;   // bytes a row, K = N2
  static constexpr int ROW_R = N1 > 32 ? N1 : 32;   // bytes a row, K = N1
  // shared memory: the left DFT planes (A), the right ones (B), and the
  // data planes, as B of the left product [4][NP][ROW_L] or as A of the
  // right product [4][MP][ROW_R]
  static constexpr int WL_BYTES = PLANES * MP * ROW_L;
  static constexpr int WR_BYTES = PLANES * NP * ROW_R;
  static constexpr int D_BYTES = PLANES * MP * ROW_R > PLANES * NP * ROW_L
                                     ? PLANES * MP * ROW_R
                                     : PLANES * NP * ROW_L;
  static constexpr size_t SMEM = WL_BYTES + WR_BYTES + D_BYTES + 1024;
};

// A limb's modulus and its Shoup constants (w, floor(w * 2^32 / q)) for
// w = 2^32 mod q, 2^64 mod q and 1, from the limb's row of the table
// `host_tables` makes: (q, c32, c32', c64, c64', 1', 0, 0).
struct Mod {
  uint32_t q;
  uint2 c32, c64, one;
};

__device__ __forceinline__ Mod load_mod(const uint4* __restrict__ limb) {
  const uint4 a = __ldg(limb), b = __ldg(limb + 1);
  Mod md;
  md.q = a.x;
  md.c32 = make_uint2(a.y, a.z);
  md.c64 = make_uint2(a.w, b.x);
  md.one = make_uint2(1u, b.y);
  return md;
}

// x * w mod q in [0, 2q) for any x < 2^32, c = (w, floor(w * 2^32 / q))
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint2 c,
                                               uint32_t q) {
  return x * c.x - __umulhi(x, c.y) * q;
}

// x mod q for x < 2q
__device__ __forceinline__ uint32_t canon(uint32_t x, uint32_t q) {
  return min(x, x - q);
}

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint2 c, uint32_t q) {
  return canon(shoup_lazy(x, c, q), q);
}

// v mod q for any v < 2^64, canonical: v = v1 2^32 + v0 is congruent to
// v1 (2^32 mod q) + v0 * 1, two Shoup products in [0, 2q) each, made
// canonical and added.
__device__ __forceinline__ uint32_t reduce64(unsigned long long v,
                                             const Mod& md) {
  const uint32_t t = canon(shoup_lazy(static_cast<uint32_t>(v >> 32), md.c32,
                                      md.q), md.q);
  const uint32_t r =
      canon(shoup_lazy(static_cast<uint32_t>(v), md.one, md.q), md.q);
  return canon(t + r, md.q);
}

// Four u32 values -> four u32 words, word j holding byte j of each value
// (value t in byte t): K4's 4 x 4 byte transpose.
__device__ __forceinline__ void byte_planes(const uint32_t (&v)[4],
                                            uint32_t (&pl)[4]) {
  const uint32_t ab_lo = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t ab_hi = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t cd_lo = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t cd_hi = __byte_perm(v[2], v[3], 0x7362);
  pl[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  pl[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  pl[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  pl[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// The products of shift group S into acc: plane pairs (i, S - i), A plane
// i and B plane S - i, over the ROW / 32 k32 steps; the first overwrites.
template <int NC, int ROW, int S>
__device__ __forceinline__ void issue_group(int (&acc)[NC / 2], uint32_t a,
                                            uint32_t a_plane, uint32_t b,
                                            uint32_t b_plane) {
  constexpr int I_LO = S > 3 ? S - 3 : 0, I_HI = S < 3 ? S : 3;
  wgmma_fence();
#pragma unroll
  for (int i = I_LO; i <= I_HI; ++i) {
    const uint64_t da = desc<ROW>(a + i * a_plane);
    const uint64_t db = desc<ROW>(b + (S - i) * b_plane);
#pragma unroll
    for (int ks = 0; ks < ROW / 32; ++ks)  // k advances 32 bytes a step
      wgmma<NC>(acc, da + 2 * ks, db + 2 * ks, i > I_LO || ks > 0);
  }
  wgmma_commit();
}

// Step P of the combine, group S = 6 - P: wait for it (the later groups
// issued stay in flight), add it into v at its shift, reduce hi once S = 4
// is in, and issue group S - DEPTH into the set just freed.
template <int NC, int ROW, int P>
__device__ __forceinline__ void combine_step(
    int (&acc)[DEPTH][NC / 2], unsigned long long (&v)[NC / 2], uint32_t a,
    uint32_t a_plane, uint32_t b, uint32_t b_plane, const Mod& md) {
  constexpr int S = GROUPS - 1 - P;
  constexpr int LAST = P + DEPTH - 1 < GROUPS - 1 ? P + DEPTH - 1 : GROUPS - 1;
  constexpr uint32_t SCALE = 1u << (8 * (S > 3 ? S - 4 : S));
  wgmma_wait<LAST - P>();
#pragma unroll
  for (int e = 0; e < NC / 2; ++e) fence_operand(acc[P % DEPTH][e]);
#pragma unroll
  for (int e = 0; e < NC / 2; ++e) {
    const unsigned long long t =
        static_cast<unsigned long long>(
            static_cast<uint32_t>(acc[P % DEPTH][e])) *
        SCALE;
    if constexpr (P == 0) v[e] = t; else v[e] += t;
    if constexpr (S == 4) {
      // hi = h1 2^32 + h0 (h1 < 2^10): 2^32 hi is congruent to
      // h1 (2^64 mod q) + h0 (2^32 mod q), each in [0, 2q)
      const uint32_t h0 = static_cast<uint32_t>(v[e]);
      const uint32_t h1 = static_cast<uint32_t>(v[e] >> 32);
      v[e] = static_cast<unsigned long long>(shoup_lazy(h0, md.c32, md.q)) +
             shoup_lazy(h1, md.c64, md.q);
    }
  }
  if constexpr (P + DEPTH < GROUPS)
    issue_group<NC, ROW, S - DEPTH>(acc[P % DEPTH], a, a_plane, b, b_plane);
}

// One product of the warpgroup's 64 rows: r[ch][e] = (A @ B^T)[row, col]
// mod q, canonical, for every chunk of NC output columns (the accumulator
// fragment map below).  a, b: shared addresses of plane 0 of the
// warpgroup's A rows and of the B tile; a_plane, b_plane: bytes a plane.
template <int NC, int NCH, int ROW>
__device__ __forceinline__ void product(uint32_t (&r)[NCH][NC / 2],
                                        uint32_t a, uint32_t a_plane,
                                        uint32_t b, uint32_t b_plane,
                                        const Mod& md) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const uint32_t bc = b + ch * NC * ROW;
    int acc[DEPTH][NC / 2];
    unsigned long long v[NC / 2];
#pragma unroll
    for (int k = 0; k < DEPTH; ++k)
#pragma unroll
      for (int e = 0; e < NC / 2; ++e) acc[k][e] = 0;
    static_assert(DEPTH == 2, "the first DEPTH groups are issued here");
    issue_group<NC, ROW, 6>(acc[0], a, a_plane, bc, b_plane);
    issue_group<NC, ROW, 5>(acc[1], a, a_plane, bc, b_plane);
    combine_step<NC, ROW, 0>(acc, v, a, a_plane, bc, b_plane, md);
    combine_step<NC, ROW, 1>(acc, v, a, a_plane, bc, b_plane, md);
    combine_step<NC, ROW, 2>(acc, v, a, a_plane, bc, b_plane, md);
    combine_step<NC, ROW, 3>(acc, v, a, a_plane, bc, b_plane, md);
    combine_step<NC, ROW, 4>(acc, v, a, a_plane, bc, b_plane, md);
    combine_step<NC, ROW, 5>(acc, v, a, a_plane, bc, b_plane, md);
    combine_step<NC, ROW, 6>(acc, v, a, a_plane, bc, b_plane, md);
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) r[ch][e] = reduce64(v[e], md);
  }
}

// Accumulator fragment of m64nNk32: register e of a thread holds row
// 16 * warp + lane / 4 + 8 * ((e >> 1) & 1) of the warpgroup's 64 and
// column 8 * (e >> 2) + 2 * (lane % 4) + (e & 1) of the chunk.
__device__ __forceinline__ int frag_row(int warp, int lane, int e) {
  return 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int lane, int e) {
  return 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
}

// The row [N2][N1] split into the data planes as the B operand of the left
// product: rows i1, K = i2 bytes (the transpose u8 wgmma needs).  A warp
// item is 8 columns i1 x 16 rows i2: lane & 7 a column, lane >> 3 four
// rows i2 (four 32-byte sectors a load), one u32 a plane stored
// (conflict-free under the swizzle).
template <int LOGN>
__device__ __forceinline__ void split_transposed(
    const uint32_t* __restrict__ src, uint8_t* d) {
  using R = Ring<LOGN>;
  constexpr int IC = (R::N1 + 7) / 8, ITEMS = IC * ((R::N2 + 15) / 16);
  constexpr int WARPS = R::THREADS / 32, U = 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int it0 = warp; it0 < ITEMS; it0 += U * WARPS) {
    uint32_t v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = it0 + u * WARPS;
      const int i1 = (it % IC) * 8 + (lane & 7);
      const int i2 = (it / IC) * 16 + (lane >> 3) * 4;
      const bool ok = it < ITEMS && i1 < R::N1 && i2 < R::N2;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = (i2 + t) * R::N1 + i1;
        v[u][t] = ok ? __ldg(src + i) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = it0 + u * WARPS;
      const int i1 = (it % IC) * 8 + (lane & 7);
      const int i2 = (it / IC) * 16 + (lane >> 3) * 4;
      if (it >= ITEMS || i1 >= R::N1 || i2 >= R::N2) continue;
      uint32_t pl[4];
      byte_planes(v[u], pl);
      const uint32_t at = swz<R::ROW_L>(i1, i2);
#pragma unroll
      for (int j = 0; j < PLANES; ++j)
        *reinterpret_cast<uint32_t*>(d + j * R::NP * R::ROW_L + at) = pl[j];
    }
  }
}

// The row [N2][N1] split into the data planes as the A operand of the
// right product: rows a, K = j1 bytes, the natural layout.  A thread takes
// four neighbouring values (one 16-byte load) and stores one u32 a plane.
template <int LOGN>
__device__ __forceinline__ void split_natural(const uint32_t* __restrict__ src,
                                              uint8_t* d) {
  using R = Ring<LOGN>;
  constexpr int W4 = R::N1 / 4, WORDS = R::N / 4, U = 8;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  for (int w0 = threadIdx.x; w0 < WORDS; w0 += U * R::THREADS) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * R::THREADS;
      v[u] = w < WORDS ? __ldg(s4 + w) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * R::THREADS;
      if (w >= WORDS) continue;
      const uint32_t vals[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      uint32_t pl[4];
      byte_planes(vals, pl);
      const uint32_t at = swz<R::ROW_R>(w / W4, (w % W4) * 4);
#pragma unroll
      for (int j = 0; j < PLANES; ++j)
        *reinterpret_cast<uint32_t*>(d + j * R::MP * R::ROW_R + at) = pl[j];
    }
  }
}

// Runs body(ch, e, a, c) for each pair of accumulator registers (e, e + 1)
// of the thread that lies in the ring: row a < N2, columns c, c + 1 < N1.
template <int LOGN, typename F>
__device__ __forceinline__ void each_pair(int g, int warp, int lane, F body) {
  using R = Ring<LOGN>;
#pragma unroll
  for (int ch = 0; ch < R::NCH; ++ch)
#pragma unroll
    for (int e = 0; e < R::NC / 2; e += 2) {
      const int a = 64 * (g % R::MT) + frag_row(warp, lane, e);
      const int c = ((g / R::MT) * R::NCH + ch) * R::NC + frag_col(lane, e);
      if (a < R::N2 && c < R::N1) body(ch, e, a, c);
    }
}

// r[a, c] *= t[a * N1 + c] mod q for the thread's pairs in the ring: every
// table load first (one round trip to memory), then the Shoup products.
template <int LOGN>
__device__ __forceinline__ void scale_pairs(
    uint32_t (&r)[Ring<LOGN>::NCH][Ring<LOGN>::NC / 2],
    const uint2* __restrict__ t, int g, int warp, int lane, uint32_t q) {
  using R = Ring<LOGN>;
  uint4 w[R::NCH][R::NC / 4];
  each_pair<LOGN>(g, warp, lane, [&](int ch, int e, int a, int c) {
    w[ch][e / 2] = __ldg(reinterpret_cast<const uint4*>(t + a * R::N1 + c));
  });
  each_pair<LOGN>(g, warp, lane, [&](int ch, int e, int a, int c) {
    r[ch][e] = shoup(r[ch][e], make_uint2(w[ch][e / 2].x, w[ch][e / 2].y), q);
    r[ch][e + 1] =
        shoup(r[ch][e + 1], make_uint2(w[ch][e / 2].z, w[ch][e / 2].w), q);
  });
}

// One row: the split of src into the data planes (the DFT planes are in
// flight to wl and wr), the two products around the twiddles tmid, and the
// output into dst.
template <int LOGN, bool INV>
__device__ __forceinline__ void run_row(const uint32_t* __restrict__ src,
                                        uint32_t* __restrict__ dst,
                                        const uint2* __restrict__ tmid,
                                        const Mod& md, uint32_t wl,
                                        uint32_t wr, uint32_t ds, uint8_t* d) {
  using R = Ring<LOGN>;
  constexpr int NC = R::NC, NCH = R::NCH, ROW_L = R::ROW_L, ROW_R = R::ROW_R;
  if constexpr (!INV)
    split_transposed<LOGN>(src, d);
  else
    split_natural<LOGN>(src, d);
  copy_wait();
  fence_async_shared();
  __syncthreads();

  // warpgroup g: rows a from 64 * (g % MT), output columns from
  // (g / MT) * NCH * NC
  const int g = threadIdx.x / WG_THREADS;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const uint32_t am = (g % R::MT) * 64, bn = (g / R::MT) * NCH * NC;
  uint32_t r[NCH][NC / 2];
  if constexpr (!INV)  // Wa @ y: A = Wa planes, B = the data [NP][ROW_L]
    product<NC, NCH, ROW_L>(r, wl + am * ROW_L, R::MP * ROW_L,
                            ds + bn * ROW_L, R::NP * ROW_L, md);
  else                 // y . Wbi: A = the data [MP][ROW_R], B = Wbi planes
    product<NC, NCH, ROW_R>(r, ds + am * ROW_R, R::MP * ROW_R,
                            wr + bn * ROW_R, R::NP * ROW_R, md);
  // times tw' (forward) or twi' (inverse)
  scale_pairs<LOGN>(r, tmid, g, warp, lane, md.q);
  __syncthreads();  // every warpgroup's products have read the data planes
  if constexpr (!INV) {
    // natural: A of the right product, rows a, K = c; two bytes a plane
    each_pair<LOGN>(g, warp, lane, [&](int ch, int e, int a, int c) {
      const uint32_t at = swz<ROW_R>(a, c);
#pragma unroll
      for (int p = 0; p < PLANES; ++p)
        *reinterpret_cast<uint16_t*>(d + p * R::MP * ROW_R + at) =
            static_cast<uint16_t>(
                __byte_perm(r[ch][e], r[ch][e + 1], p | (p + 4) << 4));
    });
  } else {
    // transposed: B of the left product, rows c, K = a; a byte a plane
    each_pair<LOGN>(g, warp, lane, [&](int ch, int e, int a, int c) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const uint32_t at = swz<ROW_L>(c + b, a);
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
          d[p * R::NP * ROW_L + at] =
              static_cast<uint8_t>(r[ch][e + b] >> (8 * p));
      }
    });
  }
  fence_async_shared();
  __syncthreads();
  if constexpr (!INV)  // . Wb: A = the data [MP][ROW_R], B = Wb planes
    product<NC, NCH, ROW_R>(r, ds + am * ROW_R, R::MP * ROW_R,
                            wr + bn * ROW_R, R::NP * ROW_R, md);
  else                 // Wai @ .: A = Wai planes, B = the data [NP][ROW_L]
    product<NC, NCH, ROW_L>(r, wl + am * ROW_L, R::MP * ROW_L,
                            ds + bn * ROW_L, R::NP * ROW_L, md);
  each_pair<LOGN>(g, warp, lane, [&](int ch, int e, int a, int c) {
    *reinterpret_cast<uint2*>(dst + a * R::N1 + c) =
        make_uint2(r[ch][e], r[ch][e + 1]);
  });
}

// Block b of the grid takes row (b % B) * L + b / B, B = rows / L: the
// blocks of one limb are neighbours (their DFT planes hit the L2 cache).
template <int LOGN, bool INV>
__global__ void __launch_bounds__(Ring<LOGN>::THREADS, 1)
    matmul_ntt_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ y,
                      const uint4* __restrict__ limbs,    // [L][8] constants
                      const uint4* __restrict__ t_left,   // Wa' | Wai' planes
                      const uint2* __restrict__ t_mid,    // tw' | twi'
                      const uint4* __restrict__ t_right,  // Wb | Wbi planes
                      long long batches, int L) {
  using R = Ring<LOGN>;
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on a 1024-byte boundary (a swizzle atom is 8 rows)
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t wl = (raw + 1023u) & ~1023u;
  const uint32_t wr = wl + R::WL_BYTES;
  const uint32_t ds = wr + R::WR_BYTES;

  const int limb = static_cast<int>(blockIdx.x / batches);
  const size_t row = static_cast<size_t>(blockIdx.x % batches) * L + limb;
  const Mod md = load_mod(limbs + 2 * limb);
  {
    const uint4* src = t_left + static_cast<size_t>(limb) * (R::WL_BYTES / 16);
    for (int i = threadIdx.x; i < R::WL_BYTES / 16; i += R::THREADS)
      copy16(wl + 16 * i, src + i);
    src = t_right + static_cast<size_t>(limb) * (R::WR_BYTES / 16);
    for (int i = threadIdx.x; i < R::WR_BYTES / 16; i += R::THREADS)
      copy16(wr + 16 * i, src + i);
  }
  run_row<LOGN, INV>(x + row * R::N, y + row * R::N,
                     t_mid + static_cast<size_t>(limb) * R::N, md, wl, wr, ds,
                     smem_raw + (ds - raw));
}

// The dynamic shared-memory allowance, once per instance and device.
template <int LOGN, bool INV>
cudaError_t ready() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(matmul_ntt_kernel<LOGN, INV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Ring<LOGN>::SMEM));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int LOGN, bool INV>
cudaError_t launch(const void* x, void* y, const void* limbs,
                   const void* t_left, const void* t_mid, const void* t_right,
                   long long rows, int L, cudaStream_t stream) {
  using R = Ring<LOGN>;
  cudaError_t err = ready<LOGN, INV>();
  if (err != cudaSuccess) return err;
  matmul_ntt_kernel<LOGN, INV>
      <<<static_cast<unsigned>(rows), R::THREADS, R::SMEM, stream>>>(
          static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
          static_cast<const uint4*>(limbs), static_cast<const uint4*>(t_left),
          static_cast<const uint2*>(t_mid),
          static_cast<const uint4*>(t_right), rows / L, L);
  return cudaGetLastError();
}

template <int LOGN, bool INV>
int describe(int* out) {
  using R = Ring<LOGN>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, matmul_ntt_kernel<LOGN, INV>);
  if (err == cudaSuccess) err = ready<LOGN, INV>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, matmul_ntt_kernel<LOGN, INV>, R::THREADS, R::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = R::THREADS;
  out[3] = static_cast<int>(R::SMEM);
  out[4] = blocks;
  return 0;
}

// log2 N of (N1, N2) as split4 makes them, or -1.
int ring_log(int N1, int N2) {
  for (int logn = 4; logn <= 14; ++logn)
    if (N1 == (1 << (logn - (logn + 1) / 2)) && N2 == (1 << ((logn + 1) / 2)))
      return logn;
  return -1;
}

#define MM_EACH_LOGN(F) \
  F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12) F(13) F(14)

template <bool INV>
int dispatch(const void* x, void* y, const void* limbs, const void* t_left,
             const void* t_mid, const void* t_right, long long rows, int L,
             int N1, int N2, void* stream) {
  if (L <= 0 || rows <= 0 || rows % L != 0 || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (ring_log(N1, N2)) {
#define MM_CASE(logn)                                                      \
  case logn:                                                               \
    return static_cast<int>(launch<logn, INV>(x, y, limbs, t_left, t_mid, \
                                              t_right, rows, L, st));
    MM_EACH_LOGN(MM_CASE)
#undef MM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns the cudaError_t of the launch.
// (N1, N2) is split4 of a ring from 16 to 16384.  limbs, the DFT planes
// (wa / wai, wb / wbi) and the twiddles tw / twi are the tables of
// `host_tables` (limbs, wa_planes, tw_fold, wb_planes and their inverse
// counterparts), with the twist psi^i of the forward and the factor
// psi^-i N^-1 of the inverse folded into the left planes and the
// twiddles; x, y and every table 16-byte aligned (the wrapper checks the
// rest).
extern "C" int matmul_ntt_forward(const void* x, void* y, const void* limbs,
                                  const void* wa, const void* tw,
                                  const void* wb, long long rows, int L,
                                  int N1, int N2, void* stream) {
  return dispatch<false>(x, y, limbs, wa, tw, wb, rows, L, N1, N2, stream);
}

extern "C" int matmul_ntt_inverse(const void* x, void* y, const void* limbs,
                                  const void* wai, const void* twi,
                                  const void* wbi, long long rows, int L,
                                  int N1, int N2, void* stream) {
  return dispatch<true>(x, y, limbs, wai, twi, wbi, rows, L, N1, N2, stream);
}

// Five ints into `out` for the instance of ring 2^logn (forward, or
// inverse if `inverse`) on the current device: registers and local
// (spilled) bytes a thread, threads and dynamic shared bytes of a block,
// resident blocks an SM.
extern "C" int matmul_ntt_kernel_info(int logn, int inverse, int* out) {
  switch (logn * 2 + (inverse ? 1 : 0)) {
#define MM_CASE(l)                                   \
  case 2 * l: return describe<l, false>(out);        \
  case 2 * l + 1: return describe<l, true>(out);
    MM_EACH_LOGN(MM_CASE)
#undef MM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* matmul_ntt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
