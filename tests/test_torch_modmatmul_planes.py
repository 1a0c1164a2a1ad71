"""A numpy replay of the arithmetic plan of the K4 kernel
(cryptonets_tpu_torch/kernels/modmatmul.cu), which runs only on the card:
the tiling (M padded to a wgmma width, O cut into chunks of kc), the split
of x into four u8 planes by `__byte_perm` and their swizzled shared-memory
stores, the operand tiles as the 128-byte-swizzle K-major descriptors
name them (k advancing 32 bytes a step), the s32 sums by shift group with
the 2**31 check, the Shoup fold into the canonical accumulators, and the
accumulator fragment map of the epilogue, all with the constants
`prepare_contract` makes.  Bit-equal to the JAX reference's
`exact_mod_contract`.  If the kernel's indices, selectors or layouts
change, change this replay with them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu.kernels.modmatmul import exact_mod_contract as j_contract  # noqa: E402
from cryptonets_tpu_torch.kernels import modmatmul as MM  # noqa: E402

PLANES, GROUPS = MM.PLANES, MM.GROUPS
M32 = (1 << 32) - 1
LANES = np.arange(32)


# ------------------------------------------------------ device primitives
def byte_perm(x, y, sel):
    """__byte_perm(x, y, sel) for selector nibbles 0-7."""
    src = [(x >> (8 * i)) & 255 for i in range(4)] + \
          [(y >> (8 * i)) & 255 for i in range(4)]
    r = np.zeros_like(x)
    for n in range(4):
        r |= src[(sel >> (4 * n)) & 7] << (8 * n)
    return r


def swz(row, kb, rb=128):
    """The kernel's `swz<rb>`: byte offset of (row, byte kb) in a plane
    tile of rows of rb bytes (128 or 32)."""
    return row * rb + ((((kb >> 4) ^ (row // (128 // rb))) & (rb // 16 - 1))
                       << 4) + (kb & 15)


def operand(smem, base, rows, ks, rb):
    """The [rows, 32] u8 tile a wgmma descriptor at `base` + 32 * ks bytes
    names: K-major rows of rb bytes under the rb-byte swizzle."""
    r = np.arange(rows)[:, None]
    kb = ks * 32 + np.arange(32)[None, :]
    return smem[base + swz(r, kb, rb)].astype(np.int64)


def fragment(nw):
    """(row, column) of accumulator register e of thread T of the
    warpgroup, for e < nw / 2: [128, nw / 2] arrays."""
    T = np.arange(128)[:, None]
    e = np.arange(nw // 2)[None, :]
    warp, lane = T // 32, T % 32
    row = 16 * warp + lane // 4 + 8 * ((e >> 1) & 1)
    col = 8 * (e >> 2) + 2 * (lane % 4) + (e & 1)
    return row, col


# ------------------------------------------------------------ the replay
def replay(wc, x, N, sums=None):
    """The kernel on x uint32 [P, O, inner] with prepared weights `wc`:
    block by block, as modmatmul.cu computes it.  `sums` collects the
    largest s32 group sum seen."""
    P, O, inner = x.shape
    k = len(wc.q)
    nw, mt, kc, chunks = wc.nw, wc.mt, wc.kc, wc.chunks
    planes = wc.planes.numpy()
    fold = wc.fold.numpy().view(np.uint32).astype(np.uint64)
    mods = wc.mods.numpy().view(np.uint32).astype(np.uint64)
    tile = MM.TILE                                # one warpgroup a block
    assert N >= tile
    rb = MM.row_bytes(kc)
    xs0, ws0 = 0, PLANES * tile * rb
    out = np.zeros((P, wc.M, inner), np.uint64)
    row, col = fragment(nw)
    for p in range(P):
        for bx in range(inner // tile * mt):
            mti, j0 = bx % mt, bx // mt * tile
            limb = (j0 // N) % k
            q = mods[limb]
            canon = np.zeros((tile, nw), np.uint64)
            for c in range(chunks):
                o0 = c * kc
                smem = np.zeros(ws0 + PLANES * nw * rb, np.uint8)
                smem[ws0:] = planes[limb, mti, c].reshape(-1)
                pgroups = tile // 8
                for it in range(pgroups * (kc // 16)):
                    pos = (it % pgroups) * 8 + (LANES & 7)
                    kb = ((it // pgroups) * 4 + (LANES >> 3)) * 4
                    v = [np.where(o0 + kb + t < O,
                                  x[p, np.minimum(o0 + kb + t, O - 1), j0 + pos],
                                  0).astype(np.uint64) for t in range(4)]
                    ab_lo = byte_perm(v[0], v[1], 0x5140)
                    ab_hi = byte_perm(v[0], v[1], 0x7362)
                    cd_lo = byte_perm(v[2], v[3], 0x5140)
                    cd_hi = byte_perm(v[2], v[3], 0x7362)
                    pl = [byte_perm(ab_lo, cd_lo, 0x5410),
                          byte_perm(ab_lo, cd_lo, 0x7632),
                          byte_perm(ab_hi, cd_hi, 0x5410),
                          byte_perm(ab_hi, cd_hi, 0x7632)]
                    at = swz(pos, kb, rb)
                    for j in range(PLANES):
                        dst = xs0 + j * tile * rb + at
                        for e in range(4):
                            smem[dst + e] = (pl[j] >> (8 * e)) & 255
                for s in range(GROUPS):
                    acc = np.zeros((tile, nw), np.int64)
                    for i in range(max(0, s - 3), min(s, 3) + 1):
                        for ks in range(kc // 32):
                            A = operand(smem, xs0 + (s - i) * tile * rb, tile,
                                        ks, rb)
                            B = operand(smem, ws0 + i * nw * rb, nw, ks, rb)
                            acc += A @ B.T
                    assert acc.min() >= 0 and acc.max() < 1 << 31
                    if sums is not None:
                        sums.append(int(acc.max()))
                    # the fold, register by register of the fragment
                    cs, csh = fold[limb, s]
                    av = acc[row, col].astype(np.uint64)
                    t = (av * cs - ((av * csh) >> 32) * q) & M32
                    t = np.minimum(t, (t - q) & M32)
                    u = canon[row, col] + t
                    canon[row, col] = np.minimum(u, (u - q) & M32)
            m = mti * nw + col
            keep = m < wc.M
            out[p, m[keep], j0 + row[keep]] = canon[row, col][keep]
    return out.astype(np.uint32)


def _case(M, O, k, N, P, seed, worst=False):
    rng = np.random.default_rng(seed)
    qs = ntt_primes(N, 31, k)
    if worst:
        W = np.full((M, O), -1, np.int64)          # q - 1 in every limb
        x = np.stack([np.full((P, O, 1, 2, N), q - 1) for q in qs], axis=-2)
    else:
        W = rng.integers(-(1 << 62), 1 << 62, size=(M, O))
        x = np.stack([rng.integers(0, q, size=(P, O, 1, 2, N)) for q in qs],
                     axis=-2)
    return qs, W, x.astype(np.uint32)


def _reference(W, x, qs):
    return np.asarray(j_contract(
        W, jnp.asarray(x), qs,
        jnp.asarray(np.array(qs, np.uint32).reshape(-1, 1))))


@pytest.mark.parametrize("M,O,k,N,P", [
    (5, 25, 2, 128, 1),       # LoLa's conv shape: width 8, one short chunk
    (13, 1, 2, 64, 2),        # O = 1; ragged M in width 16
    (3, 129, 1, 64, 1),       # O just above one chunk of 128
    (70, 40, 1, 64, 1),       # width 112, 42 outputs of padding
    (120, 140, 2, 128, 1),    # two tiles of m (mt = 2, width 64), two chunks
])
def test_replay_bit_equal_to_reference(M, O, k, N, P):
    qs, W, x = _case(M, O, k, N, P, seed=M * 100 + O)
    want = _reference(W, x, qs)
    wc = MM.prepare_contract(W, qs, "cpu")
    got = replay(wc, x.reshape(P, O, -1), N).reshape(want.shape)
    np.testing.assert_array_equal(got, want)


def test_replay_worst_case_sums_stay_below_2_31():
    """Every weight and every residue q - 1 over a full chunk of 128: the
    group sums are the largest the data allows and stay exact in s32; the
    chunk limit KF_MAX is the largest with 4 * 255**2 * KF < 2**31."""
    M, O, k, N, P = 8, 128, 1, 64, 1
    qs, W, x = _case(M, O, k, N, P, seed=0, worst=True)
    sums = []
    wc = MM.prepare_contract(W, qs, "cpu")
    assert (wc.kc, wc.chunks) == (MM.KC_MAX, 1)
    got = replay(wc, x.reshape(P, O, -1), N, sums)
    np.testing.assert_array_equal(got.reshape(_reference(W, x, qs).shape),
                                  _reference(W, x, qs))
    q = qs[0]
    b = [((q - 1) >> (8 * i)) & 255 for i in range(4)]
    assert max(sums) == 128 * max(sum(b[i] * b[s - i] for i in range(4)
                                      if 0 <= s - i < 4) for s in range(7))
    assert max(sums) < 1 << 31
    assert MM.KF_MAX == 8256
    assert 4 * 255**2 * MM.KF_MAX < 2**31 <= 4 * 255**2 * (MM.KF_MAX + 1)
    assert MM.KC_MAX <= MM.KF_MAX


def test_prepare_contract_planes_and_constants():
    """prepare_contract on the CPU returns what the replay reads: the
    reduced weights, the four byte planes (zero past M and O) in the
    swizzled layout, 2**(8s) mod q with Shoup companions, the moduli."""
    rng = np.random.default_rng(4)
    qs = ntt_primes(64, 31, 3)
    M, O = 13, 150
    W = rng.integers(-(1 << 62), 1 << 62, size=(M, O))
    wc = MM.prepare_contract(W, qs, "cpu")
    assert (wc.nw, wc.mt, wc.kc, wc.chunks) == (16, 1, 128, 2)
    red = MM.reduce_weights(W, qs)
    np.testing.assert_array_equal(wc.reduced.numpy(), red)
    planes = wc.planes.numpy()
    assert planes.shape == (3, 1, 2, 4, 16, 128) and planes.dtype == np.uint8
    for li, q in enumerate(qs):
        for m in range(16):
            for o in range(2 * 128):
                c, kb = divmod(o, 128)
                v = int(red[m, o, li]) if m < M and o < O else 0
                got = planes[li, 0, c, :, m, ((kb >> 4) ^ (m & 7)) * 16 + (kb & 15)]
                assert list(got) == [(v >> (8 * i)) & 255 for i in range(4)]
        f = wc.fold.numpy().view(np.uint32)[li]
        for s in range(7):
            c = pow(2, 8 * s, q)
            assert (int(f[s, 0]), int(f[s, 1])) == (c, (c << 32) // q)
    assert list(wc.mods.numpy().view(np.uint32)) == list(qs)


@pytest.mark.parametrize("M,O,want", [
    (1, 1, (8, 1, 32, 1)), (5, 25, (8, 1, 32, 1)), (8, 32, (8, 1, 32, 1)),
    (10, 100, (16, 1, 128, 1)), (100, 845, (112, 1, 128, 7)),
    (113, 33, (64, 2, 64, 1)), (257, 129, (112, 3, 128, 2)),
    (64, 8257, (64, 1, 128, 65)),
])
def test_tiling_rule(M, O, want):
    """M pads to mt tiles of one wgmma width each (the fewest tiles of at
    most 112, then the narrowest width); O cuts into chunks of kc (a
    multiple of 32, <= 128)."""
    nw, mt, kc, chunks = MM.tiling(M, O)
    assert (nw, mt, kc, chunks) == want
    assert nw in MM.WIDTHS and nw * mt >= M and mt == -(-M // MM.WIDTHS[-1])
    assert kc % 32 == 0 and kc * chunks >= O > kc * (chunks - 1)


def test_fragment_map_covers_the_tile():
    """The epilogue's register map is a bijection of the warpgroup's
    registers onto the 64 x nw accumulator tile, for every width."""
    for nw in MM.WIDTHS:
        row, col = fragment(nw)
        cells = row * nw + col
        assert row.max() == MM.TILE - 1 and col.max() == nw - 1
        assert np.array_equal(np.sort(cells.ravel()), np.arange(MM.TILE * nw))


def test_byte_transpose_selectors():
    """The four __byte_perm pairs give plane j = byte j of four values."""
    rng = np.random.default_rng(1)
    v = rng.integers(0, 1 << 32, size=(4, 64), dtype=np.uint64)
    ab_lo, ab_hi = byte_perm(v[0], v[1], 0x5140), byte_perm(v[0], v[1], 0x7362)
    cd_lo, cd_hi = byte_perm(v[2], v[3], 0x5140), byte_perm(v[2], v[3], 0x7362)
    pl = [byte_perm(ab_lo, cd_lo, 0x5410), byte_perm(ab_lo, cd_lo, 0x7632),
          byte_perm(ab_hi, cd_hi, 0x5410), byte_perm(ab_hi, cd_hi, 0x7632)]
    for j in range(4):
        want = sum(((v[t] >> (8 * j)) & 255) << (8 * t) for t in range(4))
        np.testing.assert_array_equal(pl[j], want)


@pytest.mark.parametrize("rb", [128, 32])
def test_shared_layout_is_the_descriptor_swizzle(rb):
    """The plane tiles are K-major rows of rb bytes under the rb-byte
    swizzle the wgmma descriptors name (address bits 4-6 XOR bits 7-9 for
    128, bit 4 XOR bit 7 for 32, in an aligned tile), the layout
    `prepare_contract` makes; and a warp's plane stores (8 positions x 4
    words) fall in distinct banks."""
    r = np.arange(64)[:, None]
    kb = np.arange(rb)[None, :]
    lin = r * rb + kb
    mask = 7 if rb == 128 else 1
    np.testing.assert_array_equal(swz(r, kb, rb), lin ^ (((lin >> 7) & mask) << 4))
    np.testing.assert_array_equal(MM.swizzle(64, rb) + r * rb, swz(r, kb, rb))
    for qg in range(rb // 16):
        pos = LANES & 7
        kb = (qg * 4 + (LANES >> 3)) * 4
        assert len(set((swz(pos + 16, kb, rb) // 4 % 32).tolist())) == 32
