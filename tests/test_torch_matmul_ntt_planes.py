"""A numpy replay of the arithmetic plan of the K5 kernel
(cryptonets_tpu_torch/kernels/matmul_ntt.cu), which runs only on the card:
one block a row, the DFT planes that `host_tables` prepares (the twist
and the inverse's psi**-i N**-1 folded into them and into the twiddles)
copied into shared memory, the transposed u8 split of the row
(`__byte_perm`, swizzled stores), the natural split, the operand tiles as
the K-major swizzled wgmma descriptors name them (k advancing 32 bytes a
step), the 16 plane-pair products in 7 shift groups with their s32 check,
the exact combine (hi folded by two Shoup products first, then lo) and
its final reduction, the twiddles, the second split, and the accumulator
fragment map of the epilogues, for the forward and the inverse
transform.  The
shared memory starts as random bytes, as on the card: what the kernel
does not write must not matter.  Bit-equal to the plain versions, which
`tests/test_torch_matmul_ntt.py` holds bit-equal to the JAX reference.
If the kernel's indices, selectors or layouts change, change this replay
with them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu_torch.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.kernels import matmul_ntt as M  # noqa: E402

PLANES, GROUPS = 4, 7
U64 = np.uint64
M32 = U64((1 << 32) - 1)
LANES = np.arange(32)
PAIRS = [sum(1 for i in range(4) if 0 <= s - i < 4) for s in range(GROUPS)]


# ------------------------------------------------------ device primitives
def byte_perm(x, y, sel):
    """__byte_perm(x, y, sel) for selector nibbles 0-7."""
    src = [(x >> U64(8 * i)) & U64(255) for i in range(4)] + \
          [(y >> U64(8 * i)) & U64(255) for i in range(4)]
    r = np.zeros_like(x)
    for n in range(4):
        r |= src[(sel >> (4 * n)) & 7] << U64(8 * n)
    return r


def byte_planes(v):
    """The kernel's `byte_planes`: word j holds byte j of v[0..3]."""
    ab_lo, ab_hi = byte_perm(v[0], v[1], 0x5140), byte_perm(v[0], v[1], 0x7362)
    cd_lo, cd_hi = byte_perm(v[2], v[3], 0x5140), byte_perm(v[2], v[3], 0x7362)
    return [byte_perm(ab_lo, cd_lo, 0x5410), byte_perm(ab_lo, cd_lo, 0x7632),
            byte_perm(ab_hi, cd_hi, 0x5410), byte_perm(ab_hi, cd_hi, 0x7632)]


def swz(row, kb, rb):
    """`swz<rb>` of u8mma.cuh: byte offset of (row, byte kb) in a plane
    tile of rows of rb bytes (128, 64 or 32)."""
    return row * rb + ((((kb >> 4) ^ (row // (128 // rb))) & (rb // 16 - 1))
                       << 4) + (kb & 15)


def operand(smem, base, rows, ks, rb):
    """The [rows, 32] u8 tile a wgmma descriptor at `base` + 32 * ks bytes
    names: K-major rows of rb bytes under the rb-byte swizzle."""
    r = np.arange(rows)[:, None]
    kb = ks * 32 + np.arange(32)[None, :]
    return smem[base + swz(r, kb, rb)].astype(np.float64)



def shoup_lazy(x, w, wsh, q):
    return (x * w - ((x * wsh) >> U64(32)) * q) & M32


def canon(x, q):
    """`canon`: min(x, x - q) in u32."""
    return np.minimum(x, (x - q) & M32)


def shoup(x, w, wsh, q):
    return canon(shoup_lazy(x, w, wsh, q), q)


def reduce64(v, md):
    """`reduce64`: v mod q from v1 (2**32 mod q) + v0 * 1."""
    q = md["q"]
    t = canon(shoup_lazy(v >> U64(32), *md["c32"], q), q)
    r = canon(shoup_lazy(v & M32, U64(1), md["one"], q), q)
    return canon(t + r, q)


def load_mod(row):
    """`load_mod`: the limb's constants from its row of the table."""
    row = row.astype(np.uint64)
    return dict(q=row[0], c32=(row[1], row[2]), c64=(row[3], row[4]),
                one=row[5])


def frag(nc, wg):
    """(warpgroup, row within its 64, column, register) of every even
    accumulator register e of every thread, as `frag_row` / `frag_col`
    give them: the first of each pair (e, e + 1)."""
    T = np.arange(128 * wg)[:, None]
    e = np.arange(0, nc // 2, 2)[None, :]
    warp, lane = (T // 32) % 4, T % 32
    row = 16 * warp + lane // 4 + 8 * ((e >> 1) & 1)
    col = 8 * (e >> 2) + 2 * (lane % 4) + (e & 1)
    g = np.broadcast_to(T // 128, row.shape)
    return g.ravel(), row.ravel(), col.ravel()


# ------------------------------------------------------------ the replay
class Block:
    """One block of the kernel on one row of ring n."""

    def __init__(self, n, seed):
        self.n = n
        geo = self.geo = M.geometry(n)
        self.nc, self.nch = geo.nc, geo.nch
        self.wl_bytes = PLANES * geo.mp * geo.row_l
        self.wr_bytes = PLANES * geo.np_ * geo.row_r
        d_bytes = max(PLANES * geo.mp * geo.row_r, PLANES * geo.np_ * geo.row_l)
        # shared memory as the kernel finds it: whatever was there before
        self.smem = np.random.default_rng(seed).integers(
            0, 256, self.wl_bytes + self.wr_bytes + d_bytes, dtype=np.uint8)
        self.wl, self.wr = 0, self.wl_bytes
        self.ds = self.wl_bytes + self.wr_bytes
        self.stats = dict(group=0, hi=0, lo=0)

    def put(self, at, word):
        """A u32 store of `word` (uint64 array) at byte offsets `at`."""
        for e in range(4):
            self.smem[at + e] = (word >> U64(8 * e)) & U64(255)

    def split_transposed(self, x):
        g = self.geo
        ic = -(-g.n1 // 8)
        for it in range(ic * -(-g.n2 // 16)):
            i1 = (it % ic) * 8 + (LANES & 7)
            i2 = (it // ic) * 16 + (LANES >> 3) * 4
            ok = (i1 < g.n1) & (i2 < g.n2)
            i1, i2 = i1[ok], i2[ok]
            v = [x[(i2 + t) * g.n1 + i1] for t in range(4)]
            at = swz(i1, i2, g.row_l)
            for j, word in enumerate(byte_planes(v)):
                self.put(self.ds + j * g.np_ * g.row_l + at, word)

    def split_natural(self, x):
        g = self.geo
        w = np.arange(self.n // 4)
        v = [x[4 * w + t] for t in range(4)]
        at = swz(w // (g.n1 // 4), (w % (g.n1 // 4)) * 4, g.row_r)
        for j, word in enumerate(byte_planes(v)):
            self.put(self.ds + j * g.mp * g.row_r + at, word)

    def product(self, a, a_plane, b, b_plane, rb, md):
        """`product` for every warpgroup: [mp, np_] canonical (rows a,
        output columns)."""
        g = self.geo
        out = np.zeros((g.mp, g.np_), np.uint64)
        for wg in range(g.wg):
            am, bn = (wg % g.mt) * 64, (wg // g.mt) * self.nch * self.nc
            ag = a + am * rb
            for ch in range(self.nch):
                c0 = bn + ch * self.nc
                bc = b + c0 * rb
                valid = ((am + np.arange(64)[:, None] < g.n2)
                         & (c0 + np.arange(self.nc)[None, :] < g.n1))
                v = None
                for p in range(GROUPS):
                    s = GROUPS - 1 - p
                    acc = np.zeros((64, self.nc))
                    for i in range(max(0, s - 3), min(s, 3) + 1):
                        for ks in range(rb // 32):
                            A = operand(self.smem, ag + i * a_plane, 64, ks, rb)
                            B = operand(self.smem, bc + (s - i) * b_plane,
                                        self.nc, ks, rb)
                            acc += A @ B.T      # exact: below 2**53
                    acc = acc.astype(np.int64)
                    assert acc.min() >= 0 and acc.max() < 1 << 31  # s32
                    self.stats["group"] = max(self.stats["group"],
                                              int(acc[valid].max()))
                    t = acc.astype(np.uint64) * U64(1 << (8 * (s - 4 if s > 3 else s)))
                    v = t if p == 0 else v + t
                    if s == 4:
                        self.stats["hi"] = max(self.stats["hi"], int(v[valid].max()))
                        v = (shoup_lazy(v & M32, *md["c32"], md["q"])
                             + shoup_lazy(v >> U64(32), *md["c64"], md["q"]))
                self.stats["lo"] = max(self.stats["lo"], int(v[valid].max()))
                out[am:am + 64, c0:c0 + self.nc] = reduce64(v, md)
        return out

    def pairs(self):
        """`each_pair`: (a, c) of the first register of every pair inside
        the ring, every warpgroup and chunk."""
        g = self.geo
        wg, row, col = frag(self.nc, g.wg)
        out = []
        for ch in range(self.nch):
            a = 64 * (wg % g.mt) + row
            c = ((wg // g.mt) * self.nch + ch) * self.nc + col
            ok = (a < g.n2) & (c < g.n1)
            out.append((a[ok], c[ok]))
        return [np.concatenate(z) for z in zip(*out)]

    def run(self, x, tab, limb, inverse):
        g = self.geo
        md = load_mod(_u32(tab.limbs)[limb])
        Q = md["q"]
        left = (tab.wai_planes if inverse else tab.wa_planes)[limb].numpy()
        right = (tab.wbi_planes if inverse else tab.wb_planes)[limb].numpy()
        self.smem[self.wl:self.wr] = left.reshape(-1)
        self.smem[self.wr:self.ds] = right.reshape(-1)
        mid = _u32(tab.twi_fold if inverse else tab.tw_fold)[limb].astype(np.uint64)
        x = x.astype(np.uint64)
        lprod = (self.wl, g.mp * g.row_l, self.ds, g.np_ * g.row_l, g.row_l)
        rprod = (self.ds, g.mp * g.row_r, self.wr, g.np_ * g.row_r, g.row_r)
        if not inverse:
            self.split_transposed(x)
            r = self.product(*lprod, md)
        else:
            self.split_natural(x)
            r = self.product(*rprod, md)
        a, c = self.pairs()
        for b in range(2):
            i = a * g.n1 + c + b
            r[a, c + b] = shoup(r[a, c + b], mid[i, 0], mid[i, 1], Q)
        r0, r1 = r[a, c], r[a, c + 1]
        if not inverse:   # natural: rows a, K = c, two bytes a plane
            at = swz(a, c, g.row_r)
            for p in range(PLANES):
                h = byte_perm(r0, r1, p | (p + 4) << 4)
                base = self.ds + p * g.mp * g.row_r + at
                self.smem[base] = h & U64(255)
                self.smem[base + 1] = (h >> U64(8)) & U64(255)
            r = self.product(*rprod, md)
        else:             # transposed: rows c, K = a, a byte a plane
            for b, rv in enumerate((r0, r1)):
                at = swz(c + b, a, g.row_l)
                for p in range(PLANES):
                    self.smem[self.ds + p * g.np_ * g.row_l + at] = \
                        (rv >> U64(8 * p)) & U64(255)
            r = self.product(*lprod, md)
        y = np.zeros(self.n, np.uint64)
        for b in range(2):
            y[a * g.n1 + c + b] = r[a, c + b]
        return y


def _u32(t):
    return t.numpy().view(np.uint32)


def replay(x, tab, inverse, stats=None):
    """The kernel on x uint32 [rows, L, n], one block a row."""
    rows, L, n = x.shape
    y = np.zeros_like(x)
    for r in range(rows):
        for limb in range(L):
            blk = Block(n, seed=r * L + limb)
            y[r, limb] = blk.run(x[r, limb], tab, limb, inverse)
            if stats is not None:
                for k, v in blk.stats.items():
                    stats[k] = max(stats.get(k, 0), v)
    return y.astype(np.uint32)


def _inputs(n, L, rows, kind, seed):
    mods = ntt_primes(n, 31, L)
    q = np.array(mods, np.uint64).reshape(1, -1, 1)
    if kind == "q-1":
        return mods, np.broadcast_to(q - 1, (rows, L, n)).astype(np.uint32)
    rng = np.random.default_rng(seed)
    return mods, (rng.integers(0, 1 << 31, (rows, L, n), dtype=np.uint64)
                  % q).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("kind", ["random", "q-1"])
@pytest.mark.parametrize("n,L,rows", [(16, 2, 2), (64, 2, 1), (512, 1, 2),
                                      (4096, 1, 1), (8192, 1, 1),
                                      (16384, 1, 1)])
def test_replay_bit_equal_to_plain(n, L, rows, kind):
    """Forward and inverse replays, every ring geometry: 4 x 4 (one
    warpgroup, N padded to 8, K to 32), 8 x 8, 16 x 32, 64 x 64 (64-byte
    rows), 64 x 128 (two warpgroups) and 128 x 128 (two chunks of output
    columns); random residues and every residue q - 1 at 31 bits."""
    mods, x = _inputs(n, L, rows, kind, seed=n + L)
    tab = M.host_tables(n, mods)
    want = _u32(M.matmul_ntt_forward_plain(_t(x), tab))
    np.testing.assert_array_equal(replay(x, tab, False), want)
    back = _u32(M.matmul_ntt_inverse_plain(_t(x), tab))
    np.testing.assert_array_equal(replay(x, tab, True), back)


def test_limb_constants():
    """The table `load_mod` reads: q and the Shoup pairs of 2**32 mod q,
    2**64 mod q and 1; and `reduce64` exact on the largest values, for
    31-bit primes and a small one."""
    mods = list(ntt_primes(64, 31, 3)) + [3]
    t = M.limb_constants(mods)
    for q, row in zip(mods, t):
        md = load_mod(row)
        c32, c64 = (1 << 32) % q, (1 << 64) % q
        assert [int(v) for v in (md["q"], *md["c32"], *md["c64"], md["one"])] == \
            [q, c32, (c32 << 32) // q, c64, (c64 << 32) // q, (1 << 32) // q]
        v = np.array([0, 1, q - 1, q, (1 << 52) - 1, (1 << 64) - 1,
                      2**51 + 12345, (q - 1) << 21], np.uint64)
        assert [int(r) for r in reduce64(v, md)] == [int(x) % q for x in v]


def test_worst_case_sums_and_combine_bounds():
    """The largest products K5 sees (K = 128 in both products, n = 16384)
    on every residue q - 1: the group sums stay exact in s32 and below
    2**25, hi below 2**42 and lo below 2**51, for any bytes."""
    mods, x = _inputs(16384, 1, 1, "q-1", 0)
    tab = M.host_tables(16384, mods)
    stats = {}
    np.testing.assert_array_equal(
        replay(x, tab, False, stats),
        _u32(M.matmul_ntt_forward_plain(_t(x), tab)))
    np.testing.assert_array_equal(
        replay(x, tab, True, stats),
        _u32(M.matmul_ntt_inverse_plain(_t(x), tab)))
    K, b = 128, 255 * 255
    group_max = [PAIRS[s] * K * b for s in range(GROUPS)]
    hi_max = sum(group_max[s] << (8 * (s - 4)) for s in (4, 5, 6))
    lo_max = 4 * max(mods) + sum(group_max[s] << (8 * s) for s in range(4))
    assert max(group_max) < 1 << 25 < 1 << 31
    assert hi_max < 1 << 42 and lo_max < 1 << 51
    assert 0 < stats["group"] <= max(group_max)
    assert 0 < stats["hi"] <= hi_max and 0 < stats["lo"] <= lo_max


def _folded(n, mods):
    """Wa', Wai', Wb^T, Wbi^T, tw', twi' from the reference's tables."""
    v = {k: w.astype(object) for k, w in M.host_values(n, mods).items()}
    N1, N2 = M.split4(n)
    q = np.array(mods, dtype=object).reshape(-1, 1, 1)
    pre, post = v["pre"][:, None, :], v["post"][:, None, :]
    return {
        "Wa": v["Wa"] * pre[..., ::N1] % q,
        "Wai": v["Wai"] * (post[..., ::N1] * n % q).transpose(0, 2, 1) % q,
        "Wb": v["Wb"].transpose(0, 2, 1), "Wbi": v["Wbi"].transpose(0, 2, 1),
        "tw": (v["tw"].reshape(-1, N2, N1) * pre[..., :N1] % q).reshape(len(mods), n),
        "twi": (v["twi"].reshape(-1, N2, N1) * post[..., :N1] % q).reshape(len(mods), n),
    }


@pytest.mark.parametrize("n", [16, 512, 8192, 16384])
def test_prepared_planes_recombine(n):
    """The DFT planes of `MatmulNTTTables` are the four byte planes of
    Wa' = Wa diag(psi**(N1 b)), Wai' = diag(psi**(-N1 a)) Wai (rows a,
    K = N2) and Wb^T, Wbi^T (rows = output columns, K = N1) in the
    swizzled layout, zero past the ring: unswizzled and summed they give
    the matrices back; tw_fold and twi_fold are tw psi**c and
    twi psi**-c N**-1, with their Shoup companions."""
    mods = ntt_primes(n, 31, 2)
    tab, geo = M.host_tables(n, mods), M.geometry(n)
    want = _folded(n, mods)
    for field, name in (("tw_fold", "tw"), ("twi_fold", "twi")):
        pairs = _u32(getattr(tab, field)).astype(object)
        np.testing.assert_array_equal(pairs[..., 0], want[name])
        np.testing.assert_array_equal(
            pairs[..., 1], (want[name] << 32) // np.array(mods, dtype=object)[:, None])
    for field, name, rows, rb in (("wa_planes", "Wa", geo.mp, geo.row_l),
                                  ("wai_planes", "Wai", geo.mp, geo.row_l),
                                  ("wb_planes", "Wb", geo.np_, geo.row_r),
                                  ("wbi_planes", "Wbi", geo.np_, geo.row_r)):
        planes = getattr(tab, field).numpy()
        assert planes.shape == (2, PLANES, rows, rb) and planes.dtype == np.uint8
        r = np.arange(rows)[:, None]
        kb = np.arange(rb)[None, :]
        logical = planes.reshape(2, PLANES, -1)[..., swz(r, kb, rb)]
        whole = sum(logical[:, p].astype(np.uint64) << U64(8 * p)
                    for p in range(PLANES))
        w = want[name]
        R, K = w.shape[1:]
        np.testing.assert_array_equal(whole[:, :R, :K], w.astype(np.uint64))
        assert not whole[:, R:].any() and not whole[:, :, K:].any()


@pytest.mark.parametrize("nc", [8, 16, 32])
def test_fragment_map_covers_the_tile(nc):
    """The register pairs of `each_pair` cover the 64 x nc accumulator
    tile of every warpgroup once."""
    for wg in (1, 2, 4):
        g, row, col = frag(nc, wg)
        cells = np.concatenate([g * 64 * nc + row * nc + col + b
                                for b in range(2)])
        assert np.array_equal(np.sort(cells), np.arange(wg * 64 * nc))


@pytest.mark.parametrize("rb", [128, 64, 32])
def test_swizzle_is_the_address_xor(rb):
    """`swz` is the rb-byte swizzle the wgmma descriptors name (layout
    types 1, 2, 3): address bits 4-6, 4-5 or 4 XOR bits 7-9, 7-8 or 7 in an
    aligned tile, and `modmatmul.swizzle`, which lays out the planes."""
    from cryptonets_tpu_torch.kernels.modmatmul import swizzle

    r = np.arange(64)[:, None]
    kb = np.arange(rb)[None, :]
    lin = r * rb + kb
    mask = {128: 7, 64: 3, 32: 1}[rb]
    np.testing.assert_array_equal(swz(r, kb, rb), lin ^ (((lin >> 7) & mask) << 4))
    np.testing.assert_array_equal(swizzle(64, rb) + r * rb, swz(r, kb, rb))


def test_geometry_and_shared_memory():
    """Every ring from 16 to 16384: the kernel's tiles (wgmma M = 64 a
    warpgroup, N a width the kernel has, K a whole number of k32 steps),
    at most four warpgroups a block, and a block's shared memory within
    the 227 KB a block may take."""
    for logn in range(4, 15):
        n = 1 << logn
        g = M.geometry(n)
        assert (g.n1, g.n2) == M.split4(n) and g.n1 * g.n2 == n
        assert g.mp == 64 * g.mt >= g.n2 and g.np_ >= g.n1
        assert g.nc in (8, 16, 32) and g.nc * g.cg * g.nch == g.np_
        assert 1 <= g.wg <= 4    # warpgroups a block
        assert g.row_l in (32, 64, 128) and g.row_l >= g.n2
        assert g.row_r in (32, 64, 128) and g.row_r >= g.n1
        smem = (PLANES * (g.mp * g.row_l + g.np_ * g.row_r)
                + PLANES * max(g.mp * g.row_r, g.np_ * g.row_l) + 1024)
        assert smem <= 232448

