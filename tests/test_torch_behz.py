"""The BEHZ multiply's kernels on the CPU (`kernels/bconv.py` `behz`, the
lift, floor and Shenoy-Kumaresan modes of K7 on the tables
`BFVParams._behz_tables` makes; `kernels/modmac.py` `ct_tensor`), where
each entry point runs its plain twin.

Each mode and the tensor product is held bit-equal to a composite of the
plain conversion and int64 passes written out below (`_composite_*`, with
separate q and Bsk transforms) at the chain lengths and plain moduli of
the `lola`, `cryptonets`, `cifar` and `cryptonets_bigt` presets on small
rings, under both NTTs; the kernels' own arithmetic (Shoup load scale,
the corrections folded into one REDC on the tables, the tensor kernel's
two REDCs) is replayed in numpy on those tables against the twins, with
edge residues, a limb-sharded rank's tables too; `square(a)` equals
`multiply(a, a.clone())`; the two Square call sites take the square path
for one operand and the general one for two; limb-sharded ranks (threads
of this process) gather their q limbs and run the same modes, their
product equal to one device's; the operators under `torch.func.vmap`
equal the loop over the records.  No JAX: one torch thread."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu_torch.api import matrix as tmatrix  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory  # noqa: E402
from cryptonets_tpu_torch.crypto import bfv as tbfv  # noqa: E402
from cryptonets_tpu_torch.crypto.bfv import BFV, BFVParams  # noqa: E402
from cryptonets_tpu_torch.crypto.modular import (  # noqa: E402
    add_mod, as_res, mul_const_mod, neg_mod, sub_mod, wide)
from cryptonets_tpu_torch.crypto.ntt import ntt_context_for  # noqa: E402
from cryptonets_tpu_torch.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.kernels import bconv, modmac  # noqa: E402
from cryptonets_tpu_torch.utils.opcount import OPS  # noqa: E402

N = 64
# (preset, data limbs, its first plain modulus)
PRESETS = [("lola", 7, 557057), ("cryptonets", 7, ntt_primes(8192, 30, 1)[0]),
           ("cifar", 13, ntt_primes(16384, 30, 1)[0]),
           ("cryptonets_bigt", 7, 549764251649)]
M32 = (1 << 32) - 1


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(k, t, ntt_impl="butterfly"):
    return BFVParams(N, t, ntt_primes(N, 31, k), ntt_impl=ntt_impl, device="cpu")


def _residues(gen, lead, mods):
    """int32 residues [*lead, L, N] in [0, q_l), with the edges: each row's
    coefficient 0 at 0 and 1 at q - 1, the first row at q - 1."""
    q = torch.tensor(mods, dtype=torch.int64).view(-1, 1)
    x = torch.randint(0, 1 << 62, (*lead, len(mods), N), generator=gen) % q
    x[..., 0] = 0
    x[..., 1] = q[:, 0] - 1
    x.view(-1, len(mods), N)[0] = q - 1
    return x.to(torch.int32)


# ------------------- the multiply as a composite of the plain conversion
def _composite_lift(p, x_q):
    cq, cb = p.chain_q, p.chain_bsk
    mt = p.m_tilde
    xt = mul_const_mod(x_q, p.mtilde_mod_q, cq.q)
    y = mul_const_mod(xt, p.inv_punct_q, cq.q)
    conv = as_res(bconv.fast_bconv(y, p.bconv["q_to_bsk"], cb))
    conv_mt = ((wide(y)[..., :, None, :] * p.punct_q_to_mtilde) % mt).sum(dim=-3) % mt
    r = conv_mt.squeeze(-2) * p.neg_qinv_mtilde % mt
    r_c = torch.where(r >= mt >> 1, r - mt, r)
    corr = mul_const_mod(r_c[..., None, :] % cb.q, p.q_mod_bsk, cb.q)
    return mul_const_mod(add_mod(conv, corr, cb.q), p.mtilde_inv_bsk, cb.q)


def _composite_tensor_hat(xh, yh, chain):
    yh = chain.to_mont(yh)
    x0, x1 = xh[..., 0, :, :], xh[..., 1, :, :]
    y0, y1 = yh[..., 0, :, :], yh[..., 1, :, :]
    c0 = chain.mont_mul(x0, y0)
    c1 = add_mod(chain.mont_mul(x0, y1), chain.mont_mul(x1, y0), chain.q)
    c2 = chain.mont_mul(x1, y1)
    return torch.stack([c0, c1, c2], dim=-3)


def _composite_floor(p, c_q, c_bsk):
    cq, cb = p.chain_q, p.chain_bsk
    tc_q = mul_const_mod(c_q, p.t_mod_q, cq.q)
    tc_bsk = mul_const_mod(c_bsk, p.t_mod_bsk, cb.q)
    y = mul_const_mod(tc_q, p.inv_punct_q, cq.q)
    u = as_res(bconv.fast_bconv(y, p.bconv["q_to_bsk"], cb))
    return mul_const_mod(sub_mod(tc_bsk, u, cb.q), p.qinv_mod_bsk, cb.q)


def _composite_sk(p, fl):
    cq = p.chain_q
    nB = len(p.B_list)
    y_B, y_msk = fl[..., :nB, :], fl[..., nB, :]
    z = mul_const_mod(y_B, p.inv_punct_B, p.chain_B.q)
    conv = bconv.fast_bconv(z, p.bconv["B_to_q_msk"], p.chain_q_msk)
    conv_q, conv_msk = conv[..., :-1, :], conv[..., -1:, :]
    alpha = mul_const_mod(sub_mod(conv_msk, y_msk[..., None, :], p.msk_chain.q),
                          p.Binv_mod_msk, p.msk_chain.q)
    alpha_res = torch.where(alpha > (p.msk >> 1),
                            neg_mod(cq.reduce(p.msk - wide(alpha)), cq.q),
                            cq.reduce(alpha))
    return sub_mod(conv_q, mul_const_mod(alpha_res, p.B_mod_q, cq.q), cq.q)


def _composite_multiply(p, a, b):
    ntt_bsk = ntt_context_for(p.ntt_impl, p.n, p.bsk_list)

    def tensor(x, y, ntt, chain):
        return ntt.inverse(_composite_tensor_hat(ntt.forward(x), ntt.forward(y), chain))

    c_q = tensor(a, b, p.ntt_q, p.chain_q)
    c_bsk = tensor(_composite_lift(p, a), _composite_lift(p, b), ntt_bsk, p.chain_bsk)
    return _composite_sk(p, _composite_floor(p, c_q, c_bsk))


# --------------------------------------------------- the twins, one by one
@pytest.mark.parametrize("preset,k,t", PRESETS, ids=[x[0] for x in PRESETS])
def test_twins_equal_the_composite(preset, k, t):
    """Lift, tensor, floor and Shenoy-Kumaresan (through the entry points,
    which run the twins here) each equal the composite's step on the same
    inputs, edge residues included."""
    p = _params(k, t)
    gen = torch.Generator().manual_seed(k + t % 97)
    x = _residues(gen, (3, 2), p.q_list)
    lifted = bconv.behz(x, p.bconv["lift"])
    assert torch.equal(lifted[..., :k, :], x)
    assert torch.equal(lifted[..., k:, :], _composite_lift(p, x))

    xh = _residues(gen, (3, 2), p.chain_qbsk.moduli)
    yh = _residues(gen, (3, 2), p.chain_qbsk.moduli)
    for y in (yh, None):
        got = modmac.ct_tensor(xh, y, p.chain_qbsk)
        want = _composite_tensor_hat(xh, xh if y is None else y, p.chain_qbsk)
        assert torch.equal(got, want)

    c = _residues(gen, (3, 3), p.chain_qbsk.moduli)
    fl = bconv.behz(c, p.bconv["floor"])
    assert torch.equal(fl, _composite_floor(p, c[..., :k, :], c[..., k:, :]))
    fl = _residues(gen, (3, 3), p.bsk_list)
    assert torch.equal(bconv.behz(fl, p.bconv["sk"]), _composite_sk(p, fl))


@pytest.mark.parametrize("ntt_impl", ["butterfly", "matmul"])
@pytest.mark.parametrize("preset,k,t", PRESETS, ids=[x[0] for x in PRESETS])
def test_multiply_and_square_equal_the_composite(preset, k, t, ntt_impl):
    """The whole product over the combined chain q + Bsk (one forward and
    one inverse NTT) equals the composite's separate transforms, and the
    square (one lift, one forward NTT) equals the product of a with a
    copy of itself."""
    p = _params(k, t, ntt_impl)
    bfv = BFV(p)
    gen = torch.Generator().manual_seed(2 * k + 1)
    a = _residues(gen, (2, 2), p.q_list)
    b = _residues(gen, (2, 2), p.q_list)
    prod = bfv.multiply(a, b)
    assert prod.shape == (2, 3, k, N)
    assert torch.equal(prod, _composite_multiply(p, a, b))
    sq = bfv.square(a)
    assert torch.equal(sq, bfv.multiply(a, a.clone()))
    assert torch.equal(sq, _composite_multiply(p, a, a))
    # one operand broadcast over the other's rows (`api/matrix.py`'s
    # encrypted matrix by an encrypted vector)
    assert torch.equal(bfv.multiply(a, b[:1]), _composite_multiply(p, a, b[:1]))


# ------------------------------------------- the kernels' arithmetic, replayed
def _u64(t):
    return t.numpy().view(np.uint32).astype(np.uint64)


def _redc(s, m, minv):
    u = ((s & M32) * minv) & M32
    r = (s + u * m) >> np.uint64(32)
    return np.where(r >= m, r - m, r)


def _lazy_add(s, prod, mR):
    s = s + prod
    return np.where(s >= mR, s - mR, s)


def _replay_mode(tab, x):
    """`fast_bconv_kernel_behz` on rows x [R, Lin, N] (uint64) in numpy: the
    Shoup scale at load, the correction in registers, one lazy sum and one
    REDC a target, on the prepared tables."""
    src, T, tgt = _u64(tab.src), _u64(tab.tab), _u64(tab.tgt)
    c0, c1, c2 = (np.uint64(c) for c in tab.consts)
    Lf, Lt = T.shape
    y = []
    for i in range(Lf):
        q, w, ws = src[i, 0], src[i, 1], src[i, 2]
        xi = x[:, i]
        r = (xi * w - ((xi * ws) >> np.uint64(32)) * q) & M32
        y.append(np.where(r >= q, r - q, r))
    e = np.zeros_like(x[:, 0])
    neg = np.zeros(e.shape, bool)
    if tab.mode == "lift":
        s = np.zeros_like(e)
        for i in range(Lf):
            s = (s + y[i] * src[i, 3]) & M32
        rr = (s * c0) & np.uint64(0xFFFF)
        neg = rr >= 0x8000
        e = np.where(neg, np.uint64(0x10000) - rr, rr)
    elif tab.mode == "sk":
        mR = c0 << np.uint64(32)
        s = (c0 - x[:, Lf]) * c2
        for i in range(Lf):
            s = _lazy_add(s, y[i] * src[i, 3], mR)
        a = _redc(s, c0, c1)
        neg = a > (c0 >> np.uint64(1))
        e = np.where(neg, c0 - a, a)
    out = []
    for t in range(Lt):
        m, minv, kp, kn = tgt[t]
        mR = m << np.uint64(32)
        s = x[:, Lf + t] * kp if tab.mode == "floor" else e * np.where(neg, kn, kp)
        for i in range(Lf):
            s = _lazy_add(s, y[i] * T[i, t], mR)
        out.append(_redc(s, m, minv))
    res = np.stack(out, axis=1)
    if tab.mode == "lift":
        res = np.concatenate([x[:, tab.lo:tab.lo + tab.out0], res], axis=1)
    return res.astype(np.uint32).view(np.int32)


def _replay_tensor(x, y, chain):
    """`ct_tensor_kernel` in numpy: each product (c1's two summed) reduced
    by a REDC, then by a REDC against R**2 mod q."""
    mt = _u64(chain.mont)
    q, qinv, r2 = (mt[:, i, None] for i in range(3))
    x = x.numpy().astype(np.uint64)
    y = x if y is None else y.numpy().astype(np.uint64)

    def red(s):
        return _redc(_redc(s, q, qinv) * r2, q, qinv)

    x0, x1, y0, y1 = x[:, 0], x[:, 1], y[:, 0], y[:, 1]
    out = np.stack([red(x0 * y0), red(x0 * y1 + x1 * y0), red(x1 * y1)], axis=1)
    return out.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("preset,k,t", PRESETS, ids=[x[0] for x in PRESETS])
def test_kernel_arithmetic_replayed_on_the_tables(preset, k, t):
    """Each mode's arithmetic on the tables `BFVParams._behz_tables` made,
    one device's and a limb-sharded rank's (limbs [2, 5): the lift writes
    those through, Shenoy-Kumaresan targets them), and the tensor kernel's
    on the chain's Montgomery table, equal the twins; the inputs hold 0
    and q - 1 at every limb, and every row of the largest residues, where
    the lazy sums are largest."""
    full = _params(k, t)
    gen = torch.Generator().manual_seed(3 * k)
    nb = len(full.bsk_list)
    for p, kl in ((full, k), (full.narrow(_Shard(None, 0, 2, 5, k)), 3)):
        cases = {"lift": _residues(gen, (4,), p.q_list),
                 "floor": _residues(gen, (4,), p.q_list + p.bsk_list),
                 "sk": _residues(gen, (4,), p.bsk_list)}
        for mode, x in cases.items():
            tab = p.bconv[mode]
            assert (tab.Lf, tab.Lt, tab.Lout) == {
                "lift": (k, nb, kl + nb), "floor": (k, nb, nb), "sk": (nb - 1, kl, kl)}[mode]
            got = _replay_mode(tab, x.numpy().view(np.uint32).astype(np.uint64))
            np.testing.assert_array_equal(got, bconv.behz_plain(x, tab).numpy())
    for square in (True, False):
        xh = _residues(gen, (3, 2), full.chain_qbsk.moduli)
        yh = None if square else _residues(gen, (3, 2), full.chain_qbsk.moduli)
        np.testing.assert_array_equal(_replay_tensor(xh, yh, full.chain_qbsk),
                                      modmac.ct_tensor_plain(xh, yh, full.chain_qbsk).numpy())


def test_mode_plans_cover_every_output_once():
    """The modes' launch plans at the paths' shapes (CryptoNets' chunk of 64
    ciphertexts, LoLa's one, CIFAR's at n = 16384, a wide Bsk): the grid's
    blocks times V coefficients cover each row's coefficients, and the
    chunks each target, once; V holds the registers' budget."""
    for R, Lf, Lt, n in ((128, 7, 9, 8192), (192, 7, 9, 8192), (192, 8, 7, 8192),
                         (2, 7, 9, 8192), (3, 8, 7, 8192), (3, 14, 13, 16384),
                         (3, 13, 15, 16384), (5, 20, 22, 64), (1, 3, 4, 2)):
        for align in (16, 8, 4):
            pl = bconv.mode_plan(R, Lf, Lt, n, align)
            V, chunk = pl["V"], pl["chunk"]
            assert V in ((4 if Lf <= 8 else 2), 1) and align % (4 * V) == 0 or V == 1
            tiles = 1 << pl["log_tiles"]
            assert pl["grid"][0] == R * tiles and tiles * V * bconv.THREADS >= n
            assert (tiles - 1) * V * bconv.THREADS < n
            assert pl["grid"][2] * chunk >= Lt > (pl["grid"][2] - 1) * chunk
            assert Lf * chunk <= bconv.MAX_TABLE and chunk <= bconv.MAX_CHUNK
            assert (Lf << pl["log_chunk_p2"]) <= 2 * bconv.MAX_TABLE
    for R, L, n in ((128, 16, 8192), (2, 16, 8192), (3, 28, 16384), (1, 2, 2)):
        pl = modmac.tensor_plan(R, L, n, True)
        tiles = 1 << pl["log_tiles"]
        assert pl["grid"] == (R * tiles, L, 1)
        assert tiles * pl["V"] * modmac.THREADS >= n > (tiles - 1) * pl["V"] * modmac.THREADS


# --------------------------------------------------------- the call sites
@pytest.fixture
def counted(monkeypatch):
    """Calls of `BFV.square` and `BFV.multiply`, by name."""
    counts = {"square": 0, "multiply": 0}
    for name in counts:
        orig = getattr(BFV, name)

        def counting(self, *args, name=name, orig=orig):
            counts[name] += 1
            return orig(self, *args)
        monkeypatch.setattr(BFV, name, counting)
    return counts


def test_square_call_sites_take_the_one_operand_path(counted):
    """`HEMatrix.elementwise_multiply` and `HEVector.pointwise_multiply`
    call `square` when the other operand is the same object (one call a
    plain prime and piece, `OPS["square"]` counting its ciphertexts), and
    `multiply` for distinct operands, with products equal either way."""
    chain = ntt_primes(N, 30, 3)
    fac = CrtBfvFactory(plain_primes=ntt_primes(N, 17, 2), n=N, coeff_modulus=chain,
                        seed=1, device="cpu")
    P = len(fac.bfv)
    vec = np.arange(N) % 5 - 2.0
    v = fac.get_encrypted_vector(vec)
    w = v._clone_meta(data=v.data.clone())     # the same ciphertext, another object
    OPS.reset()
    sq = v.pointwise_multiply(v)
    assert counted == {"square": P, "multiply": 0}
    assert OPS.reset()["square"] == v.data.shape[1]
    prod = v.pointwise_multiply(w)
    assert counted == {"square": P, "multiply": P}
    assert "square" not in OPS.reset()
    assert torch.equal(sq.data, prod.data)

    cols = [fac.get_encrypted_vector(vec + i) for i in range(3)]
    m = tmatrix.HEMatrix(fac, cols, tmatrix.COLUMN_MAJOR)
    other = tmatrix.HEMatrix(fac, [c._clone_meta(data=c.data.clone()) for c in cols],
                             tmatrix.COLUMN_MAJOR)
    for key in counted:
        counted[key] = 0
    msq = m.elementwise_multiply(m)
    pieces = -(-3 // tmatrix.MULT_CHUNK)
    assert counted == {"square": P * pieces, "multiply": 0}
    assert OPS.reset()["square"] == 3
    mprod = m.elementwise_multiply(other)
    assert counted == {"square": P * pieces, "multiply": P * pieces}
    for a, b in zip(msq.vectors, mprod.vectors):
        assert torch.equal(a.data, b.data)


class _Shard:
    """Rank `rank` of a limb group whose ranks are threads of this process
    (`group`, a `_ThreadGroup`; None: no collective), holding limbs [lo,
    hi) of k."""

    def __init__(self, group, rank, lo, hi, k):
        self.group, self.rank, self.lo, self.hi, self.k = group, rank, lo, hi, k

    def all_gather(self, x, dim):
        g = self.group
        g.gathers[self.rank] += 1
        g.slots[self.rank] = x
        g.barrier.wait()
        out = torch.cat(g.slots, dim=dim)
        g.barrier.wait()
        return out

    def all_reduce_sum(self, x):
        raise AssertionError("the multiply sums nothing over the ranks")


class _ThreadGroup:
    """A limb group of ranks that run as threads, one block of the chain
    each: `run(fn)` calls fn(rank's shard) on every rank at once and
    returns their results in rank order."""

    def __init__(self, blocks, k):
        self.barrier = threading.Barrier(len(blocks))
        self.slots = [None] * len(blocks)
        self.gathers = [0] * len(blocks)
        self.shards = [_Shard(self, r, lo, hi, k) for r, (lo, hi) in enumerate(blocks)]

    def run(self, fn):
        out = [None] * len(self.shards)

        def rank(r):
            try:
                out[r] = fn(self.shards[r])
            except BaseException as e:      # noqa: BLE001 - reported below
                out[r] = e
                self.barrier.abort()
        threads = [threading.Thread(target=rank, args=(r,)) for r in range(len(out))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for o in out:
            if isinstance(o, BaseException):
                raise o
        return out


@pytest.mark.parametrize("blocks", [((0, 3), (3, 6)), ((0, 2), (2, 4), (4, 6))],
                         ids=["2ranks", "3ranks"])
def test_sharded_ranks_gather_and_run_the_modes(blocks, monkeypatch):
    """Limb-sharded ranks multiply and square through the same modes on
    their own tables (each rank reaches the mode entry four times a
    product, three times a square), gathering the q limbs of each lifted
    operand and of the product once (three gathers a product, two a
    square) and summing nothing over the ranks; their limbs, joined, equal
    one device's product and square, bit for bit."""
    k, t = 6, 557057
    full = _params(k, t)
    group = _ThreadGroup(blocks, k)
    reached = {}                      # thread -> calls of the mode entry
    rows = bconv._behz_rows

    def counting(x, tab):
        me = threading.get_ident()
        reached[me] = reached.get(me, 0) + 1
        return rows(x, tab)
    monkeypatch.setattr(bconv, "_behz_rows", counting)
    gen = torch.Generator().manual_seed(5)
    a = _residues(gen, (2, 2), full.q_list)
    b = _residues(gen, (2, 2), full.q_list)

    def product(shard, square):
        p = full.narrow(shard)
        assert p.bconv["sk"].moduli[1] == full.q_list[shard.lo:shard.hi]
        x = a[..., shard.lo:shard.hi, :]
        if square:
            return BFV(p).square(x)
        return BFV(p).multiply(x, b[..., shard.lo:shard.hi, :])

    prod = torch.cat(group.run(lambda s: product(s, False)), dim=-2)
    assert group.gathers == [3] * len(blocks)
    assert sorted(reached.values()) == [4] * len(blocks)
    reached.clear()
    sq = torch.cat(group.run(lambda s: product(s, True)), dim=-2)
    assert group.gathers == [5] * len(blocks)
    assert sorted(reached.values()) == [3] * len(blocks)
    assert torch.equal(prod, BFV(full).multiply(a, b))
    assert torch.equal(prod, _composite_multiply(full, a, b))
    assert torch.equal(sq, BFV(full).square(a))


def test_operators_under_vmap_equal_the_loop():
    """The modes and the tensor product on a batch of records (through
    `cryptonets_torch::behz` and `::ct_tensor`) equal the loop over the
    records; `square` and `multiply` under vmap too."""
    p = _params(7, 557057)
    bfv = BFV(p)
    gen = torch.Generator().manual_seed(9)
    a = _residues(gen, (3, 2, 2), p.q_list)        # [B, C, 2, k, N]
    b = _residues(gen, (3, 2, 2), p.q_list)
    vm = torch.func.vmap
    c = _residues(gen, (3, 2, 3), p.chain_qbsk.moduli)
    fl = _residues(gen, (3, 2, 3), p.bsk_list)
    for mode, x in (("lift", a), ("floor", c), ("sk", fl)):
        tab = p.bconv[mode]
        assert torch.equal(vm(lambda r: bconv.behz(r, tab))(x),
                           torch.stack([bconv.behz(r, tab) for r in x]))
    xh = _residues(gen, (3, 2, 2), p.chain_qbsk.moduli)
    yh = _residues(gen, (2, 2), p.chain_qbsk.moduli)      # one operand not batched
    assert torch.equal(vm(lambda x: modmac.ct_tensor(x, yh, p.chain_qbsk))(xh),
                       torch.stack([modmac.ct_tensor(x, yh, p.chain_qbsk) for x in xh]))
    assert torch.equal(vm(lambda x: modmac.ct_tensor(x, None, p.chain_qbsk))(xh),
                       torch.stack([modmac.ct_tensor(x, None, p.chain_qbsk) for x in xh]))
    assert torch.equal(vm(bfv.square)(a), torch.stack([bfv.square(x) for x in a]))
    assert torch.equal(vm(bfv.multiply)(a, b),
                       torch.stack([bfv.multiply(x, y) for x, y in zip(a, b)]))
