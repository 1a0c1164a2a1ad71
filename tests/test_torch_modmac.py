"""K6 (`kernels/modmac.py` `mod_mac`, the modular multiply-accumulate over
a stacked axis) and K7 (`kernels/bconv.py` `fast_bconv`, the RNS fast base
conversion) on the CPU, where each wrapper runs its plain twin, against
the JAX package's own expressions on the same numpy inputs: K6 in every
form its call sites use (the stacked key switch for J in {1, 2, 7}, the
BSGS giant chunk read through strides, the hoisted babies' gather, int32
or int64, with its accumulator, the accumulated loop over the
components), K7 against the reference's `BFV._fast_bconv` for q -> Bsk,
B -> q, B -> m_sk, Shenoy-Kumaresan's merged B -> (q, m_sk) and sp -> q,
the kernel's arithmetic on the prepared Montgomery table too, and
against its group extension at alpha = 3.  The inputs hold the edge
residues 0 and q - 1 on the largest 31-bit NTT primes.  Both operators
under `torch.func.vmap` equal the loop over the records, and each call
site dispatches through the wrappers.  The wrappers' launch plans cover
each output once: the kernels' index arithmetic replayed in numpy."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from cryptonets_tpu.crypto import modular as jmod  # noqa: E402
from cryptonets_tpu.crypto.bfv import BFV as JaxBFV  # noqa: E402
from cryptonets_tpu.crypto.bfv import BFVParams as JaxParams  # noqa: E402
from cryptonets_tpu.crypto.bfv import ModChain as JaxChain  # noqa: E402
from cryptonets_tpu.crypto.bfv import mod_sum as j_mod_sum  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.api import bsgs as tbsgs  # noqa: E402
from cryptonets_tpu_torch.api import matrix as tmatrix  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory  # noqa: E402
from cryptonets_tpu_torch.crypto import bfv as tbfv  # noqa: E402
from cryptonets_tpu_torch.crypto.bfv import BFV, BFVParams, get_mod_chain  # noqa: E402
from cryptonets_tpu_torch.kernels import bconv, modmac  # noqa: E402

N = 64
BIG = ntt_primes(N, 31, 7)          # the largest 31-bit NTT primes, descending
PLAIN = ntt_primes(N, 17, 1)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _res(rng, lead, mods):
    """uint32 residues [*lead, L, N] in [0, q_l), with the edges: every
    row's coefficient 0 is 0 and coefficient 1 is q - 1, and the last row
    is q - 1 throughout."""
    q = np.array(mods, np.uint64).reshape(len(mods), 1)
    x = (rng.integers(0, 1 << 62, (*lead, len(mods), N), dtype=np.uint64) % q)
    x[..., 0] = 0
    x[..., 1] = q[:, 0] - 1
    flat = x.reshape(-1, len(mods), N)
    flat[-1] = q - 1
    return flat.reshape(x.shape).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(x):
    return x.contiguous().numpy().view(np.uint32)


def _jax_inner(a, k, jc):
    """The reference's `mod_sum(cq.mont_mul(dhat, k), cq.q, axis=0)`."""
    kshape = (k.shape[0],) + (1,) * (a.ndim - 3) + k.shape[1:]
    return np.asarray(j_mod_sum(jc.mont_mul(jnp.asarray(a), jnp.asarray(k.reshape(kshape))),
                                jc.q, axis=0))


# ------------------------------------------------------------------- K6
@pytest.mark.parametrize("J", [1, 2, 7])
def test_key_inner_product_bit_equal(J):
    """The stacked key switch (`BFV._key_inner_product`): dhat [J, 3, L, N]
    against both keys, one read of dhat, bit-equal to the reference's
    `mod_sum(mont_mul(...))` for each key."""
    rng = np.random.default_rng(J)
    mods = BIG[:4]
    a, k0, k1 = _res(rng, (J, 3), mods), _res(rng, (J,), mods), _res(rng, (J,), mods)
    out = modmac.key_inner_product(_t(a), _t(k0), _t(k1), get_mod_chain(mods, "cpu"))
    jc = JaxChain(mods)
    want = np.stack([_jax_inner(a, k0, jc), _jax_inner(a, k1, jc)], axis=-3)
    assert out.shape == (3, 2, len(mods), N)
    np.testing.assert_array_equal(_np(out), want)


def test_giant_chunk_strided_bit_equal():
    """The BSGS giant chunk (`bsgs_matvec.chunk_acc`): bab_hat [P, g, F, 2,
    k, N] in the hoisted layout (g outermost) read through strides for
    each flip f, the diagonal forms varying with P, the second flip
    accumulating onto the first; bit-equal to the reference's
    `mod_sum(mont_mul(bab_hat, forms), q, axis=1)` over g F."""
    rng = np.random.default_rng(5)
    mods, P, g, F = BIG[:3], 2, 4, 2
    bab = _res(rng, (g, P, F, 2), mods)                   # the hoisted layout
    forms = _res(rng, (P, g, F), mods)
    bab_t = _t(bab).movedim(0, 1)                         # [P, g, F, 2, k, N], a view
    forms_t = _t(forms)
    chain = get_mod_chain(mods, "cpu")
    acc = None
    for f in range(F):
        x = bab_t[:, :, f].transpose(0, 1)
        w = forms_t[:, :, f].transpose(0, 1)[None]
        acc = modmac.mod_mac(x, (w,), chain, None if acc is None else (acc[None],))[0, :, :, 0]
    jc = JaxChain(mods)
    jbab = jnp.moveaxis(jnp.asarray(bab), 0, 1)
    prod = jc.mont_mul(jbab, jnp.asarray(forms)[:, :, :, None])
    want = j_mod_sum(prod.reshape(P, g * F, *prod.shape[3:]), jc.q, axis=1)
    np.testing.assert_array_equal(_np(acc), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_hoisted_babies_gather_bit_equal(dtype):
    """The hoisted babies' gather and inner product with c0_hat's gathered
    accumulator, a chunk of B babies in one call, against the reference's
    scanned `body` (`cryptonets_tpu/api/bsgs.py:219-229`); the gather as
    the factory keeps it (int32) and widened (int64)."""
    from cryptonets_tpu.crypto.ntt import ntt_automorphism_perm

    rng = np.random.default_rng(7)
    mods, J, P, F, B = BIG[:3], 5, 2, 2, 3
    dhat, c0_hat = _res(rng, (J, P, F), mods), _res(rng, (P, F), mods)
    k0s, k1s = _res(rng, (B, J), mods), _res(rng, (B, J), mods)
    perms = np.stack([ntt_automorphism_perm(N, pow(3, b, 2 * N)) for b in range(1, B + 1)])
    L = len(mods)
    acc = (_t(c0_hat).reshape(1, 1, P * F, L, N).expand(B, -1, -1, -1, -1), None)
    keys = tuple(_t(k)[:, :, None] for k in (k0s, k1s))
    out = modmac.mod_mac(_t(dhat).reshape(J, 1, P * F, L, N), keys,
                         get_mod_chain(mods, "cpu"), acc,
                         torch.from_numpy(perms.astype(dtype)))
    out = out.reshape(B, P, F, 2, L, N)
    cq = JaxChain(mods)
    jd, jc0 = jnp.asarray(dhat), jnp.asarray(c0_hat)
    for b in range(B):
        perm = jnp.asarray(perms[b])
        dp = jd[..., perm]
        t0 = j_mod_sum(cq.mont_mul(dp, jnp.asarray(k0s[b])[:, None, None]), cq.q, axis=0)
        t1 = j_mod_sum(cq.mont_mul(dp, jnp.asarray(k1s[b])[:, None, None]), cq.q, axis=0)
        c0r = jmod.add_mod(jc0[..., perm], t0, cq.q)
        np.testing.assert_array_equal(_np(out[b]), np.asarray(jnp.stack([c0r, t1], axis=-3)))


def test_accumulated_loop_bit_equal():
    """The loops over digits or groups (`_switch_key_digits_accumulated`,
    the looped hybrid switch): one component a call onto the accumulator,
    against the reference's `digit_body` (add_mod of mont_mul from zero)."""
    rng = np.random.default_rng(11)
    mods, J = BIG[-3:], 4
    dhat, k0, k1 = _res(rng, (J, 2, 3), mods), _res(rng, (J,), mods), _res(rng, (J,), mods)
    chain = get_mod_chain(mods, "cpu")
    t = None
    for j in range(J):
        t = modmac.key_inner_product(_t(dhat[j])[None], _t(k0[j:j + 1]), _t(k1[j:j + 1]),
                                     chain, t)
    cq = JaxChain(mods)
    t0 = t1 = jnp.zeros(dhat.shape[1:], jnp.uint32)
    for j in range(J):
        d = jnp.asarray(dhat[j])
        t0 = jmod.add_mod(t0, cq.mont_mul(d, jnp.asarray(k0[j])), cq.q)
        t1 = jmod.add_mod(t1, cq.mont_mul(d, jnp.asarray(k1[j])), cq.q)
    np.testing.assert_array_equal(_np(t), np.asarray(jnp.stack([t0, t1], axis=-3)))


def test_mod_mac_refusals():
    chain = get_mod_chain(BIG[:2], "cpu")
    a = torch.zeros((2, 1, 1, 1, 2, N), dtype=torch.int32)
    k = torch.zeros((1, 2, 1, 2, N), dtype=torch.int32)
    modmac.check(a, (k,), chain, (None,), None)                  # fits
    with pytest.raises(ValueError, match="does not fit"):
        modmac.check(a, (k[:, :1],), chain, (None,), None)
    with pytest.raises(ValueError, match="last stride"):
        wide = torch.zeros((2, 1, 1, 1, 2, 2 * N), dtype=torch.int32)
        modmac.check(wide[..., ::2], (k,), chain, (None,), None)
    modmac.check(a, (k,), chain, (None,), torch.zeros((1, N), dtype=torch.int32))
    with pytest.raises(ValueError, match="gather must be"):
        modmac.check(a, (k,), chain, (None,), torch.zeros((1, N), dtype=torch.int16))
    with pytest.raises(ValueError, match="odd moduli below"):
        get_mod_chain([(1 << 31) + 11], "cpu")
    a = a.squeeze(2)
    with pytest.raises(ValueError, match="no mod_mac"):
        modmac.mod_mac(a.to("meta"), (k.to("meta"),), chain)


# ------------------------------------------------------------------- K7
@pytest.fixture(scope="module")
def params():
    """(reference, port) parameters on the largest 31-bit primes with two
    special primes and groups of three limbs."""
    jp = JaxParams(N, PLAIN[0], BIG, n_special=2, ks_alpha=3)
    tp = BFVParams(N, PLAIN[0], BIG, n_special=2, ks_alpha=3, device="cpu")
    assert tp.ks_groups == [(0, 3), (3, 6), (6, 7)]
    return jp, tp


def _kernel_arithmetic(y, table, moduli):
    """`bconv.cu`'s sum on the prepared table, in numpy: the products y_i
    (c_i R mod m) summed lazily below m 2**32, then one REDC."""
    mont = table.mont.numpy().view(np.uint32).astype(np.uint64)      # [Lf, Lt]
    q = np.array(moduli, np.uint64)
    qinv = np.array([-pow(int(m), -1, 1 << 32) % (1 << 32) for m in moduli], np.uint64)
    qR = q << np.uint64(32)
    yv = y.astype(np.uint64)[..., :, None, :]                        # [..., Lf, 1, N]
    s = np.zeros(yv.shape[:-3] + (len(moduli), y.shape[-1]), np.uint64)
    for i in range(y.shape[-2]):
        s = s + yv[..., i, :, :] * mont[i][:, None]
        s = np.where(s >= qR[:, None], s - qR[:, None], s)
    m = ((s & np.uint64(0xFFFFFFFF)) * qinv[:, None]) & np.uint64(0xFFFFFFFF)
    t = (s + m * q[:, None]) >> np.uint64(32)
    return np.where(t >= q[:, None], t - q[:, None], t).astype(np.uint32)


@pytest.mark.parametrize("conv", ["q_to_bsk", "B_to_q", "B_to_msk", "B_to_q_msk",
                                  "sp_to_q"])
def test_fast_bconv_bit_equal(params, conv):
    """K7 (`fast_bconv`, which every conversion of `crypto/bfv.py` calls)
    against the reference's `BFV._fast_bconv` on y over the source base,
    edges included, with the bare int64 table and with the prepared one
    (`BFVParams.bconv`); the kernel's arithmetic on the prepared Montgomery
    table gives the same residues.  Shenoy-Kumaresan's merged conversion
    into (q, m_sk), one call, equals the reference's two."""
    jp, tp = params
    src, table, chain = {
        "q_to_bsk": ("q_list", "punct_q_to_bsk", "chain_bsk"),
        "B_to_q": ("B_list", "punct_B_to_q", "chain_q"),
        "B_to_msk": ("B_list", "punct_B_to_msk", "msk_chain"),
        "B_to_q_msk": ("B_list", None, "chain_q_msk"),
        "sp_to_q": ("sp_list", "ks_punct_sp_to_q", "chain_q"),
    }[conv]
    y = _res(np.random.default_rng(3), (2, 3), getattr(tp, src))
    jb = JaxBFV(jp)
    if table is None:
        want = np.concatenate([
            np.asarray(jb._fast_bconv(jnp.asarray(y), getattr(jp, t), getattr(jp, c)))
            for t, c in (("punct_B_to_q", "chain_q"), ("punct_B_to_msk", "msk_chain"))], -2)
    else:
        want = np.asarray(jb._fast_bconv(jnp.asarray(y), getattr(jp, table),
                                         getattr(jp, chain)))
    prepared = tp.bconv.get(conv) or bconv.BconvTable.prepare(
        getattr(tp, table), getattr(tp, chain).moduli)
    tables = (prepared,) if table is None else (getattr(tp, table), prepared)
    for c in tables:
        out = bconv.fast_bconv(_t(y), c, getattr(tp, chain))
        assert out.shape[-2] == len(getattr(tp, chain))
        np.testing.assert_array_equal(_np(out), want)
    np.testing.assert_array_equal(
        _kernel_arithmetic(y, prepared, getattr(tp, chain).moduli), want)


def test_group_extend_bit_equal(params):
    """`BFV._group_extend` through K7 (a group's slice of y read in place)
    against the reference's group extension at alpha = 3
    (`cryptonets_tpu/crypto/bfv.py:1163-1175`), the one-limb group too."""
    jp, tp = params
    y = _res(np.random.default_rng(4), (2,), tp.q_list)
    cqp = jp.chain_qp
    w, w_sh = jp.ks_grp_conv
    terms = jmod.mul_const_mod(jnp.asarray(y)[..., :, None, :], w, w_sh, cqp.q[None, :, :])
    for gi, (i0, i1) in enumerate(tp.ks_groups):
        seg = terms[..., i0:i1, :, :]
        want = j_mod_sum(seg, cqp.q, axis=-3) if i1 - i0 > 1 else seg[..., 0, :, :]
        np.testing.assert_array_equal(_np(BFV(tp)._group_extend(_t(y), gi)),
                                      np.asarray(want))


def test_fast_bconv_refusals(params):
    _, tp = params
    y = torch.zeros((1, 1, 3, N), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs y"):
        bconv.check(y, tp.punct_q_to_bsk, tp.chain_bsk)            # 7 source limbs
    with pytest.raises(ValueError, match="does not fit"):
        bconv.check(y[:, :, :1].expand(1, 1, 7, N).contiguous(), tp.punct_q_to_bsk,
                    tp.chain_q)
    with pytest.raises(ValueError, match="int32"):
        bconv.check(y[:, :, :1].expand(1, 1, 7, N).long(), tp.punct_q_to_bsk,
                    tp.chain_bsk)


# ----------------------------------------------------------------- vmap
def test_vmap_equals_loop(params):
    """Both operators under `torch.func.vmap` (records at dim 0 and at a
    middle dim, data and accumulators batched, keys and gathers not) give
    the loop over the records; a batched key or table is refused."""
    _, tp = params
    rng = np.random.default_rng(9)
    mods, J, R = BIG[:3], 3, 2
    chain = get_mod_chain(mods, "cpu")
    A = _t(_res(rng, (4, J, R), mods))                    # 4 records
    C = _t(_res(rng, (4, R, 2), mods))[:, :, 0]           # [4, R, L, N], strided
    k0, k1 = _t(_res(rng, (J,), mods)), _t(_res(rng, (J,), mods))
    perm = torch.randperm(N)[None]
    keys = (k0.reshape(1, J, 1, 3, N), k1.reshape(1, J, 1, 3, N))

    def mac(a, c):
        return modmac.mod_mac(a.reshape(J, 1, R, 3, N), keys, chain,
                              (c[None, None], None), perm)

    loop = torch.stack([mac(A[i], C[i]) for i in range(4)])
    np.testing.assert_array_equal(_np(torch.func.vmap(mac)(A, C)), _np(loop))
    at1 = torch.func.vmap(mac, in_dims=(1, 0))(A.movedim(0, 1).contiguous(), C)
    np.testing.assert_array_equal(_np(at1), _np(loop))
    acc_only = torch.func.vmap(mac, in_dims=(None, 0))(A[0], C)
    np.testing.assert_array_equal(_np(acc_only[1]), _np(mac(A[0], C[1])))

    def kip(d, t):
        return modmac.key_inner_product(d, k0, k1, chain, t)

    T = _t(_res(rng, (4, R, 2), mods))
    np.testing.assert_array_equal(
        _np(torch.func.vmap(kip)(A, T)),
        _np(torch.stack([kip(A[i], T[i]) for i in range(4)])))
    with pytest.raises(ValueError, match="not its keys"):
        torch.func.vmap(lambda k: modmac.key_inner_product(A[0], k, k1, chain))(
            torch.stack([k0, k0]))

    Y = _t(_res(rng, (4, 2), tp.q_list))                  # [4, 2, 7, N]

    def conv(y):
        return bconv.fast_bconv(y, tp.punct_q_to_bsk, tp.chain_bsk)

    np.testing.assert_array_equal(_np(torch.func.vmap(conv)(Y)),
                                  _np(torch.stack([conv(y) for y in Y])))
    ext = torch.func.vmap(lambda y: BFV(tp)._group_extend(y, 1), in_dims=1)(Y.movedim(0, 1))
    np.testing.assert_array_equal(
        _np(ext), _np(torch.stack([BFV(tp)._group_extend(y, 1) for y in Y])))
    with pytest.raises(ValueError, match="not its tables"):
        torch.func.vmap(lambda c: bconv.fast_bconv(Y[0], c, tp.chain_bsk))(
            torch.stack([tp.punct_q_to_bsk] * 2))


# ------------------------------------------------------------- dispatch
@pytest.fixture
def counted(monkeypatch):
    """Counts of the calls into K6's and K7's kernel form (the kernel on
    CUDA, the twin here), by wrapper: K7's BEHZ modes apart."""
    counts = {"mod_mac": 0, "fast_bconv": 0, "behz": 0}

    def wrap(name, fn):
        def counting(*args):
            counts[name] += 1
            return fn(*args)
        return counting

    monkeypatch.setattr(modmac, "_mod_mac6", wrap("mod_mac", modmac._mod_mac6))
    monkeypatch.setattr(bconv, "_fast_bconv4", wrap("fast_bconv", bconv._fast_bconv4))
    monkeypatch.setattr(bconv, "_behz_rows", wrap("behz", bconv._behz_rows))
    return counts


def _delta(counts, fn):
    before = dict(counts)
    out = fn()
    return out, {k: counts[k] - before[k] for k in counts}


def test_sites_dispatch_through_the_wrappers(counted):
    """Every call site of the tables in the module docstrings of
    `kernels/modmac.py` and `kernels/bconv.py` reaches its wrapper, and
    none keeps the int64 chain: `crypto/bfv.py` and `api/bsgs.py` no
    longer hold `mod_sum`."""
    assert not hasattr(tbfv, "mod_sum") and not hasattr(tbsgs, "mod_sum")
    chain = ntt_primes(N, 30, 3)
    digit = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=chain, seed=1,
                          device="cpu", rot_steps=(1, 2, 3))
    hybrid = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=chain, seed=1,
                           n_special=1, device="cpu")
    groups = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=chain, seed=1,
                           ks_alpha=1, device="cpu", rot_steps=(1, 2, 3))
    vec = np.arange(N) % 5 - 2.0
    for fac in (digit, hybrid, groups):
        bfv, keys = fac.bfv[0], fac.keys
        ct = fac.get_encrypted_vector(vec).data[0]          # [C, 2, k, N]
        sq, d = _delta(counted, lambda: bfv.multiply(ct, ct))
        # lift x2, floor, SK: K7's BEHZ modes
        assert d == {"mod_mac": 0, "fast_bconv": 0, "behz": 4}, d
        _, d = _delta(counted, lambda: bfv.relinearize(sq, keys))
        k7 = 0 if not bfv.p.ks_hybrid else bfv.p.ks_omega + (bfv.p.n_special > 0)
        assert d == {"mod_mac": 1, "fast_bconv": k7, "behz": 0}, d
        for attr in ("digit_stack_bytes", "group_stack_bytes"):
            setattr(bfv, attr, 0)                           # the loops (2')
        _, d = _delta(counted, lambda: bfv.relinearize(sq, keys))
        J = bfv.p.ks_omega if bfv.p.ks_hybrid else bfv.p.k * bfv.p.digits_per_limb
        assert d == {"mod_mac": J, "fast_bconv": k7, "behz": 0}, d
        del bfv.digit_stack_bytes, bfv.group_stack_bytes
        _, d = _delta(counted, lambda: bfv.decrypt_residues_mod_t(keys, ct))
        assert d == {"mod_mac": 0, "fast_bconv": 1, "behz": 0}, d
    # the hoisted babies (3) and the giant chunks (1), sparse and dense
    for fac in (digit, groups):
        g, R = 4, 6
        W = np.random.default_rng(2).integers(-3, 4, (R, N))
        form = tbsgs.BsgsDenseForm(fac, W, R, N, g=g)
        assert tbsgs.hoist_eligible(fac, g)
        ub = fac.get_encrypted_vector(vec).data[:, 0, None]   # [P, 1, 2, k, N]
        _, d = _delta(counted, lambda: tbsgs._hoisted_babies_hat(fac, ub, g))
        assert d["mod_mac"] == -(-(g - 1) // tbsgs.BABY_CHUNK), d
        data = fac.get_encrypted_vector(vec).data[:, :1]
        _, d = _delta(counted, lambda: tbsgs.bsgs_matvec(form, data))
        assert d["mod_mac"] >= 1 + len(form.active), d
    # the matrix products (`api/matrix.py`): the forced dense output and a
    # plain matrix by an encrypted sparse vector
    rows = [fac_vec for fac_vec in (digit.get_encrypted_vector(vec + i) for i in range(3))]
    m = tmatrix.HEMatrix(digit, rows, tmatrix.ROW_MAJOR)
    _, d = _delta(counted, lambda: m.mul(digit.get_encrypted_vector(vec), force_dense=True))
    assert d["mod_mac"] >= 3 + 1, d
    from cryptonets_tpu_torch.api.vector import SPARSE, HEVector

    plain_cols = tmatrix.HEMatrix(digit, [digit.get_plain_vector(vec + i) for i in range(3)],
                                  tmatrix.COLUMN_MAJOR)
    sv = HEVector(digit, data=torch.stack([digit.get_encrypted_vector(vec).data[:, 0]] * 3, 1),
                  dim=3, scale=1.0, fmt=SPARSE, is_signed=True)
    _, d = _delta(counted, lambda: plain_cols.mul(sv))
    assert d["mod_mac"] == 1, d


# ---------------------------------------------------------- launch plans
def _fdiv(x, d):
    """`modmac.cu` `fdiv` by the wrapper's (mul, shift) for d."""
    mul, shift = modmac.fast_div(d)
    return (((x * mul) >> 32) + x) >> shift


@pytest.mark.parametrize("d", [1, 2, 3, 7, 12, 13, 26, 48, 63, 104, 65535])
def test_fast_div_equals_division(d):
    """The multiply-high split of block indices equals x // d over the
    grid's range, and at the top of the 31-bit range."""
    x = np.concatenate([np.arange(1 << 20, dtype=np.uint64),
                        (1 << 31) - 1 - np.arange(1 << 12, dtype=np.uint64)])
    np.testing.assert_array_equal(_fdiv(x, d), x // np.uint64(d))


# (Z, R1, RA, RB, L, N, C, vector): the fused phase's K6 launches (LoLa's
# baby and chunk of 16, its stacked switch, CIFAR's giant chunk,
# LoLaLarge's stacked and looped groups, cifar_bigt's stacked groups) and
# the edges: N = 4096 and 2, Z = 1, an odd row count, a record batch,
# unaligned operands
MAC_SHAPES = [
    (1, 1, 1, 4, 7, 8192, 2, True), (16, 1, 1, 4, 7, 8192, 2, True),
    (1, 1, 1, 4, 7, 8192, 2, True), (1, 3, 1, 2, 13, 16384, 1, True),
    (1, 1, 1, 48, 14, 16384, 2, True), (1, 1, 1, 48, 14, 16384, 2, True),
    (1, 1, 1, 104, 14, 16384, 2, True), (15, 1, 1, 3, 3, 4096, 1, True),
    (1, 1, 1, 1, 1, 2, 1, False), (3, 4, 5, 7, 2, 64, 2, True),
    (16, 1, 8, 4, 7, 1024, 2, False)]


@pytest.mark.parametrize("shape", MAC_SHAPES)
def test_mod_mac_plan_covers_each_output_once(shape):
    """`modmac.plan` replayed as `mod_mac_kernel` splits its block and
    thread indices: every (z, r1, ra, rb, l, n) output is one thread's,
    once, and a thread's V coefficients and RT rows stay in range."""
    Z, R1, RA, RB, L, N, C, vector = shape
    pl = modmac.plan(Z, R1, RA, RB, L, N, C, vector)
    V, RT, RBT, lt = pl["V"], pl["RT"], pl["RBT"], pl["log_tiles"]
    assert RT <= modmac.ROWS_MAX[C] and N % V == 0 and RBT == -(-RB // RT)
    gx, gy, gz = pl["grid"]
    bx, by, bz, tid = (a.ravel().astype(np.uint64) for a in np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(gz), np.arange(modmac.THREADS),
        indexing="ij"))
    u = _fdiv(bx, RBT)
    rbt, tile, l = bx - u * np.uint64(RBT), u & np.uint64((1 << lt) - 1), u >> np.uint64(lt)
    z = _fdiv(by, R1)
    r1 = by - z * np.uint64(R1)
    n = (tile * np.uint64(modmac.THREADS) + tid) * np.uint64(V)
    live = n < N
    dims, count = (Z, R1, RA, RB, L, N // V), 0
    for r in range(RT):
        rb = rbt * np.uint64(RT) + np.uint64(r)
        ok = live & (rb < RB)
        idx = np.ravel_multi_index(tuple(x[ok].astype(np.int64) for x in
                                         (z, r1, bz, rb, l, n // np.uint64(V))), dims)
        count = count + np.bincount(idx, minlength=int(np.prod(dims)))
    assert (count == 1).all()


# (RA, RB, Lf, Lt, N, vector): the fused phase's K7 launches (LoLa's q ->
# Bsk and merged B -> (q, m_sk), LoLaLarge's group extension and
# mod-down, lola_large_bigt's mod-down), a record batch, and the edges:
# N = 4096 and 2, one row, Lf = 1, the largest Lt, Lf above the
# registers' 16, unaligned y
BCONV_SHAPES = [
    (1, 2, 7, 9, 8192, True), (1, 2, 8, 8, 8192, True), (1, 48, 3, 14, 16384, True),
    (1, 96, 3, 11, 16384, True), (1, 246, 3, 11, 16384, True),
    (16, 2, 7, 9, 8192, True), (1, 1, 1, 1, 2, False), (1, 3, 1, 1024, 4096, True),
    (1, 5, 32, 32, 1024, True), (2, 7, 14, 2, 4096, False)]


@pytest.mark.parametrize("shape", BCONV_SHAPES)
def test_fast_bconv_plan_covers_each_output_once(shape):
    """`bconv.plan` replayed as `fast_bconv_kernel` splits its indices:
    every (ra, rb, l, n) output is one thread's, once; each block stages
    its chunk's Lf x nt table entries once each, within the shared
    table."""
    RA, RB, Lf, Lt, N, vector = shape
    pl = bconv.plan(RA, RB, Lf, Lt, N, vector)
    V, lt, chunk, lc = pl["V"], pl["log_tiles"], pl["chunk"], pl["log_chunk_p2"]
    assert chunk <= bconv.MAX_CHUNK and Lf * chunk <= bconv.MAX_TABLE and N % V == 0
    gx, gy, gz = pl["grid"]
    bx, by, bz, tid = (a.ravel() for a in np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(gz), np.arange(bconv.THREADS),
        indexing="ij"))
    tile, rb = bx & ((1 << lt) - 1), bx >> lt
    n = (tile * bconv.THREADS + tid) * V
    live = n < N
    dims, count = (RA, RB, Lt, N // V), 0
    for t in range(chunk):
        tt = bz * chunk + t
        ok = live & (tt < Lt)
        idx = np.ravel_multi_index((by[ok], rb[ok], tt[ok], n[ok] // V), dims)
        count = count + np.bincount(idx, minlength=int(np.prod(dims)))
    assert (count == 1).all()
    for z in range(gz):                     # the staging loop of one block
        nt = min(chunk, Lt - z * chunk)
        e = np.arange(Lf << lc)
        i, t = e >> lc, e & ((1 << lc) - 1)
        slot = (i * nt + t)[t < nt]
        assert sorted(slot) == list(range(Lf * nt)) and Lf * nt <= bconv.MAX_TABLE
