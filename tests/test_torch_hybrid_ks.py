"""Hybrid (special-prime) key switching, the rotate-and-add ladder and the
row-major matvec of the port against the JAX reference at n = 256, under
the butterfly and the four-step NTT.

With the reference's keys over Q*P imported through `keyset_from_numpy`
and reference-encrypted inputs, the parameter tables, the hybrid key
switch (stacked over the groups and looped over them), relinearize,
apply_galois, multiply, rotate_accumulate_scan, `_sum_slots_data`,
sum_all_slots, dot_product and the row-major `HEMatrix.mul` are bit-equal
(integers, exact).  With the port's own keys under every pairing of
(digit / hybrid) x (butterfly / matmul), encrypt, square, rotate,
sum-all-slots and decrypt give exact values with budget left."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cryptonets_tpu.api as japi  # noqa: E402
from cryptonets_tpu.api.matrix import _sum_slots_data as j_sum_slots  # noqa: E402
from cryptonets_tpu.crypto.bfv import Ciphertext  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.api.bsgs import (  # noqa: E402
    BsgsDenseForm,
    bsgs_matvec,
    hoist_eligible,
)
from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory  # noqa: E402
from cryptonets_tpu_torch.api.matrix import _sum_slots_data  # noqa: E402
from cryptonets_tpu_torch.api.vector import HEVector  # noqa: E402
from cryptonets_tpu_torch.convert import keyset_from_numpy  # noqa: E402

N = 256
PLAIN = ntt_primes(N, 17, 2)
CHAIN = ntt_primes(N, 30, 4)
IMPLS = ("butterfly", "matmul")


def _t(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _np(x):
    return x.numpy().view(np.uint32)


@pytest.fixture(scope="module", params=IMPLS)
def pair(request, tmp_path_factory):
    """(reference factory with two special primes, port factory with the
    reference's keys), both under the same NTT."""
    impl = request.param
    jf = japi.CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN,
                            seed=3, n_special=2, ntt_impl=impl)
    path = str(tmp_path_factory.mktemp("keys") / "keys.npz")
    japi.CrtBfvFactory._save_cached_keys(path, jf.keys)
    with np.load(path) as z:
        keys = keyset_from_numpy(z, device="cpu")
    tf = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, seed=3,
                       n_special=2, ntt_impl=impl, device="cpu", keys=keys)
    return jf, tf


@pytest.fixture(scope="module")
def cts(pair):
    jf, _ = pair
    rng = np.random.default_rng(0)
    a = rng.integers(-5, 6, N).astype(float)
    b = rng.integers(-5, 6, N).astype(float)
    da = np.asarray(jf.get_encrypted_vector(a).data)
    db = np.asarray(jf.get_encrypted_vector(b).data)
    return a, b, da, db


def test_params_and_key_shapes_equal(pair):
    jf, tf = pair
    assert tf.ntt_impl == jf.ntt_impl
    for jp, tp in zip(jf.params, tf.params):
        for name in ("sp_list", "qp_list", "ks_groups", "ks_omega", "P_big",
                     "ks_alpha", "n_special", "ks_hybrid", "bsk_list"):
            assert getattr(jp, name) == getattr(tp, name), name
        assert tp.ntt_qp.moduli == tuple(jp.qp_list) and len(tp.sp_list) == 2
        # the reference keeps (values, Shoup companions) pairs
        for name in ("ks_pqt", "ks_grp_conv", "ks_inv_punct_grp",
                     "ks_inv_punct_sp", "ks_punct_sp_to_q", "ks_pinv_q"):
            np.testing.assert_array_equal(
                getattr(tp, name).numpy(), np.asarray(getattr(jp, name)[0]), name)
        for name in ("ks_phalf_sp", "ks_phalf_q"):
            np.testing.assert_array_equal(
                getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), name)
    kp = len(CHAIN) + 2
    assert tuple(tf.keys.relin.k0.shape) == (2, kp, N)
    assert all(tuple(sk.k1.shape) == (2, kp, N) for sk in tf.keys.galois.values())


def test_hybrid_switch_stacked_and_looped(pair, cts):
    """The reference loops over the groups only past 2**31 bytes; the
    port's threshold is an attribute, so both forms run here."""
    jf, tf = pair
    _, _, da, _ = cts
    jb, tb = jf.bfv[0], tf.bfv[0]
    poly = da[0][..., 1, :, :]                              # [C, k, N]
    want = np.asarray(jb._switch_key_inner_hybrid(poly, jf.keys.relin))
    assert tb.group_stack_bytes == 1 << 31
    try:
        for limit in (1 << 31, 0):
            tb.group_stack_bytes = limit
            got = tb._switch_key_inner(_t(poly), tf.keys.relin)
            np.testing.assert_array_equal(_np(got), want)
            g = jb.galois_elt_rows(N // 2 - 4)
            np.testing.assert_array_equal(
                _np(tb.apply_galois(_t(da[0]), g, tf.keys)),
                np.asarray(jb.apply_galois(Ciphertext(da[0]), g, jf.keys).data))
    finally:
        del tb.group_stack_bytes
    assert tb.group_stack_bytes == 1 << 31


def test_multiply_relinearize_rotate_bit_equal(pair, cts):
    jf, tf = pair
    _, _, da, db = cts
    for pi in range(jf.P):
        jb, tb = jf.bfv[pi], tf.bfv[pi]
        m_j = np.asarray(jb.multiply(Ciphertext(da[pi]), Ciphertext(db[pi])).data)
        np.testing.assert_array_equal(_np(tb.multiply(_t(da[pi]), _t(db[pi]))), m_j)
        r_j = np.asarray(jb.relinearize(Ciphertext(m_j), jf.keys).data)
        np.testing.assert_array_equal(_np(tb.relinearize(_t(m_j), tf.keys)), r_j)
    # a step without its own key: composed from the power-of-two ladder
    np.testing.assert_array_equal(
        _np(tf.bfv[0].rotate_rows(_t(da), 3, tf.keys)),
        np.asarray(jf.bfv[0].rotate_rows(Ciphertext(da), 3, jf.keys).data))
    for pi in range(jf.P):
        want = np.asarray(jf.bfv[pi].decrypt_residues_mod_t(jf.keys, Ciphertext(da[pi])))
        np.testing.assert_array_equal(
            _np(tf.bfv[pi].decrypt_residues_mod_t(tf.keys, _t(da[pi]))), want)


def test_ladder_and_slot_sums_bit_equal(pair, cts):
    jf, tf = pair
    a, b, da, db = cts
    row = N // 2
    g_tuple = tuple(jf.bfv[0].galois_elt_rows(-s % row) for s in (1, 2, 4, 8))
    got = tf.bfv[0].rotate_accumulate_scan(_t(da), tf.stacked_galois(g_tuple))
    want = jf.bfv[0].rotate_accumulate_scan(da, jf.stacked_galois(g_tuple))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # the stacks are cached per key set
    assert tf.stacked_galois(g_tuple) is tf.stacked_galois(g_tuple)
    # two blocks summed, then the complete sum; and a bucket sum
    two = np.concatenate([da, db], axis=1)
    np.testing.assert_array_equal(
        _np(_sum_slots_data(tf, _t(two))), np.asarray(j_sum_slots(jf, two)))
    np.testing.assert_array_equal(
        _np(_sum_slots_data(tf, _t(da), 8)), np.asarray(j_sum_slots(jf, da, 8)))

    jva = japi.HEVector(jf, data=da, dim=N, scale=1.0)
    jvb = japi.HEVector(jf, data=db, dim=N, scale=1.0)
    tva = HEVector(tf, data=_t(da), dim=N, scale=1.0)
    tvb = HEVector(tf, data=_t(db), dim=N, scale=1.0)
    js, ts = jva.sum_all_slots(), tva.sum_all_slots()
    np.testing.assert_array_equal(_np(ts.data), np.asarray(js.data))
    assert (ts.fmt, ts.dim) == (js.fmt, js.dim) == ("sparse", 1)
    assert ts.decrypt()[0] == a.sum() and ts.noise_budget() > 0
    jd, td = jva.dot_product(jvb), tva.dot_product(tvb)
    np.testing.assert_array_equal(_np(td.data), np.asarray(jd.data))
    assert td.decrypt()[0] == float(a @ b)
    jd8, td8 = jva.dot_product(jvb, 8), tva.dot_product(tvb, 8)
    np.testing.assert_array_equal(_np(td8.data), np.asarray(jd8.data))
    assert (td8.fmt, td8.dim) == (jd8.fmt, jd8.dim) == ("dense", N)


def test_row_major_matvec_bit_equal(pair, cts):
    jf, tf = pair
    a, _, da, _ = cts
    W = np.random.default_rng(5).integers(-3, 4, (6, N)).astype(float)
    jv = japi.HEVector(jf, data=da, dim=N, scale=1.0)
    tv = HEVector(tf, data=_t(da), dim=N, scale=1.0)
    jm = jf.get_plain_matrix(W, "row", 2.0)
    tm = tf.get_plain_matrix(W, "row", 2.0)
    np.testing.assert_array_equal(
        _np(tm._stacked_mult_forms()), np.asarray(jm._stacked_mult_forms()))
    jo, to = jm.mul(jv), tm.mul(tv)
    np.testing.assert_array_equal(_np(to.data), np.asarray(jo.data))
    assert (to.fmt, to.dim, to.scale) == (jo.fmt, jo.dim, jo.scale) == ("sparse", 6, 2.0)
    # a sparse plain bias, then the decoded values against the Raw backend
    bias = np.arange(6) - 2.0
    jo = jo.add(jf.get_plain_vector(bias, "sparse", 2.0))
    to = to.add(tf.get_plain_vector(bias, "sparse", 2.0))
    np.testing.assert_array_equal(_np(to.data), np.asarray(jo.data))
    raw = RawFactory(N)
    rv = raw.get_plain_matrix(W, "row", 2.0).mul(raw.get_plain_vector(a)).add(
        raw.get_plain_vector(bias, "sparse", 2.0))
    np.testing.assert_array_equal(to.decrypt(), rv.decrypt())
    assert list(to.decrypt_full_precision()) == list(rv.decrypt_full_precision())
    assert to.noise_budget() > 0
    # the forced dense output (row r's sum in flat slot r) is ported:
    # bit-equal under either NTT; a column-major matrix takes a sparse
    # vector only
    jo, to = jm.mul(jv, True), tm.mul(tv, force_dense=True)
    np.testing.assert_array_equal(_np(to.data), np.asarray(jo.data))
    assert (to.fmt, to.dim) == (jo.fmt, jo.dim) == ("dense", 6)
    np.testing.assert_array_equal(to.decrypt(), W @ a)
    with pytest.raises(ValueError, match="sparse vector"):
        tf.get_plain_matrix(W.T, "col", 2.0).mul(tv)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n_special", [0, 2])
def test_own_keys_round_trips(n_special, impl):
    """The port's own keygen over Q*P (or digits, n_special = 0) under
    either NTT: exact values after encrypt, square, rotate, sum."""
    tf = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, seed=5,
                       n_special=n_special, ntt_impl=impl, device="cpu",
                       rot_steps=(3,))
    rng = np.random.default_rng(1)
    a = rng.integers(-20, 21, N).astype(float)
    va = tf.get_encrypted_matrix(a[:, None], "col").vectors[0]
    np.testing.assert_array_equal(va.decrypt(), a)
    sq = va.pointwise_multiply(va)
    np.testing.assert_array_equal(sq.decrypt(), a * a)
    row = N // 2
    np.testing.assert_array_equal(
        sq.rotate(3).decrypt(),
        np.concatenate([np.roll(a[:row] ** 2, -3), np.roll(a[row:] ** 2, -3)]))
    total = sq.sum_all_slots()
    assert total.decrypt()[0] == float((a * a).sum())
    assert total.fmt == "sparse" and total.noise_budget() > 0
    # a bucket sum of 4: out[i] = sum_{j<4} in[i - j] within each row
    want = sum(np.concatenate([np.roll(a[:row], j), np.roll(a[row:], j)])
               for j in range(4))
    np.testing.assert_array_equal(va.sum_all_slots(4).decrypt(), want)


def test_no_hoisting_under_the_four_step_ntt():
    """The hoisted baby steps gather by a permutation of the bit-reversed
    ordering: under the four-step NTT, and with special primes, the BSGS
    matvec must not hoist (it would gather wrongly ordered data) and takes
    the chained baby steps instead, exact all the same."""
    steps = tuple(range(1, 4))
    w = np.arange(12).reshape(3, 4) - 5
    for kw, ok in ((dict(ks_alpha=1), True),
                   (dict(ks_alpha=1, ntt_impl="matmul"), False),
                   (dict(n_special=1), False)):
        tf = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN,
                           seed=2, device="cpu", rot_steps=steps, **kw)
        assert hoist_eligible(tf, 4) is ok
        form = BsgsDenseForm(tf, w, 3, 4, g=4)
        data = tf.get_encrypted_matrix(np.arange(4.0)[:, None], "col").vectors[0].data
        out = HEVector(tf, data=bsgs_matvec(form, data), dim=3, scale=1.0)
        np.testing.assert_array_equal(out.decrypt(), w @ np.arange(4.0))
