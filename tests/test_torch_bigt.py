"""Plain moduli of 2**31 and above in the port against the JAX package on
the CPU, at n = 512 with two ~39-bit batching primes (the width of the
reference CryptoNets primes), as `tests/test_bigt.py` runs the reference:

  * the encoder's round trip, and the C++ host NTT (`runtime/hostcrypto`)
    against its exact object-int twin and the reference encoder;
  * `plain_to_residues`;
  * the two-plane device decrypt and its host join, bit-equal to the
    reference under its imported keys on the same ciphertexts (fresh,
    after a multiply and relinearisation, after a rotation, batched), and
    equal to the exact host decrypt;
  * the factory: the vector and matrix-column round trips, add, multiply
    and a dot product;
  * a mini CryptoNets network under big t against the Raw oracle;
  * the BSGS guard: `BsgsDenseForm` refuses a factory that encodes on the
    host, and `LLDenseLayer` then takes no BSGS.

Integers are compared bit-equal; Raw logits at rtol 1e-9.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from cryptonets_tpu.api.factory import CrtBfvFactory as JaxFactory  # noqa: E402
from cryptonets_tpu.crypto.bfv import BFV as JaxBFV  # noqa: E402
from cryptonets_tpu.crypto.bfv import BFVParams as JaxParams  # noqa: E402
from cryptonets_tpu.crypto.bfv import Ciphertext  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory  # noqa: E402
from cryptonets_tpu_torch.convert import keyset_from_numpy  # noqa: E402
from cryptonets_tpu_torch.crypto.bfv import BFV, BFVParams  # noqa: E402
from cryptonets_tpu_torch.crypto.encoder import (  # noqa: E402
    BatchEncoder, _host_tables, _intt_host, _ntt_host)

N = 512
BIG_TS = ntt_primes(N, 39, 2)
COEFF = ntt_primes(N, 30, 5)
RNG = np.random.default_rng(77)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread runs them as fast and
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _big_ints(shape, hi):
    return RNG.integers(0, hi, size=shape, dtype=np.int64).astype(object)


# --------------------------------------------------------------- encoder
def test_encoder_big_t_roundtrip_and_equal_reference():
    from cryptonets_tpu.crypto.encoder import BatchEncoder as JaxEncoder

    for t in BIG_TS:
        assert t >= 1 << 31
        te, je = BatchEncoder(N, t), JaxEncoder(N, t)
        slots = _big_ints(N, t)
        coeffs = te.encode(slots)
        assert coeffs.dtype == np.uint64
        np.testing.assert_array_equal(coeffs.astype(object), je.encode(slots))
        np.testing.assert_array_equal(te.encode(slots.astype(np.int64)), coeffs)
        np.testing.assert_array_equal(te.decode(coeffs).astype(object), slots)
        signed = RNG.integers(-(1 << 40), 1 << 40, N)
        np.testing.assert_array_equal(te.encode(signed).astype(object), je.encode(signed))
        np.testing.assert_array_equal(te.index_map, je.index_map)


@pytest.mark.parametrize("thread_coeffs", [None, N])
def test_host_ntt_equals_object_twin(thread_coeffs, monkeypatch):
    """The C++ 128-bit NTT equals the exact object-int NTT on the same
    input, forward and inverse, one row and a batch of rows; the batch in
    one C call, or (`thread_coeffs` = N) a row a thread."""
    from cryptonets_tpu_torch.runtime import hostcrypto

    if thread_coeffs is not None:
        monkeypatch.setattr(hostcrypto, "THREAD_COEFFS", thread_coeffs)
    t = BIG_TS[1]
    enc = BatchEncoder(N, t)
    pf, pi = _host_tables(N, t)[:2]          # exact object-int tables
    x = _big_ints((3, N), t)
    fwd = hostcrypto.ntt_forward(x.astype(np.uint64), enc.pf, t)
    inv = hostcrypto.ntt_inverse(x.astype(np.uint64), enc.pi, enc.n_inv, t)
    np.testing.assert_array_equal(fwd.astype(object), _ntt_host(x, pf, t))
    np.testing.assert_array_equal(
        inv.astype(object), _intt_host(x, pi, enc.n_inv, t))
    np.testing.assert_array_equal(
        hostcrypto.ntt_forward(x[0].astype(np.uint64), enc.pf, t), fwd[0])
    assert hostcrypto.library_path().exists()


def test_plain_to_residues_big_t():
    t = BIG_TS[0]
    tp = BFVParams(N, t, coeff_modulus=COEFF, dbc=16, device="cpu")
    jp = JaxParams(N, t, coeff_modulus=COEFF, dbc=16)
    coeffs = _big_ints((2, N), t)
    want = jp.plain_to_residues(coeffs)
    for c in (coeffs, coeffs.astype(np.uint64), coeffs.astype(np.int64)):
        got = tp.plain_to_residues(c)
        assert got.shape == (2, len(COEFF), N) and got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    for name in ("big_gamma", "big_m2", "B_list", "msk", "delta"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ("big_gt_m1", "big_qinv_m1", "big_ginv_m1"):
        assert getattr(tp, name) == int(getattr(jp, name)), name


# ------------------------------------------------- the two-plane decrypt
@pytest.fixture(scope="module")
def big_ctx(tmp_path_factory):
    """(reference BFV, its keys, port BFV, the same keys imported)."""
    jb = JaxBFV(JaxParams(N, BIG_TS[0], coeff_modulus=COEFF, dbc=16))
    keys = jb.keygen(seed=42)
    path = str(tmp_path_factory.mktemp("keys") / "keys.npz")
    JaxFactory._save_cached_keys(path, keys)
    with np.load(path) as z:
        tkeys = keyset_from_numpy(z, device="cpu")
    tb = BFV(BFVParams(N, BIG_TS[0], coeff_modulus=COEFF, dbc=16, device="cpu"))
    return jb, keys, tb, tkeys


def _enc(jb, keys, coeffs, seed):
    res = jnp.asarray(jb.p.plain_to_residues(coeffs))
    return jb.encrypt(keys, res, jax.random.key(seed))


def _planes_equal(jb, keys, tb, tkeys, jct, tct):
    """The port's planes of tct equal the reference's of jct; returns the
    port's joined coefficients (object ints)."""
    lo, m2 = jb.decrypt_big_t_planes(keys, jct)
    tlo, tm2 = tb.decrypt_big_t_planes(tkeys, tct)
    assert tlo.dtype == torch.int64 and tm2.dtype == torch.int32
    np.testing.assert_array_equal(tlo.numpy().astype(np.uint32), np.asarray(lo))
    np.testing.assert_array_equal(tm2.numpy().view(np.uint32), np.asarray(m2))
    got = tb.join_big_t_planes(tlo, tm2)
    np.testing.assert_array_equal(
        got, jb.join_big_t_planes(np.asarray(lo), np.asarray(m2)))
    host = tb.decrypt(tkeys, tct)
    np.testing.assert_array_equal(host, jb.decrypt(keys, jct))
    np.testing.assert_array_equal(got.astype(object), host)
    return host


def test_plane_decrypt_bit_equal_fresh_and_edge(big_ctx):
    """Full-range coefficients; and a raw decrypt of q - 1 on every limb
    (a ciphertext (q - 1, 0)), which drives the wrap-around sums of the
    2**32 plane to their largest terms."""
    jb, keys, tb, tkeys = big_ctx
    m = _big_ints(N, jb.p.t)
    jct = _enc(jb, keys, m, seed=1)
    got = _planes_equal(jb, keys, tb, tkeys, jct, _t(jct.data))
    np.testing.assert_array_equal(got, m)
    q = np.array(COEFF, np.uint32).reshape(-1, 1)
    edge = np.zeros((2, len(COEFF), N), np.uint32)
    edge[0] = q - 1
    _planes_equal(jb, keys, tb, tkeys, Ciphertext(jnp.asarray(edge)), _t(edge))


def test_plane_decrypt_after_multiply_and_rotation(big_ctx):
    """The port's multiply + relinearize and rotation of a reference
    ciphertext are bit-equal to the reference's, and so are their
    planes."""
    jb, keys, tb, tkeys = big_ctx
    m = _big_ints(N, 1 << 19)
    jct = _enc(jb, keys, m, seed=2)
    tct = _t(jct.data)
    jsq = jb.relinearize(jb.square(jct), keys)
    tsq = tb.relinearize(tb.multiply(tct, tct), tkeys)
    np.testing.assert_array_equal(tsq.numpy().view(np.uint32), np.asarray(jsq.data))
    _planes_equal(jb, keys, tb, tkeys, jsq, tsq)
    jrot = jb.rotate_rows(jct, 3, keys)
    trot = tb.rotate_rows(tct, 3, tkeys)
    np.testing.assert_array_equal(trot.numpy().view(np.uint32), np.asarray(jrot.data))
    _planes_equal(jb, keys, tb, tkeys, jrot, trot)


def test_plane_decrypt_batched(big_ctx):
    jb, keys, tb, tkeys = big_ctx
    m = _big_ints((3, N), jb.p.t)
    jct = _enc(jb, keys, m, seed=3)
    got = _planes_equal(jb, keys, tb, tkeys, jct, _t(jct.data))
    assert got.shape == (3, N)
    np.testing.assert_array_equal(got, m)


# ------------------------------------------------------ factory-level CRT
@pytest.fixture(scope="module")
def big_fac():
    return CrtBfvFactory(plain_primes=BIG_TS, n=N, coeff_modulus=COEFF,
                         dbc=16, seed=5, device="cpu")


def test_big_fac_flags(big_fac):
    assert big_fac._device_decode_big
    assert not big_fac._device_decode and not big_fac._device_encode
    assert big_fac._plain_ntt is None


def test_big_fac_vector_roundtrip(big_fac):
    """Values up to the ~78-bit CRT product survive encrypt -> two-plane
    decrypt -> CRT join, signed; and the split into residues is the
    reference's."""
    M = big_fac.plain_crt.product
    vals = [0, 1, -1, 123456789, -(1 << 62), (M - 1) // 2, -((M - 1) // 2)]
    data = big_fac.encrypt_blocks(np.array(vals, dtype=object), len(vals))
    assert data.shape == (2, 1, 2, len(COEFF), N)
    got = big_fac.decrypt_blocks(data, len(vals))
    np.testing.assert_array_equal(got, np.array(vals, dtype=object))
    for a, b in zip(big_fac.split_big_numbers(vals),
                    [(np.array(vals, dtype=object) % t).astype(np.int64)
                     for t in BIG_TS]):
        np.testing.assert_array_equal(a, b)


def test_big_fac_ops_match_plain(big_fac):
    a = RNG.integers(-(1 << 18), 1 << 18, size=12).astype(float)
    b = RNG.integers(-(1 << 18), 1 << 18, size=12).astype(float)
    va = big_fac.get_encrypted_vector(a, "dense", 1.0)
    vb = big_fac.get_encrypted_vector(b, "dense", 1.0)
    ai, bi = a.astype(np.int64), b.astype(np.int64)
    np.testing.assert_array_equal(
        va.add(vb).decrypt_full_precision().astype(np.int64), ai + bi)
    np.testing.assert_array_equal(
        va.pointwise_multiply(vb).decrypt_full_precision().astype(np.int64), ai * bi)
    assert int(va.dot_product(vb).decrypt_full_precision()[0]) == int(np.dot(ai, bi))
    sp = big_fac.get_encrypted_vector(a[:3], "sparse", 2.0)
    np.testing.assert_array_equal(sp.decrypt(), a[:3])


def test_big_fac_matrix_decrypt_columns(big_fac):
    """The batched decrypt of all matrix columns (decrypt_columns)."""
    m = RNG.integers(-50, 50, size=(6, 3)).astype(float)
    enc = big_fac.get_encrypted_matrix(m, "col", scale=4.0)
    np.testing.assert_array_equal(enc.decrypt(), m)


def test_mixed_plain_primes_decrypt_exactly_on_the_host():
    """A plain prime below 2**31 beside one above: neither device decode
    applies, so the factory encodes on the host and decrypts with the
    exact host decrypt; signed values past 2**40 come back."""
    small = ntt_primes(N, 20, 1)[0]
    fac = CrtBfvFactory(plain_primes=(small, BIG_TS[0]), n=N, coeff_modulus=COEFF,
                        dbc=16, seed=6, device="cpu")
    assert not (fac._device_encode or fac._device_decode or fac._device_decode_big)
    vals = np.array([0, 5, -7, 1 << 40, -(1 << 45)], dtype=object)
    data = fac.encrypt_blocks(vals, len(vals))
    np.testing.assert_array_equal(fac.decrypt_blocks(data, len(vals)), vals)


# ------------------------------------------------- mini network at big t
def test_big_t_mini_cryptonets_network():
    """conv -> square -> dense -> square on the big-t factory equals the
    Raw oracle: the host encode, the contraction, BEHZ with a 39-bit t and
    the two-plane decrypt on one path."""
    from cryptonets_tpu_torch.nn.layers import EncryptLayer, PoolLayer, SquareActivation
    from cryptonets_tpu_torch.nn.readers import BatchReader

    rng = np.random.default_rng(123)
    batch, side = 3, 6
    recs = [(0, rng.integers(0, 4, side * side).astype(float)) for _ in range(batch)]
    conv_w = rng.integers(-2, 3, 2 * 3 * 3).astype(float)
    deep_chain = ntt_primes(N, 30, 7)

    def build(fac):
        reader = BatchReader(RawFactory(N), max_slots=batch, scale=2.0)
        reader.set_source_records([(lb, f.copy()) for lb, f in recs])
        enc = EncryptLayer(reader)
        enc.factory = fac
        conv = PoolLayer(enc, input_shape=[side, side], kernel_shape=[3, 3],
                         stride=[2, 2], map_count=[2, 1], weights=conv_w,
                         bias=np.array([1.0, -1.0]), weights_scale=4.0)
        n_feat = 2 * len(conv.engine.corners)
        rs = np.random.default_rng(321)
        dense = PoolLayer(SquareActivation(conv), input_shape=[n_feat],
                          kernel_shape=[n_feat], stride=[n_feat + 1],
                          map_count=[4],
                          weights=rs.integers(-3, 4, 4 * n_feat).astype(float),
                          bias=rs.integers(-5, 6, 4).astype(float),
                          weights_scale=4.0)
        head = SquareActivation(dense)
        head.prepare_network()
        return head

    fac = CrtBfvFactory(plain_primes=BIG_TS, n=N, coeff_modulus=deep_chain,
                        dbc=16, seed=7, device="cpu")
    raw = build(RawFactory(N)).get_next().decrypt()
    out = build(fac).get_next()
    np.testing.assert_allclose(out.decrypt(), raw, rtol=1e-9, atol=0)
    assert min(v.noise_budget() for v in out.vectors) > 0


# ---------------------------------------------------------- the BSGS guard
def test_bsgs_refuses_a_factory_that_encodes_on_the_host(big_fac):
    """The diagonals of BSGS are encoded on the device as one residue for
    every limb: a big-t factory must be refused (reference
    `api/bsgs.py:91-95`), and a force-dense LLDenseLayer on it must not
    take BSGS (reference `nn/lola.py:484`): it takes per-row dots with
    the forced dense output."""
    from cryptonets_tpu_torch.api.bsgs import BsgsDenseForm
    from cryptonets_tpu_torch.nn.layers import EncryptLayer
    from cryptonets_tpu_torch.nn.lola import LLDenseLayer
    from cryptonets_tpu_torch.nn.readers import LLSingleLineReader

    w = RNG.integers(-3, 4, size=(4, 8))
    with pytest.raises(ValueError, match="device-side encoding"):
        BsgsDenseForm(big_fac, w, 4, 8)
    reader = LLSingleLineReader(RawFactory(N)).set_source_records(
        [(0, np.ones(8))])
    enc = EncryptLayer(reader)
    enc.factory = big_fac
    dense = LLDenseLayer(enc, weights=w.ravel().astype(float), bias=np.zeros(4),
                         input_format="dense", force_dense_format=True,
                         use_bsgs=True)
    dense.factory = big_fac
    dense.prepare()
    assert dense.bsgs_form is None and dense.weights_matrix.fmt == "row"
    assert dense.weights_matrix._unit_masks.shape == (2, 4, len(COEFF), N)
