"""Plain moduli of 2**62 and above in the port against the JAX package on
the CPU, at n = 256: one prime between 2**62 and 2**63 (the C++ host NTT's
range) and one of 64 bits above 2**63 (the object-int NTT's), over twelve 30-bit limbs.

  * the encoder and `plain_to_residues`, bit-equal to the reference's;
  * the exact host decrypt under the reference's keys (imported through
    `convert.keyset_from_numpy`) on the reference's ciphertexts: fresh,
    after a plaintext multiply, and after a ciphertext product with
    relinearisation, whose residues are bit-equal too;
  * a factory on the reference's key file (`api/serial.py`): it encodes on
    the host, keeps the ciphertexts on its device, decrypts on the host,
    and decrypts the reference's ciphertexts to the reference's values;
  * a small LoLa chain (conv, vectorize, square, dense) under each prime,
    its decoded output equal to the Raw oracle's.

Integers are compared bit-equal; the chain's output exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from cryptonets_tpu.api.factory import CrtBfvFactory as JaxFactory  # noqa: E402
from cryptonets_tpu.api import serial as jserial  # noqa: E402
from cryptonets_tpu.crypto.bfv import BFV as JaxBFV  # noqa: E402
from cryptonets_tpu.crypto.bfv import BFVParams as JaxParams  # noqa: E402
from cryptonets_tpu.crypto.encoder import BatchEncoder as JaxEncoder  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.api import serial  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory  # noqa: E402
from cryptonets_tpu_torch.convert import keyset_from_numpy  # noqa: E402
from cryptonets_tpu_torch.crypto.bfv import BFV, BFVParams  # noqa: E402
from cryptonets_tpu_torch.crypto.encoder import BatchEncoder  # noqa: E402
from cryptonets_tpu_torch.nn.layers import EncryptLayer, SquareActivation  # noqa: E402
from cryptonets_tpu_torch.nn.lola import (LLDenseLayer, LLPoolLayer,  # noqa: E402
                                          LLVectorizeLayer)
from cryptonets_tpu_torch.nn.readers import LLConvReader  # noqa: E402

N = 256
T62 = ntt_primes(N, 63, 1)[0]     # 2**62 < t < 2**63: the C++ host NTT
T64 = ntt_primes(N, 64, 1)[0]     # t >= 2**63: the object-int NTT
COEFF = ntt_primes(N, 30, 12)
TS = pytest.mark.parametrize("t", [T62, T64], ids=["t62", "t64"])
RNG = np.random.default_rng(62)


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


def _u(x):
    return x.numpy().view(np.uint32)


def _big_ints(shape, hi):
    """Uniform ints in [0, hi) as object ints (hi may pass 2**64)."""
    lo = RNG.integers(0, 1 << 62, size=shape).astype(object)
    top = RNG.integers(0, 1 << 30, size=shape).astype(object)
    return (top * (1 << 62) + lo) % hi


def test_primes_lie_at_2_62_and_above():
    assert (1 << 62) < T62 < (1 << 63) <= T64
    assert all((t - 1) % (2 * N) == 0 for t in (T62, T64))


@TS
def test_encoder_equals_reference(t):
    """encode and decode against the reference's encoder: slot values of
    the full range and signed values, and the round trip."""
    te, je = BatchEncoder(N, t), JaxEncoder(N, t)
    slots = _big_ints(N, t)
    coeffs = te.encode(slots)
    np.testing.assert_array_equal(np.asarray(coeffs).astype(object), je.encode(slots))
    np.testing.assert_array_equal(te.decode(coeffs), slots)
    np.testing.assert_array_equal(te.decode(coeffs), je.decode(je.encode(slots)))
    signed = RNG.integers(-(1 << 60), 1 << 60, N)
    np.testing.assert_array_equal(np.asarray(te.encode(signed)).astype(object),
                                  je.encode(signed))
    rows = _big_ints((2, N), t)      # leading axes, as the factory encodes
    np.testing.assert_array_equal(
        np.asarray(te.encode(rows)).astype(object)[1], je.encode(rows[1]))


@TS
def test_plain_to_residues_equals_reference(t):
    tp = BFVParams(N, t, coeff_modulus=COEFF, dbc=16, device="cpu")
    jp = JaxParams(N, t, coeff_modulus=COEFF, dbc=16)
    coeffs = _big_ints((2, N), t)
    want = jp.plain_to_residues(coeffs)
    forms = [coeffs] + ([coeffs.astype(np.uint64)] if t < 1 << 63 else [])
    for c in forms:
        got = tp.plain_to_residues(c)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    # no device decrypt for such t: neither the gamma nor the two-plane one
    assert tp.gamma is None and tp.big_gamma is None
    for name in ("B_list", "msk", "delta"):
        assert getattr(tp, name) == getattr(jp, name), name


@pytest.fixture(scope="module", params=[T62, T64], ids=["t62", "t64"])
def ctx(request, tmp_path_factory):
    """(reference BFV, its keys, port BFV, the same keys imported)."""
    t = request.param
    jb = JaxBFV(JaxParams(N, t, coeff_modulus=COEFF, dbc=16))
    keys = jb.keygen(seed=42)
    path = str(tmp_path_factory.mktemp("keys") / "keys.npz")
    JaxFactory._save_cached_keys(path, keys)
    with np.load(path) as z:
        tkeys = keyset_from_numpy(z, device="cpu")
    tb = BFV(BFVParams(N, t, coeff_modulus=COEFF, dbc=16, device="cpu"))
    return jb, keys, tb, tkeys


def _enc(jb, keys, coeffs, seed):
    res = jnp.asarray(jb.p.plain_to_residues(coeffs))
    return jb.encrypt(keys, res, jax.random.key(seed))


def test_host_decrypt_bit_equal_fresh_plain_product_and_product(ctx):
    """The exact host decrypt of the reference's ciphertexts equals the
    reference's: fresh (full-range plaintext), after a plaintext multiply
    and after a ciphertext product with relinearisation, whose residues
    equal the reference's bit for bit; each decrypts to the exact
    polynomial product mod t."""
    jb, keys, tb, tkeys = ctx
    t = jb.p.t
    m = _big_ints(N, t)
    jct = _enc(jb, keys, m, seed=1)
    got = tb.decrypt(tkeys, _t(jct.data))
    np.testing.assert_array_equal(got, jb.decrypt(keys, jct))
    np.testing.assert_array_equal(got, m)

    def negacyclic(a, b):
        full = np.convolve(a.astype(object), b.astype(object))
        out = full[:N].copy()
        out[: N - 1] -= full[N:]
        return out % t

    a = RNG.integers(0, 1 << 20, N).astype(object)
    b = RNG.integers(-8, 9, N).astype(object) % t
    ja = _enc(jb, keys, a, seed=2)
    pt = tb.prepare_plain_mult(_t(tb.p.plain_to_residues(b)))
    tprod = tb.mul_plain(_t(ja.data), pt)
    jprod = jb.mul_plain(ja, jb.prepare_plain_mult(jnp.asarray(jb.p.plain_to_residues(b))))
    np.testing.assert_array_equal(_u(tprod), np.asarray(jprod.data))
    np.testing.assert_array_equal(tb.decrypt(tkeys, tprod), negacyclic(a, b))

    c = RNG.integers(0, 1 << 20, N).astype(object)
    jc = _enc(jb, keys, c, seed=3)
    jsq = jb.relinearize(jb.multiply(ja, jc), keys)
    tsq = tb.relinearize(tb.multiply(_t(ja.data), _t(jc.data)), tkeys)
    np.testing.assert_array_equal(_u(tsq), np.asarray(jsq.data))
    got = tb.decrypt(tkeys, tsq)
    np.testing.assert_array_equal(got, jb.decrypt(keys, jsq))
    np.testing.assert_array_equal(got, negacyclic(a, c))


@TS
def test_factory_on_reference_keys(t, tmp_path):
    """A port factory on the reference's key file: host encode, the
    ciphertexts on its device, the host decrypt; it decrypts the
    reference's ciphertexts to the reference's values, and its own
    add_plain, plain and ciphertext products exactly."""
    jf = JaxFactory(plain_primes=(t,), n=N, coeff_modulus=COEFF, dbc=16, seed=7)
    path = str(tmp_path / "keys.npz")
    jserial.save_keys(jf, path)
    tf = serial.load_factory(path, device="cpu")
    assert not (tf._device_encode or tf._device_decode or tf._device_decode_big)
    vals = np.array([0, 1, -1, 123456789, -(1 << 61), (t - 1) // 2,
                     -((t - 1) // 2)], dtype=object)
    jdata = jf.encrypt_blocks(vals, len(vals))
    got = tf.decrypt_blocks(_t(jdata), len(vals))
    np.testing.assert_array_equal(got, jf.decrypt_blocks(jdata, len(vals)))
    np.testing.assert_array_equal(got, vals)

    a = RNG.integers(-(1 << 20), 1 << 20, 12).astype(float)
    b = RNG.integers(-(1 << 20), 1 << 20, 12).astype(float)
    va = tf.get_encrypted_vector(a, "dense", 1.0)
    vb = tf.get_encrypted_vector(b, "dense", 1.0)
    assert va.data.device == tf.device
    pb = tf.get_plain_vector(b, "dense", 1.0)
    ai, bi = a.astype(np.int64).astype(object), b.astype(np.int64).astype(object)
    np.testing.assert_array_equal(va.add(pb).decrypt_full_precision(), ai + bi)
    np.testing.assert_array_equal(
        va.pointwise_multiply(pb).decrypt_full_precision(), ai * bi)
    np.testing.assert_array_equal(
        va.pointwise_multiply(vb).decrypt_full_precision(), ai * bi)


def _chain(factory, records):
    """A small LoLa chain: LLConvReader -> Encrypt -> conv (2 maps) ->
    vectorize -> square -> dense(3) at n = 256."""
    rng = np.random.default_rng(9)
    geo = dict(input_shape=[8, 8], kernel_shape=[3, 3], upper_padding=[1, 1],
               stride=[2, 2])
    reader = LLConvReader(RawFactory(N), normalization_factor=1.0, scale=2.0, **geo)
    reader.set_source_records([(lb, f.copy()) for lb, f in records])
    enc = EncryptLayer(reader)
    enc.factory = factory
    conv = LLPoolLayer(enc, map_count=[2, 1],
                       weights=rng.integers(-2, 3, 18).astype(float),
                       bias=rng.integers(-2, 3, 2).astype(float),
                       weights_scale=2.0, **geo)
    act = SquareActivation(LLVectorizeLayer(conv))
    head = LLDenseLayer(act, weights=rng.integers(-2, 3, 3 * 32).astype(float),
                        bias=rng.integers(-2, 3, 3).astype(float),
                        weights_scale=2.0, input_format="dense")
    head.prepare_network()
    return head


@TS
def test_small_chain_matches_raw_oracle(t):
    records = [(0, np.random.default_rng(11).integers(0, 4, 64).astype(float))]
    fac = CrtBfvFactory(plain_primes=(t,), n=N, coeff_modulus=COEFF, dbc=16,
                        seed=3, device="cpu")
    out = _chain(fac, records).get_next().get_column(0)
    raw = _chain(RawFactory(N), records).get_next().get_column(0)
    np.testing.assert_array_equal(out.decrypt(), raw.decrypt())
    assert out.noise_budget() > 0
