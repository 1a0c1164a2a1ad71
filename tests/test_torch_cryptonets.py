"""The CryptoNets slice of the port against the JAX reference at n = 256
with a 3-prime plain CRT and digit key switching (dbc = 16): with the
reference's keys imported through `keyset_from_numpy` and the same input
ciphertexts, relinearisation (stacked and accumulated over the digits), a
rotation, the chunked elementwise multiply, both branches of PoolLayer and
the whole reduced network give bit-equal ciphertexts; with the port's own
keys the decrypted output equals the Raw oracle exactly, and the port's
Raw oracle equals the reference's.  Integers are compared exactly; the
float outputs of the two Raw oracles with rtol = 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cryptonets_tpu.api as japi  # noqa: E402
import cryptonets_tpu.nn as jnn  # noqa: E402
from cryptonets_tpu.crypto.bfv import Ciphertext  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu.nn.jit import EncryptedForward as JaxForward  # noqa: E402
from cryptonets_tpu_torch.api import matrix as tmatrix  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory  # noqa: E402
from cryptonets_tpu_torch.api.matrix import HEMatrix  # noqa: E402
from cryptonets_tpu_torch.api.vector import HEVector  # noqa: E402
from cryptonets_tpu_torch.convert import keyset_from_numpy  # noqa: E402
from cryptonets_tpu_torch.crypto.bfv import BFV  # noqa: E402
from cryptonets_tpu_torch.nn import layers as tlayers  # noqa: E402
from cryptonets_tpu_torch.nn import readers as treaders  # noqa: E402
from cryptonets_tpu_torch.nn.forward import EncryptedForward  # noqa: E402

N = 256
PLAIN = ntt_primes(N, 20, 3)
CHAIN = ntt_primes(N, 30, 6)
FAC = dict(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, dbc=16, seed=7)
BATCH, SIDE = 3, 6

JAX_MODS = (jnn.BatchReader, jnn.EncryptLayer, jnn.PoolLayer, jnn.SquareActivation)
PORT_MODS = (treaders.BatchReader, tlayers.EncryptLayer, tlayers.PoolLayer,
             tlayers.SquareActivation)


def _t(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _np(x):
    return x.numpy().view(np.uint32)


def _records():
    rng = np.random.default_rng(123)
    return [(int(rng.integers(0, 10)), rng.integers(0, 4, SIDE * SIDE).astype(float))
            for _ in range(BATCH)]


def _network(mods, factory, raw_factory):
    """The reduced CryptoNets-shaped network of `tests/test_bigt.py` in
    either package: conv(2 maps, 3x3, stride 2) -> square -> dense(4) ->
    square -> dense(2).  Returns the layers, head last."""
    Reader, Enc, Pool, Square = mods
    rng = np.random.default_rng(5)
    reader = Reader(raw_factory, max_slots=BATCH, scale=2.0)
    reader.set_source_records([(lb, f.copy()) for lb, f in _records()])
    enc = Enc(reader)
    enc.factory = factory
    conv = Pool(enc, input_shape=[SIDE, SIDE], kernel_shape=[3, 3],
                stride=[2, 2], upper_padding=[1, 1], map_count=[2, 1],
                weights=rng.integers(-2, 3, 2 * 10).astype(float),
                weights_scale=4.0)            # bias embedded in the windows
    act = Square(conv)
    n_feat = 2 * len(conv.engine.corners)
    dense = Pool(act, input_shape=[n_feat], kernel_shape=[n_feat],
                 stride=[n_feat + 1], map_count=[4],
                 weights=rng.integers(-3, 4, 4 * n_feat).astype(float),
                 bias=rng.integers(-5, 6, 4).astype(float), weights_scale=4.0)
    act2 = Square(dense)
    dense2 = Pool(act2, input_shape=[4], kernel_shape=[4], stride=[5],
                  map_count=[2], weights=rng.integers(-3, 4, 8).astype(float),
                  bias=np.array([1.0, -2.0]), weights_scale=2.0)
    dense2.prepare_network()
    return dict(reader=reader, enc=enc, conv=conv, act=act, dense=dense,
                act2=act2, head=dense2)


def _to_port(m, tf):
    return HEMatrix(tf, [
        HEVector(tf, data=_t(v.data), dim=v.dim, scale=v.scale, fmt=v.fmt)
        for v in m.vectors
    ], m.fmt)


def _assert_matrix_equal(tm, jm):
    assert len(tm.vectors) == len(jm.vectors) and tm.fmt == jm.fmt
    for tv, jv in zip(tm.vectors, jm.vectors):
        assert (tv.dim, tv.scale, tv.fmt) == (jv.dim, jv.scale, jv.fmt)
        np.testing.assert_array_equal(_np(tv.data), np.asarray(jv.data))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference factory, port factory with the reference's digit keys)."""
    jf = japi.CrtBfvFactory(**FAC)
    path = str(tmp_path_factory.mktemp("keys") / "keys.npz")
    japi.CrtBfvFactory._save_cached_keys(path, jf.keys)
    with np.load(path) as z:
        keys = keyset_from_numpy(z, device="cpu")
    return jf, CrtBfvFactory(**FAC, device="cpu", keys=keys)


@pytest.fixture(scope="module")
def stages(pair):
    """The reference network run eagerly, stage by stage, and the port's
    layers over the same keys: (reference outputs, port layers)."""
    jf, tf = pair
    jnet = _network(JAX_MODS, jf, japi.RawFactory(N))
    out = {"enc": jnet["enc"].apply(jnet["reader"].get_next())}
    prev = "enc"
    for name in ("conv", "act", "dense", "act2", "head"):
        out[name] = jnet[name].apply(out[prev])
        prev = name
    return out, _network(PORT_MODS, tf, RawFactory(N))


def test_digit_tables_and_keys_import(pair):
    jf, tf = pair
    jp, tp = jf.params[0], tf.params[0]
    assert not tp.ks_hybrid and tp.digits_per_limb == jp.digits_per_limb == 2
    kD = tp.k * tp.digits_per_limb
    np.testing.assert_array_equal(
        tp.ks_digit_w.numpy(), np.asarray(jf.bfv[0]._digit_w_tables()[0]))
    assert tuple(tf.keys.relin.k0.shape) == (kD, tp.k, N)
    np.testing.assert_array_equal(_np(tf.keys.relin.k1), np.asarray(jf.keys.relin.k1))
    assert sorted(tf.keys.galois) == sorted(jf.keys.galois)


@pytest.mark.parametrize("form", ["stacked", "accumulated"])
def test_digit_key_switch_bit_equal(pair, stages, form):
    """relinearize and a rotation through the digit key switch, in both
    forms, on a batch of ciphertexts [V, C, size, k, N]."""
    jf, tf = pair
    enc = stages[0]["enc"]
    a = np.stack([np.asarray(v.data) for v in enc.vectors[:3]], axis=1)
    b = np.stack([np.asarray(v.data) for v in enc.vectors[3:6]], axis=1)
    for pi in (0, 2):
        jb, tb = jf.bfv[pi], BFV(tf.params[pi])
        tb.digit_stack_bytes = 0 if form == "accumulated" else 1 << 40
        prod = np.asarray(jb.multiply(Ciphertext(a[pi]), Ciphertext(b[pi])).data)
        np.testing.assert_array_equal(_np(tb.multiply(_t(a[pi]), _t(b[pi]))), prod)
        want = np.asarray(jb.relinearize(Ciphertext(prod), jf.keys).data)
        np.testing.assert_array_equal(_np(tb.relinearize(_t(prod), tf.keys)), want)
        g = jb.galois_elt_rows(4)
        np.testing.assert_array_equal(
            _np(tb.apply_galois(_t(a[pi]), g, tf.keys)),
            np.asarray(jb.apply_galois(Ciphertext(a[pi]), g, jf.keys).data))


@pytest.mark.parametrize("limit", [0, 1 << 40])
def test_port_digit_keys_round_trip(limit):
    """The port's own digit keys: encrypt, multiply, relinearize and
    decrypt exactly, in the accumulated and the stacked form."""
    tf = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, dbc=16,
                       seed=11, device="cpu")
    for bfv in tf.bfv:
        bfv.digit_stack_bytes = limit
    rng = np.random.default_rng(2)
    a = rng.integers(-40, 41, N).astype(float)
    b = rng.integers(-40, 41, N).astype(float)
    va, vb = tf.get_encrypted_matrix(np.stack([a, b], axis=1), "col").vectors
    prod = va.pointwise_multiply(vb)
    assert prod.data.shape[-3] == 2
    np.testing.assert_array_equal(prod.decrypt(), a * b)
    assert prod.noise_budget() > 40
    row = N // 2
    np.testing.assert_array_equal(
        va.rotate(3).decrypt(),
        np.concatenate([np.roll(a[:row], -3), np.roll(a[row:], -3)]))


def test_chunked_elementwise_multiply_bit_equal(pair, stages, monkeypatch):
    """Pieces of 2 columns over 5 (a remainder of 1) against the
    reference's batched multiply under the same keys and inputs."""
    jf, tf = pair
    enc = stages[0]["enc"]
    ja = jf.get_matrix(enc.vectors[:5], "col")
    jb = jf.get_matrix(enc.vectors[5:10], "col")
    want = ja.elementwise_multiply(jb)
    monkeypatch.setattr(tmatrix, "MULT_CHUNK", 2)
    got = _to_port(ja, tf).elementwise_multiply(_to_port(jb, tf))
    _assert_matrix_equal(got, want)
    sq = _to_port(ja, tf)
    _assert_matrix_equal(sq.elementwise_multiply(sq), ja.elementwise_multiply(ja))


@pytest.mark.parametrize("branch,src", [("conv", "enc"), ("dense", "act"),
                                        ("head", "act2")])
def test_pool_layer_encrypted_bit_equal(pair, stages, branch, src):
    """Conv branch (padding, embedded bias) and dense branch (one exact
    modular contraction) of PoolLayer on the reference's ciphertexts."""
    _, tf = pair
    ref, tnet = stages
    got = tnet[branch].apply(_to_port(ref[src], tf))
    _assert_matrix_equal(got, ref[branch])


def test_tiny_cryptonets_chain(pair, stages):
    """The slice as a whole: same keys and encrypted input -> bit-equal
    output ciphertexts; the port's own pipeline (device encode, encrypt,
    decrypt, decode) equals its Raw oracle exactly; the two Raw oracles
    agree."""
    _, tf = pair
    ref, tnet = stages
    tfwd = EncryptedForward(tnet["head"])
    out = tfwd.run_encrypted(_to_port(ref["enc"], tf))
    _assert_matrix_equal(out, ref["head"])

    traw = _network(PORT_MODS, RawFactory(N), RawFactory(N))["head"].get_next()
    jraw = _network(JAX_MODS, japi.RawFactory(N), japi.RawFactory(N))["head"].get_next()
    assert traw.scale == jraw.scale
    np.testing.assert_allclose(traw.decrypt(), jraw.decrypt(), rtol=1e-12)
    want = traw.decrypt()
    assert want.shape == (BATCH, 2)
    # batched decrypt of the matrix, and column by column
    np.testing.assert_array_equal(out.decrypt(), want)
    np.testing.assert_array_equal(
        np.stack([v.decrypt() for v in out.vectors], axis=1), want)

    own = CrtBfvFactory(**{**FAC, "seed": 9}, device="cpu")
    ofwd = EncryptedForward(_network(PORT_MODS, own, RawFactory(N))["head"])
    res = ofwd()
    assert all(v._dec_slots is not None for v in res.vectors)
    np.testing.assert_array_equal(res.decrypt(), want)
    assert [list(v.decrypt_full_precision()) for v in res.vectors] == \
        [[int(x) for x in col] for col in traw.m.T]
    assert min(v.noise_budget() for v in res.vectors) > 0
    assert ofwd() is None   # the reader is drained


def test_reference_forward_matches_staged(pair, stages):
    """The reference's own EncryptedForward (eager) gives the staged
    outputs the other tests compare against."""
    jf, _ = pair
    jnet = _network(JAX_MODS, jf, japi.RawFactory(N))
    jfwd = JaxForward(jnet["head"], jit=False)
    out = jfwd.run_encrypted(stages[0]["enc"])
    for jv, sv in zip(out.vectors, stages[0]["head"].vectors):
        np.testing.assert_array_equal(np.asarray(jv.data), np.asarray(sv.data))


def test_pool_layer_raw_and_mean_pool():
    """Raw path of conv and dense, and the mean pool (window sums with a
    padding column) on both backends."""
    tnet = _network(PORT_MODS, RawFactory(N), RawFactory(N))
    jnet = _network(JAX_MODS, japi.RawFactory(N), japi.RawFactory(N))
    traw, jraw = tnet["reader"].get_next(), jnet["reader"].get_next()
    np.testing.assert_array_equal(traw.m, jraw.m)
    for name in ("conv", "act", "dense"):
        traw, jraw = tnet[name].apply(traw), jnet[name].apply(jraw)
        assert traw.scale == jraw.scale
        np.testing.assert_array_equal(traw.m, jraw.m)

    def pool(Pool, Reader, Enc, factory, raw_factory):
        reader = Reader(raw_factory, max_slots=BATCH, scale=2.0)
        reader.set_source_records([(lb, f.copy()) for lb, f in _records()])
        enc = Enc(reader)
        enc.factory = factory
        layer = Pool(enc, input_shape=[SIDE, SIDE], kernel_shape=[2, 2],
                     stride=[2, 2], lower_padding=[1, 0])
        layer.prepare_network()
        return layer

    jpool = pool(jnn.PoolLayer, jnn.BatchReader, jnn.EncryptLayer,
                 japi.RawFactory(N), japi.RawFactory(N)).get_next()
    tpool = pool(tlayers.PoolLayer, treaders.BatchReader, tlayers.EncryptLayer,
                 RawFactory(N), RawFactory(N)).get_next()
    assert tpool.scale == jpool.scale == 8.0
    np.testing.assert_array_equal(tpool.m, jpool.m)
    tf = CrtBfvFactory(**FAC, device="cpu")
    epool = pool(tlayers.PoolLayer, treaders.BatchReader, tlayers.EncryptLayer,
                 tf, RawFactory(N)).get_next()
    assert epool.is_encrypted and epool.scale == 8.0
    np.testing.assert_array_equal(epool.decrypt(), tpool.decrypt())


def test_batch_reader_matches_reference(tmp_path):
    recs = _records() + _records()[:2]
    jr = jnn.BatchReader(japi.RawFactory(N), max_slots=3, scale=4.0,
                         normalization_factor=0.5)
    tr = treaders.BatchReader(RawFactory(N), max_slots=3, scale=4.0,
                              normalization_factor=0.5)
    jr.set_source_records([(lb, f.copy()) for lb, f in recs])
    tr.set_source_records([(lb, f.copy()) for lb, f in recs])
    for want_rows in (3, 2):
        jm, tm = jr.get_next(), tr.get_next()
        assert tm.m.shape == (want_rows, SIDE * SIDE) and tm.scale == jm.scale
        np.testing.assert_array_equal(tm.m, jm.m)
        assert tr.labels == jr.labels
    assert tr.get_next() is None and jr.get_next() is None
    assert tr.output_dimension() == -1 and tr.get_output_scale() == 4.0

    path = tmp_path / "records.tsv"
    path.write_text("".join(
        f"{lb}\t{len(f)}\t" + "\t".join(f"{i}:{v}" for i, v in enumerate(f) if v)
        + "\n" for lb, f in recs))
    jr = jnn.BatchReader(japi.RawFactory(N), file_name=str(path), max_slots=4)
    tr = treaders.BatchReader(RawFactory(N), file_name=str(path), max_slots=4)
    for _ in range(2):
        jm, tm = jr.get_next(), tr.get_next()
        np.testing.assert_array_equal(tm.m, jm.m)
        assert tr.labels == jr.labels
    assert tr.get_next() is None


def test_cryptonets_preset_and_model():
    """The preset equals the reference's (less its NTT choice); the model
    raises without a card unless the caller asks for the CPU; its Raw
    oracle on the real weights equals the reference's."""
    from cryptonets_tpu.data.preprocess import synthetic_mnist_records as jrec
    from cryptonets_tpu.models import cryptonets_mnist as jmodel
    from cryptonets_tpu.models.presets import CONFIGS as JCONFIGS
    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.models import cryptonets_mnist as tmodel
    from cryptonets_tpu_torch.models.presets import CONFIGS, make_factory

    ref = dict(JCONFIGS["cryptonets"])
    ref.pop("ntt_impl")
    assert CONFIGS["cryptonets"] == {**ref, "dbc": 16, "ks_alpha": 0}
    # the reference's big-t presets are ported (their factories encode on
    # the host: tests/test_torch_bigt.py); LoLaLarge's Raw factory builds
    assert CONFIGS["cryptonets_bigt"] == JCONFIGS["cryptonets_bigt"]
    assert CONFIGS["lola_large_bigt"] == JCONFIGS["lola_large_bigt"]
    assert make_factory("lola_large_bigt", False).n == 16384
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmodel.build(True, 4, records=[])

    records = synthetic_mnist_records(6, seed=2)
    for (la, fa), (lb, fb) in zip(records, jrec(6, seed=2)):
        assert la == lb and np.array_equal(fa, fb)
    jh, _, jr = jmodel.build(False, 4, records=[(lb, f.copy()) for lb, f in records])
    th, _, tr = tmodel.build(False, 4, records=[(lb, f.copy()) for lb, f in records])
    jh.prepare_network()
    th.prepare_network()
    for rows in (4, 2):
        jm, tm = jh.get_next(), th.get_next()
        assert tm.scale == jm.scale and tr.labels == jr.labels
        assert tm.decrypt().shape == (rows, 10)
        np.testing.assert_allclose(tm.decrypt(), jm.decrypt(), rtol=1e-12)
    assert th.get_next() is None
    # evaluate: two Raw batches; ms per image is the last batch's own
    res = tmodel.evaluate(encrypt=False, batch_size=3, n_batches=2)
    assert res["count"] == 6 and len(res["batch_times"]) == 2
    assert res["amortized_ms"] == 1000.0 * res["batch_times"][-1] / 3
