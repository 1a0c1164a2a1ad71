"""LoLaLarge against the JAX package on the CPU.

At n = 256 a LoLaLarge-shaped chain runs in both packages on the same
ciphertext and the same keys (hybrid key switching with two special
primes): a conv of 27 maps with its own bias (one exact contraction), a
Vectorize of 27 pieces at stride 9 with the single-hop key for -9 (a
scanned lower run, a piece crossing the row under a prefix mask, a
scanned upper run), a square, a conv-as-dense layer through BSGS with
chained babies, `_choose_g`'s baby count and the dense-support Horner, a
square and a per-row Dense(10).  The ciphertexts are bit-equal after
every layer and the decoded logits equal the Raw oracle.  At full width
(n = 16384) the port's Raw path of `build_lola_large` gives the
reference's logits, and the preset, the CSV weights reader and the
vectorised conv-as-dense lowering equal the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cryptonets_tpu.api as japi  # noqa: E402
import cryptonets_tpu.nn as jnn  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu.nn.jit import EncryptedForward as JaxForward  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory  # noqa: E402
from cryptonets_tpu_torch.api.matrix import HEMatrix  # noqa: E402
from cryptonets_tpu_torch.api.vector import HEVector  # noqa: E402
from cryptonets_tpu_torch.convert import keyset_from_numpy  # noqa: E402
from cryptonets_tpu_torch.nn import convolution as tconv  # noqa: E402
from cryptonets_tpu_torch.nn import lola as tlola  # noqa: E402
from cryptonets_tpu_torch.nn import readers as treaders  # noqa: E402
from cryptonets_tpu_torch.nn.forward import EncryptedForward  # noqa: E402
from cryptonets_tpu_torch.nn.layers import EncryptLayer, SquareActivation  # noqa: E402

N = 256
PLAIN = ntt_primes(N, 20, 3)
CHAIN = ntt_primes(N, 30, 7)
MAPS, STRIDE = 27, 9          # 27 conv maps of 3 x 3 windows
GEO = dict(input_shape=[1, 7, 7], kernel_shape=[1, 3, 3], stride=[1000, 2, 2])
DENSE_ENGINE = dict(input_shape=[MAPS, 3, 3], kernel_shape=[MAPS, 2, 2],
                    stride=[MAPS, 1, 1], map_count=[4, 1, 1])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many small tensor ops: one intra-op
    thread runs them as fast alone and keeps parallel test workers from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Port:
    EncryptLayer, SquareActivation = EncryptLayer, SquareActivation
    LLConvReader = treaders.LLConvReader
    ConvolutionEngine = tconv.ConvolutionEngine
    LLPoolLayer, LLVectorizeLayer, LLDenseLayer = (
        tlola.LLPoolLayer, tlola.LLVectorizeLayer, tlola.LLDenseLayer)


def _large_chain(L, factory, raw_factory, records):
    """Conv (27 maps, bias) -> Vectorize (243) -> Square ->
    conv-as-dense (16 outputs, BSGS) -> Square -> Dense(10)."""
    rng = np.random.default_rng(5)
    w0 = rng.integers(-2, 3, MAPS * 9).astype(float)
    b0 = rng.integers(-2, 3, MAPS).astype(float)
    w1 = rng.integers(-2, 3, 4 * MAPS * 4).astype(float)
    b1 = rng.integers(-2, 3, 4).astype(float)
    w2 = rng.integers(-2, 3, 10 * 16).astype(float)
    b2 = rng.integers(-2, 3, 10).astype(float)
    reader = L.LLConvReader(raw_factory, normalization_factor=1.0, scale=2.0, **GEO)
    reader.set_source_records([(lb, f.copy()) for lb, f in records])
    enc = L.EncryptLayer(reader)
    enc.factory = factory
    conv = L.LLPoolLayer(enc, map_count=[MAPS, 1, 1], weights=w0, bias=b0,
                         weights_scale=2.0, **GEO)
    act = L.SquareActivation(L.LLVectorizeLayer(conv))
    engine = L.ConvolutionEngine(**DENSE_ENGINE)
    dense = L.LLDenseLayer(
        act, weights=engine.get_dense_weights(w1).ravel(),
        bias=engine.get_dense_bias(b1), weights_scale=2.0,
        input_format="dense", force_dense_format=True, use_bsgs=True)
    head = L.LLDenseLayer(L.SquareActivation(dense), weights=w2, bias=b2,
                          weights_scale=2.0, input_format="dense")
    head.prepare_network()
    return head


def _records(count=2):
    rng = np.random.default_rng(12)
    return [(0, rng.integers(0, 4, 49).astype(float)) for _ in range(count)]


def test_large_chain_bit_equal_layer_by_layer(tmp_path):
    records = _records()
    kw = dict(seed=8, n_special=2)
    jf = japi.CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN,
                            rot_steps=(-STRIDE,), **kw)
    jfwd = JaxForward(_large_chain(jnn, jf, japi.RawFactory(N), records), jit=False)
    jm = jfwd.encrypt_layer.apply(jfwd.reader.get_next())

    path = str(tmp_path / "keys.npz")
    japi.CrtBfvFactory._save_cached_keys(path, jf.keys)
    with np.load(path) as z:
        keys = keyset_from_numpy(z, device="cpu")
    tf = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN,
                       device="cpu", keys=keys, **kw)
    thead = _large_chain(_Port, tf, RawFactory(N), records)
    form = thead.source.source.bsgs_form
    assert (form.F, form.g, form.G) == (2, 8, 16)        # _choose_g(128, 2)
    assert len(form.active) > max(4, form.G // 4)        # dense support
    tfwd = EncryptedForward(thead)
    tm = HEMatrix(tf, [
        HEVector(tf, data=torch.from_numpy(np.array(v.data, np.uint32).view(np.int32)),
                 dim=v.dim, scale=v.scale, fmt=v.fmt)
        for v in jm.vectors
    ], jm.fmt)
    assert len(tm.vectors) == 9
    assert len(jfwd.layers) == len(tfwd.layers) == 6
    for jl, tl in zip(jfwd.layers, tfwd.layers):
        jm, tm = jl.apply(jm), tl.apply(tm)
        name = type(tl).__name__
        assert len(jm.vectors) == len(tm.vectors), name
        for jv, tv in zip(jm.vectors, tm.vectors):
            np.testing.assert_array_equal(
                tv.data.numpy().view(np.uint32), np.asarray(jv.data), err_msg=name)
            assert (tv.dim, tv.scale, tv.fmt) == (jv.dim, jv.scale, jv.fmt), name
    out = tm.get_column(0)
    assert out.fmt == "sparse" and out.dim == 10

    raw = _large_chain(_Port, RawFactory(N), RawFactory(N), records)
    raws = [raw.get_next().get_column(0).decrypt_full_precision() for _ in records]
    assert list(out.decrypt_full_precision()) == list(raws[0])
    for want in raws:       # the port's own encode, encrypt and decode
        got = tfwd().get_column(0)
        assert list(got.decrypt_full_precision()) == list(want)
        assert got.noise_budget() > 0


def test_full_width_raw_path_matches_reference():
    """n = 16384, the seeded stand-in weights: the port's Raw oracle of
    build_lola_large equals the reference's, and so do the preset and the
    conv-as-dense lowering."""
    from cryptonets_tpu.models import lola_mnist as jlm
    from cryptonets_tpu.models import presets as jp
    from cryptonets_tpu.nn.convolution import ConvolutionEngine as JEngine
    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.models import lola_mnist, presets

    assert presets.CONFIGS["lola_large"] == jp.CONFIGS["lola_large"]
    records = synthetic_mnist_records(2, seed=11)
    copy = lambda: [(lb, f.copy()) for lb, f in records]  # noqa: E731
    jh = jlm.build_lola_large(False, records=copy())[0]
    th = lola_mnist.BUILDERS["LoLaLarge"](False, records=copy())[0]
    jh.prepare_network()
    th.prepare_network()
    for _ in records:
        jc, tc = jh.get_next().get_column(0), th.get_next().get_column(0)
        assert tc.scale == jc.scale and tc.dim == 10
        np.testing.assert_array_equal(tc.decrypt(), jc.decrypt())
    # the lowering at a small shape with padding on every axis
    kw = dict(input_shape=[3, 7, 7], kernel_shape=[3, 3, 3], stride=[3, 2, 2],
              upper_padding=[0, 1, 1], lower_padding=[0, 1, 1], map_count=[4, 1, 1])
    w = np.random.default_rng(2).normal(size=4 * 27)
    np.testing.assert_array_equal(tconv.ConvolutionEngine(**kw).get_dense_weights(w),
                                  JEngine(**kw).get_dense_weights(w))


def test_weights_reader_and_csv_weights_equal_reference(tmp_path):
    from cryptonets_tpu.nn.readers import WeightsReader as JReader
    from cryptonets_tpu_torch.models.lola_mnist import lola_large_weights

    rng = np.random.default_rng(4)
    rows = [rng.normal(size=s) for s in (12, 5, 7)]
    wcsv, bcsv = tmp_path / "w.csv", tmp_path / "b.csv"
    wcsv.write_text("\n".join(",".join(repr(float(x)) for x in r) for r in rows) + "\n\n")
    bcsv.write_text("1.5,2\n-3\n0.25,0.5,0.75\n")
    t, j = treaders.WeightsReader(str(wcsv), str(bcsv)), JReader(str(wcsv), str(bcsv))
    for a, b in ((t.weights, j.weights), (t.biases, j.biases)):
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    w0, b0, w1, b1, w2, b2 = lola_large_weights(str(wcsv), str(bcsv))
    np.testing.assert_array_equal(w0, rows[0] / 256.0)
    np.testing.assert_array_equal(w2, rows[2])
    np.testing.assert_array_equal(b1, [-3.0])
