"""LoLa-CIFAR against the JAX package on the CPU.

At n = 256 a CIFAR-shaped chain runs in both packages on the same
ciphertext under the same keys (hybrid key switching with one special
prime, as the `cifar` preset): a 3-channel stride-2 conv with padding on
the two spatial axes (27 maps, one exact contraction), a Vectorize of 27
pieces at stride 9 with the single-hop key for -9 (Horner runs), a
square, a conv-as-dense layer with padding through BSGS with F = 2
(243 inputs span both slot rows) and chained babies, a square and a
per-row Dense(10).  The ciphertexts are bit-equal after every layer and
the decoded logits equal the Raw oracle.  At full width the port's Raw
path of `lola_cifar.build` (the reader's 196 corners x 192 offsets, the
5488 x 16268 conv-as-dense) gives the reference's logits; the records
and the preset equal the reference's.  Integers bit-equal; Raw logits at
rtol 1e-9.
"""

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
GEO = dict(input_shape=[3, 5, 5], kernel_shape=[3, 3, 3],
           upper_padding=[0, 1, 1], lower_padding=[0, 1, 1], stride=[1000, 2, 2])
DENSE_ENGINE = dict(input_shape=[MAPS, 3, 3], kernel_shape=[MAPS, 2, 2],
                    upper_padding=[0, 1, 1], lower_padding=[0, 1, 1],
                    stride=[MAPS, 1, 1], map_count=[4, 1, 1])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread runs them as fast and
    keeps parallel test workers from oversubscribing the cores."""
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


def _cifar_chain(L, factory, raw_factory, records):
    """Conv (27 maps, bias) -> Vectorize (243) -> Square -> conv-as-dense
    (64 outputs, BSGS, F = 2) -> Square -> Dense(10)."""
    rng = np.random.default_rng(5)
    w0 = rng.integers(-2, 3, MAPS * 27).astype(float)
    b0 = rng.integers(-2, 3, MAPS).astype(float)
    w1 = rng.integers(-2, 3, 4 * MAPS * 4).astype(float)
    b1 = rng.integers(-2, 3, 4).astype(float)
    w2 = rng.integers(-2, 3, 10 * 64).astype(float)
    b2 = rng.integers(-2, 3, 10).astype(float)
    reader = L.LLConvReader(raw_factory, sparse_format=False,
                            normalization_factor=1.0, scale=2.0, **GEO)
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
    return [(0, rng.integers(0, 4, 75).astype(float)) for _ in range(count)]


def test_cifar_chain_bit_equal_layer_by_layer(tmp_path):
    records = _records()
    kw = dict(seed=8, n_special=1)
    jf = japi.CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN,
                            rot_steps=(-STRIDE,), **kw)
    jfwd = JaxForward(_cifar_chain(jnn, jf, japi.RawFactory(N), records), jit=False)
    jm = jfwd.encrypt_layer.apply(jfwd.reader.get_next())

    path = str(tmp_path / "keys.npz")
    japi.CrtBfvFactory._save_cached_keys(path, jf.keys)
    with np.load(path) as z:
        keys = keyset_from_numpy(z, device="cpu")
    tf = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN,
                       device="cpu", keys=keys, **kw)
    thead = _cifar_chain(_Port, tf, RawFactory(N), records)
    form = thead.source.source.bsgs_form
    assert (form.F, form.in_dim, form.out_dim) == (2, 243, 64)
    tfwd = EncryptedForward(thead)
    reader = tfwd.reader
    assert (len(reader.engine.corners), len(reader.engine.offsets)) == (9, 27)
    tm = HEMatrix(tf, [
        HEVector(tf, data=torch.from_numpy(np.array(v.data, np.uint32).view(np.int32)),
                 dim=v.dim, scale=v.scale, fmt=v.fmt)
        for v in jm.vectors
    ], jm.fmt)
    assert len(tm.vectors) == 27
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

    raw = _cifar_chain(_Port, RawFactory(N), RawFactory(N), records)
    raws = [raw.get_next().get_column(0) for _ in records]
    assert list(out.decrypt_full_precision()) == list(raws[0].decrypt_full_precision())
    for want in raws:       # the port's own encode, encrypt and decode
        got = tfwd().get_column(0)
        np.testing.assert_allclose(got.decrypt(), want.decrypt(), rtol=1e-9, atol=0)
        assert list(got.decrypt_full_precision()) == list(want.decrypt_full_precision())
        assert got.noise_budget() > 0


def test_records_and_preset_equal_reference():
    from cryptonets_tpu.data.preprocess import synthetic_cifar_records as jrecs
    from cryptonets_tpu.models import presets as jp
    from cryptonets_tpu_torch.data.preprocess import synthetic_cifar_records
    from cryptonets_tpu_torch.models import presets

    assert presets.CONFIGS["cifar"] == jp.CONFIGS["cifar"]
    for (la, fa), (lb, fb) in zip(synthetic_cifar_records(3, seed=4), jrecs(3, seed=4)):
        assert la == lb and fa.dtype == fb.dtype
        np.testing.assert_array_equal(fa, fb)


@pytest.fixture(scope="module")
def full_width():
    """The Raw heads of both packages at n = 16384, built and prepared
    once (the reference's preparation dominates: about a minute)."""
    from cryptonets_tpu.models import lola_cifar as jlc
    from cryptonets_tpu_torch.data.preprocess import synthetic_cifar_records
    from cryptonets_tpu_torch.models import lola_cifar

    records = synthetic_cifar_records(2, seed=4)
    copy = lambda: [(lb, f.copy()) for lb, f in records]  # noqa: E731
    jh, _, jr = jlc.build(False, records=copy())
    th, _, tr = lola_cifar.build(False, records=copy())
    jh.prepare_network()
    th.prepare_network()
    return records, (jh, jr), (th, tr)


def test_full_width_raw_path_matches_reference(full_width):
    records, (jh, jr), (th, tr) = full_width
    e = tr.engine
    assert (len(e.corners), len(e.offsets)) == (196, 192)
    assert (len(jr.engine.corners), len(jr.engine.offsets)) == (196, 192)
    dense4 = th.source.source
    assert dense4.weights.size == 5488 * 16268 and len(dense4.bias) == 5488
    np.testing.assert_array_equal(dense4.weights, jh.source.source.source.weights)
    for _ in records:
        jc, tc = jh.get_next().get_column(0), th.get_next().get_column(0)
        assert tc.scale == jc.scale and tc.dim == 10
        np.testing.assert_array_equal(tc.decrypt(), jc.decrypt())
        assert tr.labels == jr.labels
