"""LoLaSmall and Caltech-101 end to end against the JAX reference on the
CPU.

At n = 256 a LoLaSmall-shaped chain (conv 5 maps, vectorize, square,
per-row Dense(10); hybrid key switching with two special primes) and a
Caltech-shaped one (single-line reader, per-row Dense over two blocks;
digit key switching) run in both packages on the same ciphertext and the
same keys, under the butterfly and the four-step NTT, with bit-equal
ciphertexts after every layer; with the port's own keys the decoded
logits equal the Raw oracle exactly.  At full width the port's Raw paths
of `build_lola_small` and `caltech101.build` give the reference's logits.
The readers, the INI parser, the oracle extraction, the synthetic records
and the presets give the reference's outputs on the same files and
seeds."""

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
from cryptonets_tpu_torch.nn.forward import EncryptedForward  # noqa: E402
from cryptonets_tpu_torch.nn.layers import EncryptLayer, SquareActivation  # noqa: E402
from cryptonets_tpu_torch.nn.lola import LLDenseLayer, LLPoolLayer, LLVectorizeLayer  # noqa: E402
from cryptonets_tpu_torch.nn.readers import LLConvReader, LLSingleLineReader  # noqa: E402

N = 256
PLAIN = ntt_primes(N, 20, 2)
CHAIN = ntt_primes(N, 30, 5)
IMPLS = ("butterfly", "matmul")
GEO = dict(input_shape=[8, 8], kernel_shape=[3, 3], upper_padding=[1, 1],
           stride=[2, 2])
CAL_DIM, CAL_CLASSES = 300, 7   # two blocks of 256 slots

JAX_LAYERS = dict(Enc=jnn.EncryptLayer, Conv=jnn.LLConvReader,
                  Line=jnn.LLSingleLineReader, Pool=jnn.LLPoolLayer,
                  Vec=jnn.LLVectorizeLayer, Square=jnn.SquareActivation,
                  Dense=jnn.LLDenseLayer)
PORT_LAYERS = dict(Enc=EncryptLayer, Conv=LLConvReader, Line=LLSingleLineReader,
                   Pool=LLPoolLayer, Vec=LLVectorizeLayer,
                   Square=SquareActivation, Dense=LLDenseLayer)


def _small_chain(L, factory, raw_factory, records):
    """Conv (5 maps) -> Vectorize -> Square -> per-row Dense(10)."""
    rng = np.random.default_rng(3)
    conv_w = rng.integers(-2, 3, 5 * 9).astype(float)
    conv_b = rng.integers(-2, 3, 5).astype(float)
    d_w = rng.integers(-2, 3, 10 * 80).astype(float)
    d_b = rng.integers(-4, 5, 10).astype(float)
    reader = L["Conv"](raw_factory, normalization_factor=1.0, scale=2.0, **GEO)
    reader.set_source_records([(lb, f.copy()) for lb, f in records])
    enc = L["Enc"](reader)
    enc.factory = factory
    conv = L["Pool"](enc, map_count=[5, 1], weights=conv_w, bias=conv_b,
                     weights_scale=2.0, **GEO)
    act = L["Square"](L["Vec"](conv))
    head = L["Dense"](act, weights=d_w, bias=d_b, weights_scale=2.0,
                      input_format="dense")
    head.prepare_network()
    return head


def _caltech_chain(L, factory, raw_factory, records):
    """Single-line reader -> per-row Dense over two blocks."""
    rng = np.random.default_rng(4)
    w = rng.integers(-3, 4, CAL_CLASSES * CAL_DIM).astype(float)
    b = rng.integers(-4, 5, CAL_CLASSES).astype(float)
    reader = L["Line"](raw_factory, normalization_factor=1.0, scale=4.0)
    reader.set_source_records([(lb, f.copy()) for lb, f in records])
    enc = L["Enc"](reader)
    enc.factory = factory
    head = L["Dense"](enc, weights=w, bias=b, weights_scale=2.0,
                      input_format="dense")
    head.prepare_network()
    return head


def _small_records(count=2):
    rng = np.random.default_rng(11)
    return [(0, rng.integers(0, 4, 64).astype(float)) for _ in range(count)]


def _caltech_records(count=2):
    rng = np.random.default_rng(12)
    return [(i, rng.integers(0, 8, CAL_DIM) / 4.0) for i in range(count)]


CHAINS = {
    "small": (_small_chain, _small_records, dict(n_special=2), 10),
    "caltech": (_caltech_chain, _caltech_records, dict(dbc=16), CAL_CLASSES),
}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("which", sorted(CHAINS))
def test_chain_bit_equal_layer_by_layer(which, impl, tmp_path):
    chain, make_records, kw, n_out = CHAINS[which]
    records = make_records()
    jf = japi.CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN,
                            seed=7, ntt_impl=impl, **kw)
    jhead = chain(JAX_LAYERS, jf, japi.RawFactory(N), records)
    jfwd = JaxForward(jhead, jit=False)
    jm = jfwd.encrypt_layer.apply(jfwd.reader.get_next())

    path = str(tmp_path / "keys.npz")
    japi.CrtBfvFactory._save_cached_keys(path, jf.keys)
    with np.load(path) as z:
        keys = keyset_from_numpy(z, device="cpu")
    tf = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, seed=7,
                       ntt_impl=impl, device="cpu", keys=keys, **kw)
    thead = chain(PORT_LAYERS, tf, RawFactory(N), records)
    tfwd = EncryptedForward(thead)
    tm = HEMatrix(tf, [
        HEVector(tf, data=torch.from_numpy(np.array(v.data, np.uint32).view(np.int32)),
                 dim=v.dim, scale=v.scale, fmt=v.fmt)
        for v in jm.vectors
    ], jm.fmt)
    assert len(jfwd.layers) == len(tfwd.layers)
    for jl, tl in zip(jfwd.layers, tfwd.layers):
        jm, tm = jl.apply(jm), tl.apply(tm)
        assert len(jm.vectors) == len(tm.vectors), type(tl).__name__
        for jv, tv in zip(jm.vectors, tm.vectors):
            np.testing.assert_array_equal(
                tv.data.numpy().view(np.uint32), np.asarray(jv.data),
                err_msg=type(tl).__name__)
            assert (tv.dim, tv.scale, tv.fmt) == (jv.dim, jv.scale, jv.fmt)
    out = tm.get_column(0)
    assert out.fmt == "sparse" and out.dim == n_out
    assert tuple(out.data.shape[:2]) == (len(PLAIN), n_out)

    # the port's own pipeline (device encode, encrypt, sparse decode) on
    # every record, against the Raw oracle
    rhead = chain(PORT_LAYERS, RawFactory(N), RawFactory(N), records)
    raws = [rhead.get_next().get_column(0).decrypt_full_precision()
            for _ in records]
    assert list(out.decrypt_full_precision()) == list(raws[0])
    for want in raws:
        got = tfwd().get_column(0)
        assert got._dec_slots is not None
        assert list(got.decrypt_full_precision()) == list(want)
        assert got.noise_budget() > 0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("which", sorted(CHAINS))
def test_chain_own_keys_match_raw(which, impl):
    """Keys made by the port (over Q*P for the LoLaSmall shape), one
    special prime less than above."""
    chain, make_records, kw, _ = CHAINS[which]
    if "n_special" in kw:
        kw = dict(n_special=1)
    records = make_records(1)
    tf = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, seed=9,
                       ntt_impl=impl, device="cpu", **kw)
    got = EncryptedForward(chain(PORT_LAYERS, tf, RawFactory(N), records))()
    want = chain(PORT_LAYERS, RawFactory(N), RawFactory(N), records).get_next()
    assert list(got.get_column(0).decrypt_full_precision()) == \
        list(want.get_column(0).decrypt_full_precision())
    assert got.get_column(0).noise_budget() > 0


def test_full_width_raw_paths_match_reference():
    """Real lola_small.npz weights at n = 8192 and the synthetic Caltech
    parameters at n = 4096: the port's Raw oracles equal the reference's."""
    from cryptonets_tpu.data.preprocess import synthetic_feature_records as jfeat
    from cryptonets_tpu.data.preprocess import synthetic_mnist_records as jrec
    from cryptonets_tpu.models import caltech101 as jcal
    from cryptonets_tpu.models.lola_mnist import build_lola_small as jbuild
    from cryptonets_tpu_torch.data.preprocess import (
        synthetic_feature_records,
        synthetic_mnist_records,
    )
    from cryptonets_tpu_torch.models import caltech101
    from cryptonets_tpu_torch.models.lola_mnist import build_lola_small

    records = synthetic_mnist_records(2, seed=11)
    feats = synthetic_feature_records(2, caltech101.N_FEATURES, seed=6)
    for (la, fa), (lb, fb) in zip(feats, jfeat(2, jcal.N_FEATURES, seed=6)):
        assert la == lb and np.array_equal(fa, fb)
    copy = lambda rs: [(lb, f.copy()) for lb, f in rs]  # noqa: E731
    pairs = [
        (jbuild(False, records=copy(jrec(2, seed=11)))[0],
         build_lola_small(False, records=copy(records))[0], 10),
        (jcal.build(False, records=copy(feats))[0],
         caltech101.build(False, records=copy(feats))[0], 102),
    ]
    for jh, th, n_out in pairs:
        jh.prepare_network()
        th.prepare_network()
        for _ in range(2):
            jc, tc = jh.get_next().get_column(0), th.get_next().get_column(0)
            assert tc.scale == jc.scale and tc.dim == n_out
            np.testing.assert_array_equal(tc.decrypt(), jc.decrypt())


def test_presets_and_network_table_equal_reference():
    from cryptonets_tpu.models import presets as jp
    from cryptonets_tpu_torch.models import lola_cifar, lola_mnist, presets

    assert presets.SEAL_128_CHAIN_BITS == jp.SEAL_128_CHAIN_BITS
    for n, smc in ((4096, 2), (8192, 3), (8192, None), (16384, 7)):
        assert presets.coeff_count_for(n, smc) == jp.coeff_count_for(n, smc)
    for name in ("lola_small", "caltech", "lola", "lola_large", "cifar",
                 "lola_dense", "cryptonets_bigt"):
        assert presets.CONFIGS[name] == jp.CONFIGS[name]
    assert sorted(lola_mnist.BUILDERS) == [
        "LoLa", "LoLaBsgs", "LoLaDense", "LoLaLarge", "LoLaPacked", "LoLaSmall"]
    # the Raw paths of the builders of slices D and E and of CIFAR
    for name in ("LoLaPacked", "LoLaLarge", "LoLaDense"):
        res = lola_mnist.evaluate(lola_mnist.BUILDERS[name], encrypt=False,
                                  n_records=1)
        assert res["count"] == 1
    assert lola_cifar.evaluate(encrypt=False, n_records=1)["count"] == 1
    # the verbatim big-t preset of CIFAR is ported: equal to the
    # reference's, its Raw factory builds
    assert presets.CONFIGS["cifar_bigt"] == jp.CONFIGS["cifar_bigt"]
    assert presets.make_factory("cifar_bigt", False).n == 16384
    # the Raw path of the evaluation harness (full width is cheap in Raw)
    res = lola_mnist.evaluate(lola_mnist.build_lola_small, encrypt=False,
                              n_records=2)
    assert res["count"] == 2 and len(res["latencies"]) == 2


def test_readers_and_data_equal_reference(tmp_path):
    from cryptonets_tpu.data import testnetwork as jtn
    from cryptonets_tpu.models.caltech101 import IniReader as JIni
    from cryptonets_tpu_torch.data import testnetwork
    from cryptonets_tpu_torch.models.caltech101 import IniReader

    # the single-line reader, from records and from a sparse TSV file
    tsv = tmp_path / "feats.tsv"
    tsv.write_text("3\t6\t0:1.5\t4:2\n1\t6\t5:0.25\n")
    for make in (lambda R, F: R(F(8), file_name=str(tsv), normalization_factor=0.5,
                                scale=4.0),
                 lambda R, F: R(F(8), normalization_factor=0.5, scale=4.0)
                 .set_source_records([(3, np.arange(6.0)), (1, np.ones(6))])):
        jr = make(jnn.LLSingleLineReader, japi.RawFactory)
        tr = make(LLSingleLineReader, RawFactory)
        for _ in range(2):
            jm, tm = jr.get_next(), tr.get_next()
            np.testing.assert_array_equal(tm.m, jm.m)
            assert tm.m.shape == (6, 1) and tm.scale == jm.scale == 4.0
            assert tr.labels == jr.labels and tr.output_dimension() == 6
        assert tr.get_next() is None and jr.get_next() is None

    # a scorer source in the generated file's format, ten classes
    rng = np.random.default_rng(8)
    lines = []
    for c in range(10):
        idx = rng.choice(4096, 5, replace=False)
        terms = " + ".join(f"{rng.normal():.6g}*f[{i}]" for i in idx)
        lines.append(f"score[{c}] = {terms} + {rng.normal():.6g};")
    src = tmp_path / "TestNetwork.cs"
    src.write_text("class T { void S() {\n" + "\n".join(lines) + "\n} }\n")
    W, bias = testnetwork.parse_testnetwork(str(src))
    jW, jbias = jtn.parse_testnetwork(str(src))
    np.testing.assert_array_equal(W, jW)
    np.testing.assert_array_equal(bias, jbias)
    assert np.count_nonzero(W) == 50 and np.count_nonzero(bias) == 10
    f = rng.normal(size=4096)
    np.testing.assert_array_equal(testnetwork.score(W, bias, f), jtn.score(jW, jbias, f))

    # the extracted oracle model, written as an INI and parsed back
    oW, obias = testnetwork.load()
    np.testing.assert_array_equal(oW, jtn.load()[0])
    np.testing.assert_array_equal(obias, jtn.load()[1])
    ini_t, ini_j = tmp_path / "t.ini", tmp_path / "j.ini"
    testnetwork.write_model_ini(str(ini_t), oW, obias)
    jtn.write_model_ini(str(ini_j), oW, obias)
    assert ini_t.read_text() == ini_j.read_text()
    ti, ji = IniReader(str(ini_t), 4096, 102), JIni(str(ini_j), 4096, 102)
    np.testing.assert_array_equal(ti.weights, ji.weights)
    np.testing.assert_array_equal(ti.bias, ji.bias)
    affine = tmp_path / "affine.txt"
    affine.write_text("name a b\n" + "".join(
        f"f{i} 0 {1.0 + i % 3}\n" for i in range(4096)))
    ti.normalize(str(affine))
    ji.normalize(str(affine))
    np.testing.assert_array_equal(ti.weights, ji.weights)
    np.testing.assert_allclose(
        ti.bias[:10], testnetwork.score(oW, obias, np.zeros(4096)), atol=1e-5)
