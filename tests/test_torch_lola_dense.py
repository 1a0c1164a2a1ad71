"""LoLaDense against the JAX package on the CPU.

At n = 512, with two plain primes just below 2**32 (so the factory
encodes on the host and decrypts through the two-plane form) and two
special primes, a LoLaDense-shaped chain runs in both packages on the
same ciphertext under the same keys: PreConv (9 permutes over 4 corner
blocks, some of them empty), a conv of 3 maps with embedded biases at the
PreConv's hot slots, Vectorize, a square, Duplicate(4), a packed dense
layer of 8 outputs at shift 128, Interleave(-1), a square and the
interleaved Dense(10).  The ciphertexts are bit-equal after every layer
and the decoded logits equal the Raw oracle.  `permute` alone is bit-equal
under imported keys; the PreConv index algebra at LoLaDense's MNIST
geometry, the full-width Raw path of `build_lola_dense` and the presets
equal the reference's.  Integers bit-equal; Raw logits at rtol 1e-9.
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
from cryptonets_tpu_torch.nn import lola as tlola  # noqa: E402
from cryptonets_tpu_torch.nn import readers as treaders  # noqa: E402
from cryptonets_tpu_torch.nn.forward import EncryptedForward  # noqa: E402
from cryptonets_tpu_torch.nn.layers import EncryptLayer, SquareActivation  # noqa: E402

N = 512
PLAIN = ntt_primes(N, 32, 2)       # just below 2**32: above 2**31 and every limb
CHAIN = ntt_primes(N, 30, 14)
KW = dict(seed=9, n_special=2)
GEO = dict(input_shape=[10, 10], kernel_shape=[3, 3], upper_padding=[1, 1],
           stride=[2, 2])
MAPS, HIDDEN, COUNT, SHIFT = 3, 8, 4, 128
SELECTED = [SHIFT - 1 + i * SHIFT for i in range(COUNT)]
MNIST_GEO = dict(input_shape=[28, 28], kernel_shape=[5, 5],
                 upper_padding=[1, 1], stride=[2, 2])


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


def _np(x):
    return x.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference factory, port factory with the reference's keys)."""
    jf = japi.CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, **KW)
    path = str(tmp_path_factory.mktemp("keys") / "keys.npz")
    japi.CrtBfvFactory._save_cached_keys(path, jf.keys)
    with np.load(path) as z:
        keys = keyset_from_numpy(z, device="cpu")
    tf = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN,
                       device="cpu", keys=keys, **KW)
    assert not tf._device_encode and tf._device_decode_big
    return jf, tf


class _Port:
    EncryptLayer, SquareActivation = EncryptLayer, SquareActivation
    LLSingleLineReader = treaders.LLSingleLineReader
    LLPreConvLayer, LLPoolLayer, LLVectorizeLayer = (
        tlola.LLPreConvLayer, tlola.LLPoolLayer, tlola.LLVectorizeLayer)
    LLDuplicateLayer, LLPackedDenseLayer = tlola.LLDuplicateLayer, tlola.LLPackedDenseLayer
    LLInterleaveLayer, LLInterleavedDenseLayer = (
        tlola.LLInterleaveLayer, tlola.LLInterleavedDenseLayer)


def _dense_chain(L, factory, raw_factory, records):
    """PreConv -> Conv(3, embedded biases) -> Vectorize -> Square ->
    Duplicate(4) -> PackedDense(8, shift 128) -> Interleave(-1) -> Square
    -> InterleavedDense(10), as `build_lola_dense` lays it out."""
    rng = np.random.default_rng(6)
    w0 = rng.integers(-2, 3, MAPS * 10).astype(float)
    corners = 25
    w1 = rng.integers(-1, 2, MAPS * corners * HIDDEN).astype(float)
    b1 = rng.integers(-3, 4, HIDDEN).astype(float)
    w3 = rng.integers(-2, 3, 10 * HIDDEN).astype(float)
    b3 = rng.integers(-3, 4, 10).astype(float)
    reader = L.LLSingleLineReader(raw_factory, normalization_factor=1.0, scale=2.0)
    reader.set_source_records([(lb, f.copy()) for lb, f in records])
    enc = L.EncryptLayer(reader)
    enc.factory = factory
    pre = L.LLPreConvLayer(enc, use_axis_for_blocks=[True, True], **GEO)
    pre.factory = factory
    pre.prepare()
    pre.layer_prepared = True
    conv = L.LLPoolLayer(pre, map_count=[MAPS, 1], weights=w0, weights_scale=2.0,
                         hot_indices=pre.hot_indices, **GEO)
    act = L.SquareActivation(L.LLVectorizeLayer(conv))
    dup = L.LLDuplicateLayer(act, count=COUNT)
    w1t = w1.reshape(MAPS * corners, HIDDEN).T.ravel()
    dense = L.LLPackedDenseLayer(dup, weights=pre.rearrange_weights(w1t), bias=b1,
                                 packing_count=COUNT, packing_shift=SHIFT,
                                 weights_scale=2.0)
    inter = L.LLInterleaveLayer(dense, shift=-1, selected_indices=SELECTED)
    head = L.LLInterleavedDenseLayer(
        L.SquareActivation(inter), weights=w3, bias=b3, weights_scale=2.0,
        shift=-1, selected_indices=SELECTED)
    head.prepare_network()
    return head


def _records(count=2):
    rng = np.random.default_rng(14)
    return [(0, rng.integers(0, 4, 100).astype(float)) for _ in range(count)]


def test_permute_bit_equal(pair):
    """Masked rotations summed: three selections (one None) with shifts
    of both signs and across the row, on a reference ciphertext."""
    jf, tf = pair
    rng = np.random.default_rng(3)
    x = rng.integers(-50, 50, 300).astype(float)
    jv = jf.get_encrypted_vector(x, "dense", 2.0)
    tv = HEVector(tf, data=_t(jv.data), dim=300, scale=2.0, fmt="dense")
    masks = [(rng.random(300) < 0.4).astype(float) for _ in range(3)]
    shifts = [5, -17, 300]
    jsel = [jf.get_plain_vector(masks[0], "dense", 1.0), None,
            jf.get_plain_vector(masks[2], "dense", 1.0)]
    tsel = [tf.get_plain_vector(masks[0], "dense", 1.0), None,
            tf.get_plain_vector(masks[2], "dense", 1.0)]
    jo = jv.permute(jsel, shifts, 280)
    to = tv.permute(tsel, shifts, 280)
    np.testing.assert_array_equal(_np(to.data), np.asarray(jo.data))
    assert (to.dim, to.scale, to.fmt) == (jo.dim, jo.scale, jo.fmt) == (280, 2.0, "dense")
    np.testing.assert_array_equal(to.decrypt_full_precision(), jo.decrypt_full_precision())
    with pytest.raises(ValueError, match="no selections"):
        tv.permute([None], [1], 10)


def test_preconv_index_algebra_equals_reference():
    """LoLaDense's MNIST geometry on the Raw backend: masks (as slot
    values), shifts, hot slots, corner map, output dimension and the
    rearranged dense weights equal the reference's."""
    def prepared(L, R):
        reader = L.LLSingleLineReader(R(N))
        enc = L.EncryptLayer(reader)
        enc.factory = R(16384)
        pre = L.LLPreConvLayer(enc, use_axis_for_blocks=[True, True], **MNIST_GEO)
        pre.prepare()
        pre.layer_prepared = True
        return pre

    j, t = prepared(jnn, japi.RawFactory), prepared(_Port, RawFactory)
    assert t.output_dim == j.output_dim == 196
    assert t.shifts == j.shifts and t.corners_map == j.corners_map
    assert len(t.masks) == len(j.masks) == 25
    for tm, jm in zip(t.masks, j.masks):
        assert [m is None for m in tm] == [m is None for m in jm]
        for a, b in zip(tm, jm):
            if a is not None:
                np.testing.assert_array_equal(a.v, b.v)
                assert a.scale == b.scale
    np.testing.assert_array_equal(t.hot_indices, j.hot_indices)
    w = np.random.default_rng(1).normal(size=100 * 5 * 169)
    np.testing.assert_array_equal(t.rearrange_weights(w), j.rearrange_weights(w))


def test_dense_chain_bit_equal_layer_by_layer(pair):
    jf, tf = pair
    records = _records()
    jfwd = JaxForward(_dense_chain(jnn, jf, japi.RawFactory(N), records), jit=False)
    jm = jfwd.encrypt_layer.apply(jfwd.reader.get_next())
    thead = _dense_chain(_Port, tf, RawFactory(N), records)
    tfwd = EncryptedForward(thead)
    tm = HEMatrix(tf, [
        HEVector(tf, data=_t(v.data), dim=v.dim, scale=v.scale, fmt=v.fmt)
        for v in jm.vectors], jm.fmt)
    assert len(jfwd.layers) == len(tfwd.layers) == 9
    for jl, tl in zip(jfwd.layers, tfwd.layers):
        jm, tm = jl.apply(jm), tl.apply(tm)
        name = type(tl).__name__
        assert len(jm.vectors) == len(tm.vectors), name
        for jv, tv in zip(jm.vectors, tm.vectors):
            np.testing.assert_array_equal(_np(tv.data), np.asarray(jv.data), err_msg=name)
            assert (tv.dim, tv.scale, tv.fmt) == (jv.dim, jv.scale, jv.fmt), name
    out = tm.get_column(0)
    assert out.fmt == "sparse" and out.dim == 10

    raw = _dense_chain(_Port, RawFactory(N), RawFactory(N), records)
    raws = [raw.get_next().get_column(0) for _ in records]
    assert list(out.decrypt_full_precision()) == list(raws[0].decrypt_full_precision())
    for want in raws:       # the port's own host encode, encrypt and decode
        got = tfwd().get_column(0)
        assert isinstance(got._dec_slots, np.ndarray)
        np.testing.assert_allclose(got.decrypt(), want.decrypt(), rtol=1e-9, atol=0)
        assert list(got.decrypt_full_precision()) == list(want.decrypt_full_precision())
        assert got.noise_budget() > 0


def test_full_width_raw_path_and_presets_equal_reference():
    """n = 16384 on the real weights: the port's Raw oracle of
    build_lola_dense gives the reference's logits; the `lola_dense` and
    `cryptonets_bigt` presets equal the reference's, and CryptoNets builds
    on the latter (Raw)."""
    from cryptonets_tpu.models import lola_mnist as jlm
    from cryptonets_tpu.models import presets as jp
    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.models import cryptonets_mnist, lola_mnist, presets

    for name in ("lola_dense", "cryptonets_bigt"):
        assert presets.CONFIGS[name] == jp.CONFIGS[name]
    records = synthetic_mnist_records(2, seed=11)
    copy = lambda: [(lb, f.copy()) for lb, f in records]  # noqa: E731
    jh = jlm.build_lola_dense(False, records=copy())[0]
    th = lola_mnist.BUILDERS["LoLaDense"](False, records=copy())[0]
    jh.prepare_network()
    th.prepare_network()
    for _ in records:
        jc, tc = jh.get_next().get_column(0), th.get_next().get_column(0)
        assert tc.scale == jc.scale and tc.dim == 10
        np.testing.assert_array_equal(tc.decrypt(), jc.decrypt())
    head, _, _ = cryptonets_mnist.build(False, 4, records=copy(), preset="cryptonets_bigt")
    head.prepare_network()
    assert head.get_next().decrypt().shape == (2, 10)
