"""The rest of the HE surface of the port against the JAX package, on the
CPU: subtraction (`BFV.sub`, `neg`, `sub_plain`, `square`,
`HEVector.subtract`), plain-vector rotation, `HEMatrix.add` and
`set_column`, the factory's CRT string codec and `fresh_key`, the
operation counts (`utils/opcount.py`) after the per-operation budget
sequence and after a reduced LoLa chain run layer by layer, the verbose
layer path, `DebugLayer`, `utils/debug.py`, the mean-pool `LLPoolLayer`,
the `default` preset and the Basic Example.  Plain moduli of 2**62 and
above are held to the reference in `tests/test_torch_big_plain.py`.

The ring is the reference's serial ring (n = 256, two 17-bit plain
primes, three 30-bit limbs, dbc 16, seed 21); the port's factory holds
the reference's keys (read from a reference key file) and the port's
operations take the reference's ciphertexts, so results are bit-equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cryptonets_tpu.api as japi  # noqa: E402
import cryptonets_tpu.nn as jnn  # noqa: E402
from cryptonets_tpu.api import serial as jserial  # noqa: E402
from cryptonets_tpu.crypto.bfv import Ciphertext  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu.models.presets import CONFIGS as JCONFIGS  # noqa: E402
from cryptonets_tpu.utils import debug as jdebug  # noqa: E402
from cryptonets_tpu.utils.budget import op_budgets as jbudgets  # noqa: E402
from cryptonets_tpu.utils.opcount import OPS as JOPS  # noqa: E402
from cryptonets_tpu_torch.api import serial  # noqa: E402
from cryptonets_tpu_torch.api.factory import RawFactory  # noqa: E402
from cryptonets_tpu_torch.api.matrix import HEMatrix  # noqa: E402
from cryptonets_tpu_torch.api.vector import HEVector  # noqa: E402
from cryptonets_tpu_torch.models import basic_example  # noqa: E402
from cryptonets_tpu_torch.models.presets import CONFIGS  # noqa: E402
from cryptonets_tpu_torch.nn.layers import DebugLayer, EncryptLayer, SquareActivation  # noqa: E402
from cryptonets_tpu_torch.nn.lola import LLDenseLayer, LLPoolLayer, LLVectorizeLayer  # noqa: E402
from cryptonets_tpu_torch.nn.readers import LLConvReader  # noqa: E402
from cryptonets_tpu_torch.utils import debug  # noqa: E402
from cryptonets_tpu_torch.utils.budget import op_budgets  # noqa: E402
from cryptonets_tpu_torch.utils.opcount import OPS  # noqa: E402

N = 256
RING = dict(plain_primes=ntt_primes(N, 17, 2), n=N,
            coeff_modulus=ntt_primes(N, 30, 3), dbc=16)
GEO = dict(input_shape=[8, 8], kernel_shape=[3, 3], upper_padding=[1, 1],
           stride=[2, 2])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread runs them as fast and
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference factory, port factory with the reference's keys)."""
    jf = japi.CrtBfvFactory(seed=21, **RING)
    path = str(tmp_path_factory.mktemp("keys") / "keys.npz")
    jserial.save_keys(jf, path)
    return jf, serial.load_factory(path, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _u(x):
    return x.numpy().view(np.uint32)


def _port_vector(tf, jv):
    """The port's HEVector of a reference vector: the same residues."""
    if not jv.is_encrypted:
        return HEVector(tf, values=jv.values, dim=jv.dim, scale=jv.scale,
                        fmt=jv.fmt, is_signed=jv.is_signed)
    return HEVector(tf, data=_t(jv.data), dim=jv.dim, scale=jv.scale,
                    fmt=jv.fmt, is_signed=jv.is_signed)


@pytest.fixture(scope="module")
def vectors(pair):
    jf, _ = pair
    rng = np.random.default_rng(5)
    a, b = rng.integers(-9, 10, (2, 40)).astype(float)
    return dict(a=jf.get_encrypted_vector(a, "dense", 2.0),
                b=jf.get_encrypted_vector(b, "dense", 2.0),
                pa=jf.get_plain_vector(a, "dense", 2.0),
                pb=jf.get_plain_vector(b, "dense", 2.0))


def test_bfv_sub_neg_sub_plain_square_bit_equal(pair, vectors):
    jf, tf = pair
    jb, tb = jf.bfv[0], tf.bfv[0]
    a, b = vectors["a"].data[0], vectors["b"].data[0]           # [C, 2, k, N]
    form = vectors["pb"].add_form()[0]                          # [C, k, N]
    sq = jb.square(Ciphertext(a)).data                          # size 3
    cases = [
        (jb.sub(Ciphertext(a), Ciphertext(b)).data, tb.sub(_t(a), _t(b))),
        (jb.neg(Ciphertext(a)).data, tb.neg(_t(a))),
        (jb.sub_plain(Ciphertext(a), form).data, tb.sub_plain(_t(a), _t(form))),
        (sq, tb.square(_t(a))),
        # sizes 3 and 2: the smaller padded with a zero polynomial
        (jb.sub(Ciphertext(sq), Ciphertext(b)).data, tb.sub(_t(sq), _t(b))),
        (jb.sub(Ciphertext(b), Ciphertext(sq)).data, tb.sub(_t(b), _t(sq))),
        (jb.add(Ciphertext(b), Ciphertext(sq)).data, tb.add(_t(b), _t(sq))),
    ]
    for want, got in cases:
        np.testing.assert_array_equal(_u(got), np.asarray(want))


@pytest.mark.parametrize("case", ["enc-enc", "enc-plain", "plain-enc",
                                  "plain-plain", "zero"])
def test_vector_subtract_bit_equal(pair, vectors, case):
    jf, tf = pair
    x, y = {"enc-enc": ("a", "b"), "enc-plain": ("a", "pb"),
            "plain-enc": ("pa", "b"), "plain-plain": ("pa", "pb"),
            "zero": ("a", None)}[case]
    jx = vectors[x]
    jy = jf.get_zero_vector(40, scale=0.0) if y is None else vectors[y]
    want = jx.subtract(jy)
    tx = _port_vector(tf, jx)
    ty = (tf.get_zero_vector(40, scale=0.0) if y is None
          else _port_vector(tf, jy))
    got = tx.subtract(ty)
    if y is None:
        assert got is tx and want is jx
    assert (got.dim, got.scale, got.fmt) == (want.dim, want.scale, want.fmt)
    if want.is_encrypted:
        np.testing.assert_array_equal(_u(got.data), np.asarray(want.data))
    else:
        assert list(got.values) == list(want.values)
    np.testing.assert_array_equal(got.decrypt(), want.decrypt())


def test_plain_rotate_matrix_add_set_column_bit_equal(pair, vectors):
    jf, tf = pair
    for amount in (3, -5, 200):
        want = vectors["pa"].rotate(amount)
        got = _port_vector(tf, vectors["pa"]).rotate(amount)
        assert list(got.values) == list(want.values)
    rng = np.random.default_rng(9)
    M = rng.integers(-5, 6, (6, 3)).astype(float)
    jm = jf.get_encrypted_matrix(M, "col", 1.0)
    tm = HEMatrix(tf, [_port_vector(tf, v) for v in jm.vectors], "col")
    for g, w in zip(tm.add(tm).vectors, jm.add(jm).vectors):
        np.testing.assert_array_equal(_u(g.data), np.asarray(w.data))
    jm.set_column(1, vectors["a"])
    tm.set_column(1, _port_vector(tf, vectors["a"]))
    for g, w in zip(tm.add(tm).vectors, jm.add(jm).vectors):
        np.testing.assert_array_equal(_u(g.data), np.asarray(w.data))
    assert tm.get_column(1).dim == 40


def test_string_codec_and_fresh_key(pair):
    jf, tf = pair
    for value in (0, 1, 123456789, jf.plain_crt.product - 1):
        s = jf.get_string_from_value(value)
        assert tf.get_string_from_value(value) == s
        assert tf.get_value_from_string(s) == jf.get_value_from_string(s) == value
    assert (tf.block_size, tf.slot_count) == (jf.block_size, jf.slot_count)
    g1, g2 = tf.fresh_key(), tf.fresh_key()
    assert not torch.equal(torch.randint(0, 2**31, (64,), generator=g1),
                           torch.randint(0, 2**31, (64,), generator=g2))


def test_op_budget_counts_equal_reference(pair):
    """The per-operation budget sequence: the same operation counts in
    both packages, and budgets within 3 bits."""
    jf, tf = pair
    JOPS.reset()
    jrow = jbudgets(jf)
    jcounts = JOPS.reset()
    OPS.reset()
    trow = op_budgets(tf)
    assert OPS.reset() == jcounts and jcounts
    assert list(trow) == list(jrow)
    for k in trow:
        assert abs(trow[k] - jrow[k]) <= 3, (k, trow, jrow)


def _reduced_lola(nn, factory, raw_factory, records, tap=None, square=True):
    """Conv (2 maps), vectorize, square, a dense layer of per-row dots;
    with `tap` a DebugLayer after the conv (the port only).  The ring's
    90 bits do not keep budget through all of it: the verbose run, which
    probes each layer's budget, goes without the square."""
    rng = np.random.default_rng(3)
    reader = nn.LLConvReader(raw_factory, normalization_factor=1.0, scale=2.0, **GEO)
    reader.set_source_records([(lb, f.copy()) for lb, f in records])
    enc = nn.EncryptLayer(reader)
    enc.factory = factory
    conv = nn.LLPoolLayer(enc, map_count=[2, 1], weights=rng.integers(-2, 3, 18),
                          bias=rng.integers(-2, 3, 2), weights_scale=2.0, **GEO)
    if tap is not None:
        conv = DebugLayer(conv, callback=tap)
    act = nn.LLVectorizeLayer(conv)
    if square:
        act = nn.SquareActivation(act)
    return nn.LLDenseLayer(act, weights=rng.integers(-2, 3, 4 * 32),
                           bias=rng.integers(-2, 3, 4), weights_scale=2.0)


class _PortLayers:
    LLConvReader, EncryptLayer, LLPoolLayer = LLConvReader, EncryptLayer, LLPoolLayer
    SquareActivation, LLVectorizeLayer, LLDenseLayer = (
        SquareActivation, LLVectorizeLayer, LLDenseLayer)


RECORDS = [(0, np.random.default_rng(11).integers(0, 4, 64).astype(float))]


def test_reduced_lola_counts_verbose_and_debug_layer(pair, capsys):
    """A reduced LoLa chain run layer by layer (`get_next`): the same
    operation counts in both packages; in verbose mode one report line a
    layer; the DebugLayer's callback sees the conv's output."""
    jf, tf = pair
    jhead = _reduced_lola(jnn, jf, japi.RawFactory(N), RECORDS)
    jhead.prepare_network()
    JOPS.reset()
    jhead.get_next()
    jcounts = JOPS.reset()

    seen = []
    head = _reduced_lola(_PortLayers, tf, RawFactory(N), RECORDS, tap=seen.append)
    head.prepare_network()
    OPS.reset()
    out = head.get_next()
    assert OPS.reset() == jcounts and jcounts["rotation"] > 0
    assert len(seen) == 1 and len(seen[0].vectors) == 2 and seen[0].is_encrypted

    quiet = _reduced_lola(_PortLayers, tf, RawFactory(N), RECORDS, square=False)
    quiet.prepare_network()
    head = _reduced_lola(_PortLayers, tf, RawFactory(N), RECORDS, square=False)
    head.set_verbose(True)
    capsys.readouterr()
    head.prepare_network()
    loud = head.get_next()
    lines = capsys.readouterr().out.splitlines()
    layers = ["EncryptLayer", "LLPoolLayer", "LLVectorizeLayer", "LLDenseLayer"]
    assert [ln.split()[1] for ln in lines if ln.startswith("Layer ")] == layers
    assert [ln.split()[1] for ln in lines
            if ln.startswith("Prepare ")] == ["LLConvReader"] + layers
    assert any(ln.strip().startswith("rotation") for ln in lines)
    reader = head.get_source().get_source().get_source().get_source()
    assert isinstance(reader, LLConvReader) and reader.get_source() is None
    assert (list(loud.get_column(0).decrypt_full_precision())
            == list(quiet.get_next().get_column(0).decrypt_full_precision()))


def test_show_and_dump_text_equal(pair, tmp_path, capsys):
    jf, tf = pair
    M = np.arange(-6, 6, dtype=float).reshape(4, 3) * 1.25
    jm = jf.get_encrypted_matrix(M, "col", 4.0)
    tm = HEMatrix(tf, [_port_vector(tf, v) for v in jm.vectors], "col")
    capsys.readouterr()
    jdebug.show(jm)
    want = capsys.readouterr().out
    debug.show(tm)
    assert capsys.readouterr().out == want and "\t" in want
    jdebug.dump(str(tmp_path / "j.tsv"), jm)
    debug.dump(str(tmp_path / "t.tsv"), tm)
    assert (tmp_path / "j.tsv").read_text() == (tmp_path / "t.tsv").read_text()


def test_mean_pool_llpool_bit_equal(pair):
    """The mean-pool LLPoolLayer (no weights): the offset columns added,
    the scale multiplied by their count; on the Raw backend its values
    are the window means, encrypted its ciphertext is the reference's."""
    jf, tf = pair
    img = np.arange(64, dtype=float)
    outs = {}
    for name, nn, fac, raw in (("ref", jnn, jf, japi.RawFactory(N)),
                               ("port", _PortLayers, tf, RawFactory(N))):
        reader = nn.LLConvReader(raw, normalization_factor=1.0, scale=1.0,
                                 input_shape=[8, 8], kernel_shape=[2, 2],
                                 stride=[2, 2])
        reader.set_source_records([(0, img.copy())])
        pool = nn.LLPoolLayer(reader, input_shape=[8, 8], kernel_shape=[2, 2],
                              stride=[2, 2])
        pool.prepare_network()
        outs[name] = pool.get_next()
        assert pool.get_output_scale() == 4.0 and pool.output_dimension() == 16
    want = img.reshape(4, 2, 4, 2).mean(axis=(1, 3)).ravel()
    np.testing.assert_array_equal(outs["port"].decrypt()[:, 0], want)
    np.testing.assert_array_equal(outs["ref"].decrypt()[:, 0], want)

    m = jf.get_encrypted_matrix(np.random.default_rng(2).integers(-9, 9, (16, 4)),
                                "col", 1.0)
    jpool = jnn.LLPoolLayer(None, input_shape=[8, 8], kernel_shape=[2, 2],
                            stride=[2, 2])
    jpool.factory = jf
    jout = jpool.apply(m)
    pool = LLPoolLayer(None, input_shape=[8, 8], kernel_shape=[2, 2], stride=[2, 2])
    pool.factory = tf
    tout = pool.apply(HEMatrix(tf, [_port_vector(tf, v) for v in m.vectors], "col"))
    assert len(tout.vectors) == 1 and tout.scale == jout.scale == 4.0
    np.testing.assert_array_equal(_u(tout.vectors[0].data),
                                  np.asarray(jout.vectors[0].data))


def test_default_preset_and_basic_example():
    assert CONFIGS["default"] == JCONFIGS["default"]
    res = basic_example.run(verbose=False, device="cpu")
    v = np.arange(1.0, 11.0)
    assert res["norm_squared"] == 385 and res["sum"] == 55
    np.testing.assert_array_equal(res["elementwise"], v * v[::-1])

