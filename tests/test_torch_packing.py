"""Slice D, the reference packing (LoLaPacked), against the JAX package on
the CPU.

At n = 256, with keys made by the reference and imported into the port
(`keyset_from_numpy`) and the reference's input ciphertexts, the port's
`duplicate`, every branch of `interleave`, `flat_mask_form`, the chained
and the dense-support BSGS and a reduced LoLaPacked chain (conv,
vectorize, square, duplicate, packed dense, interleave, square,
interleaved dense) give bit-equal ciphertexts; the decoded integers equal
the plaintext placement and the Raw oracle.  `_choose_g` agrees with the
reference on a grid, and the `lola` preset now carries dbc = 8."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cryptonets_tpu.api as japi  # noqa: E402
import cryptonets_tpu.nn as jnn  # noqa: E402
from cryptonets_tpu.api import bsgs as jbsgs  # noqa: E402
from cryptonets_tpu.api.vector import HEVector as JVector  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu.nn.jit import EncryptedForward as JaxForward  # noqa: E402
from cryptonets_tpu_torch.api import bsgs as tbsgs  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory  # noqa: E402
from cryptonets_tpu_torch.api.matrix import HEMatrix  # noqa: E402
from cryptonets_tpu_torch.api.raw import RawVector  # noqa: E402
from cryptonets_tpu_torch.api.vector import HEVector  # noqa: E402
from cryptonets_tpu_torch.convert import keyset_from_numpy  # noqa: E402
from cryptonets_tpu_torch.nn.forward import EncryptedForward  # noqa: E402
from cryptonets_tpu_torch.nn import lola as tlola  # noqa: E402
from cryptonets_tpu_torch.nn.layers import EncryptLayer, SquareActivation  # noqa: E402
from cryptonets_tpu_torch.nn.readers import LLConvReader  # noqa: E402

N = 256
ROW = N // 2
PLAIN = ntt_primes(N, 20, 2)
CHAIN = ntt_primes(N, 30, 7)
SCAN = 9          # the stride of the scanned interleave runs
GEO = dict(input_shape=[8, 8], kernel_shape=[3, 3], upper_padding=[1, 1],
           stride=[2, 2])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many small tensor ops: one intra-op
    thread runs them as fast alone and keeps parallel test workers from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _u(x):
    return x.numpy().view(np.uint32)


def _import(jf, tmp_path_factory, **kw):
    """A port factory on the CPU with the reference factory's keys."""
    path = str(tmp_path_factory.mktemp("keys") / "keys.npz")
    japi.CrtBfvFactory._save_cached_keys(path, jf.keys)
    with np.load(path) as z:
        keys = keyset_from_numpy(z, device="cpu")
    return CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN,
                         device="cpu", keys=keys, **kw)


_PAIRS = {}


def _pair(tmp_path_factory, **kw):
    """(reference factory, port factory with its keys), made once per
    module and configuration: each new configuration costs the reference
    its XLA compiles."""
    key = tuple(sorted(kw.items()))
    if key not in _PAIRS:
        jf = japi.CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN,
                                seed=7, **kw)
        _PAIRS[key] = jf, _import(jf, tmp_path_factory, seed=7, **kw)
    return _PAIRS[key]


# digit key switching at dbc = 8 (the `lola` preset's), the power-of-two
# ladder plus a single-hop key for -SCAN
DIGITS = dict(dbc=8, rot_steps=(-SCAN,))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _pair(tmp_path_factory, **DIGITS)


def _vectors(jf, tf, dims, seed):
    """Reference ciphertexts of seeded integer vectors, and the same data
    as port vectors."""
    rng = np.random.default_rng(seed)
    vals = [rng.integers(-9, 10, d) for d in dims]
    jv = [jf.get_encrypted_vector(v.astype(float), "dense", 1.0) for v in vals]
    tv = [HEVector(tf, data=_t(v.data), dim=v.dim, scale=1.0) for v in jv]
    return vals, jv, tv


def _decoded(v, dim):
    v.dim = dim
    return np.array([int(x) for x in v.decrypt_full_precision()])


def test_duplicate_bit_equal(pair):
    """Eight copies at stride 32 fill the ring: copies 4-7 come from the
    column-swapped input."""
    jf, tf = pair
    vals, jv, tv = _vectors(jf, tf, [20], seed=1)
    got, want = tv[0].duplicate(8), jv[0].duplicate(8)
    np.testing.assert_array_equal(_u(got.data), np.asarray(want.data))
    assert got.dim == want.dim == 256
    raw = RawVector(vals[0], 1.0, N).duplicate(8).v
    np.testing.assert_array_equal(_decoded(got, 256), raw)


# (dims, shift): every placement of the case analysis
INTERLEAVE_CASES = {
    # shift -1 over 13 pieces: row + shift*k, piece 1 ends at the row end
    "negative": ([256] * 13, -1),
    # lower in-block pieces, one crossing into the upper half-row (prefix
    # mask), two upper pieces: one output block
    "lower_upper_row_crossing": ([40] * 6, 40),
    # stride n/2 - 4: piece 1 crosses the row, piece 2 the block boundary,
    # two output blocks
    "block_crossing": ([ROW - 4] * 3, ROW - 4),
    # 27 pieces at the scanned stride: a lower run of 14, a crossing
    # piece, an upper run of 12
    "runs": ([SCAN] * 27, SCAN),
    # 40 pieces: runs in two output blocks and a block-crossing piece
    "runs_two_blocks": ([SCAN] * 40, SCAN),
}


@pytest.mark.parametrize("case,with_key", [
    (case, True) for case in sorted(INTERLEAVE_CASES)] + [("runs", False)])
def test_interleave_bit_equal(pair, case, with_key):
    """Bit-equal to the reference; with the -SCAN key the runs take the
    Horner loop, without it (the 27 pieces of `runs`) every piece takes
    the per-piece path."""
    jf, tf = pair
    dims, shift = INTERLEAVE_CASES[case]
    g = tf.bfv[0].galois_elt_rows(-SCAN % ROW)
    assert g in tf.keys.galois
    vals, jv, tv = _vectors(jf, tf, dims, seed=len(dims) + abs(shift))
    jkeys, tkeys = jf.keys, tf.keys
    if not with_key:
        jf.keys = jkeys._replace(galois={e: k for e, k in jkeys.galois.items() if e != g})
        tf.keys = tkeys._replace(galois={e: k for e, k in tkeys.galois.items() if e != g})
    try:
        want = JVector.interleave(jv, shift)
        got = HEMatrix(tf, tv, "col").interleave(shift)
    finally:
        jf.keys, tf.keys = jkeys, tkeys
    np.testing.assert_array_equal(_u(got.data), np.asarray(want.data))
    assert got.dim == want.dim == dims[0]
    blocks = got.data.shape[1]
    if shift > 0:
        assert blocks == -(-dims[0] * len(dims) // N)
        flat = np.zeros(blocks * N, np.int64)
        for k, v in enumerate(vals):
            flat[shift * k : shift * k + len(v)] += v
    else:
        flat = np.zeros(N, np.int64)
        flat[:] = vals[0]
        for k, v in enumerate(vals[1:], start=1):   # rotated right by row - k
            w = np.concatenate([np.roll(v[:ROW], ROW + shift * k),
                                np.roll(v[ROW:], ROW + shift * k)])
            flat += w
    t_prod = int(np.prod(PLAIN))
    centered = (flat + t_prod // 2) % t_prod - t_prod // 2
    np.testing.assert_array_equal(_decoded(got, blocks * N), centered)


def test_flat_mask_form_bit_equal(pair):
    jf, tf = pair
    for lo, hi in ((0, 7), (0, 130), (3, 256)):
        got = tf.flat_mask_form(lo, hi)
        np.testing.assert_array_equal(_u(got), np.asarray(jf.flat_mask_form(lo, hi)))
        assert tf.flat_mask_form(lo, hi) is got          # cached


def test_choose_g_equals_reference():
    for row in (32, 64, 128, 1024, 4096, 8192):
        for F in (1, 2):
            assert tbsgs._choose_g(row, F) == jbsgs._choose_g(row, F)
            assert tbsgs._choose_g(row, F, cap=16) == jbsgs._choose_g(row, F, cap=16)
    assert tbsgs._choose_g(8192, 2) == 64      # LoLaLarge's conv-as-dense


# chained babies: special primes (hybrid switching with mod-down), and the
# four-step NTT under digit switching
CHAINED = {"special_primes": dict(n_special=2),
           "four_step": dict(DIGITS, ntt_impl="matmul")}


# (R, D, g): a sparse support over one row, a dense support over both rows
# (the dense-support Horner; the reduced LoLaLarge chain runs it too)
BSGS_CASES = {"sparse": (4, 20, 8), "dense": (40, 200, None)}


@pytest.mark.parametrize("mode,case", [("special_primes", "sparse"),
                                       ("special_primes", "dense"),
                                       ("four_step", "sparse")])
def test_chained_bsgs_bit_equal(mode, case, tmp_path_factory):
    jf, tf = _pair(tmp_path_factory, **CHAINED[mode])
    R, D, g = BSGS_CASES[case]
    rng = np.random.default_rng(R + D)
    W = rng.integers(-6, 7, size=(R, D)).astype(np.int64)
    v = rng.integers(-4, 5, size=D).astype(np.int64)
    data = np.asarray(jf.get_encrypted_vector(v.astype(float)).data)
    jform = jbsgs.BsgsDenseForm(jf, W, R, D, g=g)
    tform = tbsgs.BsgsDenseForm(tf, W, R, D, g=g)
    assert (tform.g, tform.G, tform.F) == (jform.g, jform.G, jform.F)
    assert not tbsgs.hoist_eligible(tf, tform.g)
    assert not jbsgs.hoist_eligible(jf, jform.g)
    np.testing.assert_array_equal(tform.table, jform.table)
    assert tform.active == jform.active
    dense = len(tform.active) > max(4, tform.G // 4)
    assert dense == (case == "dense")
    want = np.asarray(jbsgs.bsgs_matvec(jform, data))
    got = tbsgs.bsgs_matvec(tform, _t(data))
    np.testing.assert_array_equal(_u(got), want)
    out = HEVector(tf, data=got, dim=R, scale=1.0)
    np.testing.assert_array_equal(
        np.array([int(x) for x in out.decrypt_full_precision()]), W @ v)


def test_lola_preset_carries_dbc8():
    """The `lola` preset equals the reference's (dbc = 8); under RNS-group
    switching (LoLa's ks_alpha = 1) the digit width changes no key."""
    from cryptonets_tpu.models import presets as jp
    from cryptonets_tpu_torch.models import presets

    assert presets.CONFIGS["lola"] == jp.CONFIGS["lola"]
    assert presets.CONFIGS["lola"]["dbc"] == 8
    keys = [CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, seed=3,
                          ks_alpha=1, dbc=dbc, rot_steps=(1, 2, 3),
                          device="cpu").keys
            for dbc in (8, 16)]
    for a, b in zip(keys[0], keys[1]):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for e in a:
                assert torch.equal(a[e].k0, b[e].k0) and torch.equal(a[e].k1, b[e].k1)
        elif isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b)


# --------------------------------------------------- reduced LoLaPacked
def _packed_chain(L, factory, raw_factory, records):
    """Conv (2 maps, 16 windows) -> Vectorize (32) -> Square ->
    Duplicate(8) (stride 32 fills the ring) -> PackedDense(12 outputs,
    8 to a row at shift 32) -> Interleave(-1) -> Square ->
    InterleavedDense(10)."""
    rng = np.random.default_rng(3)
    conv_w = rng.integers(-2, 3, 2 * 10).astype(float)   # bias embedded
    d1_w = rng.integers(-2, 3, 12 * 32).astype(float)
    d1_b = rng.integers(-2, 3, 12).astype(float)
    d2_w = rng.integers(-2, 3, 10 * 12).astype(float)
    d2_b = rng.integers(-2, 3, 10).astype(float)
    reader = L.LLConvReader(raw_factory, normalization_factor=1.0, scale=2.0, **GEO)
    reader.set_source_records([(lb, f.copy()) for lb, f in records])
    enc = L.EncryptLayer(reader)
    enc.factory = factory
    conv = L.LLPoolLayer(enc, map_count=[2, 1], weights=conv_w,
                         weights_scale=2.0, **GEO)
    act = L.SquareActivation(L.LLVectorizeLayer(conv))
    dup = L.LLDuplicateLayer(act, count=8)
    dense = L.LLPackedDenseLayer(dup, weights=d1_w, bias=d1_b, packing_count=8,
                                 packing_shift=32, weights_scale=2.0)
    selected = [31 + 32 * i for i in range(8)]
    inter = L.LLInterleaveLayer(dense, shift=-1, selected_indices=selected)
    head = L.LLInterleavedDenseLayer(
        L.SquareActivation(inter), weights=d2_w, bias=d2_b, weights_scale=2.0,
        shift=-1, selected_indices=selected)
    head.prepare_network()
    return head


class _Port:
    EncryptLayer, SquareActivation, LLConvReader = (
        EncryptLayer, SquareActivation, LLConvReader)
    LLPoolLayer, LLVectorizeLayer = tlola.LLPoolLayer, tlola.LLVectorizeLayer
    LLDuplicateLayer, LLPackedDenseLayer = (
        tlola.LLDuplicateLayer, tlola.LLPackedDenseLayer)
    LLInterleaveLayer, LLInterleavedDenseLayer = (
        tlola.LLInterleaveLayer, tlola.LLInterleavedDenseLayer)


def _records(count=2):
    rng = np.random.default_rng(11)
    return [(0, rng.integers(0, 4, 64).astype(float)) for _ in range(count)]


def _raw_layer_outputs(L, factory, records):
    """Each layer's Raw output on the first record."""
    head = _packed_chain(L, factory, factory, records)
    chain, p = [], head
    while not isinstance(p, L.EncryptLayer):
        chain.append(p)
        p = p.source
    m = p.source.get_next()
    outs = []
    for layer in reversed(chain):
        m = layer.apply(m)
        outs.append(m)
    return outs


def test_packed_layers_raw_equal_reference():
    """The Raw branch of every layer equals the reference's."""
    got = _raw_layer_outputs(_Port, RawFactory(N), _records())
    want = _raw_layer_outputs(jnn, japi.RawFactory(N), _records())
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.scale == w.scale and g.fmt == w.fmt
        np.testing.assert_array_equal(g.m, w.m)


@pytest.mark.parametrize("impl", ["butterfly", "matmul"])
def test_packed_chain_bit_equal_layer_by_layer(impl, tmp_path_factory):
    """The reduced LoLaPacked chain on the reference's ciphertext and keys:
    bit-equal after every layer, the logits equal the Raw oracle's."""
    records = _records()
    jf, tf = _pair(tmp_path_factory, **DIGITS,
                   **({"ntt_impl": impl} if impl == "matmul" else {}))
    jfwd = JaxForward(_packed_chain(jnn, jf, japi.RawFactory(N), records), jit=False)
    tfwd = EncryptedForward(_packed_chain(_Port, tf, RawFactory(N), records))
    jm = jfwd.encrypt_layer.apply(jfwd.reader.get_next())
    tm = HEMatrix(tf, [HEVector(tf, data=_t(v.data), dim=v.dim, scale=v.scale,
                                fmt=v.fmt) for v in jm.vectors], jm.fmt)
    assert len(jfwd.layers) == len(tfwd.layers) == 8
    for jl, tl in zip(jfwd.layers, tfwd.layers):
        jm, tm = jl.apply(jm), tl.apply(tm)
        name = type(tl).__name__
        assert type(jl).__name__ == name
        assert len(jm.vectors) == len(tm.vectors), name
        for jv, tv in zip(jm.vectors, tm.vectors):
            np.testing.assert_array_equal(_u(tv.data), np.asarray(jv.data),
                                          err_msg=name)
            assert (tv.dim, tv.scale, tv.fmt) == (jv.dim, jv.scale, jv.fmt), name
    out = tm.get_column(0)
    assert out.fmt == "sparse" and out.dim == 10

    raw = _packed_chain(_Port, RawFactory(N), RawFactory(N), records)
    raws = [raw.get_next().get_column(0).decrypt_full_precision() for _ in records]
    assert list(out.decrypt_full_precision()) == list(raws[0])
    for want in raws:       # the port's own encode, encrypt and decode
        got = tfwd().get_column(0)
        assert list(got.decrypt_full_precision()) == list(want)
        assert got.noise_budget() > 0
