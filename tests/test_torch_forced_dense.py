"""The forced dense output and the column-major matvec of the port against
the JAX package on the CPU, at n = 256 on two rings of plain primes: two
~39-bit primes (`ntt_primes(256, 39, 2)`, above 2**31: the host encode and
the two-plane decrypt, as the `cifar_bigt` and `lola_large_bigt` presets)
and three ~20-bit ones (the device encode).  Both rings carry one special
prime and the single-hop key for -9, as `cifar`'s factory does; the port
imports the reference's keys, and both packages run on the same
ciphertexts:

  * the factory's `unit_mask_form`, `mask_mult_form` and the batched
    `plain_mult_forms` / `unit_mask_forms`;
  * `sum_all_slots(force_output_in_column=5)` and `dot_product`;
  * every branch of `HEMatrix.mul`: row-major (encrypted by encrypted,
    encrypted by plain, plain by encrypted; forced dense on and off) and
    column-major (encrypted by encrypted sparse, encrypted by plain
    scalars, plain by encrypted sparse), each with the rows in one piece
    and one a piece, and in pieces of two with a remainder; the branches
    of an encrypted matrix by an encrypted vector (the reference's BEHZ
    multiply, whose compile takes most of this file's time) on the big-t
    ring only;
  * `LLDenseLayer` over a sparse input;
  * a reduced CIFAR chain under the big-t primes (`_cifar_chain` of
    `tests/test_torch_lola_cifar.py`): its conv-as-dense takes per-row
    dots with the forced dense output, bit-equal layer by layer, and the
    decoded logits equal the Raw oracle;
  * CryptoNets under either NTT: `cryptonets_mnist.build` passes its
    `ntt_impl` on, and the reduced CryptoNets network decodes to the same
    integers under both.

Integers are compared bit-equal; Raw logits at rtol 1e-9.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cryptonets_tpu.api as japi  # noqa: E402
import cryptonets_tpu.nn as jnn  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu.nn.jit import EncryptedForward as JaxForward  # noqa: E402
from cryptonets_tpu.nn.network import Layer as JLayer  # noqa: E402
from cryptonets_tpu_torch.api import matrix as tmatrix  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory  # noqa: E402
from cryptonets_tpu_torch.api.matrix import HEMatrix  # noqa: E402
from cryptonets_tpu_torch.api.vector import HEVector  # noqa: E402
from cryptonets_tpu_torch.convert import keyset_from_numpy  # noqa: E402
from cryptonets_tpu_torch.nn import lola as tlola  # noqa: E402
from cryptonets_tpu_torch.nn.forward import EncryptedForward  # noqa: E402
from cryptonets_tpu_torch.nn.network import Layer as TLayer  # noqa: E402
from test_torch_lola_cifar import STRIDE, _cifar_chain, _Port, _records  # noqa: E402

N = 256
# (plain primes, limbs): thirteen 30-bit limbs, as many as `cifar_bigt`
# has, keep the reduced CIFAR chain under t ~ 2**39 at a positive budget
# through its two squares and four plaintext multiplies (28 bits; ten
# limbs end at 0)
RINGS = {"big_t": (ntt_primes(N, 39, 2), ntt_primes(N, 30, 13)),
         "small_t": (ntt_primes(N, 20, 3), ntt_primes(N, 30, 7))}
KW = dict(n=N, seed=8, n_special=1)
RNG = np.random.default_rng(31)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread runs them as fast and
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """ring name -> (reference factory, port factory with the reference's
    keys), each built once, at first use."""
    built = {}

    def get(name):
        if name not in built:
            plain, chain = RINGS[name]
            jf = japi.CrtBfvFactory(plain_primes=plain, coeff_modulus=chain,
                                    rot_steps=(-STRIDE,), **KW)
            path = str(tmp_path_factory.mktemp("keys") / "keys.npz")
            japi.CrtBfvFactory._save_cached_keys(path, jf.keys)
            with np.load(path) as z:
                keys = keyset_from_numpy(z, device="cpu")
            tf = CrtBfvFactory(plain_primes=plain, coeff_modulus=chain,
                               device="cpu", keys=keys, **KW)
            assert tf._device_encode == (name == "small_t")
            built[name] = (jf, tf)
        return built[name]
    return get


def _t(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _np(x):
    return x.numpy().view(np.uint32)


def _port_vec(tf, jv):
    return HEVector(tf, data=_t(jv.data), dim=jv.dim, scale=jv.scale, fmt=jv.fmt)


def _port_mat(tf, jm):
    return HEMatrix(tf, [_port_vec(tf, v) for v in jm.vectors], jm.fmt)


def _same(tv, jv, what=""):
    np.testing.assert_array_equal(_np(tv.data), np.asarray(jv.data), err_msg=what)
    assert (tv.dim, tv.scale, tv.fmt) == (jv.dim, jv.scale, jv.fmt), what


# ------------------------------------------------------------------ masks
@pytest.mark.parametrize("ring", sorted(RINGS))
def test_masks_and_batched_forms_equal_reference(pairs, ring):
    jf, tf = pairs(ring)
    for col in (0, 5, N // 2 + 3, N - 1):
        np.testing.assert_array_equal(_np(tf.unit_mask_form(col)),
                                      np.asarray(jf.unit_mask_form(col)))
    for lo, hi in ((3, 40), (0, N // 2), (17, 18)):
        np.testing.assert_array_equal(_np(tf.mask_mult_form(lo, hi)),
                                      np.asarray(jf.mask_mult_form(lo, hi)))
    assert tf.mask_mult_form(3, 40) is tf.mask_mult_form(3, 40)
    assert tf.unit_mask_form(5) is tf.unit_mask_form(5)
    # the batched forms equal the single ones, over several encode pieces
    cols = [0, 5, 7, N - 1, 130]
    rows = RNG.integers(-(1 << 40), 1 << 40, size=(3, N))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("cryptonets_tpu_torch.api.factory.ENCODE_CHUNK", 2)
        masks = tf.unit_mask_forms(cols)
        forms = tf.plain_mult_forms(rows)
    for i, col in enumerate(cols):
        torch.testing.assert_close(masks[:, i], tf.unit_mask_form(col)[:, 0],
                                   rtol=0, atol=0)
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(
            _np(forms[:, i]), np.asarray(jf.plain_mult_form(row, N))[:, 0])


# ------------------------------------------------------------- slot sums
@pytest.mark.parametrize("ring", sorted(RINGS))
def test_forced_slot_sum_and_dot_product(pairs, ring):
    """The reference's own test (`tests/test_api_vector.py::
    test_sum_all_slots`), bit-equal, and the dot products (by an
    encrypted vector on the big-t ring only: the reference's BEHZ
    multiply compiles anew for every ring)."""
    jf, tf = pairs(ring)
    a = RNG.integers(-5, 5, 30).astype(float)
    b = RNG.integers(-5, 5, 30).astype(float)
    ja = jf.get_encrypted_vector(a, "dense", 1.0)
    jb = jf.get_encrypted_vector(b, "dense", 2.0)
    ta, tb = _port_vec(tf, ja), _port_vec(tf, jb)
    js, ts = ja.sum_all_slots(force_output_in_column=5), \
        ta.sum_all_slots(force_output_in_column=5)
    _same(ts, js, "sum_all_slots")
    d = ts.decrypt()
    assert d.shape == (30,) and d[5] == a.sum()
    assert np.all(np.delete(d, 5) == 0)
    with pytest.raises(ValueError, match="complete sum"):
        ta.sum_all_slots(4, force_output_in_column=5)
    plain = jf.get_plain_vector(b, "dense", 2.0)
    tplain = tf.get_plain_vector(b, "dense", 2.0)
    others = [(plain, tplain)] + ([(jb, tb)] if ring == "big_t" else [])
    for jo, to in others:
        jd = ja.dot_product(jo, None, 7)
        td = ta.dot_product(to, None, 7)
        _same(td, jd, "dot_product")
        assert td.decrypt()[7] == a @ b
        _same(ta.dot_product(to), ja.dot_product(jo), "dot_product, sparse")


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_forced_dot_budget_steps_equal_reference(pairs, ring):
    """The noise budget after each step of a per-row dot with the forced
    dense output (`scripts/torch_mask_noise.py`'s steps: times a plain
    row, the slot-sum ladder, the unit mask, five rows as one forced
    matvec), each package measuring its own ciphertexts: equal step by
    step.  Each plaintext multiply costs log2(t * sqrt(n / 12)) bits
    within 5, the growth under a polynomial uniform mod t."""
    from cryptonets_tpu.api.tracker import CryptoTracker

    jf, tf = pairs(ring)
    x = RNG.integers(0, 256, 200).astype(float)
    w = RNG.integers(-1024, 1025, size=(5, 200)).astype(float)
    ja = jf.get_encrypted_vector(x, "dense", 1.0)
    budgets = {}
    for pkg, f, a in (("ref", jf, ja), ("port", tf, _port_vec(tf, ja))):
        prod = a.pointwise_multiply(f.get_plain_vector(w[0], "dense", 1.0))
        steps = [a, prod, prod.sum_all_slots(),
                 prod.sum_all_slots(force_output_in_column=7),
                 f.get_plain_matrix(w, "row", 1.0).mul(a, True)]
        budgets[pkg] = [CryptoTracker.test_vector_budget(v, warn=False)
                        if pkg == "ref" else v.noise_budget() for v in steps]
    assert budgets["port"] == budgets["ref"]
    b = budgets["port"]
    predicted = np.log2(max(RINGS[ring][0]) * np.sqrt(N / 12))
    for cost in (b[0] - b[1], b[2] - b[3]):      # the row, the unit mask
        assert abs(cost - predicted) <= 5, (b, predicted)


# ---------------------------------------------------------------- matvec
R, D = 5, 12          # rows (columns) and their dim


def _operands(jf, tf, fmt, enc_m, enc_v):
    """(reference matrix, vector), (port matrix, vector)."""
    m = RNG.integers(-4, 5, size=(R, D) if fmt == "row" else (D, R)).astype(float)
    if fmt == "row":
        v, vfmt = RNG.integers(-4, 5, D).astype(float), "dense"
    else:
        v, vfmt = RNG.integers(-4, 5, R).astype(float), "sparse"
    if enc_m:
        jm = jf.get_encrypted_matrix(m, fmt, 2.0)
        tm = _port_mat(tf, jm)
    else:
        jm, tm = jf.get_plain_matrix(m, fmt, 2.0), tf.get_plain_matrix(m, fmt, 2.0)
    if enc_v:
        jv = jf.get_encrypted_vector(v, vfmt, 4.0)
        tv = _port_vec(tf, jv)
    else:
        jv, tv = jf.get_plain_vector(v, vfmt, 4.0), tf.get_plain_vector(v, vfmt, 4.0)
    return (jm, jv), (tm, tv), m @ v


# (fmt, encrypted matrix, encrypted vector, force_dense): the branches of
# an encrypted matrix by an encrypted vector (the BEHZ multiply) run on
# the big-t ring, every other branch on both
PLAIN_BRANCHES = [("row", True, False, False), ("row", True, False, True),
                  ("row", False, True, False), ("row", False, True, True),
                  ("col", True, False, False), ("col", False, True, False)]
BRANCHES = [("big_t",) + b for b in PLAIN_BRANCHES + [
    ("row", True, True, False), ("row", True, True, True),
    ("col", True, True, False)]] + [("small_t",) + b for b in PLAIN_BRANCHES]


@pytest.mark.parametrize("ring,fmt,enc_m,enc_v,force", BRANCHES)
def test_matrix_mul_branches_bit_equal(pairs, ring, fmt, enc_m, enc_v, force):
    """Each branch bit-equal to the reference, with the rows (columns) in
    one piece and one a piece; the decrypted result is the matrix
    product."""
    jf, tf = pairs(ring)
    (jm, jv), (tm, tv), want = _operands(jf, tf, fmt, enc_m, enc_v)
    jout = jm.mul(jv, force)
    for piece_bytes in (tmatrix.DOT_CHUNK_BYTES, 1):   # one piece, one a row
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmatrix, "DOT_CHUNK_BYTES", piece_bytes)
            tout = tm.mul(tv, force)
        _same(tout, jout, f"{fmt} {enc_m} {enc_v} {force} {piece_bytes}")
    np.testing.assert_array_equal(tout.decrypt(), want)
    assert tout.fmt == ("sparse" if fmt == "row" and not force else "dense")
    with pytest.raises(ValueError):
        tm.mul(tf.get_plain_vector(np.ones(3), "dense", 1.0))


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_row_pieces_with_a_remainder(pairs, ring):
    """Pieces of two rows over five rows (two pieces and a remainder),
    forced dense, bit-equal to the reference's single stack."""
    jf, tf = pairs(ring)
    (jm, jv), (tm, tv), want = _operands(jf, tf, "row", False, True)
    row_bytes = tf.P * 3 * len(tf.coeff_modulus) * N * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmatrix, "DOT_CHUNK_BYTES", 2 * row_bytes)
        assert tmatrix._pieces(R, row_bytes) == [(0, 2), (2, 4), (4, 5)]
        tout = tm.mul(tv, True)
    _same(tout, jm.mul(jv, True), "pieces of two")
    np.testing.assert_array_equal(tout.decrypt(), want)


# ------------------------------------------------------- the dense layer
@pytest.mark.parametrize("ring", sorted(RINGS))
def test_dense_layer_over_a_sparse_input(pairs, ring):
    """`LLDenseLayer(input_format="sparse")`: the column-major matvec of
    the plain weights by the encrypted sparse input, plus a dense bias."""
    jf, tf = pairs(ring)
    maps, inputs = 6, 4
    w = RNG.integers(-3, 4, maps * inputs).astype(float)
    b = RNG.integers(-3, 4, maps).astype(float)
    x = RNG.integers(-3, 4, inputs).astype(float)

    class JSrc(JLayer):
        def get_output_scale(self):
            return 2.0

    class TSrc(TLayer):
        def get_output_scale(self):
            return 2.0

    jl = jnn.LLDenseLayer(JSrc(None, jf), w, b, 4.0, input_format="sparse")
    tl = tlola.LLDenseLayer(TSrc(None, tf), w, b, 4.0, input_format="sparse")
    jl.prepare()
    tl.prepare()
    assert tl.weights_matrix.fmt == "col" and tl.bsgs_form is None
    jv = jf.get_encrypted_vector(x, "sparse", 2.0)
    jout = jl.apply(jf.get_matrix([jv], "col")).get_column(0)
    tout = tl.apply(tf.get_matrix([_port_vec(tf, jv)], "col")).get_column(0)
    _same(tout, jout, "sparse-input dense layer")
    np.testing.assert_array_equal(tout.decrypt(), w.reshape(maps, inputs) @ x + b)
    with pytest.raises(ValueError, match="dense input"):
        tlola.LLDenseLayer(TSrc(None, tf), w, b, 4.0, input_format="sparse",
                           force_dense_format=True).prepare()


# ------------------------------------------------ a reduced CIFAR-bigt chain
def test_reduced_cifar_bigt_chain_bit_equal(pairs):
    """`tests/test_torch_lola_cifar.py`'s chain on the big-t factory: its
    conv-as-dense (64 outputs, 243 inputs over both slot rows) takes
    per-row dots with the forced dense output (no BSGS: the factory
    encodes on the host), bit-equal layer by layer; the two-plane decrypt
    of the output gives the Raw oracle's logits with budget to spare."""
    jf, tf = pairs("big_t")
    records = _records(1)
    jfwd = JaxForward(_cifar_chain(jnn, jf, japi.RawFactory(N), records), jit=False)
    jm = jfwd.encrypt_layer.apply(jfwd.reader.get_next())
    thead = _cifar_chain(_Port, tf, RawFactory(N), records)
    dense = thead.source.source
    assert dense.bsgs_form is None and dense.weights_matrix.fmt == "row"
    assert dense.weights_matrix._unit_masks.shape == (2, 64, 13, N)
    tfwd = EncryptedForward(thead)
    tm = _port_mat(tf, jm)
    for jl, tl in zip(jfwd.layers, tfwd.layers):
        jm, tm = jl.apply(jm), tl.apply(tm)
        for jv, tv in zip(jm.vectors, tm.vectors):
            _same(tv, jv, type(tl).__name__)
    assert tm.get_column(0).fmt == "sparse"

    out = tm.get_column(0)
    assert out.noise_budget() > 0
    raw = _cifar_chain(_Port, RawFactory(N), RawFactory(N), records)
    want = raw.get_next().get_column(0)
    assert list(out.decrypt_full_precision()) == list(want.decrypt_full_precision())
    np.testing.assert_allclose(out.decrypt(), want.decrypt(), rtol=1e-9, atol=0)


# ----------------------------------------------- CryptoNets under either NTT
def test_cryptonets_under_either_ntt(monkeypatch):
    """`cryptonets_mnist.build` gives its factory the `ntt_impl` it is
    passed (on a stand-in of its preset at n = 256: `tests/
    test_torch_cryptonets.py`'s ring); on each factory the reduced
    CryptoNets network of that file (a batch of 3) decodes to the same
    integers under the four-step NTT as under the butterfly, those of the
    Raw oracle."""
    from cryptonets_tpu_torch.crypto.ntt import ntt_context_for
    from cryptonets_tpu_torch.models import cryptonets_mnist, presets
    from test_torch_cryptonets import FAC, PORT_MODS, _network

    monkeypatch.setitem(presets.CONFIGS, "cryptonets", dict(
        plain_primes=FAC["plain_primes"], n=N, coeff_modulus=FAC["coeff_modulus"],
        dbc=16, ks_alpha=0))
    raw = _network(PORT_MODS, RawFactory(N), RawFactory(N))["head"].get_next()
    got = {}
    for impl in ("butterfly", "matmul"):
        _, fac, _ = cryptonets_mnist.build(True, 3, records=[], device="cpu",
                                           seed=FAC["seed"], ntt_impl=impl)
        assert fac.ntt_impl == impl
        assert fac.bfv[0].p.ntt_q is ntt_context_for(impl, N, FAC["coeff_modulus"])
        out = EncryptedForward(_network(PORT_MODS, fac, RawFactory(N))["head"])()
        got[impl] = [list(v.decrypt_full_precision()) for v in out.vectors]
        np.testing.assert_array_equal(out.decrypt(), raw.decrypt())
    assert got["butterfly"] == got["matmul"]
