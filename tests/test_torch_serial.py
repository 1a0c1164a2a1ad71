"""The client/server split of the port (`cryptonets_tpu_torch/api/
serial.py`) against the JAX package's `api/serial.py`, on the CPU.

On the reference's serial ring (`tests/test_serial.py`: n = 256, two
17-bit plain primes, three 30-bit limbs, dbc 16, seed 21): key files,
full or public-only, written by either package load in the other with
the same keys bit for bit; vector and matrix files cross both ways and
decrypt alike; a public-only factory of either package evaluates and
refuses to decrypt with the same message; and a reduced LoLa chain run
by a server on a factory loaded from a public-only file gives, bit for
bit, the client's in-process output ciphertexts."""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cryptonets_tpu.api as japi  # noqa: E402
from cryptonets_tpu.api import serial as jserial  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.api import serial  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory  # noqa: E402
from cryptonets_tpu_torch.api.vector import HEVector  # noqa: E402
from cryptonets_tpu_torch.nn.forward import EncryptedForward  # noqa: E402
from cryptonets_tpu_torch.nn.layers import EncryptLayer  # noqa: E402
from cryptonets_tpu_torch.nn.lola import (LLDenseLayer, LLPoolLayer,  # noqa: E402
                                          LLVectorizeLayer)
from cryptonets_tpu_torch.nn.readers import LLConvReader  # noqa: E402

N = 256
RING = dict(plain_primes=ntt_primes(N, 17, 2), n=N,
            coeff_modulus=ntt_primes(N, 30, 3), dbc=16)
KEY_ARRAYS = ("k__s_hat_mont", "k__s2_hat_mont", "k__p0", "k__p1",
              "k__relin_k0", "k__relin_k1", "k__s_small")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread runs them as fast and
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The reference factory, a port factory with its own keys, and the
    key files each wrote, full and public-only."""
    d = tmp_path_factory.mktemp("serial")
    jf = japi.CrtBfvFactory(seed=21, **RING)
    tf = CrtBfvFactory(seed=22, device="cpu", **RING)
    out = dict(jf=jf, tf=tf)
    for secret in (True, False):
        kind = "full" if secret else "public"
        out[f"ref_{kind}"] = str(d / f"ref_{kind}.npz")
        out[f"port_{kind}"] = str(d / f"port_{kind}.npz")
        jserial.save_keys(jf, out[f"ref_{kind}"], include_secret=secret)
        serial.save_keys(tf, out[f"port_{kind}"], include_secret=secret)
    return out


def _arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _same_files(a, b):
    """Two key files hold the same config and the same arrays, bit for bit."""
    za, zb = _arrays(a), _arrays(b)
    assert sorted(za) == sorted(zb)
    assert str(za.pop("config")) == str(zb.pop("config"))
    for k in za:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("kind", ["full", "public"])
def test_key_files_cross_both_ways(files, tmp_path, kind):
    """A reference key file loads in the port and writes back the same
    file; a port key file loads in the reference and writes back the
    same file.  Without the secret key the secret arrays are zeros."""
    secret = kind == "full"
    tf = serial.load_factory(files[f"ref_{kind}"], device="cpu")
    assert tf.has_secret_key is secret
    back = str(tmp_path / "back.npz")
    serial.save_keys(tf, back, include_secret=secret)
    _same_files(files[f"ref_{kind}"], back)

    jf = jserial.load_factory(files[f"port_{kind}"])
    assert jf.has_secret_key is secret
    jserial.save_keys(jf, back, include_secret=secret)
    _same_files(files[f"port_{kind}"], back)
    z = _arrays(files[f"port_{kind}"])
    assert set(KEY_ARRAYS) <= set(z)
    if not secret:
        for name in ("k__s_hat_mont", "k__s2_hat_mont", "k__s_small"):
            assert not z[name].any()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_vector_and_matrix_files_cross(files, writer):
    """A vector and a matrix written by either package load in the other
    with the same residues and decrypt to the values in both."""
    jf = files["jf"]
    tf = serial.load_factory(files["ref_full"], device="cpu")
    rng = np.random.default_rng(77)
    v = rng.integers(-9, 9, 12).astype(float)
    M = rng.integers(-5, 5, (6, 3)).astype(float)
    if writer == "reference":
        vec, mat = jf.get_encrypted_vector(v, "dense", 2.0), jf.get_encrypted_matrix(M, "col", 2.0)
        save_v, save_m, load_v, load_m, fac = (jserial.save_vector, jserial.save_matrix,
                                               serial.load_vector, serial.load_matrix, tf)
    else:
        vec, mat = tf.get_encrypted_vector(v, "dense", 2.0), tf.get_encrypted_matrix(M, "col", 2.0)
        save_v, save_m, load_v, load_m, fac = (serial.save_vector, serial.save_matrix,
                                               jserial.load_vector, jserial.load_matrix, jf)
    buf = io.BytesIO()
    save_v(vec, buf)
    buf.seek(0)
    back = load_v(fac, buf)
    assert (back.dim, back.scale, back.fmt, back.is_signed) == (12, 2.0, "dense", True)
    np.testing.assert_array_equal(np.asarray(back.data).view(np.uint32),
                                  np.asarray(vec.data).view(np.uint32))
    np.testing.assert_array_equal(back.decrypt()[:12], v)
    buf = io.BytesIO()
    save_m(mat, buf)
    buf.seek(0)
    bm = load_m(fac, buf)
    assert bm.fmt == "col" and len(bm.vectors) == 3
    for a, b in zip(bm.vectors, mat.vectors):
        np.testing.assert_array_equal(np.asarray(a.data).view(np.uint32),
                                      np.asarray(b.data).view(np.uint32))
    np.testing.assert_array_equal(bm.decrypt()[:6], M)


def test_public_only_factory_evaluates_and_refuses_to_decrypt(files, capsys):
    """Both packages: a factory from a public-only file encrypts and adds
    and subtracts; the real factory decrypts the result; the public-only
    one refuses with the same message, the load with the same warning."""
    tp = serial.load_factory(files["ref_public"], device="cpu")
    jp = jserial.load_factory(files["ref_public"])
    warnings = capsys.readouterr().out.splitlines()
    assert len(warnings) == 2 and warnings[0] == warnings[1]
    v = np.arange(4.0)
    e = tp.get_encrypted_vector(v, "dense", 1.0)
    s = e.add(e).subtract(tp.get_plain_vector(v, "dense", 1.0))
    real = serial.load_factory(files["ref_full"], device="cpu")
    np.testing.assert_array_equal(
        HEVector(real, data=s.data, dim=s.dim, scale=s.scale).decrypt()[:4], v)
    messages = []
    for vec in (s, jp.get_encrypted_vector(v, "dense", 1.0)):
        with pytest.raises(RuntimeError) as err:
            vec.decrypt()
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    with pytest.raises(RuntimeError):
        tp.get_encrypted_matrix(np.ones((3, 2)), "col").decrypt()


GEO = dict(input_shape=[8, 8], kernel_shape=[3, 3], upper_padding=[1, 1],
           stride=[2, 2])


def reduced_lola(factory, records=None):
    """A reduced LoLa chain on the serial ring: conv (2 maps), vectorize,
    a dense layer of per-row dots (the ring's 90 bits leave no budget
    for a square besides)."""
    rng = np.random.default_rng(3)
    reader = LLConvReader(RawFactory(N), normalization_factor=1.0, scale=2.0, **GEO)
    if records is not None:
        reader.set_source_records(records)
    enc = EncryptLayer(reader)
    enc.factory = factory
    conv = LLPoolLayer(enc, map_count=[2, 1], weights=rng.integers(-2, 3, 18),
                       bias=rng.integers(-2, 3, 2), weights_scale=2.0, **GEO)
    return LLDenseLayer(LLVectorizeLayer(conv), weights=rng.integers(-2, 3, 4 * 32),
                        bias=rng.integers(-2, 3, 4), weights_scale=2.0)


def test_reduced_chain_through_a_public_only_server(files):
    """The client encrypts a record and writes it; a server holding only
    the public file runs the reduced chain (its factory set on the
    EncryptLayer before `prepare_network`) and writes the output; the
    client's decryption equals its in-process run, bit for bit, and the
    Raw oracle.  The server's record bodies, which decrypt, refuse to be
    made."""
    rng = np.random.default_rng(11)
    records = [(0, rng.integers(0, 4, 64).astype(float))]
    client = serial.load_factory(files["port_full"], device="cpu")
    head_c = reduced_lola(client, [(lb, f.copy()) for lb, f in records])
    head_c.prepare_network()
    fwd_c = EncryptedForward(head_c)
    buf = io.BytesIO()
    serial.save_matrix(fwd_c.encrypt_layer.apply(fwd_c.reader.get_next()), buf)
    wire_in = buf.getvalue()

    server = serial.load_factory(files["port_public"], device="cpu")
    head_s = reduced_lola(RawFactory(N))
    fwd_s = EncryptedForward(head_s)
    fwd_s.encrypt_layer.factory = server
    head_s.prepare_network()
    res = fwd_s.run_encrypted(serial.load_matrix(server, io.BytesIO(wire_in)))
    with pytest.raises(RuntimeError):
        res.decrypt()
    # the record bodies decrypt too: they refuse before anything runs
    for body in (lambda: fwd_s.record_fn(1, 1, 64, 2.0),
                 lambda: fwd_s.record_batch_fn(2, 1, 1, 64, 2.0)):
        with pytest.raises(RuntimeError, match="without a secret key"):
            body()
    buf = io.BytesIO()
    serial.save_matrix(res, buf)
    buf.seek(0)
    got = serial.load_matrix(client, buf).get_column(0)

    want = fwd_c.run_encrypted(serial.load_matrix(client, io.BytesIO(wire_in))).get_column(0)
    assert torch.equal(got.data, want.data)
    assert (got.dim, got.scale, got.fmt) == (want.dim, want.scale, want.fmt)
    head_r = reduced_lola(RawFactory(N), [(lb, f.copy()) for lb, f in records])
    head_r.prepare_network()
    raw = head_r.get_next().get_column(0).decrypt_full_precision()
    assert list(got.decrypt_full_precision()) == list(raw)
    assert got.noise_budget() > 0
