"""The exact modular contraction of the port (cryptonets_tpu_torch/
kernels/modmatmul.py) against the JAX reference's digit-plane
`exact_mod_contract`: the plain version, which serves CPU tensors and is
what the CUDA kernel is held against on the card, is bit-equal for
negative weights, weights above 2**31, 2**62 and 2**63, and O = 1, from
raw or from prepared weights.  Also the weight reduction, the tiling
rule, the layers preparing their weights once, and the rule that the
port's sources import neither jax nor the JAX package."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu.kernels.modmatmul import exact_mod_contract as j_contract  # noqa: E402
from cryptonets_tpu_torch.kernels import modmatmul as MM  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _weights(kind, rng, M, O):
    if kind == "small":
        return rng.integers(-100, 101, size=(M, O))
    if kind == "int64":     # any sign, above 2**31 and 2**62, int64 array
        W = rng.integers(-(1 << 62), 1 << 62, size=(M, O))
        W.flat[0], W.flat[-1] = (1 << 62) + 12345, -(1 << 63)
        return W
    W = rng.integers(-(1 << 40), 1 << 40, size=(M, O)).astype(object)
    W.flat[0], W.flat[-1] = (1 << 80) + 7, -(1 << 70) - 3   # Python ints
    return W


@pytest.mark.parametrize("M,O,k,N,P,kind", [
    (5, 25, 3, 64, 2, "int64"),
    (3, 1, 2, 64, 1, "int64"),        # O = 1
    (10, 100, 4, 128, 1, "small"),
    (4, 97, 3, 64, 2, "object"),
    (11, 7, 2, 32, 1, "object"),
])
def test_plain_contract_matches_reference(M, O, k, N, P, kind):
    rng = np.random.default_rng(M * 1000 + O)
    qs = ntt_primes(N, 30, k)
    W = _weights(kind, rng, M, O)
    x = np.stack([rng.integers(0, q, size=(P, O, 1, 2, N)) for q in qs],
                 axis=-2).astype(np.uint32)          # [P, O, 1, 2, k, N]
    want = np.asarray(j_contract(
        W, jnp.asarray(x), qs, jnp.asarray(np.array(qs, np.uint32).reshape(-1, 1))))
    xt = torch.from_numpy(x.view(np.int32))
    q_col = torch.tensor(qs, dtype=torch.int64).view(-1, 1)
    prepared = MM.prepare_contract(W, qs, "cpu")
    for fn in (MM.exact_mod_contract_plain, MM.exact_mod_contract):
        for w in (W, prepared):
            got = fn(w, xt, qs, q_col)
            assert got.dtype == torch.int32 and got.shape == (P, M, 1, 2, k, N)
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # and against exact Python-int arithmetic, limb 0
    exact = (np.array(W, dtype=object) @ x[0, :, 0, 0, 0, :].astype(object)) % qs[0]
    np.testing.assert_array_equal(want[0, :, 0, 0, 0, :].astype(object), exact)


def test_reduce_weights_paths_agree():
    """The vectorised int64 reduction equals the Python-int one; uint64
    and object arrays go through Python ints."""
    rng = np.random.default_rng(0)
    qs = ntt_primes(64, 31, 3)
    W = rng.integers(-(1 << 63), (1 << 63) - 1, size=(6, 9))
    fast = MM.reduce_weights(W, qs)
    slow = MM.reduce_weights(W.astype(object), qs)
    assert fast.shape == (6, 9, 3) and fast.dtype == np.int64
    np.testing.assert_array_equal(fast, slow)
    assert fast.min() >= 0 and all(fast[..., i].max() < q for i, q in enumerate(qs))
    big = np.array([[(1 << 64) - 1, 1 << 63]], dtype=np.uint64)
    np.testing.assert_array_equal(
        MM.reduce_weights(big, qs)[0, :, 0],
        [((1 << 64) - 1) % qs[0], (1 << 63) % qs[0]])
    np.testing.assert_array_equal(
        MM.reduce_weights([[1 << 100, -1]], qs)[0, :, 1],
        [(1 << 100) % qs[1], qs[1] - 1])


def test_tile_choice_and_launch_counter():
    """M pads to a wgmma width (8, 16, 32, 64 or 112) in the fewest tiles
    of at most 112, O cuts into chunks of at most 128 values (a multiple
    of 32); the CPU path launches nothing."""
    assert [MM.tiling(M, 25)[:2] for M in (1, 5, 8, 9, 10, 56, 65, 100, 257)] == \
        [(8, 1), (8, 1), (8, 1), (16, 1), (16, 1), (64, 1), (112, 1),
         (112, 1), (112, 3)]
    assert [MM.tiling(5, O)[2:] for O in (1, 25, 32, 33, 100, 128, 129, 845)] == \
        [(32, 1), (32, 1), (32, 1), (64, 1), (128, 1), (128, 1), (128, 2),
         (128, 7)]
    before = MM.LAUNCHES["mod_contract"]
    qs = ntt_primes(32, 30, 2)
    x = torch.zeros((1, 2, 1, 2, 2, 32), dtype=torch.int32)
    MM.exact_mod_contract([[1, 2]], x, qs, torch.tensor(qs).view(-1, 1))
    assert MM.LAUNCHES["mod_contract"] == before  # the CPU launches nothing


def test_contract_rejects_bad_shapes():
    qs = ntt_primes(32, 30, 2)
    q_col = torch.tensor(qs).view(-1, 1)
    x = torch.zeros((1, 3, 1, 2, 2, 32), dtype=torch.int32)
    with pytest.raises(ValueError):
        MM.exact_mod_contract([[1, 2]], x, qs, q_col)          # O mismatch
    with pytest.raises(ValueError):
        MM.exact_mod_contract([[1, 2, 3]], x[0], qs, q_col)    # rank
    with pytest.raises(ValueError):
        MM.exact_mod_contract([[1, 2, 3]], x, qs[:1], q_col)   # limb count


def test_layers_prepare_their_weights_once(monkeypatch):
    """LLPoolLayer (LoLa's conv) and PoolLayer (a dense layer) make their
    contraction weights once over two records, not once a call; a new
    factory makes them anew.  The decrypted outputs equal the Raw path."""
    from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory
    from cryptonets_tpu_torch.nn.layers import EncryptLayer, PoolLayer
    from cryptonets_tpu_torch.nn.lola import LLPoolLayer
    from cryptonets_tpu_torch.nn.readers import BatchReader, LLConvReader

    calls = []
    real = MM.prepare_contract
    monkeypatch.setattr(MM, "prepare_contract",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    n = 256
    fac = dict(plain_primes=ntt_primes(n, 20, 2), n=n,
               coeff_modulus=ntt_primes(n, 30, 3), seed=3)
    rng = np.random.default_rng(6)
    geo = dict(input_shape=[6, 6], kernel_shape=[3, 3], stride=[3, 3])
    conv_w = rng.integers(-2, 3, 2 * 9).astype(float)
    dense_w = rng.integers(-3, 4, 3 * 12).astype(float)
    records = [(0, rng.integers(0, 4, 36).astype(float)) for _ in range(4)]

    def lola(factory):
        reader = LLConvReader(RawFactory(n), normalization_factor=1.0,
                              scale=2.0, **geo)
        reader.set_source_records([(lb, f.copy()) for lb, f in records[:2]])
        enc = EncryptLayer(reader)
        enc.factory = factory
        conv = LLPoolLayer(enc, map_count=[2, 1], weights=conv_w,
                           bias=np.array([1.0, -1.0]), weights_scale=2.0, **geo)
        conv.prepare_network()
        return conv

    def dense(factory):
        reader = BatchReader(RawFactory(n), max_slots=2, scale=2.0)
        reader.set_source_records([(lb, f.copy()[:12]) for lb, f in records])
        enc = EncryptLayer(reader)
        enc.factory = factory
        layer = PoolLayer(enc, input_shape=[12], kernel_shape=[12],
                          stride=[13], map_count=[3], weights=dense_w,
                          bias=np.array([2.0, 0.0, -3.0]), weights_scale=2.0)
        layer.prepare_network()
        return layer

    enc_fac = CrtBfvFactory(**fac, device="cpu")
    for build, shape in ((lola, (2, 9)), (dense, (3, 12))):
        calls.clear()
        head, raw = build(enc_fac), build(RawFactory(n))
        for _ in range(2):
            got = head.get_next()
            want = raw.get_next()
            for i in range(len(got.vectors)):
                assert list(got.get_column(i).decrypt_full_precision()) == \
                    list(want.get_column(i).decrypt_full_precision())
        assert calls == [shape]
        build(CrtBfvFactory(**fac, device="cpu")).get_next()
        assert calls == [shape, shape]


def test_port_sources_import_no_jax():
    """No import line of the port or of chip_smoke.py names jax or the
    JAX package."""
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|cryptonets_tpu)(?![\w])", re.M)
    files = sorted((ROOT / "cryptonets_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"]
    files += sorted((ROOT / "scripts").glob("torch_*.py"))
    assert len(files) > 30
    for path in files:
        hits = pat.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"
