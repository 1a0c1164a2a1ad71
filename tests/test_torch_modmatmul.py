"""The exact modular contraction of the port (cryptonets_tpu_torch/
kernels/modmatmul.py) against the JAX reference's digit-plane
`exact_mod_contract`: the plain version, which serves CPU tensors and is
what the CUDA kernel is held against on the card, is bit-equal for
negative weights, weights above 2**31, 2**62 and 2**63, and O = 1.  Also
the weight reduction, the tile choice, and the rule that the port's
sources import neither jax nor the JAX package."""

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
    for fn in (MM.exact_mod_contract_plain, MM.exact_mod_contract):
        got = fn(W, xt, qs, q_col)
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
    assert [MM.tile_for(M) for M in (1, 5, 6, 8, 10, 16, 100, 101)] == \
        [5, 5, 8, 8, 10, 8, 10, 8]
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


def test_port_sources_import_no_jax():
    """No import line of the port or of chip_smoke.py names jax or the
    JAX package."""
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|cryptonets_tpu)(?![\w])", re.M)
    files = sorted((ROOT / "cryptonets_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_lola_breakdown.py",
              ROOT / "scripts" / "torch_ntt_sass.py"]
    assert len(files) > 30
    for path in files:
        hits = pat.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"
