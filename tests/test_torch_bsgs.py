"""Port BSGS diagonal matvec (cryptonets_tpu_torch/api/bsgs.py) with
hoisted babies, under RNS-group and under digit key switching: bit-equal
to the JAX `bsgs_matvec` under the same keys and input ciphertext, and
exact against the integer matvec."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu.api import bsgs as jbsgs  # noqa: E402
from cryptonets_tpu.api.factory import CrtBfvFactory as JaxFactory  # noqa: E402
from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.api import bsgs as tbsgs  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory  # noqa: E402
from cryptonets_tpu_torch.api.vector import HEVector  # noqa: E402
from cryptonets_tpu_torch.convert import keyset_from_numpy  # noqa: E402

N = 1024
PLAIN = ntt_primes(N, 17, 2)
CHAIN = ntt_primes(N, 30, 4)
G_BABY = 16


def _t(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


# key switching: RNS groups without special primes, and base-2^16 digits
KS_MODES = {"groups": dict(ks_alpha=1), "digits": dict(ks_alpha=0, dbc=16)}


@pytest.fixture(scope="module", params=sorted(KS_MODES))
def pair(request, tmp_path_factory):
    ks = KS_MODES[request.param]
    jf = JaxFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, seed=5,
                    rot_steps=tuple(range(1, G_BABY)), **ks)
    path = str(tmp_path_factory.mktemp("keys") / "keys.npz")
    JaxFactory._save_cached_keys(path, jf.keys)
    with np.load(path) as z:
        keys = keyset_from_numpy(z, device="cpu")
    tf = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, seed=5,
                       device="cpu", keys=keys, **ks)
    assert tf.bfv[0].p.ks_hybrid == (request.param == "groups")
    return jf, tf


@pytest.mark.parametrize("R,D,seed", [(20, 60, 7), (9, 100, 8)])
def test_hoisted_bsgs_bit_equal(pair, R, D, seed):
    jf, tf = pair
    rng = np.random.default_rng(seed)
    W = rng.integers(-8, 9, size=(R, D)).astype(np.int64)
    v = rng.integers(-5, 6, size=D).astype(np.int64)
    data = np.asarray(jf.get_encrypted_vector(v.astype(float)).data)
    jform = jbsgs.BsgsDenseForm(jf, W, R, D, g=G_BABY)
    tform = tbsgs.BsgsDenseForm(tf, W, R, D, g=G_BABY)
    assert jbsgs.hoist_eligible(jf, G_BABY) and tbsgs.hoist_eligible(tf, G_BABY)
    np.testing.assert_array_equal(tform.table, jform.table)
    assert tform.active == jform.active
    assert len(tform.active) <= max(4, tform.G // 4)  # sparse support
    want = np.asarray(jbsgs.bsgs_matvec(jform, data))
    got = tbsgs.bsgs_matvec(tform, _t(data))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    out = HEVector(tf, data=got, dim=R, scale=1.0)
    np.testing.assert_array_equal(
        np.array([int(x) for x in out.decrypt_full_precision()]), W @ v)


def test_stacked_baby_keys_follow_the_key_set(pair):
    """The stacked-key cache is keyed by the key set: replacing the keys
    rebuilds the stacks (the reference caches by Galois tuple only)."""
    _, tf = pair
    _, k0, _ = tf.stacked_baby_rotations(4)
    old = tf.keys
    g1 = tf.bfv[0].galois_elt_rows(1)
    swapped = dict(old.galois)
    swapped[g1] = old.galois[tf.bfv[0].galois_elt_rows(2)]
    tf.keys = old._replace(galois=swapped)
    try:
        _, k0_new, _ = tf.stacked_baby_rotations(4)
        assert torch.equal(k0_new[0], swapped[g1].k0)
        assert not torch.equal(k0_new[0], k0[0])
    finally:
        tf.keys = old
    assert torch.equal(tf.stacked_baby_rotations(4)[1], k0)
