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


# ------------------------------------------------ the diagonal encode alone
ENCODE_CASES = [  # (n, plain primes, special primes, NTT)
    (256, 2, 0, "butterfly"), (256, 3, 1, "butterfly"), (512, 4, 0, "butterfly"),
    (512, 2, 2, "butterfly"), (256, 3, 0, "matmul"),
]


def _signed_table(shape, t_min, seed):
    """Slot values in (-t_min, t_min) with +-(t_min - 1), 0 and -1 planted."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(-t_min + 1, t_min, size=shape).astype(np.int32)
    edges = np.array([t_min - 1, -(t_min - 1), 0, -1], np.int32)[: shape[-1]]
    tbl[0, 0, : len(edges)] = edges
    tbl[-1, -1, -len(edges):] = -edges
    return tbl


@pytest.mark.parametrize("n,P,n_special,impl", ENCODE_CASES)
def test_encode_diag_chunk_bit_equal_to_jax(n, P, n_special, impl):
    """The lift launches' encode of one giant chunk [g, F, n] equals the
    JAX package's `_encode_diag_chunk` on a factory with the same primes
    and ring, bit for bit (the four-step NTT through its own path)."""
    import jax.numpy as jnp

    plain = ntt_primes(n, 17, P)
    kw = dict(plain_primes=plain, n=n, coeff_modulus=ntt_primes(n, 30, 3),
              n_special=n_special, ntt_impl=impl)
    jf = JaxFactory(**kw, _skip_keygen=True)
    tf = CrtBfvFactory(**kw, device="cpu")
    tbl = _signed_table((4, 2, n), min(plain), n + P)
    want = np.asarray(jbsgs._encode_diag_chunk(jf, jnp.asarray(tbl)))
    got = tbsgs._encode_diag_chunk(tf, torch.from_numpy(tbl))
    assert got.shape == (P, 4, 2, 3, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n,L", [(2, 1), (256, 3), (1024, 13)])
def test_lift_twins_equal_the_broadcast_expressions(n, L):
    """Each lift's plain twin equals the expression it replaces: the
    forward, `to_mont(forward(x broadcast over the limbs))` for any x in
    [0, 2**31); the inverse, the inverse NTT of `where(x < 0, x + t, x)`
    broadcast over the plain primes, limb-major."""
    from cryptonets_tpu_torch.crypto.bfv import get_mod_chain
    from cryptonets_tpu_torch.crypto.ntt import get_ntt_context

    rng = np.random.default_rng(n + L)
    mods = ntt_primes(n, 31, L)
    ctx = get_ntt_context(n, mods)
    x = torch.from_numpy(rng.integers(0, 1 << 31, (5, n)).astype(np.int32))
    x[0, : min(n, 2)] = torch.tensor([(1 << 31) - 1, 0][: min(n, 2)])
    want = get_mod_chain(mods, "cpu").to_mont(
        ctx.forward(x[:, None, :].expand(5, L, n)))
    assert torch.equal(ctx.forward_lift(x), want)

    plain = ntt_primes(n, 17, 3)
    pctx = get_ntt_context(n, plain)
    s = torch.from_numpy(_signed_table((1, 5, n), min(plain), n)[0])
    flat, t = s[:, None, :], torch.tensor(plain, dtype=torch.int32).view(1, -1, 1)
    want = pctx.inverse(torch.where(flat < 0, flat + t, flat)).transpose(0, 1)
    assert torch.equal(pctx.inverse_lift(s), want)


def test_lift_refuses_batched_and_noncontiguous_rows():
    """A lift takes contiguous int32 rows [S, n] outside vmap, and a CPU
    lift launches nothing."""
    from cryptonets_tpu_torch.crypto.ntt import get_ntt_context
    from cryptonets_tpu_torch.kernels import ntt as K

    ctx = get_ntt_context(64, ntt_primes(64, 31, 2))
    before = dict(K.LAUNCHES)
    for lift in (ctx.forward_lift, ctx.inverse_lift):
        with pytest.raises(ValueError, match="batched"):
            torch.func.vmap(lift)(torch.zeros((2, 4, 64), dtype=torch.int32))
        for bad in (torch.zeros((64, 4), dtype=torch.int32).t(),      # strided
                    torch.zeros((2, 4, 64), dtype=torch.int32),        # 3-D
                    torch.zeros((4, 64), dtype=torch.int64),           # int64
                    torch.zeros((4, 32), dtype=torch.int32)):          # ring
            with pytest.raises(ValueError):
                lift(bad)
        lift(torch.zeros((4, 64), dtype=torch.int32))
    assert K.LAUNCHES == before
