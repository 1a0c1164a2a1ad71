"""The `limb` axis of the port's mesh on the CPU: RNS limbs sharded over
gloo ranks, each cross-limb operation with its explicit collective.

  * Two ranks at {batch: 1, limb: 2}, one spawned group: on five chains
    at n = 256 (digit switching; P-less RNS groups of three limbs over
    four, so a group crosses the ranks' boundary; hybrid switching with
    two special primes and the same groups; a plain prime of 39 bits,
    two-plane decrypt; one of 64 bits, exact host decrypt) each rank's
    factory is built from the full chain and narrowed to its limbs.  Its
    own encryptions are its blocks of the one-process encryptions; the
    BEHZ multiply, relinearize, rotate (one key, composed, columns), a
    BSGS matvec (hoisted where the chain allows) and the decrypt, gathered
    over the ranks, are bit-equal to the same operations in one process
    on the same ciphertexts; each rank's key set holds its limbs only.
  * Four ranks at {2, 2}, one spawned group: the JAX package's
    `tests/test_sharding.py` step (square + relinearize, rotate by 1, add)
    and its ct x ct multiply on the JAX factory's ciphertexts and keys
    (`convert.keyset_from_numpy`, narrowed at import), gathered over both
    axes, bit-equal to the JAX package's output.
  * In one process: the narrowed tables on their axes, the refusals.

The ranks' functions live in this module and import no JAX (the spawned
processes import only this module's top level); every group waits at
most 120 s at a collective.
"""

import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu_torch.api import serial  # noqa: E402
from cryptonets_tpu_torch.api.bsgs import (BsgsDenseForm, bsgs_matvec,  # noqa: E402
                                           hoist_eligible)
from cryptonets_tpu_torch.api.factory import CrtBfvFactory  # noqa: E402
from cryptonets_tpu_torch.convert import keyset_from_numpy  # noqa: E402
from cryptonets_tpu_torch.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.parallel import (LimbShard, distributed,  # noqa: E402
                                           global_ciphertext_batch, make_mesh,
                                           shard_ciphertext_data)
from cryptonets_tpu_torch.parallel import dryrun, mesh  # noqa: E402

N = 256
SEED = 21
CHAIN4 = ntt_primes(N, 30, 4)
SMALL_T = ntt_primes(N, 17, 2)
CONFIGS = {
    "digits": dict(plain_primes=SMALL_T, coeff_modulus=CHAIN4, dbc=16,
                   rot_steps=(1, 2, 3)),
    "groups": dict(plain_primes=SMALL_T, coeff_modulus=CHAIN4, ks_alpha=3,
                   rot_steps=(1, 2, 3)),
    "hybrid": dict(plain_primes=SMALL_T, coeff_modulus=CHAIN4, ks_alpha=3,
                   n_special=2),
    "two_plane": dict(plain_primes=ntt_primes(N, 39, 1),
                      coeff_modulus=ntt_primes(N, 30, 6)),
    "host": dict(plain_primes=ntt_primes(N, 64, 1),
                 coeff_modulus=ntt_primes(N, 30, 12)),
}
OPS = ("multiply", "relinearize", "rotate", "rotate_composed", "rotate_columns")
BSGS_G = 4
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _factory(name, shard=None, **kw):
    cfg = CONFIGS[name]
    return CrtBfvFactory(seed=SEED, n=N, device="cpu", shard=shard, **cfg, **kw)


def _bsgs_weights():
    return np.random.default_rng(5).integers(-3, 4, (8, 16))


def _battery(fac, a, b) -> dict:
    """Every cross-limb operation on ciphertexts a, b [P, 1, 2, L, N] (the
    factory's limbs), gathered over the limbs, on the CPU; the decrypt's
    slots.  The same code in one process and on each rank."""
    keys, bfv = fac.keys, fac.bfv
    prod = torch.stack([bf.multiply(a[pi], b[pi]) for pi, bf in enumerate(bfv)])
    relin = torch.stack([bf.relinearize(prod[pi], keys) for pi, bf in enumerate(bfv)])
    out = dict(multiply=prod, relinearize=relin,
               rotate=bfv[0].rotate_rows(a, 1, keys),
               rotate_composed=bfv[0].rotate_rows(a, 5, keys),
               rotate_columns=bfv[0].rotate_columns(a, keys))
    if fac._device_encode:
        form = BsgsDenseForm(fac, _bsgs_weights(), 8, 16, g=BSGS_G)
        out["bsgs"] = bsgs_matvec(form, a)
    out = {k: bfv[0].gather_limbs(v).cpu() for k, v in out.items()}
    out["decrypt"] = fac.decrypt_slots(relin)
    return out


def _values(name):
    rng = np.random.default_rng(len(name))
    return rng.integers(-20, 21, N), rng.integers(-20, 21, N)


def _ops_rank(path) -> dict:
    """One rank of the two-rank group: each chain's factory on this rank's
    limbs (the default mesh of two ranks, {1, 2}), its own encryptions
    gathered, the battery on its blocks of the one-process ciphertexts,
    its key set's shapes and bytes."""
    torch.set_num_threads(1)
    inputs = torch.load(path)
    m = make_mesh()
    out = {}
    for name, cfg in CONFIGS.items():
        shard = m.limb_shard(len(cfg["coeff_modulus"]))
        fac = _factory(name, shard)
        va, vb = _values(name)
        own = torch.stack([fac.get_encrypted_vector(v.astype(float)).data
                           for v in (va, vb)])
        a, b = (shard_ciphertext_data(x, m) for x in inputs[name])
        res = _battery(fac, a, b)
        res["encrypt"] = fac.bfv[0].gather_limbs(own)
        keys = fac.keys
        res["mesh"] = dict(m.shape)
        res["limbs"] = (shard.lo, shard.hi)
        res["key_shapes"] = dict(
            s_hat=tuple(keys.s_hat_mont.shape), p0=tuple(keys.p0_hat_mont.shape),
            relin=tuple(keys.relin.k0.shape),
            galois={g: tuple(sk.k1.shape) for g, sk in keys.galois.items()})
        res["key_bytes"] = keys.nbytes()
        res["hoisted"] = fac._device_encode and hoist_eligible(fac, BSGS_G)
        out[name] = res
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(one-process results, one-process key sets, the two ranks' results)."""
    inputs, want, keys = {}, {}, {}
    for name in CONFIGS:
        fac = _factory(name)
        va, vb = _values(name)
        a, b = (fac.get_encrypted_vector(v.astype(float)).data for v in (va, vb))
        inputs[name] = (a, b)
        want[name] = _battery(fac, a, b)
        want[name]["encrypt"] = torch.stack([a, b])
        want[name]["plain"] = fac.decrypt_blocks(want[name]["relinearize"], N)
        keys[name] = fac.keys
    path = str(tmp_path_factory.mktemp("limbs") / "inputs.pt")
    torch.save(inputs, path)
    got = distributed.run_ranks(_ops_rank, 2, path, backend="gloo",
                                timeout=GROUP_TIMEOUT)
    return want, keys, got


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cross_limb_ops_bit_equal_to_one_process(two_ranks, name):
    want, _, got = two_ranks
    w = want[name]
    va, vb = _values(name)
    assert list(w["plain"]) == list(va * vb)          # the operations are right
    for rank, res in enumerate(got):
        r = res[name]
        assert r["mesh"] == {"batch": 1, "limb": 2}
        half = len(CONFIGS[name]["coeff_modulus"]) // 2
        assert r["limbs"] == (half * rank, half * (rank + 1))
        for op in OPS + ("encrypt",) + (("bsgs",) if "bsgs" in w else ()):
            assert torch.equal(r[op], w[op]), (name, rank, op)
        np.testing.assert_array_equal(r["decrypt"], w["decrypt"])
        assert r["hoisted"] == (name in ("digits", "groups"))


def test_narrowed_key_set_holds_its_limbs(two_ranks):
    """Each rank's keys: its limbs of the secret and public keys, and of
    every switch key its limbs plus every special prime, over the full
    chain's J components; bytes to match."""
    _, keys, got = two_ranks
    for name in ("digits", "groups", "hybrid", "two_plane"):
        full = keys[name]
        k = len(CONFIGS[name]["coeff_modulus"])
        ns = CONFIGS[name].get("n_special", 0)
        J = full.relin.k0.shape[0]
        local = k // 2
        for res in (r[name] for r in got):
            sh = res["key_shapes"]
            assert sh["s_hat"] == sh["p0"] == (local, N)
            assert sh["relin"] == (J, local + ns, N) and full.relin.k0.shape == (J, k + ns, N)
            assert sh["galois"] == {g: (J, local + ns, N) for g in full.galois}
            per_limb = 4 * N * (4 + 2 * J * (1 + len(full.galois)))
            assert res["key_bytes"] == full.nbytes() - (k - local) * per_limb
            if name == "hybrid":
                assert res["key_bytes"] / full.nbytes() > (local + ns) / (k + ns) - 0.01


# --------------------------------------------------- the JAX package's step
def _jax_rank(path) -> dict:
    """One rank of the four-rank group ({2, 2}): the reference's keys
    narrowed at import, this rank's block of the reference's ciphertexts
    on both axes, its step and multiply, gathered over both axes."""
    from cryptonets_tpu_torch.parallel.mesh import mesh_shape

    torch.set_num_threads(1)
    spec = torch.load(path, weights_only=False)
    m = make_mesh()
    assert m.shape == dict(zip(("batch", "limb"), mesh_shape(4)))
    shard = m.limb_shard(len(spec["chain"]))
    fac = CrtBfvFactory(plain_primes=spec["plain"], n=N, coeff_modulus=spec["chain"],
                        dbc=16, seed=13, device="cpu", shard=shard,
                        keys=keyset_from_numpy(spec["keys"], "cpu", shard=shard))
    keys = fac.keys
    d, x, y = (shard_ciphertext_data(spec[k], m) for k in ("data", "x", "y"))
    step, mul = [], []
    for pi, bf in enumerate(fac.bfv):
        sq = bf.relinearize(bf.square(d[pi]), keys)
        step.append(bf.add(sq, bf.rotate_rows(sq, 1, keys)))
        mul.append(bf.relinearize(bf.multiply(x[pi], y[pi]), keys))
    return dict(step=global_ciphertext_batch(torch.stack(step), m),
                multiply=global_ciphertext_batch(torch.stack(mul), m),
                limbs=(shard.lo, shard.hi), records=m.batch_index())


@pytest.fixture(scope="module")
def jax_four_ranks(tmp_path_factory):
    """The reference's factory, ciphertexts, step and multiply (jitted on
    the CPU, as its `tests/test_sharding.py`), and the four ranks'."""
    import jax
    import jax.numpy as jnp
    from cryptonets_tpu.api import CrtBfvFactory as JaxFactory
    from cryptonets_tpu.crypto.bfv import Ciphertext

    jf = JaxFactory(plain_primes=SMALL_T, n=N, coeff_modulus=CHAIN4, dbc=16,
                    seed=13)
    rng = np.random.default_rng(55)
    vals = [rng.integers(-9, 9, 12).astype(float) for _ in range(4)]
    data = jnp.concatenate([jf.get_encrypted_vector(v, "dense", 1.0).data
                            for v in vals], axis=1)          # [P, 4, 2, k, N]
    a = jf.get_encrypted_vector(np.arange(1.0, 9.0), "dense", 1.0).data
    b = jf.get_encrypted_vector(np.arange(8.0, 0.0, -1.0), "dense", 1.0).data
    da, db = jnp.concatenate([a] * 4, axis=1), jnp.concatenate([b] * 4, axis=1)

    def step(d):
        out = []
        for pi, bfv in enumerate(jf.bfv):
            sq = bfv.relinearize(bfv.square(Ciphertext(d[pi])), jf.keys)
            out.append(bfv.add(sq, bfv.rotate_rows(sq, 1, jf.keys)).data)
        return jnp.stack(out)

    def mul(x, y):
        return jnp.stack([
            bfv.relinearize(bfv.multiply(Ciphertext(x[pi]), Ciphertext(y[pi])),
                            jf.keys).data
            for pi, bfv in enumerate(jf.bfv)])

    want = dict(step=np.asarray(jax.jit(step)(data)),
                multiply=np.asarray(jax.jit(mul)(da, db)))
    tmp = tmp_path_factory.mktemp("jaxkeys")
    JaxFactory._save_cached_keys(str(tmp / "keys.npz"), jf.keys)
    with np.load(tmp / "keys.npz") as z:
        key_arrays = {k: z[k] for k in z.files}

    def t(arr):
        return torch.from_numpy(np.array(arr, np.uint32).view(np.int32))

    path = str(tmp / "spec.pt")
    torch.save(dict(plain=tuple(SMALL_T), chain=tuple(CHAIN4), keys=key_arrays,
                    data=t(data), x=t(da), y=t(db)), path)
    got = distributed.run_ranks(_jax_rank, 4, path, backend="gloo",
                                timeout=GROUP_TIMEOUT)
    return want, vals, key_arrays, got


@pytest.mark.parametrize("op", ["step", "multiply"])
def test_jax_sharding_ops_bit_equal_on_four_ranks(jax_four_ranks, op):
    """The reference's `test_sharding.py` at {batch: 2, limb: 2}: every
    rank's gathered output equals the JAX package's, bit for bit; the step
    decrypts to v*v + the square rotated by one."""
    want, vals, key_arrays, got = jax_four_ranks
    assert [(r["records"], r["limbs"]) for r in got] == [
        (0, (0, 2)), (0, (2, 4)), (1, (0, 2)), (1, (2, 4))]
    for res in got:
        np.testing.assert_array_equal(res[op].numpy().view(np.uint32), want[op])
    if op == "step":
        fac = CrtBfvFactory(plain_primes=SMALL_T, n=N, coeff_modulus=CHAIN4,
                            dbc=16, seed=13, device="cpu",
                            keys=keyset_from_numpy(key_arrays, "cpu"))
        dec = fac.decrypt_blocks(got[0]["step"][:, :1], N)[:12].astype(float)
        v = vals[0]
        np.testing.assert_allclose(dec, v * v + np.concatenate([v[1:] * v[1:], [0.0]]))


# ---------------------------------------------------------- one process
def test_narrowed_tables_on_their_axes():
    """`BFVParams.narrow` cuts per-limb columns and the conversion tables
    out of q on their source axis, those into q on their target axis, and
    the switching targets to the rank's q limbs + every special prime; the
    chains that do not depend on the rank stay whole."""
    full = _factory("hybrid").params[0]
    p = _factory("hybrid", LimbShard(2, 4, 4, None)).params[0]
    assert p.limb_moduli == CHAIN4[2:] and p.chain_q.moduli == CHAIN4[2:]
    assert p.chain_qp.moduli == CHAIN4[2:] + full.sp_list
    assert p.q_list == full.q_list and p.delta == full.delta
    assert p.chain_bsk is full.chain_bsk and p.chain_sp is full.chain_sp
    for name in ("delta_col", "inv_punct_q", "punct_q_to_bsk", "punct_q_to_tg",
                 "B_mod_q", "ks_pinv_q"):
        assert torch.equal(getattr(p, name), getattr(full, name)[2:]), name
    for name in ("punct_B_to_q", "ks_punct_sp_to_q"):
        assert torch.equal(getattr(p, name), getattr(full, name)[:, 2:]), name
    for name in ("ks_grp_conv", "ks_pqt"):
        whole = getattr(full, name)
        assert torch.equal(getattr(p, name), torch.cat([whole[:, 2:4], whole[:, 4:]], 1))
    assert torch.equal(p.ks_inv_punct_grp, full.ks_inv_punct_grp)
    with pytest.raises(ValueError):
        p.narrow(LimbShard(0, 2, 4, None))


def test_sharded_factory_refusals(tmp_path):
    """A sharded factory does not save keys it holds only in part; a limb
    axis must divide the chain, and the production dry run's chain of 6
    (the reference's ValueError)."""
    fac = _factory("digits", LimbShard(0, 2, 4, None))
    with pytest.raises(ValueError, match="unsharded factory"):
        serial.save_keys(fac, str(tmp_path / "keys.npz"))
    with pytest.raises(ValueError):
        mesh.Mesh(1, 3).limb_block(4)
    from cryptonets_tpu.parallel import dryrun as jdry

    with pytest.raises(ValueError) as theirs:
        jdry.dryrun_production(mesh.Mesh(1, 4))
    with pytest.raises(ValueError) as ours:
        dryrun.dryrun_production(mesh.Mesh(1, 4), device="cpu")
    assert str(ours.value) == str(theirs.value)
