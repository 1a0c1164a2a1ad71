"""The four-step NTT of the port (cryptonets_tpu_torch/kernels/
matmul_ntt.py, plain version, and crypto/ntt.py MatmulNTTContext) against
the JAX reference's MatmulNTTContext on the CPU: equal tables, bit-equal
forward and inverse transforms at square and non-square splits, batched
inputs, all-(q-1) inputs at 31-bit limbs, exact round trips, and a
negacyclic product against the big-integer convolution.  Integers only:
every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu.kernels import matmul_ntt as J  # noqa: E402
from cryptonets_tpu_torch.crypto.ntt import (  # noqa: E402
    MatmulNTTContext,
    NTTContext,
    ntt_context_for,
)
from cryptonets_tpu_torch.kernels import matmul_ntt as M  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _np(x):
    return x.numpy().view(np.uint32)


def _random(shape, mods, seed):
    q = np.array(mods, np.uint64).reshape(-1, 1)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 31, shape, dtype=np.uint64) % q).astype(np.uint32)


@pytest.mark.parametrize("n", [64, 256])
def test_tables_equal_reference(n):
    """Values of every table; the reference's matrices are four 8-bit
    float planes, recombined here."""
    mods = ntt_primes(n, 31, 2)
    assert M.split4(n) == J._split4(n)
    jt = J._tables(n, mods)
    hv = M.host_values(n, mods)
    for name in ("Wa", "Wb", "Wai", "Wbi"):
        planes = np.asarray(jt[name].astype(np.float32)).astype(np.uint64)
        np.testing.assert_array_equal(
            sum(planes[d] << (8 * d) for d in range(4)), hv[name], name)
    for name in ("tw", "twi", "pre", "post"):
        np.testing.assert_array_equal(np.asarray(jt[name]), hv[name], name)
    # the device tables pair each value with its Shoup companion
    tab = M.host_tables(n, mods)
    for field, name in (("pre", "pre"), ("wa", "Wa"), ("wbi", "Wbi"),
                        ("post", "post")):
        pairs = _np(getattr(tab, field))
        np.testing.assert_array_equal(pairs[..., 0], hv[name].reshape(pairs.shape[:-1]))
    np.testing.assert_array_equal(
        _np(tab.tw)[..., 1].reshape(np.asarray(jt["tw_sh"]).shape),
        np.asarray(jt["tw_sh"]))
    np.testing.assert_array_equal(_np(tab.post)[..., 1], np.asarray(jt["post_sh"]))


@pytest.mark.parametrize("n,bits,L", [(64, 30, 3), (256, 30, 2), (4096, 30, 2),
                                      (128, 31, 2), (512, 31, 2)])
def test_forward_inverse_bit_equal(n, bits, L):
    """Batched [3, 2, L, n]; 128 and 512 split into unequal N1, N2."""
    mods = ntt_primes(n, bits, L)
    jc = J.MatmulNTTContext(n, mods)
    tc = ntt_context_for("matmul", n, mods)
    assert isinstance(tc, MatmulNTTContext)
    x = _random((3, 2, L, n), mods, seed=n)
    f = tc.forward(_t(x))
    np.testing.assert_array_equal(_np(f), np.asarray(jc.forward(x)))
    np.testing.assert_array_equal(_np(tc.inverse(_t(x))), np.asarray(jc.inverse(x)))
    assert torch.equal(tc.inverse(f), _t(x))
    assert f.dtype == torch.int32 and f.shape == x.shape


@pytest.mark.parametrize("n", [64, 128])
def test_all_q_minus_one_at_31_bits(n):
    """The largest residues in every position: the widest sums."""
    mods = ntt_primes(n, 31, 3)
    x = np.broadcast_to(
        (np.array(mods, np.uint32) - 1).reshape(-1, 1), (2, 3, n)).copy()
    jc = J.MatmulNTTContext(n, mods)
    tc = ntt_context_for("matmul", n, mods)
    np.testing.assert_array_equal(_np(tc.forward(_t(x))), np.asarray(jc.forward(x)))
    np.testing.assert_array_equal(_np(tc.inverse(_t(x))), np.asarray(jc.inverse(x)))


def test_negacyclic_product_against_big_integers():
    n = 64
    mods = ntt_primes(n, 31, 2)
    tc = ntt_context_for("matmul", n, mods)
    a, b = _random((2, n), mods, 1), _random((2, n), mods, 2)
    q = torch.tensor(mods, dtype=torch.int64).view(-1, 1)
    prod = tc.inverse(
        (tc.forward(_t(a)).long() * tc.forward(_t(b)).long() % q).to(torch.int32))
    for li, m in enumerate(mods):
        want = [0] * n
        for i in range(n):
            for j in range(n):
                term = int(a[li, i]) * int(b[li, j])
                if i + j < n:
                    want[i + j] += term
                else:
                    want[i + j - n] -= term
        assert [int(v) for v in _np(prod)[li]] == [w % m for w in want]
    # the butterfly context multiplies the same polynomials to the same
    # product, through a different ordering of the evaluation points
    bc = ntt_context_for("butterfly", n, mods)
    prod_b = bc.inverse(
        (bc.forward(_t(a)).long() * bc.forward(_t(b)).long() % q).to(torch.int32))
    assert torch.equal(prod, prod_b)
    assert not torch.equal(tc.forward(_t(a)), bc.forward(_t(a)))


def test_context_selection_and_checks():
    mods = ntt_primes(64, 30, 2)
    assert ntt_context_for("matmul", 64, mods) is ntt_context_for("matmul", 64, mods)
    assert isinstance(ntt_context_for("butterfly", 64, mods), NTTContext)
    assert ntt_context_for("matmul", 64, mods).ordering != \
        ntt_context_for("butterfly", 64, mods).ordering
    for name in ("pallas", "hybrid", "fft"):
        with pytest.raises(ValueError, match="ntt_impl"):
            ntt_context_for(name, 64, mods)
    with pytest.raises(ValueError):
        M.host_tables(8, ntt_primes(8, 30, 1))     # N1 below the kernel's tile
    tab = ntt_context_for("matmul", 64, mods).tables("cpu")
    with pytest.raises(ValueError):
        M._check(torch.zeros((3, 64), dtype=torch.int32), tab)    # limb count
    with pytest.raises(ValueError):
        M._check(torch.zeros((2, 64), dtype=torch.int64), tab)    # storage type
    before = dict(M.LAUNCHES)
    M.matmul_ntt_forward(torch.zeros((2, 64), dtype=torch.int32), tab)
    assert M.LAUNCHES == before        # a CPU tensor launches no kernel
