"""The hand-written CUDA kernels (cryptonets_tpu_torch/kernels/ntt.cu,
modmatmul.cu and matmul_ntt.cu) against their plain versions, on the card.
Needs a CUDA device: skips without one.  On the card:
`python -m pytest tests/test_torch_cuda.py -q -m cuda`
(chip_smoke.py runs the same comparison at the main path's shapes)."""

import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu_torch.crypto.ntt import get_ntt_context, ntt_context_for  # noqa: E402
from cryptonets_tpu_torch.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.kernels import matmul_ntt as M  # noqa: E402
from cryptonets_tpu_torch.kernels import modmatmul as MM  # noqa: E402
from cryptonets_tpu_torch.kernels import ntt as K  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 7, 8192), (3, 4, 1024), (2, 3, 16384)])
def test_cuda_kernels_match_twins(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    n, L = shape[-1], shape[-2]
    tab = get_ntt_context(n, ntt_primes(n, 31, L)).tables("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randint(0, 1 << 31, shape, generator=gen, device="cuda")
         % tab.q.long()).to(torch.int32)
    before = dict(K.LAUNCHES)
    y = K.ntt_forward(x, tab)
    assert torch.equal(y, K.ntt_forward_plain(x, tab))
    z = K.ntt_inverse(y, tab)
    assert torch.equal(z, K.ntt_inverse_plain(y, tab))
    assert torch.equal(z, x)
    assert K.LAUNCHES["ntt_forward"] == before["ntt_forward"] + 1
    assert K.LAUNCHES["ntt_inverse"] == before["ntt_inverse"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 1, 2), (3, 5, 8), (1, 14, 64), (7, 3, 1024), (5, 1, 4096),
    (1, 1, 8192), (3, 13, 8192), (2, 9, 16384), (1, 2, 32768), (3, 1, 32768),
])
def test_cuda_ntt_every_ring(shape):
    """Every register width and pass split of the kernel template: rings
    from n = 2 to 32768, one row and odd row counts, 1 to 14 limbs, a row
    of q - 1 everywhere and a row of zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    n, L = shape[-1], shape[-2]
    tab = get_ntt_context(n, ntt_primes(n, 31, L)).tables("cuda")
    gen = torch.Generator(device="cuda").manual_seed(n + L)
    x = (torch.randint(0, 1 << 31, shape, generator=gen, device="cuda")
         % tab.q.long()).to(torch.int32)
    x[0] = (tab.q - 1).expand(L, n)
    if shape[0] > 1:
        x[-1] = 0
    before = dict(K.LAUNCHES)
    y = K.ntt_forward(x, tab)
    z = K.ntt_inverse(y, tab)
    assert K.LAUNCHES["ntt_forward"] == before["ntt_forward"] + 1
    assert K.LAUNCHES["ntt_inverse"] == before["ntt_inverse"] + 1
    assert torch.equal(y, K.ntt_forward_plain(x, tab))
    assert torch.equal(z, K.ntt_inverse_plain(y, tab))
    assert torch.equal(z, x)


@pytest.mark.cuda
@pytest.mark.parametrize("M,O,shape,kind", [
    (5, 25, (2, 1, 2, 3, 1024), "random"),
    (13, 130, (1, 2, 2, 2, 64), "random"),
    (1, 40, (1, 1, 2, 2, 256), "random"),       # one output
    (8, 64, (2, 1, 2, 2, 128), "random"),       # one full 8-wide tile
    (100, 845, (1, 1, 2, 2, 128), "random"),    # Dense(100)'s weights
    (257, 129, (1, 1, 1, 2, 256), "random"),    # three tiles of m
    (10, 1, (3, 1, 2, 2, 64), "random"),        # O = 1
    (7, MM.KC_MAX + 1, (1, 1, 2, 2, 64), "random"),   # one o past a chunk
    (9, MM.KF_MAX + 1, (1, 1, 1, 1, 64), "random"),   # past the s32 limit
    (10, 100, (1, 1, 2, 3, 4096), "random"),    # Caltech's ring
    (100, 300, (1, 1, 2, 2, 256), "q-1"),       # every residue q - 1
])
def test_cuda_mod_contract_matches_plain(M, O, shape, kind):
    """Ragged tiles of m and O, one output and 257 over three tiles of m,
    O = 1, O one past a chunk and past the s32 group limit, the rings of
    n = 64 to 4096, all residues q - 1; raw and prepared weights give the
    same result; negative weights and Python ints past 2**63."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    import numpy as np

    P, C, s, k, n = shape
    qs = ntt_primes(n, 31, k)
    q_col = torch.tensor(qs, dtype=torch.int64, device="cuda").view(-1, 1)
    if kind == "q-1":
        x = (q_col - 1).to(torch.int32).expand(P, O, C, s, k, n).contiguous()
        W = np.full((M, O), -1, dtype=np.int64)
    else:
        gen = torch.Generator(device="cuda").manual_seed(2)
        x = (torch.randint(0, 1 << 31, (P, O, C, s, k, n), generator=gen,
                           device="cuda") % q_col).to(torch.int32)
        W = np.random.default_rng(3).integers(
            -(1 << 62), 1 << 62, size=(M, O)).astype(object)
        W[0, 0], W[-1, -1] = (1 << 90) + 1, -(1 << 64) - 5
    before = MM.LAUNCHES["mod_contract"]
    y = MM.exact_mod_contract(W, x, qs, q_col)
    assert MM.LAUNCHES["mod_contract"] == before + 1
    want = MM.exact_mod_contract_plain(W, x, qs, q_col)
    assert torch.equal(y, want)
    prepared = MM.prepare_contract(W, qs, "cuda")
    assert torch.equal(MM.exact_mod_contract(prepared, x, qs, q_col), want)
    assert MM.LAUNCHES["mod_contract"] == before + 2
    with pytest.raises(ValueError):
        MM.exact_mod_contract(W, x.long(), qs, q_col)  # not int32 storage


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 7, 8192), (3, 4, 64), (5, 2, 128),
                                   (2, 3, 512), (2, 3, 16384),
                                   (3, 2, 10, 1, 7, 8192),
                                   (6, 1, 102, 1, 3, 4096)])
def test_cuda_matmul_ntt_matches_plain(shape):
    """Square and non-square splits (128 = 8 x 16, 512 = 16 x 32), the
    smallest rings and the largest one, a LoLaSmall record's ladder over
    Q*P (420 rows) and Caltech-101's six-digit ladder (1836 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    n, L = shape[-1], shape[-2]
    tab = ntt_context_for("matmul", n, ntt_primes(n, 31, L)).tables("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = (torch.randint(0, 1 << 31, shape, generator=gen, device="cuda")
         % tab.q.long()).to(torch.int32)
    x[0] = (tab.q - 1).expand(L, n)          # the largest residues everywhere
    before = dict(M.LAUNCHES)
    y = M.matmul_ntt_forward(x, tab)
    assert torch.equal(y, M.matmul_ntt_forward_plain(x, tab))
    z = M.matmul_ntt_inverse(y, tab)
    assert torch.equal(z, M.matmul_ntt_inverse_plain(y, tab))
    assert torch.equal(z, x)
    assert M.LAUNCHES["matmul_ntt_forward"] == before["matmul_ntt_forward"] + 1
    assert M.LAUNCHES["matmul_ntt_inverse"] == before["matmul_ntt_inverse"] + 1
    with pytest.raises(ValueError):
        M.matmul_ntt_forward(x.long(), tab)   # not int32 storage


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 4096, 8192, 16384])
def test_cuda_matmul_ntt_all_residues_q_minus_1(n):
    """Every residue q - 1 of 31-bit primes, into the forward and into the
    inverse kernel: the largest bytes in every plane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    L = 3
    tab = ntt_context_for("matmul", n, ntt_primes(n, 31, L)).tables("cuda")
    x = (tab.q - 1).expand(2, L, n).contiguous()
    assert torch.equal(M.matmul_ntt_forward(x, tab),
                       M.matmul_ntt_forward_plain(x, tab))
    assert torch.equal(M.matmul_ntt_inverse(x, tab),
                       M.matmul_ntt_inverse_plain(x, tab))
