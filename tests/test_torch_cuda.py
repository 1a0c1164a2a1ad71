"""The hand-written CUDA kernels (cryptonets_tpu_torch/kernels/ntt.cu with
its lift loads, modmatmul.cu, matmul_ntt.cu, modmac.cu with the BEHZ
tensor product, and bconv.cu with its BEHZ modes) against their plain
versions, on the card.
Needs a CUDA device: skips without one.  On the card:
`python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda`
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


def _lift_case(n, L, P, S, seed):
    """Tables of a chain of L 31-bit limbs and of P 30-bit plain primes,
    forward-lift rows [P S, n] in [0, 2**31) with a row of 2**31 - 1 and a
    row of zeros, inverse-lift rows [S, n] in (-t, t) with rows of t - 1,
    -(t - 1) and 0 (t the smallest plain prime)."""
    tab = get_ntt_context(n, ntt_primes(n, 31, L)).tables("cuda")
    plain = ntt_primes(n, 30, P)
    ptab = get_ntt_context(n, plain).tables("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, 1 << 31, (P * S, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    x[0], x[-1] = (1 << 31) - 1, 0
    t = min(plain)
    s = torch.randint(-t + 1, t, (S, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    s[0] = t - 1
    if S > 2:
        s[1], s[2] = -(t - 1), 0
    return tab, ptab, x, s


def _check_lifts(tab, ptab, x, s):
    L, P = tab.q.shape[0], ptab.q.shape[0]
    before = dict(K.LAUNCHES)
    y, z = K.ntt_forward_lift(x, tab), K.ntt_inverse_lift(s, ptab)
    assert K.LAUNCHES["ntt_forward_lift"] == before["ntt_forward_lift"] + 1
    assert K.LAUNCHES["ntt_inverse_lift"] == before["ntt_inverse_lift"] + 1
    assert y.shape == (x.shape[0], L, x.shape[1]) and z.shape == (P, *s.shape)
    assert torch.equal(y, K.ntt_forward_lift_plain(x, tab))
    assert torch.equal(z, K.ntt_inverse_lift_plain(s, ptab))
    # the chain through the kernels it replaces: broadcast, K1, Montgomery
    wide = K.ntt_forward(x[:, None, :].expand(y.shape).contiguous(), tab)
    assert torch.equal(y, (wide.long() * tab.rmod.long().view(L, 1)
                           % tab.q.long()).int())


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,P,S", [
    (16384, 13, 3, 128),       # CIFAR's giant chunk: [3, 128, 13, 16384]
    (8192, 7, 4, 64),          # LoLa's Dense(100): [4, 64, 7, 8192]
    (8192, 7, 4, 32),          # LoLa's Dense(10): [4, 32, 7, 8192]
])
def test_cuda_ntt_lift_matches_twins_at_the_paths(n, L, P, S):
    """Both lift loads bit-equal to their twins at the BSGS encode's shapes,
    and the forward to K1 on the broadcast rows times R mod q."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    _check_lifts(*_lift_case(n, L, P, S, n + S))


@pytest.mark.cuda
@pytest.mark.parametrize("logn", range(1, 16))
def test_cuda_ntt_lift_every_ring(logn):
    """Every register width and pass split under the lift loads, from one
    limb to 13 and one source row to five, edge rows included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    L, P, S = (1, 1, 1) if logn % 3 == 0 else (13 if logn > 12 else 3, 3, 5)
    _check_lifts(*_lift_case(1 << logn, L, P, S, logn))


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


def _edge_residues(shape, mods, gen):
    """Residues [..., L, N] of `mods` with every row's first coefficient
    0 and its second q - 1, and the first index of dim 0 at q - 1."""
    q = torch.tensor(mods, dtype=torch.int64, device="cuda").view(-1, 1)
    x = torch.randint(0, 1 << 62, shape, generator=gen, device="cuda") % q
    x[..., 0] = 0
    x[..., 1] = q.view(-1) - 1
    x[0] = q - 1
    return x.to(torch.int32)


def _gather(kind, Z, N, gen):
    """Z gathers of N: NTT-domain automorphisms by 3^b (as the hoisted
    babies gather, int32) or random permutations (int64)."""
    from cryptonets_tpu_torch.crypto.ntt import ntt_automorphism_perm

    if kind == "real":
        return torch.stack([torch.from_numpy(ntt_automorphism_perm(N, pow(3, b, 2 * N)))
                            for b in range(1, Z + 1)]).to("cuda")
    return torch.stack([torch.randperm(N, generator=gen, device="cuda") for _ in range(Z)])


@pytest.mark.cuda
@pytest.mark.parametrize("J,Z,R1,R2,L,N,gather,acc", [
    (1, 1, 1, 1, 1, 2, False, False), (7, 1, 1, 4, 7, 8192, False, False),
    (7, 3, 1, 4, 7, 8192, "random", True), (30, 1, 3, 2, 2, 1024, False, True),
    (64, 1, 3, 2, 13, 16384, False, False), (2, 16, 1, 5, 3, 64, "random", False),
    (7, 16, 1, 4, 7, 8192, "real", True), (1, 1, 1, 3, 7, 4096, "real", True),
    (4, 1, 1, 47, 14, 16384, False, True), (1, 15, 1, 9, 3, 16384, "real", False),
])
def test_cuda_mod_mac_matches_plain(J, Z, R1, R2, L, N, gather, acc):
    """K6 against its twin: one and two keys, strided views (a transposed
    stacked axis, keys broadcast by stride 0), the gather (random, int64,
    or the NTT-domain automorphisms the path gathers by, int32) and the
    accumulator, moduli from 17 to 31 bits, edge residues; the edge
    shapes of the launch plan (N = 4096 and 16384, J = 1, Z = 1, odd row
    counts that leave a row tile part full)."""
    from cryptonets_tpu_torch.crypto.bfv import get_mod_chain
    from cryptonets_tpu_torch.kernels import modmac as K6

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    mods = ntt_primes(64, 31, L - L // 2) + ntt_primes(64, 17, L // 2)
    chain = get_mod_chain(mods, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(J + Z + L)
    a = _edge_residues((R1, J, R2, L, N), mods, gen).transpose(0, 1)
    keys = tuple(_edge_residues((Z, J, 1, L, N), mods, gen).expand(Z, J, R1, L, N)
                 for _ in range(2))
    accs = tuple(_edge_residues((Z, R1, R2, L, N), mods, gen) if acc else None
                 for _ in range(2))
    perm = _gather(gather, Z, N, gen) if gather else None
    for C in (1, 2):
        a6 = a.unsqueeze(2)
        acc6 = tuple(None if x is None else x.unsqueeze(2) for x in accs[:C])
        before = K6.LAUNCHES["mod_mac"]
        out = K6.mod_mac(a, keys[:C], chain, accs[:C], perm)
        assert K6.LAUNCHES["mod_mac"] == before + 1
        ref = K6.mod_mac_plain(a6, keys[:C], chain, acc6, perm).squeeze(2)
        assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("RB,Lf,Lt,N", [(1, 1, 1, 2), (2, 7, 9, 8192),
                                        (48, 3, 14, 16384), (5, 14, 2, 64),
                                        (3, 32, 32, 1024), (3, 1, 1024, 4096),
                                        (7, 13, 2, 16384), (246, 3, 11, 16384)])
def test_cuda_fast_bconv_matches_plain(RB, Lf, Lt, N):
    """K7 against its twin: y over [0, 2**31 - 1) with its edges, a slice of
    the source limbs read in place, a table sliced on its target axis, as
    given and prepared (`BconvTable`), targets from 17 to 31 bits; the
    plan's edges (Lf above the 16 held in registers, 1024 targets in
    chunks, one target, N = 4096 and 16384, 246 rows)."""
    from cryptonets_tpu_torch.crypto.bfv import get_mod_chain
    from cryptonets_tpu_torch.kernels import bconv as K7

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    small = min(Lt // 2, 8)
    mods = ntt_primes(64, 31, Lt - small) + ntt_primes(64, 17, small)
    chain = get_mod_chain(mods, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(Lf * Lt)
    y = _edge_residues((RB, Lf + 2, N), [2**31 - 1] * (Lf + 2), gen)[:, 1:Lf + 1]
    q = torch.tensor(mods, dtype=torch.int64, device="cuda")
    raw = torch.randint(0, 1 << 62, (Lf, Lt + 1, 1), generator=gen, device="cuda")
    raw[:, 1:] %= q.view(1, -1, 1)
    table = raw[:, 1:]                    # a slice on the target axis
    table[0] = (q - 1).view(-1, 1)
    for c in (table, K7.BconvTable.prepare(table, mods)):
        before = K7.LAUNCHES["fast_bconv"]
        out = K7.fast_bconv(y, c, chain)
        assert K7.LAUNCHES["fast_bconv"] == before + 1
        assert torch.equal(out, K7.fast_bconv_plain(y, table, chain))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mod_mac", "fast_bconv"])
def test_cuda_fused_kernels_at_the_largest_values(kind):
    """K6 and K7 where every lazy sum is largest: K6 with every residue,
    key and accumulator at q - 1 over J = 64 terms, gathered and not; K7
    with y at 2**31 - 1 and every table entry at m - 1, the prepared
    table; each against its twin."""
    from cryptonets_tpu_torch.crypto.bfv import get_mod_chain
    from cryptonets_tpu_torch.kernels import bconv as K7
    from cryptonets_tpu_torch.kernels import modmac as K6

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    mods = ntt_primes(4096, 31, 3) + ntt_primes(4096, 17, 1)
    chain = get_mod_chain(mods, "cuda")
    q = torch.tensor(mods, dtype=torch.int32, device="cuda").view(-1, 1)
    if kind == "mod_mac":
        J, R, N = 64, 5, 4096
        row = (q - 1).expand(len(mods), N).contiguous()
        a = row.expand(J, 1, R, len(mods), N).contiguous()
        keys = (row.expand(1, J, 1, len(mods), N),) * 2         # stride 0 over J
        acc = (row.expand(1, 1, R, len(mods), N),) * 2
        for perm in (None, _gather("real", 1, N, None)):
            out = K6.mod_mac(a, keys, chain, acc, perm)
            ref = K6.mod_mac_plain(a.unsqueeze(2), keys, chain,
                                   tuple(x.unsqueeze(2) for x in acc), perm).squeeze(2)
            assert torch.equal(out, ref)
    else:
        Lf, N = 16, 4096
        y = torch.full((3, Lf, N), 2**31 - 1, dtype=torch.int32, device="cuda")
        c = (q.long() - 1).view(1, -1, 1).expand(Lf, -1, 1).contiguous()
        table = K7.BconvTable.prepare(c, mods)
        out = K7.fast_bconv(y, table, chain)
        assert torch.equal(out, K7.fast_bconv_plain(y, c, chain))


@pytest.mark.cuda
def test_cuda_fused_kernels_under_vmap():
    """K6 (the gather and an accumulator batched) and K7 (the merged
    Shenoy-Kumaresan table) under `torch.func.vmap` equal the loop over
    the records, on the card."""
    from cryptonets_tpu_torch.crypto.bfv import BFVParams, get_mod_chain
    from cryptonets_tpu_torch.kernels import bconv as K7
    from cryptonets_tpu_torch.kernels import modmac as K6

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    N, J, R, B = 8192, 7, 4, 5
    mods = ntt_primes(N, 31, 7)
    chain = get_mod_chain(mods, "cuda")
    A = _edge_residues((B, J, R, 7, N), mods, gen)
    C = _edge_residues((B, R, 7, N), mods, gen)
    keys = tuple(_edge_residues((16, J, 1, 7, N), mods, gen) for _ in range(2))
    perm = _gather("real", 16, N, None)

    def mac(a, c):
        return K6.mod_mac(a.reshape(J, 1, R, 7, N), keys, chain,
                          (c[None, None].expand(16, -1, -1, -1, -1), None), perm)

    loop = torch.stack([mac(A[i], C[i]) for i in range(B)])
    assert torch.equal(torch.func.vmap(mac)(A, C), loop)

    p = BFVParams(N, ntt_primes(N, 20, 1)[0], mods, device="cuda")
    Y = _edge_residues((B, 2, len(p.B_list), N), list(p.B_list), gen)

    def conv(y):
        return K7.fast_bconv(y, p.bconv["B_to_q_msk"], p.chain_q_msk)

    assert torch.equal(torch.func.vmap(conv)(Y), torch.stack([conv(y) for y in Y]))


# (data limbs, plain modulus, n): CryptoNets' and LoLa's chain, CIFAR's at
# n = 16384, a 64-bit plain modulus whose Bsk is wider than k + 1, and a
# chain past the 16 source limbs held in registers
BEHZ_RINGS = [(7, "cryptonets", 8192), (13, "cifar", 16384), (7, (1 << 63) - 25, 8192),
              (17, 65537, 1024)]


def _behz_params(k, t, n):
    from cryptonets_tpu_torch.crypto.bfv import BFVParams
    from cryptonets_tpu_torch.models.presets import CONFIGS

    if isinstance(t, str):
        t = CONFIGS[t]["plain_primes"][0]
    return BFVParams(n, t, ntt_primes(n, 31, k), device="cuda")


class _Limbs:
    """A limb shard's block [lo, hi) of k, for the tables only."""

    def __init__(self, lo, hi, k):
        self.lo, self.hi, self.k = lo, hi, k


@pytest.mark.cuda
@pytest.mark.parametrize("k,t,n", BEHZ_RINGS)
@pytest.mark.parametrize("rows", [64, 1])
def test_cuda_behz_modes_match_twins(k, t, n, rows):
    """K7's lift, floor and Shenoy-Kumaresan modes against their twin at
    CryptoNets' chunk of 64 ciphertexts ([64, 2, k, n] in, [64, 3, ...]
    for the floor and SK) and LoLa's one, CIFAR at n = 16384, a wide Bsk
    and a chain read per target (above 16 source limbs), edge residues, on
    one device's tables and on a limb-sharded rank's (limbs [2, 5): the
    lift writes those through, SK targets them); one launch each, counted
    by mode."""
    from cryptonets_tpu_torch.kernels import bconv as K7

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    if n == 16384 and rows == 64:
        rows = 16
    full = _behz_params(k, t, n)
    gen = torch.Generator(device="cuda").manual_seed(k * rows)
    nb = len(full.bsk_list)
    cases = {"lift": _edge_residues((rows, 2, k, n), full.q_list, gen),
             "floor": _edge_residues((rows, 3, k + nb, n), full.chain_qbsk.moduli, gen),
             "sk": _edge_residues((rows, 3, nb, n), full.bsk_list, gen)}
    for p in (full, full.narrow(_Limbs(2, 5, k))):
        for mode, x in cases.items():
            tab = p.bconv[mode]
            name = f"fast_bconv_{mode}"
            before = K7.LAUNCHES[name]
            out = K7.behz(x, tab)
            assert K7.LAUNCHES[name] == before + 1
            assert out.shape[-2] == tab.Lout
            assert torch.equal(out, K7.behz_plain(x, tab)), mode


@pytest.mark.cuda
@pytest.mark.parametrize("R,L,n", [(64, 16, 8192), (1, 16, 8192), (3, 28, 16384),
                                   (5, 3, 64), (1, 1, 2)])
def test_cuda_ct_tensor_matches_twin(R, L, n):
    """The tensor kernel against its twin, two operands (one broadcast over
    the other's rows too) and the square, at CryptoNets' chunk over q +
    Bsk, LoLa's one ciphertext, CIFAR's 28 limbs at n = 16384 and small
    rings; every residue q - 1 too."""
    from cryptonets_tpu_torch.crypto.bfv import get_mod_chain
    from cryptonets_tpu_torch.kernels import modmac as K6

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    mods = ntt_primes(max(n, 64), 31, L)
    chain = get_mod_chain(mods, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(R + L)
    x = _edge_residues((R, 2, L, n), mods, gen)
    y = _edge_residues((R, 2, L, n), mods, gen)
    top = (chain.q - 1).to(torch.int32).expand(R, 2, L, n)
    for a, b in ((x, y), (x, None), (top, top), (top, None), (x, y[:1])):
        before = K6.LAUNCHES["ct_tensor"]
        out = K6.ct_tensor(a, b, chain)
        assert K6.LAUNCHES["ct_tensor"] == before + 1
        assert torch.equal(out, K6.ct_tensor_plain(a, b, chain))


@pytest.mark.cuda
def test_cuda_behz_square_under_vmap():
    """`square` and `multiply` on the card: the square equals the product
    of a with a copy of itself and the CPU's twins' product, in six
    launches (lift, K1, tensor, K2, floor, SK); under `torch.func.vmap` the
    modes and the tensor product equal the loop over the records."""
    from cryptonets_tpu_torch.crypto.bfv import BFV, BFVParams
    from cryptonets_tpu_torch.kernels import bconv as K7
    from cryptonets_tpu_torch.kernels import modmac as K6

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    k, n, B = 7, 8192, 3
    p = _behz_params(k, "cryptonets", n)
    cpu = BFVParams(n, p.t, p.q_list, device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(4)
    a = _edge_residues((B, 2, 2, k, n), p.q_list, gen)
    bfv = BFV(p)
    before = {**K7.LAUNCHES, **K6.LAUNCHES, **K.LAUNCHES}
    sq = bfv.square(a[0])
    after = {**K7.LAUNCHES, **K6.LAUNCHES, **K.LAUNCHES}
    delta = {key: after[key] - before[key] for key in after if after[key] != before[key]}
    assert delta == {"fast_bconv_lift": 1, "ntt_forward": 1, "ct_tensor": 1,
                     "ntt_inverse": 1, "fast_bconv_floor": 1, "fast_bconv_sk": 1}, delta
    assert torch.equal(sq, bfv.multiply(a[0], a[0].clone()))
    assert torch.equal(sq.cpu(), BFV(cpu).square(a[0].cpu()))
    vm = torch.func.vmap
    assert torch.equal(vm(bfv.square)(a), torch.stack([bfv.square(x) for x in a]))
    lift = p.bconv["lift"]
    lifted = vm(lambda x: K7.behz(x, lift))(a)
    assert torch.equal(lifted, torch.stack([K7.behz(x, lift) for x in a]))
    xh = vm(p.ntt_qbsk.forward)(lifted)
    assert torch.equal(vm(lambda x: K6.ct_tensor(x, None, p.chain_qbsk))(xh),
                       torch.stack([K6.ct_tensor(x, None, p.chain_qbsk) for x in xh]))
