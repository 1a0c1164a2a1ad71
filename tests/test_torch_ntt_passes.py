"""The pass plan of the Hopper NTT kernels (cryptonets_tpu_torch/kernels/
ntt.cu), replayed in numpy on the CPU: the windows and spans of `Plan`,
the element indices `coeff_index`, the twiddle indices of
`load_twiddles`, the padded shared-memory word `smem_word` and the Shoup
butterflies, written as the same formulas.  The replay is held bit-equal to the plain twins
(`ntt_forward_plain` / `ntt_inverse_plain`) for every ring from n = 2 to
16384 and every register width, and to the reference `NTTContext` at a
few rings; the exchanges are checked to be permutations that give the 32
lanes of a warp 32 distinct banks.  The kernel itself needs the card:
tests/test_torch_cuda.py and chip_smoke.py hold it against the twins."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu.crypto import ntt as jntt  # noqa: E402
from cryptonets_tpu_torch.crypto import ntt as tntt  # noqa: E402
from cryptonets_tpu_torch.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.kernels import ntt as K  # noqa: E402

M32 = (1 << 32) - 1


def kernel_log_e(logn):
    """`Plan<LOGN>::R`: log2 of the coefficients a thread holds."""
    return logn if logn <= 4 else (5 if logn == 15 else 4)


def windows(logn, R, inverse):
    """`Window`: (lo, hi, span) of each pass in the order the direction
    runs them: bits [lo, hi), the thread's span [span, span + R).  The
    inverse cuts them from the bottom, the forward from the top."""
    out = []
    for k in range(-(-logn // R)):
        if inverse:
            lo, hi = k * R, min(logn, (k + 1) * R)
        else:
            lo, hi = logn - min(logn, (k + 1) * R), logn - k * R
        out.append((lo, hi, min(lo, logn - R)))
    return out


def coeff_index(R, c, tid, e):
    return ((tid >> c) << (c + R)) | (e << c) | (tid & ((1 << c) - 1))


def smem_word(i, R, c0, c1):
    """Padded shared-memory word of coefficient i in the exchange from span
    c0 to span c1."""
    return i + (i >> R) if 0 in (c0, c1) else i + ((i >> 5) << (5 - R))


def umin_wrap(r, q_signed):
    """min(r, r + q_signed) as unsigned 32-bit words (ntt.cu's reductions)."""
    return np.minimum(r, (r + q_signed) & M32)


def mul_shoup(x, w, w_sh, q):
    hi = (x * w_sh) >> 32
    r = (x * w - hi * q) & M32
    return umin_wrap(r, -q)


def replay(x, q, tw, tw_sh, R, inverse, ninv=None, ninv_sh=None, load=None):
    """The kernel's transform of rows x [rows, n] (uint64 holding uint32),
    q [rows, 1] and tables tw, tw_sh [rows, n] of each row's limb;
    `load(a, q)` the lift load's step on the loaded words [rows, T, E]."""
    rows, n = x.shape
    logn = n.bit_length() - 1
    E, T = 1 << R, n >> R
    tid = np.arange(T)[:, None]
    e_all = np.arange(E)[None, :]
    order = windows(logn, R, inverse)
    a = None
    prev_c = None
    for lo, hi, c in order:
        idx = coeff_index(R, c, tid, e_all)                       # [T, E]
        if a is None:
            a = x[:, idx]                                          # the load
            if load is not None:
                a = load(a, q[:, :, None])
        else:
            # base + constant: the word of the thread's base plus the word
            # of the coefficient's part, as the kernel addresses it
            put = (smem_word(coeff_index(R, prev_c, tid, 0), R, prev_c, c)
                   + smem_word(e_all << prev_c, R, prev_c, c))
            assert np.array_equal(
                put, smem_word(coeff_index(R, prev_c, tid, e_all), R, prev_c, c))
            assert len(np.unique(put)) == n
            get = (smem_word(coeff_index(R, c, tid, 0), R, prev_c, c)
                   + smem_word(e_all << c, R, prev_c, c))
            words = int(max(put.max(), get.max())) + 1
            if R == kernel_log_e(logn):          # `Plan::BUFFER`
                assert words <= n + (n >> 4)
            smem = np.full((rows, words), -1, dtype=np.int64)
            smem[:, put] = a
            a = smem[:, get].astype(np.uint64)
            assert (a != np.uint64(2**64 - 1)).all()
        bits = range(lo, hi) if inverse else range(hi - 1, lo - 1, -1)
        for b in bits:
            lb = b - c
            base = (1 << (logn - 1 - b)) + ((tid[:, 0] >> c) << (c + R - 1 - b))
            # the kernel loads a stage's twiddles as aligned vectors
            assert np.all(base % (E >> (lb + 1)) == 0)
            for g in range(E >> (lb + 1)):
                t_idx = base + g                                   # [T]
                w, w_sh = tw[:, t_idx], tw_sh[:, t_idx]            # [rows, T]
                for l in range(1 << lb):
                    e0 = (g << (lb + 1)) | l
                    e1 = e0 | (1 << lb)
                    u, v = a[:, :, e0], a[:, :, e1]
                    if inverse:
                        d = umin_wrap((u - v) & M32, q)
                        a[:, :, e0] = umin_wrap(u + v, -q)
                        a[:, :, e1] = mul_shoup(d, w, w_sh, q)
                    else:
                        t = mul_shoup(v, w, w_sh, q)
                        a[:, :, e1] = umin_wrap((u - t) & M32, q)
                        a[:, :, e0] = umin_wrap(u + t, -q)
        prev_c = c
    if inverse:
        a = mul_shoup(a, ninv[:, :, None], ninv_sh[:, :, None], q[:, :, None])
    y = np.empty_like(x)
    y[:, coeff_index(R, prev_c, tid, e_all)] = a                   # the store
    return y


def _u(t):
    return t.numpy().view(np.uint32).astype(np.uint64)


def _replay_both(x, mods, R):
    """x [B, L, n] uint32 -> (forward, inverse of the forward) by replay."""
    B, L, n = x.shape
    tab = tntt.get_ntt_context(n, tuple(mods)).tables("cpu")
    limb = np.arange(B * L) % L
    q = np.array(mods, dtype=np.uint64)[limb][:, None]
    rows = x.reshape(B * L, n).astype(np.uint64)
    f = replay(rows, q, _u(tab.psi)[limb], _u(tab.psi_sh)[limb], R, False)
    i = replay(f, q, _u(tab.ipsi)[limb], _u(tab.ipsi_sh)[limb], R, True,
               _u(tab.ninv)[limb][:, None], _u(tab.ninv_sh)[limb][:, None])
    return (f.reshape(B, L, n).astype(np.uint32),
            i.reshape(B, L, n).astype(np.uint32), tab)


def _inputs(n, mods, seed):
    """Random residues with an all-(q - 1) and an all-zero row."""
    rng = np.random.default_rng(seed)
    q = np.array(mods, dtype=np.int64)[:, None]
    x = rng.integers(0, 1 << 31, (3, len(mods), n)) % q
    x[1] = q - 1
    x[2] = 0
    return x.astype(np.uint32)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("logn", range(1, 15))
def test_replay_bit_equal_to_plain_twins(logn):
    """Every register width up to the kernel's, on a chain of 31-bit
    primes and on a plain prime."""
    n = 1 << logn
    widths = sorted({kernel_log_e(logn), *range(1, min(logn, 5) + 1)})
    for mods in (ntt_primes(n, 31, 2), (65537,)):
        x = _inputs(n, mods, logn)
        tab = tntt.get_ntt_context(n, tuple(mods)).tables("cpu")
        want_f = K.ntt_forward_plain(_i32(x), tab).numpy().view(np.uint32)
        for R in widths:
            f, i, _ = _replay_both(x, mods, R)
            np.testing.assert_array_equal(f, want_f, err_msg=f"R={R} {mods}")
            want_i = K.ntt_inverse_plain(_i32(f), tab).numpy().view(np.uint32)
            np.testing.assert_array_equal(i, want_i, err_msg=f"R={R} {mods}")
            np.testing.assert_array_equal(i, x)


@pytest.mark.parametrize("n", [16, 1024, 8192])
def test_replay_bit_equal_to_reference(n):
    mods = ntt_primes(n, 31, 2)
    x = _inputs(n, mods, 7)[:1]
    f, i, _ = _replay_both(x, mods, kernel_log_e(n.bit_length() - 1))
    ref = jntt.get_ntt_context(n, tuple(mods))
    np.testing.assert_array_equal(f, np.asarray(ref.forward(x)))
    np.testing.assert_array_equal(i, np.asarray(ref.inverse(f)))


@pytest.mark.parametrize("logn", range(9, 16))
def test_exchanges_are_bank_conflict_free(logn):
    """On both sides of every exchange, for each of a thread's
    coefficients, the 32 lanes of a warp touch 32 distinct banks."""
    n, R = 1 << logn, kernel_log_e(logn)
    T = n >> R
    tid = np.arange(T).reshape(T // 32, 32)
    for inverse in (False, True):
        spans = [c for _, _, c in windows(logn, R, inverse)]
        for c0, c1 in zip(spans, spans[1:]):
            for c in (c0, c1):
                for e in range(1 << R):
                    banks = smem_word(coeff_index(R, c, tid, e), R, c0, c1) % 32
                    assert all(len(set(w)) == 32 for w in banks), (
                        logn, inverse, c0, c1, c, e)


def test_plan_fits_the_card():
    """From n = 4096 up a thread holds at least 8 coefficients and a row
    takes at most ceil(logn / R) - 1 exchanges; a block has at most 1024
    threads and fits in 227 KB of shared memory; the rule is the one in
    ntt.cu."""
    src = K._SRC.read_text()
    assert ("static constexpr int R = LOGN <= 4 ? LOGN : "
            "(LOGN == 15 ? 5 : 4);") in src
    for logn in range(1, K.MAX_LOGN + 1):
        R = kernel_log_e(logn)
        passes = len(windows(logn, R, True))
        assert passes == len(windows(logn, R, False))
        assert passes == -(-logn // R)
        assert 1 << (logn - R) <= 1024
        smem = 0 if passes == 1 else (2 if logn <= 14 else 1) * 4 * (
            (1 << logn) + (1 << logn >> 4))
        assert smem <= 227 * 1024
        if logn >= 12:
            assert 1 << R >= 8


@pytest.mark.parametrize("logn", [1, 2, 5, 9, 13, 14])
def test_replay_of_the_lift_loads_bit_equal_to_their_twins(logn):
    """The lift load (`ntt.cu`, `LIFT`): the forward's block b reads source
    row b // L on limb b % L and scales each word by R mod q (Shoup) before
    the first butterfly; the inverse's block b reads source row b // L on
    limb b % L, adds q to a negative word (min(a, a + q) on 32-bit words)
    and stores output row (b % L) S + b // L.  Replayed over every block,
    the forward on values up to 2**31 - 1, the inverse on +-(t - 1)."""
    n = 1 << logn
    R = kernel_log_e(logn)
    S, mods, plain = 5, ntt_primes(n, 31, 3), ntt_primes(n, 24, 2)
    rng = np.random.default_rng(logn)

    tab = tntt.get_ntt_context(n, tuple(mods)).tables("cpu")
    L = len(mods)
    src = rng.integers(0, 1 << 31, (S, n)).astype(np.uint32)
    src[0, 0] = (1 << 31) - 1
    b = np.arange(S * L)
    limb, row = b % L, b // L
    q = np.array(mods, dtype=np.uint64)[limb][:, None]
    rm, rm_sh = _u(tab.rmod)[limb][:, None, None], _u(tab.rmod_sh)[limb][:, None, None]
    f = replay(src[row].astype(np.uint64), q, _u(tab.psi)[limb], _u(tab.psi_sh)[limb],
               R, False, load=lambda a, q: mul_shoup(a, rm, rm_sh, q))
    want = K.ntt_forward_lift_plain(_i32(src), tab).numpy().view(np.uint32)
    np.testing.assert_array_equal(f.astype(np.uint32).reshape(S, L, n), want)

    tab = tntt.get_ntt_context(n, tuple(plain)).tables("cpu")
    L, t = len(plain), min(plain)
    signed = rng.integers(-t + 1, t, (S, n)).astype(np.int32)
    signed[0, 0], signed[-1, -1] = t - 1, -(t - 1)
    b = np.arange(S * L)
    limb, row = b % L, b // L
    q = np.array(plain, dtype=np.uint64)[limb][:, None]
    i = replay(signed.view(np.uint32)[row].astype(np.uint64), q, _u(tab.ipsi)[limb],
               _u(tab.ipsi_sh)[limb], R, True, _u(tab.ninv)[limb][:, None],
               _u(tab.ninv_sh)[limb][:, None], load=lambda a, q: umin_wrap(a, q))
    out = np.empty((L * S, n), np.uint32)
    out[limb * S + row] = i
    want = K.ntt_inverse_lift_plain(_i32(signed), tab).numpy().view(np.uint32)
    np.testing.assert_array_equal(out.reshape(L, S, n), want)
