"""Invariant-noise budget (host, exact), SEAL's InvariantNoiseBudget.

For w = [c(s)]_q (centered), the invariant noise v satisfies
t*w/q = round + v, and budget = -log2(2*max|v|) bits; decryption is
correct while the budget is positive.  As `cryptonets_tpu/crypto/
noise.py`: vectorized object-int CRT compose on the host.

`coefficient_noise` gives the same noise coefficient by coefficient,
beside the decrypted coefficient, so a run can tell which coefficient of
which plain prime crossed the threshold.
"""

from __future__ import annotations

import numpy as np


def _compose(p, limbs: np.ndarray):
    """Raw decrypt residues [k, N] -> w = [c(s)]_q in [0, q) as object
    ints [N] (the exact CRT composition)."""
    acc = None
    for r, inv, punct, m in zip(
        limbs.astype(object),
        p.crt_q.inv_punctured,
        p.crt_q.punctured,
        p.crt_q.moduli,
    ):
        term = ((r * inv) % m) * punct
        acc = term if acc is None else acc + term
    return acc % p.q_big


def noise_residues_budget(p, limbs: np.ndarray) -> int:
    """Budget from raw decrypt residues [k, N] (integer numpy)."""
    t, q = p.t, p.q_big
    w = _compose(p, limbs)
    r = (t * w) % q
    r = np.where(r > q >> 1, q - r, r)
    worst = int(max(r))
    if worst == 0:
        return q.bit_length() - 1
    return max(0, q.bit_length() - 1 - worst.bit_length())


def centered_phase(p, limbs: np.ndarray) -> np.ndarray:
    """Raw decrypt residues [k, N] -> the phase w = [c(s)]_q centered in
    (-q/2, q/2], object ints [N]."""
    q = p.q_big
    w = _compose(p, limbs)
    return np.where(w > q >> 1, w - q, w)


def coefficient_noise(p, limbs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(d, m) of raw decrypt residues [k, N], object ints [N] each: m =
    round(t w / q) mod t, the decrypted coefficient, and d = t w - q
    round(t w / q) for the centered w, the invariant noise times q
    (|d| <= q / 2).  Against the true coefficient m* the noise is
    d + q (m - m*) (m - m* taken centered mod t); decryption is right
    while that stays below q / 2 in size, and `noise_residues_budget` is
    floor(log2(q / 2) - log2(max |d|)) over the coefficients."""
    t, q = p.t, p.q_big
    w = centered_phase(p, limbs)
    r = (2 * t * w + q) // (2 * q)
    return t * w - q * r, r % t


def invariant_noise_budget(bfv, keys, ct) -> int:
    """Budget of one ciphertext [size, k, N] (sharded limbs gathered)."""
    if ct.dim() != 3:
        raise ValueError("pass a single ciphertext [size, k, N]")
    limbs = bfv.gather_limbs(bfv.raw_decrypt_residues(keys, ct)).cpu().numpy()
    return noise_residues_budget(bfv.p, limbs)
