"""Invariant-noise budget (host, exact), SEAL's InvariantNoiseBudget.

For w = [c(s)]_q (centered), the invariant noise v satisfies
t*w/q = round + v, and budget = -log2(2*max|v|) bits; decryption is
correct while the budget is positive.  As `cryptonets_tpu/crypto/
noise.py`: vectorized object-int CRT compose on the host.
"""

from __future__ import annotations

import numpy as np


def noise_residues_budget(p, limbs: np.ndarray) -> int:
    """Budget from raw decrypt residues [k, N] (integer numpy)."""
    t, q = p.t, p.q_big
    acc = None
    for r, inv, punct, m in zip(
        limbs.astype(object),
        p.crt_q.inv_punctured,
        p.crt_q.punctured,
        p.crt_q.moduli,
    ):
        term = ((r * inv) % m) * punct
        acc = term if acc is None else acc + term
    w = acc % q
    r = (t * w) % q
    r = np.where(r > q >> 1, q - r, r)
    worst = int(max(r))
    if worst == 0:
        return q.bit_length() - 1
    return max(0, q.bit_length() - 1 - worst.bit_length())


def invariant_noise_budget(bfv, keys, ct) -> int:
    """Budget of one ciphertext [size, k, N] (sharded limbs gathered)."""
    if ct.dim() != 3:
        raise ValueError("pass a single ciphertext [size, k, N]")
    limbs = bfv.gather_limbs(bfv.raw_decrypt_residues(keys, ct)).cpu().numpy()
    return noise_residues_budget(bfv.p, limbs)
