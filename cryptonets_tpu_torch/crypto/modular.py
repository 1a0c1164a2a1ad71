"""Exact modular arithmetic on residue tensors.

Every modulus is an odd prime below 2**31, so a canonical residue fits a
non-negative int32 bit for bit: int32 is the storage type of every
residue tensor in the port (`RES`).  Each primitive widens its operands
to int64, evaluates an exact formula there, and returns the canonical
residue in [0, q) as int32.  A canonical result is unique, so each
primitive is bit-equal to its counterpart in `cryptonets_tpu/crypto/
modular.py`, whose 16x16-bit partial products exist only because the TPU
has no 32x32->64 multiply.

Moduli are passed as Python ints or as integer tensors that broadcast
against the operands (a `[L, 1]` column for `[..., L, N]` residues).
"""

from __future__ import annotations

import numpy as np
import torch

from .hostmath import modinv

RES = torch.int32
R_MONT = 1 << 32


def wide(x):
    """int64 view of a residue tensor (no copy when already int64)."""
    return x if x.dtype == torch.int64 else x.to(torch.int64)


def as_res(x):
    """Canonical residues -> int32 storage."""
    return x if x.dtype == RES else x.to(RES)


def add_mod(a, b, q):
    """(a + b) mod q for a, b in [0, q)."""
    return as_res((wide(a) + b) % q)


def sub_mod(a, b, q):
    """(a - b) mod q for a, b in [0, q)."""
    return as_res((wide(a) - b) % q)


def neg_mod(a, q):
    """(-a) mod q for a in [0, q)."""
    return as_res((-wide(a)) % q)


def mul_const_mod(x, w, q):
    """x * w mod q for a constant w in [0, q).

    Exact for ANY x in [0, 2**32), not only x < q: the product stays
    below 2**63.  (The reference's Shoup form takes the same inputs; the
    CUDA kernels use Shoup with host companions, see `crypto/ntt.py`
    `_shoup_np`.)"""
    return as_res(wide(x) * w % q)


def mont_precompute_host(q: int) -> dict:
    """Host: Montgomery constants for modulus q with R = 2**32."""
    return {"r_mod": R_MONT % q, "r_inv": modinv(R_MONT % q, q)}


def mont_table(moduli, device) -> torch.Tensor:
    """int32 [L, 4] (uint32 bits) a modulus: q, -q^-1 mod 2**32, R**2 mod
    q, 0 — what the CUDA kernels' Montgomery reduction (`kernels/
    montgomery.cuh`) reads.  Raises for a modulus that is even or not
    below 2**31."""
    rows = []
    for q in (int(m) for m in moduli):
        if not 2 < q < 1 << 31 or q % 2 == 0:
            raise ValueError(f"the fused kernels need odd moduli below 2**31: {q}")
        rows.append([q, -modinv(q, R_MONT) % R_MONT, R_MONT * R_MONT % q, 0])
    table = np.array(rows, np.uint32).reshape(-1, 4).view(np.int32)
    return torch.from_numpy(table).to(device)


def mont_mul(a, b, q, r_inv):
    """a * b * R^-1 mod q (R = 2**32), the reference's REDC."""
    return as_res(wide(a) * b % q * r_inv % q)


def to_mont(x, q, r_mod):
    """x -> x * R mod q."""
    return mul_const_mod(x, r_mod, q)


def mul_mod(a, b, q):
    """General a * b mod q for data-dependent a, b in [0, q)."""
    return as_res(wide(a) * b % q)


def mod_sum(x, q, dim):
    """Sum over `dim` of entries in [0, q), reduced mod q.  The int64 sum
    is exact for up to 2**32 terms; `q` broadcasts against the result."""
    return as_res(wide(x).sum(dim=dim) % q)
