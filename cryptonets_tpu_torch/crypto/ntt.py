"""Negacyclic NTT contexts over int32 RNS limb tensors.

`NTTContext`: Longa-Naehrig merged-psi butterflies, as in
`cryptonets_tpu/crypto/ntt.py`: the forward transform takes standard
order to bit-reversed, the inverse takes bit-reversed back to standard.
`MatmulNTTContext`: the four-step transform of
`cryptonets_tpu/kernels/matmul_ntt.py`, in an evaluation ordering of its
own.  A context holds the host tables of one (ring degree, modulus chain)
pair and places them on each device at first use; `forward` / `inverse`
dispatch to the hand-written CUDA kernels for CUDA tensors and to their
plain versions for CPU tensors (`kernels/ntt.py`, `kernels/
matmul_ntt.py`).  `ntt_context_for` picks the class by name.  The
butterfly context also serves the plain-modulus (Z_t) encoder transforms
under either choice: the slot index map is tied to its ordering.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..kernels.matmul_ntt import (
    host_tables as matmul_host_tables,
    matmul_ntt_forward,
    matmul_ntt_inverse,
)
from ..kernels.ntt import (NTTTables, ntt_forward, ntt_forward_lift,
                           ntt_inverse, ntt_inverse_lift)
from .hostmath import bit_reverse, modinv
from .modular import R_MONT, RES
from .primes import min_primitive_2n_root


@lru_cache(maxsize=None)
def _tables_one(n: int, q: int):
    """Host: (psi_brev, ipsi_brev, n_inv) power tables for one modulus."""
    logn = n.bit_length() - 1
    psi = min_primitive_2n_root(q, n)
    ipsi = modinv(psi, q)
    pow_f = np.empty(n, dtype=np.uint64)
    pow_i = np.empty(n, dtype=np.uint64)
    cf = ci = 1
    for i in range(n):
        pow_f[i] = cf
        pow_i[i] = ci
        cf = cf * psi % q
        ci = ci * ipsi % q
    rev = np.array([bit_reverse(i, logn) for i in range(n)])
    return pow_f[rev], pow_i[rev], modinv(n, q)


def _shoup_np(w, q: int) -> np.ndarray:
    """Shoup companions floor(w * 2**32 / q) of constants 0 <= w < q as
    uint32: the only place the port computes them."""
    w = np.asarray(w, dtype=np.uint64)
    if not 0 < q < (1 << 31) or (w.size and int(w.max()) >= q):
        raise ValueError(f"Shoup constant out of range for q={q}")
    return np.asarray((w.astype(object) << 32) // q).astype(np.uint64).astype(np.uint32)


@lru_cache(maxsize=None)
def ntt_automorphism_perm(n: int, g: int) -> np.ndarray:
    """NTT-domain index permutation realizing a(x) -> a(x^g):
    NTT(sigma_g(x))[j] = NTT(x)[perm[j]], where position j holds the
    evaluation at psi^(2*brv(j)+1).  The hoisting primitive of the BSGS
    baby steps (`api/bsgs.py`)."""
    logn = n.bit_length() - 1
    j = np.arange(n)
    brv = np.array([bit_reverse(int(i), logn) for i in range(n)])
    e = 2 * brv + 1
    target = (e * g) % (2 * n)
    pos_of_e = np.empty(2 * n, np.int64)
    pos_of_e[e] = j
    return pos_of_e[target].astype(np.int32)


def _placed(ctx, device):
    """The host tables of `ctx` copied to `device`, once per device."""
    device = torch.device(device)
    if device not in ctx._on_device:
        h = ctx._host
        ctx._on_device[device] = type(h)(
            *(getattr(h, f).to(device) for f in h.__dataclass_fields__))
    return ctx._on_device[device]


def _i32(a: np.ndarray) -> torch.Tensor:
    """uint32 host table -> int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


class NTTContext:
    """Twiddle tables for a (ring degree, modulus chain) pair, stacked over
    the limb axis so one launch covers every limb of a [..., L, N] tensor."""

    ordering = "bit-reversed"

    def __init__(self, n: int, moduli: tuple[int, ...]):
        if n & (n - 1):
            raise ValueError("ring degree must be a power of two")
        self.n = n
        self.logn = n.bit_length() - 1
        self.moduli = tuple(int(q) for q in moduli)
        L = len(self.moduli)
        psi = np.empty((L, n), np.uint32)
        psi_sh = np.empty((L, n), np.uint32)
        ipsi = np.empty((L, n), np.uint32)
        ipsi_sh = np.empty((L, n), np.uint32)
        ninv = np.empty(L, np.uint32)
        ninv_sh = np.empty(L, np.uint32)
        rmod = np.array([R_MONT % q for q in self.moduli], np.uint32)
        for i, q in enumerate(self.moduli):
            f, inv, n_inv = _tables_one(n, q)
            psi[i] = f.astype(np.uint32)
            psi_sh[i] = _shoup_np(f, q)
            ipsi[i] = inv.astype(np.uint32)
            ipsi_sh[i] = _shoup_np(inv, q)
            ninv[i] = n_inv
            ninv_sh[i] = _shoup_np(n_inv, q)
        self._host = NTTTables(
            q=_i32(np.array(self.moduli, np.uint32).reshape(L, 1)),
            psi=_i32(psi), psi_sh=_i32(psi_sh),
            ipsi=_i32(ipsi), ipsi_sh=_i32(ipsi_sh),
            ninv=_i32(ninv), ninv_sh=_i32(ninv_sh),
            rmod=_i32(rmod),
            rmod_sh=_i32([_shoup_np(r, q) for r, q in zip(rmod, self.moduli)]),
        )
        self._on_device: dict = {}

    def tables(self, device) -> NTTTables:
        """The tables placed on `device` (copied once per device)."""
        return _placed(self, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NTT along the last axis of residues [..., L, N] -> int32."""
        x = x.to(RES).contiguous()
        return ntt_forward(x, self.tables(x.device))

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(RES).contiguous()
        return ntt_inverse(x, self.tables(x.device))

    def forward_lift(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficient rows x [S, N] in [0, 2**31), the same under every
        limb -> [S, L, N]: their NTT under each limb in Montgomery form
        (`ModChain.to_mont(forward(broadcast x))`), in one launch."""
        return ntt_forward_lift(x, self.tables(x.device))

    def inverse_lift(self, x: torch.Tensor) -> torch.Tensor:
        """Signed rows x [S, N], |x| below every limb -> [L, S, N]: the
        inverse NTT of x mod each limb, in one launch."""
        return ntt_inverse_lift(x, self.tables(x.device))


class MatmulNTTContext:
    """The four-step NTT with `NTTContext`'s interface.  Forward and
    inverse are consistent with each other and multiply polynomials
    correctly, but the order of the evaluation points is not the
    butterfly's: NTT-domain keys and gather tables belong to one
    ordering, so a factory uses one context class for its lifetime."""

    ordering = "four-step"

    def __init__(self, n: int, moduli: tuple[int, ...]):
        self.n = n
        self.moduli = tuple(int(q) for q in moduli)
        self._host = matmul_host_tables(n, self.moduli)
        self._on_device: dict = {}

    def tables(self, device):
        """The tables placed on `device` (copied once per device)."""
        return _placed(self, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NTT along the last axis of residues [..., L, N] -> int32."""
        x = x.to(RES).contiguous()
        return matmul_ntt_forward(x, self.tables(x.device))

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(RES).contiguous()
        return matmul_ntt_inverse(x, self.tables(x.device))


_CONTEXT_CACHE: dict = {}
NTT_IMPLS = {"butterfly": NTTContext, "matmul": MatmulNTTContext}


def ntt_context_for(ntt_impl: str, n: int, moduli):
    """The interned context of `ntt_impl` for (n, chain): "butterfly"
    (`NTTContext`) or "matmul" (`MatmulNTTContext`).  The reference's
    "pallas" and "hybrid" name TPU dispatch choices of the butterfly
    transform; the port has one butterfly kernel and rejects both names
    rather than alias them."""
    if ntt_impl not in NTT_IMPLS:
        raise ValueError(
            f"ntt_impl {ntt_impl!r} is not one of {sorted(NTT_IMPLS)}")
    key = (ntt_impl, n, tuple(int(m) for m in moduli))
    if key not in _CONTEXT_CACHE:
        _CONTEXT_CACHE[key] = NTT_IMPLS[ntt_impl](n, key[2])
    return _CONTEXT_CACHE[key]


def get_ntt_context(n: int, moduli) -> NTTContext:
    """The interned butterfly context of (n, chain)."""
    return ntt_context_for("butterfly", n, moduli)
