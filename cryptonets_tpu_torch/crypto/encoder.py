"""Batch encoder: Z_t^n SIMD slots <-> plaintext polynomial (host, numpy).

SEAL's slot layout, as in `cryptonets_tpu/crypto/encoder.py`: a 2 x (n/2)
matrix whose rows rotate under the Galois element 3^steps and swap under
2n - 1.  Encoding runs on the host as a length-n inverse negacyclic NTT
over Z_t, decoding as the forward NTT.  For t < 2**31 the NTT runs in
numpy uint64 (exact: products < 2**62); for the plain moduli of 2**31 and
above (LoLaDense's ~2**35, CryptoNets' ~2**39) in the C++ host runtime
(`runtime/hostcrypto.cpp`, 128-bit products), whose plain twin is the
same NTT over exact object integers (`_ntt_host` / `_intt_host` on object
arrays, for the tests).  A factory whose plain primes fit the device
encodes and decodes its records on the device instead, with the same
ordering, through `index_map` and the CUDA NTT over Z_t.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .hostmath import bit_reverse, modinv
from .primes import min_primitive_2n_root

BIG_T = 1 << 31   # from here on the host runtime's 128-bit NTT


@lru_cache(maxsize=None)
def _host_tables(n: int, t: int):
    """psi and inverse-psi power tables (bit-reversed, exact object
    ints), n^-1 and the slot index map for modulus t."""
    logn = n.bit_length() - 1
    psi = min_primitive_2n_root(t, n)
    ipsi = modinv(psi, t)
    pf = np.empty(n, dtype=object)
    pi = np.empty(n, dtype=object)
    cf = ci = 1
    for i in range(n):
        pf[i] = cf
        pi[i] = ci
        cf = cf * psi % t
        ci = ci * ipsi % t
    rev = np.array([bit_reverse(i, logn) for i in range(n)])
    # SEAL matrix_reps_index_map: slot i of row r -> coefficient position
    m = 2 * n
    row = n // 2
    pos = 1
    index_map = np.empty(n, np.int64)
    for i in range(row):
        index_map[i] = bit_reverse((pos - 1) >> 1, logn)
        index_map[i + row] = bit_reverse((m - pos - 1) >> 1, logn)
        pos = pos * 3 % m
    return pf[rev], pi[rev], modinv(n, t), index_map


def _ntt_host(x, table, t):
    """Forward negacyclic NTT (standard in, bit-reversed out) along the
    last axis; dtype uint64 (t < 2**31) or object (exact big ints)."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    for s in range(logn):
        mblk = 1 << s
        half = n >> (s + 1)
        v = x.reshape(*x.shape[:-1], mblk, 2, half)
        u, w = v[..., 0, :], v[..., 1, :]
        tw = table[mblk : 2 * mblk].reshape(mblk, 1)
        wv = (w * tw) % t
        v2 = np.stack([(u + wv) % t, (u + t - wv) % t], axis=-2)
        x = v2.reshape(*x.shape)
    return x


def _intt_host(x, table, n_inv, t):
    """Inverse (bit-reversed in, standard out), times n^-1."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    for s in range(logn):
        hblk = n >> (s + 1)
        half = n // (2 * hblk)
        v = x.reshape(*x.shape[:-1], hblk, 2, half)
        u, w = v[..., 0, :], v[..., 1, :]
        tw = table[hblk : 2 * hblk].reshape(hblk, 1)
        v2 = np.stack([(u + w) % t, (((u + t - w) % t) * tw) % t], axis=-2)
        x = v2.reshape(*x.shape)
    n_inv = n_inv if x.dtype == object else np.uint64(n_inv)
    return (x * n_inv) % t


class BatchEncoder:
    """values[0:n/2] = row 0, values[n/2:n] = row 1 (SEAL slot order).

    Plain moduli up to 2**63; from 2**31 on the NTTs run in the host
    runtime (`runtime/hostcrypto.py`)."""

    def __init__(self, n: int, t: int):
        if (t - 1) % (2 * n) != 0:
            raise ValueError(
                f"plain modulus {t} does not support batching for n={n}"
            )
        if t >= 1 << 63:
            raise ValueError(f"plain modulus {t} must be below 2**63")
        self.n, self.t = n, t
        pf, pi, self.n_inv, self.index_map = _host_tables(n, t)
        self._small = t < BIG_T
        # uint64 tables for numpy's NTT (t < 2**31) or the host runtime's
        self.pf = pf.astype(np.uint64)
        self.pi = pi.astype(np.uint64)

    def _slot_buffer(self, values) -> np.ndarray:
        """values [..., <= n] (ints mod t) -> index-mapped uint64 [..., n]."""
        v = np.asarray(values)
        if v.dtype == object:
            try:   # ints that fit int64 convert without a Python call each
                v = v.astype(np.int64)
            except OverflowError:   # the others reduce as Python ints
                v = (v % self.t).astype(np.int64)
        v = (v.astype(np.int64) % self.t).astype(np.uint64)
        buf = np.zeros(v.shape[:-1] + (self.n,), np.uint64)
        buf[..., self.index_map[: v.shape[-1]]] = v
        return buf

    def encode(self, values) -> np.ndarray:
        """values (ints, signed ok, [..., <= n]) -> poly coeffs in [0, t):
        int64 for t < 2**31, uint64 above.  Integer arrays need no object
        arithmetic at any t (the reference's `encode_int_big`)."""
        buf = self._slot_buffer(values)
        if self._small:
            return _intt_host(buf, self.pi, self.n_inv, self.t).astype(np.int64)
        from ..runtime import hostcrypto

        return hostcrypto.ntt_inverse(buf, self.pi, self.n_inv, self.t)

    def decode(self, coeffs) -> np.ndarray:
        """poly coeffs [..., n] -> slot values in [0, t): int64 for
        t < 2**62, object ints above."""
        c = np.asarray(coeffs)
        c = (c % self.t if c.dtype == object
             else c.astype(np.int64) % self.t).astype(np.uint64)
        if self._small:
            evals = _ntt_host(c, self.pf, self.t)
        else:
            from ..runtime import hostcrypto

            evals = hostcrypto.ntt_forward(c, self.pf, self.t)
        slots = evals[..., self.index_map]
        return slots.astype(np.int64) if self.t < 1 << 62 else slots.astype(object)
