"""HEVector: the scale-tracked ciphertext vector (port of
`cryptonets_tpu/api/vector.py`, the operations the ported networks use).

Layout: `data` is int32 [P, C, size, k, N] — P plain-CRT primes, C blocks.
  * dense:  C = ceil(dim/n) blocks; flat slot order (slots [0, n/2) =
    SIMD row 0, [n/2, n) = row 1, SEAL layout).
  * sparse: C = dim ciphertexts, each holding one value in every slot.
Plain (unencrypted) vectors share the class with `data=None` and scaled
integer slot values held on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.modular import add_mod
from ..crypto.noise import invariant_noise_budget

DENSE = "dense"
SPARSE = "sparse"


class HEVector:
    def __init__(self, factory, *, data=None, values=None, dim: int,
                 scale: float, fmt: str = DENSE, is_signed: bool = True):
        self.factory = factory
        self.data = data            # [P, C, size, k, N] when encrypted
        self.values = values        # numpy object ints (scaled) when plain
        self.dim = int(dim)
        self.scale = float(scale)
        self.fmt = fmt
        self.is_signed = is_signed
        self._mult_form = None
        self._add_form = None
        # decoded slot residues [P, C, N] from a fused forward
        # (nn/forward.py): decrypt then only does the host CRT join
        self._dec_slots = None

    @property
    def is_encrypted(self) -> bool:
        return self.data is not None

    @property
    def num_blocks(self) -> int:
        if self.is_encrypted:
            return self.data.shape[1]
        return max(1, -(-self.dim // self.factory.n))

    def _clone_meta(self, data=None, values=None, dim=None, scale=None, fmt=None):
        return HEVector(
            self.factory, data=data, values=values,
            dim=self.dim if dim is None else dim,
            scale=self.scale if scale is None else scale,
            fmt=self.fmt if fmt is None else fmt,
            is_signed=self.is_signed,
        )

    def register_scale(self, scale: float):
        self.scale = float(scale)
        return self

    # ------------------------------------------------------- plain lazy forms
    def _slot_values(self) -> np.ndarray:
        """Plain vector -> full slot array [C, n] (sparse: replicated)."""
        n = self.factory.n
        if self.fmt == SPARSE:
            return np.stack([np.full(n, v, dtype=object) for v in self.values])
        buf = np.zeros(self.num_blocks * n, dtype=object)
        buf[: self.dim] = self.values[: self.dim]
        return buf.reshape(self.num_blocks, n)

    def mult_form(self):
        """NTT + Montgomery plaintext multiplier [P, C, k, N], cached."""
        if self._mult_form is None:
            sv = self._slot_values()
            self._mult_form = torch.cat([
                self.factory.plain_mult_form(b, self.factory.n) for b in sv
            ], dim=1)
        return self._mult_form

    def add_form(self):
        """Coefficient residues [P, C, k, N] for add_plain, cached."""
        if self._add_form is None:
            sv = self._slot_values()
            self._add_form = torch.cat([
                self.factory.plain_add_form(b, self.factory.n) for b in sv
            ], dim=1)
        return self._add_form

    # ------------------------------------------------------------ add
    def add(self, other: "HEVector") -> "HEVector":
        if self.scale == 0:
            return other
        if other.scale == 0:
            return self
        if self.scale != other.scale:
            raise ValueError(f"Scales do not match: {self.scale} vs {other.scale}")
        if self.is_encrypted and other.is_encrypted:
            return self._clone_meta(
                data=self.factory.bfv[0].add(self.data, other.data))
        if self.is_encrypted:
            return self._clone_meta(
                data=self.factory.add_plain_data(self.data, other.add_form()))
        if other.is_encrypted:
            return other.add(self)
        return self._clone_meta(values=self.values + other.values)

    # --------------------------------------------------- pointwise multiply
    def pointwise_multiply(self, other: "HEVector") -> "HEVector":
        """Elementwise product; sparse dim-1 operands broadcast as scalars."""
        a, b = self, other
        out_scale = a.scale * b.scale
        out_dim = max(a.dim, b.dim) if (a.dim == 1 or b.dim == 1) else a.dim
        if a.dim != b.dim and a.dim != 1 and b.dim != 1:
            raise ValueError("Vector dimensions do not match")
        out_fmt = a.fmt if a.dim >= b.dim else b.fmt
        if a.dim == 1 and b.dim > 1:
            a, b = b, a
        fac = self.factory
        if a.is_encrypted and b.is_encrypted:
            out = torch.stack([
                bfv.relinearize(bfv.multiply(a.data[pi], b.data[pi]), fac.keys)
                for pi, bfv in enumerate(fac.bfv)
            ])
        elif a.is_encrypted:
            out = fac.bfv[0].mul_plain(a.data, b.mult_form()[:, :, None])
        elif b.is_encrypted:
            return b.pointwise_multiply(a)
        else:
            bv = b.values if b.dim > 1 else b.values[0]
            r = self._clone_meta(values=a.values * bv, dim=out_dim, fmt=out_fmt)
            r.scale = out_scale
            return r
        r = self._clone_meta(data=out, dim=out_dim, fmt=out_fmt)
        r.scale = out_scale
        return r

    # ------------------------------------------------------------- rotations
    def _rot_rows(self, steps: int):
        """Row-rotate the data LEFT by steps (SEAL RotateRows convention)."""
        return self.factory.bfv[0].rotate_rows(self.data, steps, self.factory.keys)

    def _col_swap_data(self, data):
        return self.factory.bfv[0].rotate_columns(data, self.factory.keys)

    def rotate(self, amount: int) -> "HEVector":
        """RotateRows(amount): each (n/2)-row of every block rotates left."""
        if not self.is_encrypted:
            raise NotImplementedError("plain-vector rotation is not ported")
        return self._clone_meta(data=self._rot_rows(amount))

    # ----------------------------------------------------------- slot sums
    def sum_all_slots(self, length: int | None = None) -> "HEVector":
        """Right-rotate-and-add tree: out[i] = sum_{j < length} in[i - j].
        A complete sum (length None or >= n/2) starts with a column swap
        and leaves the total in every slot: a sparse vector of dim 1.
        Forcing the total into one column is not ported."""
        from .matrix import _sum_slots_data

        if self.fmt != DENSE or not self.is_encrypted:
            raise ValueError("sum_all_slots takes an encrypted dense vector")
        full = length is None or length >= self.factory.n // 2
        acc = _sum_slots_data(self.factory, self.data, length)
        return self._clone_meta(data=acc, dim=1 if full else self.dim,
                                fmt=SPARSE if full else DENSE)

    def dot_product(self, other: "HEVector",
                    length: int | None = None) -> "HEVector":
        return self.pointwise_multiply(other).sum_all_slots(length)

    # ----------------------------------------------------------- interleave
    @staticmethod
    def interleave(vecs, shift: int) -> "HEVector":
        """Merge vectors: vec k lands at flat offset shift*k.

        Only the placements LoLa's Vectorize reaches are ported: shift > 0,
        fewer than 24 pieces, and every piece landing inside the lower
        half-row of block 0 (`in_block == 0` or `in_block + |shift| <
        n/2`); each piece is then one row rotation.  Every other branch of
        the reference's case analysis raises NotImplementedError."""
        v0 = vecs[0]
        p = v0.factory
        n = p.n
        row = n // 2
        q = p.bfv[0].p.chain_q.q
        absh = abs(shift)
        if shift <= 0 or len(vecs) >= 24:
            raise NotImplementedError(
                "interleave: negative shifts and scanned runs are not ported")
        for v in vecs:
            if v.num_blocks != 1 or v.fmt != DENSE:
                raise ValueError("interleave inputs must be single-block dense vectors")
        out = None
        for kidx, v in enumerate(vecs):
            this_shift = shift * kidx
            in_block = this_shift % n
            if this_shift // n != 0 or (in_block and in_block + absh >= row):
                raise NotImplementedError(
                    "interleave: pieces crossing a row or block are not ported")
            z = v.data
            if in_block:
                z = p.bfv[0].rotate_rows(z, -this_shift, p.keys)  # right
            out = z if out is None else add_mod(out, z, q)
        return v0._clone_meta(data=out, dim=v0.dim)

    @staticmethod
    def stack(vecs) -> "HEVector":
        """Concatenate vectors end to end (ref Stack)."""
        res = HEVector.interleave(vecs, int(vecs[0].dim))
        res.dim = int(vecs[0].dim) * len(vecs)
        return res

    # -------------------------------------------------------------- decrypt
    def decrypt_full_precision(self) -> np.ndarray:
        """Centered big-int values."""
        if not self.is_encrypted:
            return np.asarray(self.values[: self.dim], dtype=object)
        p = self.factory
        slots = self._dec_slots
        if slots is None:
            slots = p._decrypt_decode_all(self.data)
        slots_all = slots.cpu().numpy()                  # [P, C, N]
        if self.fmt == SPARSE:
            return p.join_split_numbers([
                slots_all[pi, :, 0].astype(np.int64)[: self.dim]
                for pi in range(p.P)
            ])
        return p.join_decoded_blocks(slots_all, self.dim)

    def decrypt(self) -> np.ndarray:
        """Float values (big ints / scale); float64 keeps 53 bits."""
        vals = self.decrypt_full_precision()
        return np.array([float(v) for v in vals]) / self.scale

    def noise_budget(self) -> int:
        """Minimum invariant-noise budget over plain primes and blocks."""
        p = self.factory
        return min(
            invariant_noise_budget(p.bfv[pi], p.keys, self.data[pi, c])
            for pi in range(p.P)
            for c in range(self.data.shape[1])
        )

    def __repr__(self):
        kind = "enc" if self.is_encrypted else "plain"
        return (f"HEVector({kind}, dim={self.dim}, scale={self.scale}, "
                f"fmt={self.fmt}, blocks={self.num_blocks})")
