"""HEVector: the scale-tracked ciphertext vector (port of
`cryptonets_tpu/api/vector.py`).  Every operation counts itself in
`utils.opcount.OPS` with the reference's names and counts.

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

from ..crypto.modular import add_mod, sub_mod
from ..crypto.noise import invariant_noise_budget
from ..utils import trace
from ..utils.opcount import OPS

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
        self._scalar_table = None   # `matrix._scalar_residues`
        # decoded slot residues [P, C, N] (host) from the record pipeline
        # (nn/forward.py): decrypt then only does the host CRT join
        self._dec_slots = None

    @property
    def is_encrypted(self) -> bool:
        return self.data is not None

    @property
    def block_size(self) -> int:
        return self.factory.block_size

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
            self._mult_form = self.factory.plain_mult_forms(self._slot_values())
        return self._mult_form

    def add_form(self):
        """Coefficient residues [P, C, k, N] for add_plain, cached."""
        if self._add_form is None:
            self._add_form = self.factory.plain_add_forms(self._slot_values())
        return self._add_form

    # ------------------------------------------------------------ add / sub
    def _binary_scale_check(self, other):
        if self.scale != 0 and other.scale != 0 and self.scale != other.scale:
            raise ValueError(f"Scales do not match: {self.scale} vs {other.scale}")

    def add(self, other: "HEVector") -> "HEVector":
        if self.scale == 0:
            return other
        if other.scale == 0:
            return self
        self._binary_scale_check(other)
        if self.is_encrypted and other.is_encrypted:
            OPS.count("addition", self.data.shape[1])
            return self._clone_meta(
                data=self.factory.bfv[0].add(self.data, other.data))
        if self.is_encrypted:
            OPS.count("plain_addition", self.data.shape[1])
            return self._clone_meta(
                data=self.factory.add_plain_data(self.data, other.add_form()))
        if other.is_encrypted:
            return other.add(self)
        return self._clone_meta(values=self.values + other.values)

    def subtract(self, other: "HEVector") -> "HEVector":
        """self - other over the four operand pairs; an operand of scale
        0 is zero.  A plain minus an encrypted vector is the negated
        ciphertext plus the plain vector."""
        if other.scale == 0:
            return self
        if self.is_encrypted and other.is_encrypted:
            self._binary_scale_check(other)
            OPS.count("subtraction", self.data.shape[1])
            return self._clone_meta(
                data=self.factory.bfv[0].sub(self.data, other.data))
        if self.is_encrypted:
            self._binary_scale_check(other)
            OPS.count("plain_subtraction", self.data.shape[1])
            return self._clone_meta(data=self.factory.add_plain_data(
                self.data, other.add_form(), sub=True))
        if other.is_encrypted:
            neg = other._clone_meta(data=other.factory.bfv[0].neg(other.data))
            return neg.add(self)
        return self._clone_meta(values=self.values - other.values)

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
            square = a is b          # one operand: lifted and transformed once
            OPS.count("multiplication", a.data.shape[1])
            OPS.count("relinearization", a.data.shape[1])
            if square:
                OPS.count("square", a.data.shape[1])
            out = torch.stack([
                bfv.relinearize(bfv.square(a.data[pi]) if square
                                else bfv.multiply(a.data[pi], b.data[pi]), fac.keys)
                for pi, bfv in enumerate(fac.bfv)
            ])
        elif a.is_encrypted:
            OPS.count("plain_multiplication", a.data.shape[1])
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
        OPS.count("rotation", self.data.shape[1])
        return self.factory.bfv[0].rotate_rows(self.data, steps, self.factory.keys)

    def _col_swap_data(self, data):
        OPS.count("rotation", data.shape[1])
        return self.factory.bfv[0].rotate_columns(data, self.factory.keys)

    def rotate(self, amount: int) -> "HEVector":
        """RotateRows(amount): each (n/2)-row of every block rotates left;
        a plain vector's slot values move the same way."""
        if not self.is_encrypted:
            row = self.factory.n // 2
            out = np.stack([
                np.concatenate([np.roll(b[:row], -amount),
                                np.roll(b[row:], -amount)])
                for b in self._slot_values()])
            return self._clone_meta(values=out.reshape(-1)[: self.dim])
        return self._clone_meta(data=self._rot_rows(amount))

    # ----------------------------------------------------------- slot sums
    def sum_all_slots(self, length: int | None = None,
                      force_output_in_column: int | None = None) -> "HEVector":
        """Right-rotate-and-add tree: out[i] = sum_{j < length} in[i - j].
        A complete sum (length None or >= n/2) starts with a column swap
        and leaves the total in every slot: a sparse vector of dim 1.
        `force_output_in_column` keeps the total in that flat slot alone
        (a unit-mask multiply): a dense vector of the input's dim; it
        needs a complete sum."""
        from .matrix import _sum_slots_data

        if self.fmt != DENSE or not self.is_encrypted:
            raise ValueError("sum_all_slots takes an encrypted dense vector")
        full = length is None or length >= self.factory.n // 2
        if force_output_in_column is not None and not full:
            raise ValueError("forcing the output column needs a complete sum")
        acc = _sum_slots_data(self.factory, self.data, length)
        if force_output_in_column is not None:
            OPS.count("plain_multiplication", acc.shape[1])
            mask = self.factory.unit_mask_form(force_output_in_column)
            acc = self.factory.bfv[0].mul_plain(acc, mask[:, :, None])
            return self._clone_meta(data=acc, fmt=DENSE)
        return self._clone_meta(data=acc, dim=1 if full else self.dim,
                                fmt=SPARSE if full else DENSE)

    def dot_product(self, other: "HEVector", length: int | None = None,
                    force_output_in_column: int | None = None) -> "HEVector":
        return self.pointwise_multiply(other).sum_all_slots(
            length, force_output_in_column)

    # ------------------------------------------------------------ duplicate
    def duplicate(self, count: int) -> "HEVector":
        """`count` copies at the next power-of-two stride above dim, in one
        ciphertext: copy i is the input rotated right by i*stride; from
        half the ring on, the rotation starts from the column-swapped
        input (made once) and is i*stride - n/2."""
        if not self.is_encrypted or self.fmt != DENSE:
            raise ValueError("duplicate takes an encrypted dense vector")
        p = self.factory
        n = p.n
        stride = 1
        while stride < self.dim:
            stride *= 2
        if stride * count > n:
            raise ValueError("the packed vector must fit in one ciphertext")
        q = p.bfv[0].p.chain_q.q
        base = res = self.data
        rotator = None
        for i in range(1, count):
            amt = i * stride
            src = base
            if 2 * amt >= n:
                if rotator is None:
                    rotator = self._col_swap_data(base)
                src = rotator
                amt -= n // 2
            OPS.count("rotation", 1)
            res = add_mod(res, p.bfv[0].rotate_rows(src, -amt, p.keys), q)
        return self._clone_meta(data=res, dim=stride * count)

    # -------------------------------------------------------------- permute
    def permute(self, selections, shifts, output_dim: int) -> "HEVector":
        """sum_i RotateRows(self * sel_i, shifts[i]) over the selections
        that are not None (ref `AtomicSealBfvVector.cs:1436-1475`): a mask
        multiply and a row rotation each."""
        if self.fmt != DENSE:
            raise ValueError("Permute works only on dense vectors")
        if self.num_blocks != 1:
            raise ValueError(
                f"can permute only a single block (got {self.num_blocks})")
        q = self.factory.bfv[0].p.chain_q.q
        res = first = None
        for sel, sh in zip(selections, shifts):
            if sel is None:
                continue
            if first is None:
                first = sel
            if sel.dim != self.dim:
                raise ValueError("selection dimension mismatch")
            if sel.scale != first.scale:
                raise ValueError("selection scales must match")
            rot = self.pointwise_multiply(sel)._rot_rows(sh)
            res = rot if res is None else add_mod(res, rot, q)
        if first is None:
            raise ValueError("permuting with no selections")
        return self._clone_meta(data=res, dim=output_dim,
                                scale=self.scale * first.scale)

    # ----------------------------------------------------------- interleave
    @staticmethod
    def interleave(vecs, shift: int) -> "HEVector":
        """Merge vectors: vec k lands at flat offset shift*k (negative
        shift: row + shift*k), the reference's case analysis
        (`AtomicSealBfvVector.cs:600-750`) followed exactly.  The
        placement extent is |shift|.  A piece is a right rotation into the
        lower or the upper half-row of an output block; one that crosses
        the row or the block boundary is split by a prefix mask.  The upper
        halves of a block are merged by one column rotation.

        Uniform runs: with a positive shift, at least 24 pieces and a
        single-hop Galois key for -shift, each run of at least 8
        consecutive pieces placed by a pure rotation into the same
        (half-row, block) folds into a Horner loop z <- rot_right(z,
        shift) + piece seeded with its last piece, then one rotation to
        the run's first offset: the same key switches in the same order as
        the reference's scan."""
        v0 = vecs[0]
        p = v0.factory
        bfv0 = p.bfv[0]
        n = p.n
        row = n // 2
        q = bfv0.p.chain_q.q
        d = v0.dim
        absh = abs(shift)
        out_blocks = -(-int(d * len(vecs)) // n) if shift > 0 else 1
        if absh * len(vecs) > n * out_blocks:
            raise ValueError("interleave: not enough room for the pieces")
        for v in vecs:
            if not v.is_encrypted or v.num_blocks != 1 or v.fmt != DENSE:
                raise ValueError(
                    "interleave inputs must be encrypted single-block dense "
                    f"vectors (got {v!r})")
        lower = [None] * out_blocks
        upper = [None] * out_blocks

        def acc(store, b, piece):
            store[b] = piece if store[b] is None else add_mod(store[b], piece, q)

        def rot_right(data, amt):
            if amt % row == 0:
                return data
            OPS.count("rotation", 1)
            return bfv0.rotate_rows(data, -amt, p.keys)

        def prefix_masked(data, ups):
            """data * mask(flat slots [0, ups)): the wrapped-around part."""
            OPS.count("plain_multiplication", 1)
            return bfv0.mul_plain(data, p.flat_mask_form(0, ups)[:, :, None])

        scanned = set()
        if (shift > 0 and len(vecs) >= 24
                and bfv0.galois_elt_rows((-shift) % row) in p.keys.galois):
            classes = []
            for kidx in range(len(vecs)):
                ts = shift * kidx
                in_block = ts % n
                start_b, end_b = ts // n, (ts + absh) // n
                if in_block == 0 or in_block + absh < row:
                    classes.append(("lower", start_b, ts % row))
                elif in_block >= row and start_b == end_b:
                    classes.append(("upper", start_b, in_block - row))
                else:
                    classes.append(None)
            k = 0
            while k < len(vecs):
                if classes[k] is None:
                    k += 1
                    continue
                j = k
                while (j + 1 < len(vecs) and classes[j + 1] is not None
                       and classes[j + 1][:2] == classes[k][:2]):
                    j += 1
                if j - k + 1 >= 8:
                    half, b, base_amt = classes[k]
                    z = vecs[j].data
                    OPS.count("rotation", j - k)
                    for i in range(j - 1, k - 1, -1):
                        z = add_mod(bfv0.rotate_rows(z, -shift, p.keys),
                                    vecs[i].data, q)
                    if base_amt % row:
                        OPS.count("rotation", 1)
                        z = bfv0.rotate_rows(z, -base_amt, p.keys)
                    acc(lower if half == "lower" else upper, b, z)
                    scanned.update(range(k, j + 1))
                k = j + 1

        for kidx, v in enumerate(vecs):
            if kidx in scanned:
                continue
            this_shift = shift * kidx
            if this_shift < 0:
                this_shift = row + this_shift
            in_block = this_shift % n
            start_b = this_shift // n
            end_b = (this_shift + absh) // n
            z = v.data
            if in_block == 0:
                acc(lower, start_b, z)
            elif in_block + absh < row:
                acc(lower, start_b, rot_right(z, this_shift))
            elif in_block >= row:
                z = rot_right(z, in_block - row)
                if start_b == end_b:
                    acc(upper, start_b, z)
                else:
                    zm = prefix_masked(z, in_block + absh - n)
                    OPS.count("subtraction", 1)
                    acc(upper, start_b, sub_mod(z, zm, q))
                    acc(lower, end_b, zm)
            else:
                z = rot_right(z, in_block)
                ups = in_block + absh - row
                if ups > 0:
                    zm = prefix_masked(z, ups)
                    OPS.count("subtraction", 1)
                    acc(upper, start_b, zm)
                    acc(lower, start_b, sub_mod(z, zm, q))
                else:
                    acc(lower, start_b, z)
        outs = []
        for b in range(out_blocks):
            blk = lower[b]
            if upper[b] is not None:
                up = v0._col_swap_data(upper[b])
                blk = up if blk is None else add_mod(blk, up, q)
            outs.append(torch.zeros_like(v0.data) if blk is None else blk)
        return v0._clone_meta(data=torch.cat(outs, dim=1), dim=d)

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
        slots_all = self._dec_slots
        if slots_all is None:
            slots_all = p.decrypt_slots(self.data)
        with trace.span("join"):
            if self.fmt == SPARSE:
                return p.join_split_numbers([
                    slots_all[pi, :, 0][: self.dim]
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
