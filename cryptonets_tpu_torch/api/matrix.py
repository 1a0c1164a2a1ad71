"""HEMatrix: a list of uniform HEVectors, columns or rows (port of
`cryptonets_tpu/api/matrix.py`).

`mul` takes every branch of the reference:
  * row-major by a dense vector (an encrypted or a plain matrix by an
    encrypted or a plain vector, not both plain): one multiply per row,
    then SumAllSlots over the rows at once (`_sum_slots_data`), which
    leaves row r's dot product in every slot of ciphertext r (a sparse
    vector); with `force_dense` each row's sum is multiplied by the unit
    mask of flat slot r and the rows are added into one dense ciphertext;
  * column-major by a sparse vector: sum_j col_j * v_j, a dense vector
    (an encrypted matrix by an encrypted vector with one relinearisation
    after the sum, an encrypted matrix by plain scalars, a plain matrix by
    an encrypted vector).
The rows (columns) run in pieces of about DOT_CHUNK_BYTES of products,
whose sums add up piece by piece: a modular sum is exact in any order, so
the result is bit-equal to the reference's one stack of every row.
Operations count themselves in `utils.opcount.OPS` as the reference's
one stack does: once a matvec, not once a piece."""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.modular import add_mod, mod_sum, mul_const_mod
from ..kernels.modmac import mod_mac
from ..utils.opcount import OPS
from .vector import DENSE, SPARSE, HEVector

# Columns per piece of the batched ciphertext multiply.  The BEHZ multiply
# and the relinearisation of one piece hold their int64 temporaries over
# the q and Bsk bases at once; the Python loop keeps one piece's alive at
# a time.  Tests lower it to run several pieces and a remainder.
MULT_CHUNK = 64
# Bytes of ciphertext products a piece of the matvecs holds (rows of the
# row-major matvec, columns of the column-major one): a piece's key
# switches widen it about thirty-fold in int64 temporaries.  Tests lower
# it to run several pieces and a remainder.
DOT_CHUNK_BYTES = 1 << 28

COLUMN_MAJOR = "col"
ROW_MAJOR = "row"


def _scalar_residues(v: HEVector) -> torch.Tensor:
    """The integer scalars of a plain sparse vector -> their residues [V,
    L, 1] on the factory's L limbs, on its device, made at first use and
    kept on the vector (no host-to-device copy a record).  An integer acts
    alike on every plain prime's pipeline (the ciphertext ring is mod q;
    decrypt reduces mod t), so the table is shared over the P axis.  The
    reference's Shoup companions have no use here: `mul_const_mod`
    multiplies exactly in int64."""
    if v._scalar_table is None:
        qs = v.factory.limb_moduli
        w = np.array([[int(x) % q for q in qs] for x in v.values], np.int64)
        v._scalar_table = torch.from_numpy(
            w.reshape(len(v.values), len(qs), 1)).to(v.factory.device)
    return v._scalar_table


def _pieces(count: int, item_bytes: int):
    """(start, stop) pieces of `count` items of `item_bytes` each, about
    DOT_CHUNK_BYTES a piece and at least one item."""
    step = max(1, DOT_CHUNK_BYTES // item_bytes)
    return [(i, min(i + step, count)) for i in range(0, count, step)]


def _sum_slots_data(factory, d, length=None, count: bool = True):
    """Batched SumAllSlots on ciphertext data [..., C, 2, k, N] ->
    [..., 1, 2, k, N]: the blocks are added, a column swap folds the two
    rows (a complete sum), then log2 right-rotate-and-add steps run as one
    ladder (`BFV.rotate_accumulate_scan`) when every step has its Galois
    key, else step by step.  out[i] = sum_{j < length} in[i - j]; the
    complete sum leaves the total in every slot.  `count` False leaves
    the operation counts to the caller (a later piece of one matvec)."""
    ops = OPS.count if count else (lambda name, n=1: None)
    bfv0 = factory.bfv[0]
    q = bfv0.p.chain_q.q
    row = factory.n // 2
    if d.shape[-4] > 1:
        ops("add_many", 1)
        d = mod_sum(d, q, dim=-4).unsqueeze(-4)
    if length is None or length >= row:
        ops("rotation", 1)
        d = add_mod(d, bfv0.rotate_columns(d, factory.keys), q)
        length = row
    g_list, steps = [], 1
    while steps < length:
        g_list.append(bfv0.galois_elt_rows(-steps % row))
        steps *= 2
    if g_list and d.shape[-3] == 2 and all(
            g in factory.keys.galois for g in g_list):
        ops("rotation", len(g_list))
        return bfv0.rotate_accumulate_scan(
            d, factory.stacked_galois(tuple(g_list)))
    acc, steps = d, 1
    while steps < length:
        ops("rotation", 1)
        acc = add_mod(acc, bfv0.rotate_rows(acc, -steps, factory.keys), q)
        steps *= 2
    return acc


class HEMatrix:
    def __init__(self, factory, vectors: list, fmt: str):
        if fmt not in (COLUMN_MAJOR, ROW_MAJOR):
            raise ValueError(f"unknown matrix format {fmt!r}")
        self.factory = factory
        self.vectors = list(vectors)
        self.fmt = fmt
        self._mult_forms = None
        self._unit_masks = None

    @property
    def column_count(self) -> int:
        if self.fmt == COLUMN_MAJOR:
            return len(self.vectors)
        return self.vectors[0].dim

    @property
    def row_count(self) -> int:
        if self.fmt == ROW_MAJOR:
            return len(self.vectors)
        return self.vectors[0].dim

    @property
    def scale(self) -> float:
        return self.vectors[0].scale

    @property
    def is_encrypted(self) -> bool:
        return self.vectors[0].is_encrypted

    def register_scale(self, scale: float):
        for v in self.vectors:
            v.register_scale(scale)
        return self

    def get_column(self, i: int) -> HEVector:
        if self.fmt != COLUMN_MAJOR:
            raise ValueError("get_column needs a column-major matrix")
        return self.vectors[i]

    def get_row(self, i: int) -> HEVector:
        if self.fmt != ROW_MAJOR:
            raise ValueError("get_row needs a row-major matrix")
        return self.vectors[i]

    def set_column(self, i: int, v: HEVector):
        if self.fmt != COLUMN_MAJOR:
            raise ValueError("set_column needs a column-major matrix")
        self.vectors[i] = v
        self._mult_forms = None

    def _stacked_data(self) -> torch.Tensor:
        """[P, V, C, s, k, N] — vector index as its own axis."""
        return torch.stack([v.data for v in self.vectors], dim=1)

    def _stacked_mult_forms(self) -> torch.Tensor:
        """[P, V, C, k, N] plaintext multipliers of a plain matrix, made
        at first use (one batched encode) and kept."""
        if self._mult_forms is None:
            f, V = self.factory, len(self.vectors)
            C = self.vectors[0].num_blocks
            if any(v.num_blocks != C for v in self.vectors):
                raise ValueError("the vectors of a matrix need one block count")
            forms = f.plain_mult_forms(
                np.concatenate([v._slot_values() for v in self.vectors]))
            self._mult_forms = forms.view(f.P, V, C, *forms.shape[2:])
        return self._mult_forms

    def _stacked_unit_masks(self) -> torch.Tensor:
        """[P, R, k, N] the unit masks of flat slots 0..R-1 that force the
        rows of a row-major matvec, made at first use and kept."""
        if self._unit_masks is None:
            self._unit_masks = self.factory.unit_mask_forms(
                range(len(self.vectors)))
        return self._unit_masks

    def prepare_mul(self, force_dense: bool = False) -> None:
        """Make the plaintext forms a `mul` reads (a plain matrix's
        multipliers, the forcing masks) now, not at the first call."""
        if not self.is_encrypted:
            self._stacked_mult_forms()
        if force_dense and self.fmt == ROW_MAJOR:
            self._stacked_unit_masks()

    def mul(self, v: HEVector, force_dense: bool = False) -> HEVector:
        """Row-major: the per-row dot products with a dense vector, a
        sparse vector, or with `force_dense` one dense vector holding row
        r's in flat slot r.  Column-major: sum_j col_j * v_j with a sparse
        v, a dense vector."""
        if not (self.is_encrypted or v.is_encrypted):
            raise ValueError("plain x plain matvec belongs to the Raw backend")
        if self.fmt == COLUMN_MAJOR:
            return self._mul_column_major(v)
        return self._mul_row_major(v, force_dense)

    def _mul_column_major(self, v: HEVector) -> HEVector:
        V = len(self.vectors)
        if v.fmt != SPARSE or v.dim != V:
            raise ValueError(
                f"column-major matvec needs a sparse vector of dim {V}: "
                f"{v.fmt}, {v.dim}")
        f = self.factory
        bfv0 = f.bfv[0]
        q = bfv0.p.chain_q.q
        col0 = self.vectors[0]
        k, N = len(f.limb_moduli), f.n
        if self.is_encrypted and v.is_encrypted:
            OPS.count("multiplication", V)
            OPS.count("relinearization", 1)
        else:
            OPS.count("plain_multiplication", V)
        acc = None
        for c0, c1 in _pieces(V, f.P * col0.num_blocks * 3 * k * N * 4):
            if self.is_encrypted:
                A = torch.stack([c.data for c in self.vectors[c0:c1]], dim=1)
            if self.is_encrypted and v.is_encrypted:
                B = v.data[:, c0:c1, None]                # [P, c, 1, 2, k, N]
                prod = torch.stack([bfv.multiply(A[pi], B[pi])
                                    for pi, bfv in enumerate(f.bfv)])
                part = mod_sum(prod, q, dim=1)            # [P, C, 3, k, N]
            elif self.is_encrypted:
                # a sparse plain vector holds one constant a ciphertext: its
                # residues multiply directly, no encoded plaintexts
                w = _scalar_residues(v)[c0:c1]                  # [c, k, 1]
                part = mod_sum(mul_const_mod(A, w[None, :, None, None], q),
                               q, dim=1)
            else:
                # summed in the NTT domain by K6 over the columns, each
                # block of the forms a row z of the launch, accumulated
                # piece by piece; one inverse NTT at the end
                W = self._stacked_mult_forms()[:, c0:c1]          # [P, c, C, k, N]
                x = bfv0.p.ntt_q.forward(v.data[:, c0:c1]).transpose(0, 1)
                part = mod_mac(x, (W.permute(2, 1, 0, 3, 4),), bfv0.p.chain_q,
                               None if acc is None else (acc,))
                acc = part[..., 0, :, :]                          # [C, P, s, k, N]
                continue
            acc = part if acc is None else add_mod(acc, part, q)
        if self.is_encrypted and v.is_encrypted:
            acc = bfv0.relinearize(acc, f.keys)
        elif not self.is_encrypted:
            acc = bfv0.p.ntt_q.inverse(acc.transpose(0, 1).contiguous())
        return HEVector(f, data=acc, dim=col0.dim, scale=col0.scale * v.scale,
                        fmt=DENSE, is_signed=col0.is_signed)

    def _mul_row_major(self, v: HEVector, force_dense: bool) -> HEVector:
        R = len(self.vectors)
        row0 = self.vectors[0]
        if v.fmt != DENSE or v.dim != row0.dim:
            raise ValueError(
                f"row-major matvec needs a dense vector of dim {row0.dim}: "
                f"{v.fmt}, {v.dim}")
        f = self.factory
        bfv0 = f.bfv[0]
        chain, ntt = bfv0.p.chain_q, bfv0.p.ntt_q
        q = chain.q
        k, N = len(f.limb_moduli), f.n
        masks = self._stacked_unit_masks() if force_dense else None
        if self.is_encrypted and v.is_encrypted:
            OPS.count("multiplication", R)
            OPS.count("relinearization", R)
        else:
            OPS.count("plain_multiplication", R)
        parts, acc = [], None
        for r0, r1 in _pieces(R, f.P * v.num_blocks * 3 * k * N * 4):
            if self.is_encrypted:
                A = torch.stack([r.data for r in self.vectors[r0:r1]], dim=1)
            if self.is_encrypted and v.is_encrypted:
                prod = torch.stack([
                    bfv.relinearize(bfv.multiply(A[pi], v.data[pi, None]), f.keys)
                    for pi, bfv in enumerate(f.bfv)])     # [P, r, C, 2, k, N]
            elif self.is_encrypted:
                prod = bfv0.mul_plain(A, v.mult_form()[:, None, :, None])
            else:
                W = self._stacked_mult_forms()[:, r0:r1, :, None]
                prod = bfv0.mul_plain(v.data[:, None], W)
            sums = _sum_slots_data(f, prod, count=r0 == 0)  # [P, r, 1, s, k, N]
            if not force_dense:
                parts.append(sums[:, :, 0])
                continue
            # row r's sum times the unit mask of slot r, the rows added in
            # the NTT domain by K6, piece onto piece: one inverse NTT at
            # the end
            x = ntt.forward(sums[:, :, 0]).transpose(0, 1)  # [r, P, s, k, N]
            m = masks[:, r0:r1].transpose(0, 1)[None]       # [1, r, P, k, N]
            acc = mod_mac(x, (m,), chain, None if acc is None else (acc[None],))[0, :, :, 0]
        scale = row0.scale * v.scale
        if not force_dense:
            data = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            return HEVector(f, data=data, dim=R, scale=scale, fmt=SPARSE,
                            is_signed=row0.is_signed)
        OPS.count("plain_multiplication", R)      # the unit masks
        return HEVector(f, data=ntt.inverse(acc[:, None]), dim=R, scale=scale,
                        fmt=DENSE, is_signed=row0.is_signed)

    def add(self, other: "HEMatrix") -> "HEMatrix":
        if self.fmt != other.fmt or len(self.vectors) != len(other.vectors):
            raise ValueError("matrix shapes do not match")
        return HEMatrix(self.factory, [
            a.add(b) for a, b in zip(self.vectors, other.vectors)], self.fmt)

    def elementwise_multiply(self, other: "HEMatrix") -> "HEMatrix":
        if self.fmt != other.fmt or len(self.vectors) != len(other.vectors):
            raise ValueError("matrix shapes do not match")
        V = len(self.vectors)
        uniform = all(
            v.is_encrypted and v.data.shape == m.vectors[0].data.shape
            for m in (self, other) for v in m.vectors)
        if V == 1 or not uniform:
            return HEMatrix(self.factory, [
                a.pointwise_multiply(b)
                for a, b in zip(self.vectors, other.vectors)
            ], self.fmt)
        # batched ct x ct multiply + relinearisation over pieces of
        # MULT_CHUNK columns, the pieces joined by one concatenation (no
        # write into a fresh tensor: the record batch runs this under vmap);
        # a square lifts and transforms each piece once (`BFV.square`)
        f = self.factory
        square = other is self
        OPS.count("multiplication", V)
        OPS.count("relinearization", V)
        if square:
            OPS.count("square", V)
        pieces = []
        for v0 in range(0, V, MULT_CHUNK):
            A = torch.stack([v.data for v in self.vectors[v0 : v0 + MULT_CHUNK]], dim=1)
            B = None if square else torch.stack(
                [v.data for v in other.vectors[v0 : v0 + MULT_CHUNK]], dim=1)
            pieces.append(torch.stack([
                bfv.relinearize(bfv.square(A[pi]) if square
                                else bfv.multiply(A[pi], B[pi]), f.keys)
                for pi, bfv in enumerate(f.bfv)]))
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
        return HEMatrix(f, [
            HEVector(f, data=out[:, i], dim=a.dim, scale=a.scale * b.scale,
                     fmt=a.fmt, is_signed=a.is_signed)
            for i, (a, b) in enumerate(zip(self.vectors, other.vectors))
        ], self.fmt)

    def convert_to_column_vector(self) -> HEVector:
        """Stack all vectors into one long dense vector."""
        return HEVector.stack(self.vectors)

    def interleave(self, shift: int) -> HEVector:
        return HEVector.interleave(self.vectors, shift)

    def decrypt(self) -> np.ndarray:
        """[dim, nvec] array of floats (column-major orientation)."""
        vs = self.vectors
        f = self.factory
        uniform = self.is_encrypted and len(vs) > 1 and all(
            v.fmt == DENSE and v.data.shape == vs[0].data.shape
            and v.dim == vs[0].dim for v in vs)
        # uniform columns: one device pass and one vectorized CRT join
        if uniform and all(v._dec_slots is None for v in vs):
            vals = f.decrypt_columns(self._stacked_data(), vs[0].dim)
        elif uniform and all(v._dec_slots is not None for v in vs):
            vals = f.join_decoded_columns(
                np.stack([v._dec_slots for v in vs], axis=1), vs[0].dim)
        else:
            return np.stack([v.decrypt() for v in vs], axis=1)
        return np.stack([
            np.array([float(x) for x in vals[i]]) / vs[i].scale
            for i in range(len(vs))
        ], axis=1)

    def __repr__(self):
        return (f"HEMatrix({self.fmt}, vecs={len(self.vectors)}, "
                f"dim={self.vectors[0].dim}, scale={self.scale})")
