"""HEMatrix: a list of uniform HEVectors, columns or rows (port of
`cryptonets_tpu/api/matrix.py`, the operations the LoLa, LoLaPacked,
LoLaLarge, CryptoNets, LoLaSmall and Caltech-101 paths use).

`mul` is the row-major matvec of a plain matrix with an encrypted dense
vector: one plaintext multiply per row, then SumAllSlots over every row
at once (`_sum_slots_data`), which leaves row r's dot product in every
slot of ciphertext r (a sparse vector).  The column-major matvec, the
encrypted-matrix branches and the forced dense output are not ported."""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.modular import add_mod, mod_sum
from .vector import DENSE, SPARSE, HEVector

# Columns per piece of the batched ciphertext multiply.  The BEHZ multiply
# and the relinearisation of one piece hold their int64 temporaries over
# the q and Bsk bases at once; the Python loop keeps one piece's alive at
# a time.  Tests lower it to run several pieces and a remainder.
MULT_CHUNK = 64

COLUMN_MAJOR = "col"
ROW_MAJOR = "row"


def _sum_slots_data(factory, d, length=None):
    """Batched SumAllSlots on ciphertext data [..., C, 2, k, N] ->
    [..., 1, 2, k, N]: the blocks are added, a column swap folds the two
    rows (a complete sum), then log2 right-rotate-and-add steps run as one
    ladder (`BFV.rotate_accumulate_scan`) when every step has its Galois
    key, else step by step.  out[i] = sum_{j < length} in[i - j]; the
    complete sum leaves the total in every slot."""
    bfv0 = factory.bfv[0]
    q = bfv0.p.chain_q.q
    row = factory.n // 2
    if d.shape[-4] > 1:
        d = mod_sum(d, q, dim=-4).unsqueeze(-4)
    if length is None or length >= row:
        d = add_mod(d, bfv0.rotate_columns(d, factory.keys), q)
        length = row
    g_list, steps = [], 1
    while steps < length:
        g_list.append(bfv0.galois_elt_rows(-steps % row))
        steps *= 2
    if g_list and d.shape[-3] == 2 and all(
            g in factory.keys.galois for g in g_list):
        return bfv0.rotate_accumulate_scan(
            d, factory.stacked_galois(tuple(g_list)))
    acc, steps = d, 1
    while steps < length:
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

    def _stacked_data(self) -> torch.Tensor:
        """[P, V, C, s, k, N] — vector index as its own axis."""
        return torch.stack([v.data for v in self.vectors], dim=1)

    def _stacked_mult_forms(self) -> torch.Tensor:
        """[P, V, C, k, N] plaintext multipliers of a plain matrix, made
        at first use and kept."""
        if self._mult_forms is None:
            self._mult_forms = torch.stack(
                [v.mult_form() for v in self.vectors], dim=1)
        return self._mult_forms

    def mul(self, v: HEVector, force_dense: bool = False) -> HEVector:
        """Row-major plain matrix times encrypted dense vector -> sparse
        vector of the per-row dot products."""
        if self.fmt != ROW_MAJOR or self.is_encrypted or not v.is_encrypted:
            raise NotImplementedError(
                "only the row-major matvec of a plain matrix with an "
                "encrypted vector is ported")
        if force_dense:
            raise NotImplementedError("the forced dense output is not ported")
        row0 = self.vectors[0]
        if v.fmt != DENSE or v.dim != row0.dim:
            raise ValueError(
                f"row-major matvec needs a dense vector of dim {row0.dim}: "
                f"{v.fmt}, {v.dim}")
        f = self.factory
        W = self._stacked_mult_forms()[:, :, :, None]     # [P, R, C, 1, k, N]
        prod = f.bfv[0].mul_plain(v.data[:, None], W)     # [P, R, C, 2, k, N]
        sums = _sum_slots_data(f, prod)                   # [P, R, 1, 2, k, N]
        return HEVector(
            f, data=sums[:, :, 0], dim=len(self.vectors),
            scale=row0.scale * v.scale, fmt=SPARSE, is_signed=row0.is_signed)

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
        # MULT_CHUNK columns, written into one output tensor
        f = self.factory
        d0 = self.vectors[0].data                       # [P, C, 2, k, N]
        out = torch.empty((f.P, V) + tuple(d0.shape[1:]), dtype=d0.dtype,
                          device=d0.device)
        for v0 in range(0, V, MULT_CHUNK):
            A = torch.stack([v.data for v in self.vectors[v0 : v0 + MULT_CHUNK]], dim=1)
            B = A if other is self else torch.stack(
                [v.data for v in other.vectors[v0 : v0 + MULT_CHUNK]], dim=1)
            for pi, bfv in enumerate(f.bfv):
                out[pi, v0 : v0 + A.shape[1]] = bfv.relinearize(
                    bfv.multiply(A[pi], B[pi]), f.keys)
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
