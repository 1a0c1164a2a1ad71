"""HEMatrix: a list of uniform HEVectors, columns or rows (port of
`cryptonets_tpu/api/matrix.py`, the operations the LoLa and CryptoNets
paths use)."""

from __future__ import annotations

import numpy as np
import torch

from .vector import DENSE, HEVector

# Columns per piece of the batched ciphertext multiply.  The BEHZ multiply
# and the relinearisation of one piece hold their int64 temporaries over
# the q and Bsk bases at once; the Python loop keeps one piece's alive at
# a time.  Tests lower it to run several pieces and a remainder.
MULT_CHUNK = 64

COLUMN_MAJOR = "col"
ROW_MAJOR = "row"


class HEMatrix:
    def __init__(self, factory, vectors: list, fmt: str):
        if fmt not in (COLUMN_MAJOR, ROW_MAJOR):
            raise ValueError(f"unknown matrix format {fmt!r}")
        self.factory = factory
        self.vectors = list(vectors)
        self.fmt = fmt

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

    def _stacked_data(self) -> torch.Tensor:
        """[P, V, C, s, k, N] — vector index as its own axis."""
        return torch.stack([v.data for v in self.vectors], dim=1)

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
                torch.stack([v._dec_slots for v in vs], dim=1), vs[0].dim)
        else:
            return np.stack([v.decrypt() for v in vs], axis=1)
        return np.stack([
            np.array([float(x) for x in vals[i]]) / vs[i].scale
            for i in range(len(vs))
        ], axis=1)

    def __repr__(self):
        return (f"HEMatrix({self.fmt}, vecs={len(self.vectors)}, "
                f"dim={self.vectors[0].dim}, scale={self.scale})")
