"""Pure index algebra shared by the conv layers (ref ConvolutionEngine,
`NeuralNetworks/ConvolutionEngine.cs`); a copy of `cryptonets_tpu/nn/
convolution.py`.  Runs at prepare time only.

Iteration orders are load-bearing (weight layouts and LoLa packing depend
on them): offsets increment the FIRST axis fastest; corners increment the
LAST axis fastest, starting from padding-adjusted minima.
"""

from __future__ import annotations

import numpy as np


class ConvolutionEngine:
    def __init__(
        self,
        input_shape,
        kernel_shape,
        stride=None,
        padding=None,
        upper_padding=None,
        lower_padding=None,
        map_count=None,
    ):
        self.input_shape = list(input_shape)
        self.kernel_shape = list(kernel_shape)
        d = len(self.kernel_shape)
        self.stride = list(stride) if stride else [1] * d
        self.padding = list(padding) if padding else [False] * d
        self.upper_padding = list(upper_padding) if upper_padding else [0] * d
        self.lower_padding = list(lower_padding) if lower_padding else [0] * d
        self.map_count = list(map_count) if map_count else None
        self.offsets = self._gen_offsets()
        self.corners = self._gen_corners()

    @property
    def maps(self) -> int:
        return int(np.prod(self.map_count)) if self.map_count else 1

    def _gen_offsets(self):
        """Kernel positions; FIRST axis increments fastest (ref
        OffsetGenerator)."""
        ks = self.kernel_shape
        out = []
        offset = [0] * len(ks)
        while True:
            out.append(list(offset))
            for i in range(len(ks)):
                offset[i] += 1
                if offset[i] < ks[i]:
                    break
                offset[i] = 0
            else:
                return out

    def _gen_corners(self):
        """Window anchors; LAST axis increments fastest (ref
        CornerGenerator)."""
        ks, inp = self.kernel_shape, self.input_shape
        mins = [
            -self.lower_padding[i] - (-(ks[i] // 2) if self.padding[i] else 0)
            for i in range(len(ks))
        ]
        maxs = [
            inp[i]
            + self.upper_padding[i]
            - (((ks[i] + 1) // 2) if self.padding[i] else ks[i])
            for i in range(len(ks))
        ]
        out = []
        offset = list(mins)
        while True:
            out.append(list(offset))
            for i in reversed(range(len(ks))):
                offset[i] += self.stride[i]
                if offset[i] <= maxs[i]:
                    break
                offset[i] = mins[i]
            else:
                return out

    def location(self, corner, offset, shape, bias: int = 0) -> int:
        """Flatten coords; -1 marks a padding position (ref Location)."""
        index = 0
        for i in range(len(offset)):
            cord = (corner[i] + offset[i]) if corner is not None else offset[i]
            if cord < 0 or cord >= shape[i]:
                return -1
            index = index * shape[i] + cord
        return index + bias

    # -- lowering a convolution to an explicit dense matrix -----------------
    def get_dense_weights(self, weights) -> np.ndarray:
        """[maps*corners, prod(input_shape)] row-major dense matrix (ref
        GetDenseWeights; used by LoLaLarge/CIFAR conv-as-dense layers):
        row m*corners + i holds map m's kernel placed at corner i, taps in
        the padding dropped.  Vectorised over corners and offsets (the
        reference's loop takes tens of seconds at LoLaLarge's size)."""
        weights = np.asarray(weights, dtype=np.float64)
        corners = np.asarray(self.corners)                  # [nc, d]
        offsets = np.asarray(self.offsets)                  # [no, d]
        shape = np.asarray(self.input_shape)
        kshape = np.asarray(self.kernel_shape)
        coords = corners[:, None, :] + offsets[None, :, :]  # [nc, no, d]
        valid = np.all((coords >= 0) & (coords < shape), axis=-1)
        loc = np.zeros(valid.shape, np.int64)
        for i in range(len(shape)):
            loc = loc * shape[i] + coords[..., i]
        k = np.zeros(len(offsets), np.int64)
        for i in range(len(kshape)):
            k = k * kshape[i] + offsets[:, i]
        nc = len(self.corners)
        kernel_size = int(np.prod(self.kernel_shape))
        mat = np.zeros((self.maps * nc, int(np.prod(self.input_shape))))
        ci, oi = np.nonzero(valid)
        for m in range(self.maps):
            mat[m * nc + ci, loc[ci, oi]] = weights[k[oi] + m * kernel_size]
        return mat

    def get_dense_bias(self, bias) -> np.ndarray:
        bias = np.asarray(bias, dtype=np.float64)
        return np.repeat(bias[: self.maps], len(self.corners))
