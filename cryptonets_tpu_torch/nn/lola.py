"""LoLa layers (ref `NeuralNetworks/LL*.cs`): port of `LLPoolLayer`,
`LLVectorizeLayer`, the reference packing's `LLDuplicateLayer`,
`LLPackedDenseLayer`, `LLInterleaveLayer` and `LLInterleavedDenseLayer`,
and `LLDenseLayer` (per-row dots and the BSGS diagonal matvec) from
`cryptonets_tpu/nn/lola.py`."""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.modmatmul import ContractCache
from ..utils.opcount import OPS
from .convolution import ConvolutionEngine
from .network import Layer


class LLPoolLayer(Layer):
    """LoLa conv over a single-image patch matrix (column i = i-th
    kernel-offset vector across windows): per map, sum_i w_i * col_i plus
    a dense bias.  Encrypted, all maps run as one exact modular
    contraction; on the Raw backend as per-map matrix products.  Without
    weights it is a mean pool: the columns added, the scale multiplied by
    their count."""

    kind = "conv"

    def __init__(self, source, input_shape, kernel_shape, stride=None,
                 padding=None, upper_padding=None, lower_padding=None,
                 map_count=None, weights=None, bias=None,
                 weights_scale: float = 1.0, hot_indices=None):
        super().__init__(source)
        self.engine = ConvolutionEngine(
            input_shape, kernel_shape, stride, padding,
            upper_padding, lower_padding, map_count,
        )
        self.weights = None if weights is None else np.asarray(weights, float)
        self.bias = None if bias is None else np.asarray(bias, float)
        self.weights_scale = float(weights_scale)
        self.hot_indices = hot_indices
        self.weight_windows = None
        self.bias_vectors = None
        self.kernel_size = -1
        self._contract = ContractCache()

    def get_output_scale(self):
        if self.weights is None:
            return len(self.engine.offsets) * self.source.get_output_scale()
        return self.weights_scale * self.source.get_output_scale()

    def output_dimension(self):
        count = len(self.engine.corners)
        return count if self.weights is None else count * self.engine.maps

    def prepare(self):
        if self.layer_prepared:
            return
        e = self.engine
        self.kernel_size = int(np.prod(e.kernel_shape))
        if self.bias is None:
            self.kernel_size += 1  # embedded-bias weight layout
        if self.weights is None:
            return
        self.weight_windows = []
        for m in range(e.maps):
            w = []
            for off in e.offsets:
                loc = e.location(None, off, e.kernel_shape, m * self.kernel_size)
                w.append(0.0 if loc < 0 else self.weights[loc])
            self.weight_windows.append(
                self.factory.get_plain_vector(w, "sparse", self.weights_scale))
        hot = (np.ones(len(e.corners)) if self.hot_indices is None
               else np.asarray(self.hot_indices, float))
        self.hot_indices = hot
        src_scale = self.source.get_output_scale()
        if self.bias is not None:
            bvals = [self.bias[m] for m in range(e.maps)]
        else:
            bvals = [self.weights[(m + 1) * self.kernel_size - 1]
                     for m in range(e.maps)]
        self.bias_vectors = [
            self.factory.get_plain_vector(
                hot * b, "dense", src_scale * self.weights_scale)
            for b in bvals
        ]

    def _weight_ints(self) -> np.ndarray:
        """The scaled integer weights [maps, offsets] of the windows."""
        return np.stack([
            np.asarray([int(x) for x in wv.values], dtype=np.int64)
            for wv in self.weight_windows
        ])

    def apply(self, m):
        if self.weights is None:  # mean pool: sum the offset columns
            agg = m.get_column(0)
            for i in range(1, m.column_count):
                agg = agg.add(m.get_column(i))
            agg.register_scale(agg.scale * m.column_count)
            return self.factory.get_matrix([agg], "col")
        if not m.is_encrypted:
            cols = [
                m.mul(self.weight_windows[k]).add(self.bias_vectors[k])
                for k in range(len(self.bias_vectors))
            ]
            return self.factory.get_matrix(cols, "col")
        from ..api.vector import HEVector
        from ..kernels.modmatmul import exact_mod_contract

        f = self.factory
        x = m._stacked_data()
        wc = self._contract.get(f, x.device, self._weight_ints)
        OPS.count("plain_multiplication", wc.M * wc.O)
        out = exact_mod_contract(
            wc, x, f.limb_moduli, f.bfv[0].p.chain_q.q
        )                                                 # [P, maps, C, s, k, N]
        col0 = m.get_column(0)
        out_scale = col0.scale * self.weights_scale
        cols = [
            HEVector(f, data=out[:, k], dim=col0.dim, scale=out_scale,
                     fmt="dense", is_signed=col0.is_signed,
                     ).add(self.bias_vectors[k])
            for k in range(self.engine.maps)
        ]
        return f.get_matrix(cols, "col")


class LLVectorizeLayer(Layer):
    """Matrix of map columns -> one long dense vector via Stack."""

    kind = "vectorize"

    def __init__(self, source=None, output_dim: int = -1):
        super().__init__(source)
        self.output_dim = output_dim

    def apply(self, m):
        return self.factory.get_matrix([m.convert_to_column_vector()], "col")

    def output_dimension(self):
        if self.output_dim > 0:
            return self.output_dim
        return self.source.output_dimension()


class LLDuplicateLayer(Layer):
    """Each column `count` times at the next power-of-two stride, in one
    ciphertext (ref `LLDuplicateLayer.cs`)."""

    kind = "packing"

    def __init__(self, source=None, count: int = 1):
        super().__init__(source)
        self.count = count

    def apply(self, m):
        cols = [m.get_column(i).duplicate(self.count)
                for i in range(m.column_count)]
        return self.factory.get_matrix(cols, m.fmt)

    def output_dimension(self):
        shift = 1
        d = self.source.output_dimension()
        while shift < d:
            shift *= 2
        return shift * self.count


class LLPackedDenseLayer(Layer):
    """Fully connected layer over a duplicated vector: the weight rows
    packed `packing_count` to a stacked row at `packing_shift` stride; a
    bucketed dot product leaves output i at slot (col + 1) * shift - 1 of
    stacked row i // packing_count, where its bias is added (ref
    `LLPackedDenseLayer.cs`).  Encrypted, one plaintext multiply over all
    stacked rows and one rotate-and-add ladder of length packing_shift."""

    kind = "dense"

    def __init__(self, source, weights, bias, packing_count: int,
                 packing_shift: int, weights_scale: float = 1.0):
        super().__init__(source)
        self.weights = np.asarray(weights, float)
        self.bias = np.asarray(bias, float)
        self.packing_count = packing_count
        self.packing_shift = packing_shift
        self.weights_scale = float(weights_scale)
        self.weights_matrix = None
        self.bias_matrix = None
        self._bias_forms = None

    def get_output_scale(self):
        return self.weights_scale * self.source.get_output_scale()

    def output_dimension(self):
        return len(self.bias)

    def prepare(self):
        if self.layer_prepared:
            return
        maps = len(self.bias)
        map_len = len(self.weights) // maps
        pc, shift = self.packing_count, self.packing_shift
        new_rows = (maps + pc - 1) // pc
        stacked = np.zeros((new_rows, pc * shift))
        padded_bias = np.zeros((new_rows, pc * shift))
        w = self.weights.reshape(maps, map_len)
        for i in range(maps):
            col, row = i % pc, i // pc
            stacked[row, col * shift : col * shift + map_len] = w[i]
            padded_bias[row, (col + 1) * shift - 1] = self.bias[i]
        self.weights_matrix = self.factory.get_plain_matrix(
            stacked, "row", self.weights_scale)
        self.bias_matrix = self.factory.get_plain_matrix(
            padded_bias, "row",
            self.source.get_output_scale() * self.weights_scale)

    def apply(self, m):
        if m.column_count != 1:
            raise ValueError("expecting only one column")
        vector = m.get_column(0)
        if not vector.is_encrypted:
            cols = [
                self.weights_matrix.get_row(k)
                .dot_product(vector, length=self.packing_shift)
                .add(self.bias_matrix.get_row(k))
                for k in range(self.weights_matrix.row_count)
            ]
            return self.factory.get_matrix(cols, "col")
        from ..api.matrix import _sum_slots_data
        from ..api.vector import HEVector

        f = self.factory
        W = self.weights_matrix._stacked_mult_forms()      # [P, R, C, k, N]
        OPS.count("plain_multiplication", W.shape[1])
        prod = f.bfv[0].mul_plain(vector.data[:, None], W[:, :, :, None])
        sums = _sum_slots_data(f, prod, length=self.packing_shift)
        if self._bias_forms is None:
            self._bias_forms = torch.stack(
                [v.add_form() for v in self.bias_matrix.vectors], dim=1)
        OPS.count("plain_addition", W.shape[1])
        out = f.add_plain_data(sums, self._bias_forms)     # [P, R, 1, 2, k, N]
        out_scale = vector.scale * self.weights_matrix.scale
        dim = self.packing_count * self.packing_shift
        return f.get_matrix([
            HEVector(f, data=out[:, r], dim=dim, scale=out_scale,
                     fmt="dense", is_signed=vector.is_signed)
            for r in range(out.shape[1])
        ], "col")


class LLInterleaveLayer(Layer):
    """The selected slots of every column (a 0/1 mask multiply), merged
    into one vector by `interleave(shift)` (ref `LLInterleaveLayer.cs`).
    Encrypted, one mask multiply over all columns."""

    kind = "packing"

    def __init__(self, source, shift: int, selected_indices,
                 input_gross_dimension: int = -1):
        super().__init__(source)
        self.shift = shift
        self.selected_indices = list(selected_indices)
        self.input_gross_dimension = input_gross_dimension
        self.mask = None

    def prepare(self):
        if self.input_gross_dimension < 0:
            self.input_gross_dimension = max(self.selected_indices) + 1
        mv = np.zeros(self.input_gross_dimension)
        mv[self.selected_indices] = 1.0
        self.mask = self.factory.get_plain_vector(mv, "dense", 1.0)

    def apply(self, m):
        col0 = m.get_column(0)
        if col0.is_encrypted:
            from ..api.vector import HEVector

            f = self.factory
            stacked = m._stacked_data()                    # [P, V, C, 2, k, N]
            mf = self.mask.mult_form()                     # [P, C, k, N]
            OPS.count("plain_multiplication", m.column_count)
            cleaned = f.bfv[0].mul_plain(stacked, mf[:, None, :, None])
            clean = [
                HEVector(f, data=cleaned[:, i], dim=col0.dim,
                         scale=col0.scale * self.mask.scale, fmt="dense",
                         is_signed=col0.is_signed)
                for i in range(m.column_count)
            ]
        else:
            clean = [m.get_column(i).pointwise_multiply(self.mask)
                     for i in range(m.column_count)]
        interleaved = self.factory.get_matrix(clean, "col").interleave(self.shift)
        return self.factory.get_matrix([interleaved], "col")

    def output_dimension(self):
        return self.input_gross_dimension


class LLInterleavedDenseLayer(Layer):
    """Fully connected layer whose weight columns are scattered to the
    interleaved slot positions (ref `LLInterleavedDenseLayer.cs`): per-row
    dot products, one output ciphertext per row."""

    kind = "dense"

    def __init__(self, source, weights, bias, shift: int, selected_indices,
                 weights_scale: float = 1.0):
        super().__init__(source)
        self.weights = np.asarray(weights, float)
        self.bias = np.asarray(bias, float)
        self.shift = shift
        self.selected_indices = list(selected_indices)
        self.weights_scale = float(weights_scale)
        self.weights_matrix = None
        self.bias_vector = None

    def get_output_scale(self):
        return self.source.get_output_scale() * self.weights_scale

    def output_dimension(self):
        return len(self.bias)

    def _target_indices(self, count):
        out = []
        offset = 0
        while count > 0:
            for i in self.selected_indices:
                if count <= 0:
                    break
                out.append(i + offset)
                count -= 1
            offset += self.shift
        return out

    def prepare(self):
        rows = len(self.bias)
        columns = len(self.weights) // rows
        small = self.weights.reshape(rows, columns)
        big = np.zeros((rows, self.source.output_dimension()))
        ti = self._target_indices(columns)
        for i in range(columns):
            big[:, ti[i]] = small[:, i]
        self.bias_vector = self.factory.get_plain_vector(
            self.bias, "sparse", self.get_output_scale())
        self.weights_matrix = self.factory.get_plain_matrix(
            big, "row", self.weights_scale)

    def apply(self, m):
        mul = self.weights_matrix.mul(m.get_column(0))
        return self.factory.get_matrix([mul.add(self.bias_vector)], "col")


class LLDenseLayer(Layer):
    """Fully connected layer.  Encrypted, over a dense input it runs as
    per-row dot products (a row-major plain matrix, SumAllSlots ladders,
    one output ciphertext per row: a sparse vector; with
    force_dense_format each row's sum masked into flat slot r of one dense
    vector) or, with force_dense_format on a factory that encodes on the
    device, as the BSGS diagonal matvec (`api/bsgs.py`); over a sparse
    input as a column-major matvec (a dense vector).  `use_bsgs` None
    takes BSGS from 128 outputs up, True forces it, False forces per-row
    dots; `bsgs_g` is the baby count (None: `api/bsgs.py` `_choose_g`).
    On the Raw backend it is a matrix product."""

    kind = "dense"

    def __init__(self, source, weights, bias, weights_scale: float = 1.0,
                 input_format: str = "dense", force_dense_format: bool = False,
                 use_bsgs: bool | None = None, bsgs_g: int | None = None):
        super().__init__(source)
        self.weights = np.asarray(weights, float)
        self.bias = np.asarray(bias, float)
        self.weights_scale = float(weights_scale)
        self.input_format = input_format
        self.force_dense_format = force_dense_format
        self.use_bsgs = use_bsgs
        self.bsgs_g = bsgs_g
        self.weights_matrix = None
        self.bias_vector = None
        self.bsgs_form = None

    def get_output_scale(self):
        return self.weights_scale * self.source.get_output_scale()

    def output_dimension(self):
        return len(self.bias)

    def prepare(self):
        if self.layer_prepared:
            return
        maps = len(self.bias)
        wmat = self.weights.reshape(maps, len(self.weights) // maps)
        bias_scale = self.source.get_output_scale() * self.weights_scale
        if self.force_dense_format and self.input_format == "sparse":
            raise ValueError("force-dense requires dense input")
        dense_out = self.force_dense_format or self.input_format != "dense"
        self.bias_vector = self.factory.get_plain_vector(
            self.bias, "dense" if dense_out else "sparse", bias_scale)
        fmt = "row" if self.input_format == "dense" else "col"
        want_bsgs = self.use_bsgs if self.use_bsgs is not None else maps >= 128
        # BSGS encodes its diagonals on the device: a factory that encodes
        # on the host (plain primes of 2**31 and above) takes per-row dots
        if (self.factory.is_encrypted and fmt == "row"
                and self.force_dense_format and want_bsgs
                and maps <= self.factory.n and wmat.shape[1] <= self.factory.n
                and self.factory.encodes_on_device):
            from ..api.bsgs import BsgsDenseForm

            # the same integers as the per-element rounding (round-half-even)
            w_int = np.round(wmat * self.weights_scale).astype(np.int64)
            self.bsgs_form = BsgsDenseForm(
                self.factory, w_int, maps, wmat.shape[1], g=self.bsgs_g)
            return
        self.weights_matrix = self.factory.get_plain_matrix(
            wmat, fmt, self.weights_scale)
        if self.factory.is_encrypted:
            # the multipliers and the forcing masks once a layer
            self.weights_matrix.prepare_mul(self.force_dense_format)

    def apply(self, m):
        if m.column_count != 1:
            raise ValueError("expecting only one column")
        v = m.get_column(0)
        if self.bsgs_form is None:
            mul = self.weights_matrix.mul(v, self.force_dense_format)
        else:
            from ..api.bsgs import bsgs_matvec
            from ..api.vector import HEVector

            if v.num_blocks != 1:
                raise ValueError("BSGS dense needs a single-block input")
            mul = HEVector(
                self.factory, data=bsgs_matvec(self.bsgs_form, v.data),
                dim=self.bsgs_form.out_dim,
                scale=v.scale * self.weights_scale, fmt="dense",
                is_signed=v.is_signed,
            )
        return self.factory.get_matrix([mul.add(self.bias_vector)], "col")


class LLPreConvLayer(Layer):
    """Re-pack one dense image vector into the patch-matrix layout
    homomorphically (ref `LLPreConvLayer.cs`, port of `cryptonets_tpu/
    nn/lola.py`): column i (kernel offset i) is a `permute` of the input,
    the sum over the corner blocks of a masked and rotated copy.  The
    corners are grouped in blocks along the axes `use_axis_for_blocks`
    selects; `corners_map` gives each corner's slot in the output,
    `hot_indices` marks those slots (the conv's bias goes there), and
    `rearrange_weights` moves a downstream dense layer's weights to them."""

    kind = "packing"

    def __init__(self, source, input_shape, kernel_shape, stride=None,
                 padding=None, upper_padding=None, lower_padding=None,
                 use_axis_for_blocks=None):
        super().__init__(source)
        self.engine = ConvolutionEngine(
            input_shape, kernel_shape, stride, padding,
            upper_padding, lower_padding,
        )
        self.use_axis_for_blocks = use_axis_for_blocks
        self.output_dim = -1
        self.shifts = None
        self.masks = None
        self.hot_indices = None
        self.corners_map = None

    def _block_offsets(self):
        """Flat offsets of the corner blocks: every combination of the
        positions below the stride on the axes used for blocks."""
        e = self.engine
        stride = e.stride
        shifts = [1] * len(stride)
        for i in range(1, len(shifts)):
            shifts[i] = shifts[i - 1] * e.input_shape[i - 1]
        block = [0] * len(stride)
        offset = 0
        out = []
        while True:
            out.append(offset)
            for i in range(len(block)):
                if not self.use_axis_for_blocks[i]:
                    continue
                block[i] += 1
                offset += shifts[i]
                if block[i] < stride[i]:
                    break
                offset -= block[i] * shifts[i]
                block[i] = 0
            else:
                return out

    def prepare(self):
        if self.layer_prepared:
            return
        e = self.engine
        if self.use_axis_for_blocks is None:
            self.use_axis_for_blocks = [True] * len(e.input_shape)
        dim = int(np.prod(e.input_shape))
        plane = dim // e.input_shape[0]
        block_offsets = self._block_offsets()
        corners_proj = sorted({c[0] for c in e.corners})
        expected = len(corners_proj) / len(block_offsets)
        small_bs = int(np.floor(expected))
        large_bs = int(np.ceil(expected))
        n_large = len(corners_proj) - len(block_offsets) * small_bs
        self.corners_map = [-1] * len(e.corners)
        self.masks, self.shifts = [], []
        for off in e.offsets:
            selections = [[] for _ in block_offsets]
            sh = [0] * len(block_offsets)
            for j in range(len(sh)):
                this_bs = small_bs if j > n_large else large_bs
                if j == 0:
                    sh[j] = e.location(None, off, e.input_shape)
                else:
                    sh[j] = (sh[j - 1] + block_offsets[j - 1] - block_offsets[j]
                             + this_bs * e.stride[0] * plane)
            for j, corner in enumerate(e.corners):
                location = e.location(corner, off, e.input_shape)
                corner_id = (corner[0] - e.corners[0][0]) // e.stride[0]
                if corner_id < large_bs * n_large:
                    block = corner_id // large_bs
                else:
                    block = n_large + (corner_id - large_bs * n_large) // small_bs
                if location >= 0:
                    selections[block].append(location)
                    mp = location - sh[block]
                    if self.corners_map[j] >= 0 and self.corners_map[j] != mp:
                        raise RuntimeError(
                            f"corner {j} maps to slots {self.corners_map[j]} and {mp}")
                    self.corners_map[j] = mp
            row_masks = []
            for sel in selections:
                if sel:
                    mv = np.zeros(dim)
                    mv[sel] = 1.0
                    row_masks.append(self.factory.get_plain_vector(mv, "dense", 1.0))
                else:
                    row_masks.append(None)
            self.masks.append(row_masks)
            self.shifts.append(sh)
        large_max = 0 if n_large == 0 else (
            plane * (1 + e.stride[0] * (large_bs - 1)) + block_offsets[n_large - 1])
        small_max = plane * (1 + e.stride[0] * (small_bs - 1)) + block_offsets[-1]
        self.output_dim = max(large_max, small_max)
        hot = np.zeros(self.output_dim)
        hot[self.corners_map] = 1.0
        self.hot_indices = hot

    def apply(self, m):
        if m.column_count != 1:
            raise ValueError("expecting a single column")
        v = m.get_column(0)
        cols = [v.permute(masks, shifts, self.output_dim)
                for masks, shifts in zip(self.masks, self.shifts)]
        return self.factory.get_matrix(cols, "col")

    def output_dimension(self):
        return self.output_dim

    def rearrange_weights(self, weights) -> np.ndarray:
        """A downstream dense layer's weights [maps * corners] moved to
        the blocked order: weight (i, j) to slot corners_map[j] of map i's
        output_dim-long row (ref RearrangeWeights)."""
        weights = np.asarray(weights, float)
        corners = len(self.engine.corners)
        maps = len(weights) // corners
        out = np.zeros((maps, self.output_dim))
        out[:, self.corners_map] = weights[: maps * corners].reshape(maps, corners)
        return out.ravel()
