"""Core layers (ref `NeuralNetworks/`), port of `cryptonets_tpu/nn/
layers.py`: EncryptLayer, SquareActivation, PoolLayer (the CryptoNets
conv / dense / mean-pool over SIMD-batched columns), TimingLayer and
DebugLayer."""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.modmatmul import ContractCache
from ..utils import trace
from ..utils.opcount import OPS
from .convolution import ConvolutionEngine
from .network import Layer


class EncryptLayer(Layer):
    """The trust boundary: plaintext Raw matrix -> encrypted matrix,
    preserving scale.  Upstream is the client, downstream ciphertexts."""

    def apply(self, m):
        res = self.factory.get_encrypted_matrix(m.m, "col", scale=1.0)
        # the values in m.m are already scaled integers
        res.register_scale(m.scale)
        return res


class SquareActivation(Layer):
    """x -> x^2 by an elementwise ciphertext multiply."""

    kind = "square"

    def apply(self, m):
        return m.elementwise_multiply(m)

    def get_output_scale(self):
        s = self.source.get_output_scale()
        return s * s


class PoolLayer(Layer):
    """CryptoNets-style conv / dense / mean-pool over column-major,
    SIMD-batched data: column j holds feature j across the batch (ref
    `PoolLayer.cs`).  weights None -> window sum with a scale divide
    (average); else per (map, corner): gather the patch columns, multiply
    by the weight window, add the per-map bias.  Doubles as a dense layer
    via kernel = input shape and a huge stride (`CryptoNets.cs:47-57`)."""

    def __init__(self, source, input_shape, kernel_shape, stride=None,
                 padding=None, upper_padding=None, lower_padding=None,
                 map_count=None, weights=None, bias=None,
                 weights_scale: float = 1.0):
        super().__init__(source)
        self.engine = ConvolutionEngine(
            input_shape, kernel_shape, stride, padding,
            upper_padding, lower_padding, map_count,
        )
        self.weights = None if weights is None else np.asarray(weights, float)
        self.bias = None if bias is None else np.asarray(bias, float)
        self.weights_scale = float(weights_scale)
        self.weight_windows = None
        self.kernel_size = -1
        self._weight_ints = None
        self._bias_forms: dict = {}
        self._gathers: dict = {}      # device index tensors and weights
        self._contract = ContractCache()

    @property
    def kind(self) -> str:
        """"dense" where the kernel covers the input, else "conv"."""
        e = self.engine
        covers = all(k >= i for k, i in zip(e.kernel_shape, e.input_shape))
        return "dense" if covers else "conv"

    def get_output_scale(self):
        if self.weights is None:
            return len(self.engine.offsets) * self.source.get_output_scale()
        return self.weights_scale * self.source.get_output_scale()

    def output_dimension(self):
        count = len(self.engine.corners)
        if self.weights is None:
            return count
        return count * self.engine.maps

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

    def _bias_values(self):
        maps = self.engine.maps
        if self.bias is not None:
            return [self.bias[mi] for mi in range(maps)]
        # bias embedded as the last weight of each window
        return [self.weights[(mi + 1) * self.kernel_size - 1]
                for mi in range(maps)]

    def _element_at(self, m, corner, offset):
        loc = self.engine.location(corner, offset, self.engine.input_shape)
        if loc < 0:  # padding: a free zero vector at the input's scale
            return self.factory.get_zero_vector(m.row_count, m.scale)
        return m.get_column(loc)

    def _weight_matrix(self) -> np.ndarray:
        """The scaled integer weights [maps, offsets] (round half even, as
        the per-element rounding of the reference); made once."""
        if self._weight_ints is None:
            e = self.engine
            W = np.zeros((e.maps, len(e.offsets)), np.int64)
            for mi in range(e.maps):
                for oi, off in enumerate(e.offsets):
                    loc = e.location(None, off, e.kernel_shape,
                                     mi * self.kernel_size)
                    if loc >= 0:
                        W[mi, oi] = int(round(self.weights[loc] * self.weights_scale))
            self._weight_ints = W
        return self._weight_ints

    def _bias_form(self, rowcount: int, bias_scale: float):
        """[P, maps, C, k, N] coefficient residues of the per-map biases,
        replicated over the batch rows; encoded on the host once per batch
        size (the values do not depend on the batch)."""
        key = (rowcount, bias_scale)
        if key not in self._bias_forms:
            f = self.factory
            self._bias_forms[key] = torch.stack([
                f.plain_add_form(
                    np.full(rowcount, round(b * bias_scale), dtype=object),
                    rowcount)
                for b in self._bias_values()
            ], dim=1)
        return self._bias_forms[key]

    def _gather_index(self, locs, device):
        """(columns, zero columns) of a gather as device index tensors,
        made once a layer and device: no host-to-device copy a record."""
        key = (tuple(locs), device)
        if key not in self._gathers:
            pad = [i for i, l in enumerate(locs) if l < 0]
            self._gathers[key] = (
                torch.tensor([max(l, 0) for l in locs], device=device),
                torch.tensor(pad, device=device) if pad else None)
        return self._gathers[key]

    def _reduced_weights(self, device) -> torch.Tensor:
        """The conv's integer weights mod every limb, [maps, O, k, 1]
        int64 on `device`, made once a chain and device."""
        f = self.factory
        key = (f.limb_moduli, device)
        if key not in self._gathers:
            W, e = self._weight_matrix(), self.engine
            wq = [[int(W[mi, oi]) % int(qq) for qq in f.limb_moduli]
                  for mi in range(e.maps) for oi in range(len(e.offsets))]
            self._gathers[key] = torch.tensor(
                wq, dtype=torch.int64, device=device).view(
                    e.maps, len(e.offsets), -1, 1)
        return self._gathers[key]

    def _apply_encrypted(self, m):
        """Batched encrypted conv / dense: forward-NTT the input columns
        once, contract patch columns against the integer weights in the
        NTT domain (the transform commutes with a position-wise sum),
        inverse-NTT, add the biases."""
        from ..api.vector import HEVector
        from ..crypto.modular import RES, wide
        from ..kernels.modmatmul import exact_mod_contract

        e = self.engine
        f = self.factory
        p0 = f.bfv[0].p
        q = p0.chain_q.q
        maps, corners = e.maps, len(e.corners)
        Vin = len(m.vectors)
        OPS.count("plain_multiplication", maps * len(e.offsets))
        Xh = p0.ntt_q.forward(m._stacked_data())        # [P, Vin, C, 2, k, N]

        def gather(locs):
            """Columns `locs` of Xh; a negative entry is a zero column."""
            if locs == list(range(Vin)):
                return Xh                                # read in place
            idx, pad = self._gather_index(locs, Xh.device)
            Xg = Xh.index_select(1, idx)
            return Xg if pad is None else Xg.index_fill_(1, pad, 0)

        if corners == 1:
            # dense layer (kernel == input): one gather of the offset
            # columns and one exact modular contraction over all maps
            Xg = gather([e.location(e.corners[0], off, e.input_shape)
                         for off in e.offsets])
            wc = self._contract.get(f, Xh.device, self._weight_matrix)
            stacked = exact_mod_contract(wc, Xg, f.limb_moduli, q)
        else:
            # conv: per offset one gather of every corner's column, per
            # map a constant multiply; the reduced terms (< 2**31 each)
            # add up exactly in int64 and are reduced once at the end
            wq = self._reduced_weights(Xh.device)        # [maps, O, k, 1]
            accs = [None] * maps
            for oi, off in enumerate(e.offsets):
                Xo = wide(gather([e.location(c, off, e.input_shape)
                                  for c in e.corners]))  # [P, Co, C, 2, k, N]
                for mi in range(maps):
                    term = Xo * wq[mi, oi] % q
                    accs[mi] = term if accs[mi] is None else accs[mi].add_(term)
            stacked = torch.cat([(a % q).to(RES) for a in accs], dim=1)
        out = p0.ntt_q.inverse(stacked)                  # coefficient domain
        col0 = m.vectors[0]
        rowcount = col0.dim
        bias_scale = self.source.get_output_scale() * self.weights_scale
        out = out.reshape(out.shape[0], maps, corners, *out.shape[2:])
        OPS.count("plain_addition", maps)
        out = f.add_plain_data(
            out, self._bias_form(rowcount, bias_scale)[:, :, None])
        return f.get_matrix([
            HEVector(f, data=out[:, mi, ci], dim=rowcount, scale=bias_scale,
                     fmt="dense", is_signed=col0.is_signed)
            for mi in range(maps) for ci in range(corners)
        ], "col")

    def apply(self, m):
        e = self.engine
        if self.weights is None:  # mean pool
            cols = []
            for corner in e.corners:
                agg = None
                for off in e.offsets:
                    el = self._element_at(m, corner, off)
                    agg = el if agg is None else agg.add(el)
                agg.register_scale(agg.scale * len(e.offsets))
                cols.append(agg)
            return self.factory.get_matrix(cols, "col")

        if m.is_encrypted:
            return self._apply_encrypted(m)

        src_scale = self.source.get_output_scale()
        bias_vecs = [
            self.factory.get_plain_vector(
                np.full(m.row_count, b), "dense", src_scale * self.weights_scale)
            for b in self._bias_values()
        ]
        cols = []
        for mi in range(e.maps):
            for corner in e.corners:
                patch = self.factory.get_matrix(
                    [self._element_at(m, corner, off) for off in e.offsets],
                    "col")
                cols.append(patch.mul(self.weight_windows[mi]).add(bias_vecs[mi]))
        return self.factory.get_matrix(cols, "col")


class TimingLayer(Layer):
    """Pass-through with named start/stop counters (ref TimingLayer.cs):
    a counter's start opens a device range of kind "timing" and its stop
    closes it (`utils/trace.py`), so that inside a captured record graph
    the counter times the device work of the layers between, on every
    replay made while tracing is on.  `get_stats` gives each counter's mean
    device ms a replay; outside a graph a counter is a profiler range only
    and adds nothing to it."""

    counters: dict = {}       # counter -> its open range
    names: dict = {}          # every counter of a TimingLayer, in order

    def __init__(self, source=None, start_counters=(), stop_counters=()):
        super().__init__(source)
        self.start_counters = list(start_counters)
        self.stop_counters = list(stop_counters)
        for c in self.start_counters:
            TimingLayer.names[c] = None

    @classmethod
    def reset(cls):
        cls.counters.clear()
        for c in cls.names:
            trace.TABLE.pop(f"range_ms.{c}", None)
            trace.TABLE.pop(f"range_n.{c}", None)

    @classmethod
    def get_stats(cls, multi_lines: bool = False) -> str:
        sep = "\n" if multi_lines else "\t"
        t = trace.TABLE
        return sep.join(f"{c} {t[f'range_ms.{c}'] / t[f'range_n.{c}']:0.2f}"
                        for c in cls.names if t[f"range_n.{c}"])

    def apply(self, m):
        for c in self.start_counters:
            r = trace.device_range(c, "timing")
            r.__enter__()
            TimingLayer.counters[c] = r
        for c in self.stop_counters:
            r = TimingLayer.counters.pop(c, None)
            if r is not None:
                r.__exit__(None, None, None)
        return m


class DebugLayer(Layer):
    """Pass-through tap that calls `callback` on the flowing matrix (ref
    `CaltechTests.cs` DebugLayer)."""

    def __init__(self, source=None, callback=None):
        super().__init__(source)
        self.callback = callback

    def apply(self, m):
        if self.callback is not None:
            self.callback(m)
        return m
