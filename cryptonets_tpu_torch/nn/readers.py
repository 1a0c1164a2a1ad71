"""Input readers, port of `cryptonets_tpu/nn/readers.py`: `BatchReader`
(ref `BatchReader.cs`: up to max_slots records per get_next, the batch in
the matrix rows, which become the SIMD slots), `LLSingleLineReader` (ref
`LLSingleLineReader.cs`: one record per get_next as a one-column matrix),
`LLConvReader` (ref `LLConvReader.cs`: one record per get_next,
pre-arranged on the client into the corners x offsets patch matrix,
im2col before encryption), and `WeightsReader` (ref `WeightsReader.cs`:
a model's weights and biases from two local CSV files).

Record format (TSV): sparse = "label dim idx:val idx:val ..."; dense =
one value per column with the label at `label_column`."""

from __future__ import annotations

import numpy as np

from ..api.raw import RawMatrix
from .convolution import ConvolutionEngine
from .network import InputLayer


def _parse_line(line: str, sparse: bool, label_column: int, norm: float):
    f = line.rstrip("\n").split("\t")
    if sparse:
        label = int(f[0])
        features = np.zeros(int(f[1]))
        for tok in f[2:]:
            i, v = tok.split(":")
            features[int(i)] = float(v) * norm
        return label, features
    if label_column >= len(f):
        return np.iinfo(np.int32).max, np.asarray([float(x) for x in f]) * norm
    vals = [float(x) for i, x in enumerate(f) if i != label_column]
    return int(f[label_column]), np.asarray(vals) * norm


class BatchReader(InputLayer):
    """Reads up to max_slots records; the batch becomes the matrix ROWS
    (SIMD slots after encryption) with the features as columns."""

    def __init__(
        self,
        factory,
        file_name: str | None = None,
        max_slots: int = 0,
        normalization_factor: float = 1.0,
        scale: float = 1.0,
        sparse_format: bool = True,
        label_column: int = 0,
    ):
        super().__init__(None, factory)
        self.file_name = file_name
        self.max_slots = max_slots
        self.normalization_factor = normalization_factor
        self.scale = scale
        self.sparse_format = sparse_format
        self.label_column = label_column
        self.labels = []
        self._records = None
        self._lines = None

    def set_source_records(self, records):
        """Inject (label, features) records instead of reading a file."""
        self._records = list(records)
        return self

    def _read_rows(self):
        if self._records is not None:
            take = self._records[: self.max_slots]
            self._records = self._records[self.max_slots :]
            return [(lb, np.asarray(f) * self.normalization_factor)
                    for lb, f in take]
        if self._lines is None:
            with open(self.file_name) as fh:
                self._lines = fh.readlines()
        take = self._lines[: self.max_slots]
        self._lines = self._lines[self.max_slots :]
        return [_parse_line(line, self.sparse_format, self.label_column,
                            self.normalization_factor) for line in take]

    def get_next(self):
        rows = self._read_rows()
        if not rows:
            return None
        self.labels = [r[0] for r in rows]
        mat = np.stack([r[1] for r in rows])  # [batch, features]
        return RawMatrix(mat, self.scale, "col", 0)

    def output_dimension(self):
        return -1

    def get_output_scale(self):
        return self.scale


class LLSingleLineReader(InputLayer):
    """One record per get_next as a single-column matrix."""

    def __init__(
        self,
        factory,
        file_name: str | None = None,
        normalization_factor: float = 1.0,
        scale: float = 1.0,
        sparse_format: bool = True,
        label_column: int = 0,
    ):
        super().__init__(None, factory)
        self.file_name = file_name
        self.normalization_factor = normalization_factor
        self.scale = scale
        self.sparse_format = sparse_format
        self.label_column = label_column
        self.labels = []
        self.dim = -1
        self._records = None
        self._lines = None

    def set_source_records(self, records):
        """Inject (label, features) records instead of reading a file."""
        self._records = list(records)
        return self

    def _next_record(self):
        if self._records is not None:
            if not self._records:
                return None
            label, feats = self._records.pop(0)
            return label, np.asarray(feats) * self.normalization_factor
        if self._lines is None:
            with open(self.file_name) as fh:
                self._lines = fh.readlines()
        if not self._lines:
            return None
        return _parse_line(self._lines.pop(0), self.sparse_format,
                           self.label_column, self.normalization_factor)

    def get_next(self):
        rec = self._next_record()
        if rec is None:
            return None
        label, features = rec
        self.labels = [label]
        self.dim = len(features)
        return self.factory.get_plain_matrix(
            features.reshape(-1, 1), "col", self.scale)

    def output_dimension(self):
        return self.dim

    def get_output_scale(self):
        return self.scale


class LLConvReader(InputLayer):
    def __init__(
        self,
        factory,
        input_shape,
        kernel_shape,
        stride=None,
        padding=None,
        upper_padding=None,
        lower_padding=None,
        file_name: str | None = None,
        normalization_factor: float = 1.0,
        scale: float = 1.0,
        sparse_format: bool = True,
        label_column: int = 0,
    ):
        super().__init__(None, factory)
        self.engine = ConvolutionEngine(
            input_shape, kernel_shape, stride, padding,
            upper_padding, lower_padding,
        )
        self.file_name = file_name
        self.normalization_factor = normalization_factor
        self.scale = scale
        self.sparse_format = sparse_format
        self.label_column = label_column
        self.labels = []
        self._records = None
        self._lines = None

    def set_source_records(self, records):
        """Inject (label, features) records instead of reading a file."""
        self._records = list(records)
        return self

    def _next_record(self):
        if self._records is not None:
            if not self._records:
                return None
            label, feats = self._records.pop(0)
            return label, np.asarray(feats) * self.normalization_factor
        if self._lines is None:
            with open(self.file_name) as fh:
                self._lines = fh.readlines()
        if not self._lines:
            return None
        return _parse_line(self._lines.pop(0), self.sparse_format,
                           self.label_column, self.normalization_factor)

    def get_next(self):
        rec = self._next_record()
        if rec is None:
            return None
        label, features = rec
        self.labels = [label]
        e = self.engine
        mat = np.zeros((len(e.corners), len(e.offsets)))
        for c, corner in enumerate(e.corners):
            for o, off in enumerate(e.offsets):
                loc = e.location(corner, off, e.input_shape)
                if loc >= 0:
                    mat[c, o] = features[loc]
        return RawMatrix(mat, self.scale, "col", 0)

    def output_dimension(self):
        return len(self.engine.corners) * len(self.engine.offsets)

    def get_output_scale(self):
        return self.scale


class WeightsReader:
    """CSV weights and biases -> one float array per non-empty line of
    each file (a layer per line)."""

    def __init__(self, weights_csv_path: str, biases_csv_path: str):
        self.weights = self._read(weights_csv_path)
        self.biases = self._read(biases_csv_path)

    @staticmethod
    def _read(path: str) -> list[np.ndarray]:
        out = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(np.array([float(x) for x in line.split(",")]))
        return out
