"""Decrypt-and-print debug helpers (ref `HE Wrapper/Utils.cs:102-122`
Show/Dump), port of `cryptonets_tpu/utils/debug.py`: peek at an
encrypted matrix or vector flowing through a network, in the reference's
tab-separated 4-decimal format."""

from __future__ import annotations

import numpy as np


def _rows(m) -> np.ndarray:
    return np.atleast_2d(np.asarray(m.decrypt(), dtype=float))


def _row_to_string(row) -> str:
    return "\t".join(f"{x:,.4f}" for x in row)


def show(m) -> None:
    """Decrypt `m` (HEMatrix, HEVector, RawMatrix) and print a row a line."""
    for row in _rows(m):
        print(_row_to_string(row))


def dump(file_name: str, m) -> None:
    """Decrypt `m` and write its rows to `file_name`, a row a line."""
    with open(file_name, "w") as f:
        for row in _rows(m):
            f.write(_row_to_string(row) + "\n")
