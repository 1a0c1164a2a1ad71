"""The Caltech-101 oracle model taken from the reference's generated
scorer, port of `cryptonets_tpu/data/testnetwork.py`.

`NeuralNetworksTest/TestNetwork.cs` of the upstream project is a generated
file with one hard-coded linear expression per class, the first ten
classes only: `score[b] = c0*f[0] + ... + c4095*f[4095] + bias;`.  It is
the independent end-to-end oracle of the Caltech linear model; the model
file itself (cal.model.ini) is missing upstream.

`parse_testnetwork` reads those expressions into a [10, 4096] weight
matrix and a [10] bias, `write_model_ini` emits them in the INI format
`models/caltech101.IniReader` parses, `score` is the oracle, and `load`
reads the extracted arrays from the JAX package's data directory
(`cryptonets_tpu/data/weights/caltech_oracle.npz`, by path).

CLI: python -m cryptonets_tpu_torch.data.testnetwork <TestNetwork.cs> <out.npz>
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from .weights_extract import WEIGHTS_DIR

N_FEATURES = 4096
N_ORACLE_CLASSES = 10

_NPZ = os.path.join(WEIGHTS_DIR, "caltech_oracle.npz")

_TERM = re.compile(
    r"(?P<coef>[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*\*\s*"
    r"f\[(?P<idx>[0-9]+)\]"
)
_LINE = re.compile(r"score\[(?P<cls>[0-9]+)\]\s*=\s*(?P<body>.*?);",
                   re.DOTALL)


def parse_testnetwork(path: str):
    """-> (W [10, 4096] float64, bias [10] float64)."""
    with open(path) as fh:
        text = fh.read()
    W = np.zeros((N_ORACLE_CLASSES, N_FEATURES))
    bias = np.zeros(N_ORACLE_CLASSES)
    n_lines = 0
    for m in _LINE.finditer(text):
        cls = int(m.group("cls"))
        body = m.group("body")
        n_lines += 1
        for t in _TERM.finditer(body):
            W[cls, int(t.group("idx"))] = float(t.group("coef"))
        # the trailing constant (no *f[..] factor) is the bias
        tail = body.rsplit("+", 1)[-1].strip()
        if "f[" not in tail:
            bias[cls] = float(tail)
    if n_lines != N_ORACLE_CLASSES:
        raise ValueError(f"{path}: {n_lines} score lines, expected "
                         f"{N_ORACLE_CLASSES}")
    return W, bias


def score(W: np.ndarray, bias: np.ndarray, f: np.ndarray) -> np.ndarray:
    """The oracle: W f + bias in float64."""
    return W @ np.asarray(f, dtype=np.float64) + bias


def write_model_ini(path: str, W: np.ndarray, bias: np.ndarray) -> None:
    """Emit the model in the INI line format.  Zero coefficients are
    left out: absent entries stay zero in the parser."""
    with open(path, "w") as fh:
        fh.write("[Model]\n")
        for c in range(W.shape[0]):
            fh.write(f"Class_{c}+(Bias)\t{float(bias[c]):.17g}\n")
            for i in np.nonzero(W[c])[0]:
                fh.write(f"Class_{c}+f{i}\t{float(W[c, i]):.17g}\n")


def load():
    """-> (W, bias) from the extracted npz, or None if absent."""
    if not os.path.exists(_NPZ):
        return None
    with np.load(_NPZ) as z:
        return z["W"], z["bias"]


def main():
    src, out = sys.argv[1], sys.argv[2]
    W, bias = parse_testnetwork(src)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, W=W, bias=bias)
    print(f"{out}: W{W.shape} ({int((W != 0).sum())} nonzero), "
          f"bias {bias.shape}")


if __name__ == "__main__":
    main()
