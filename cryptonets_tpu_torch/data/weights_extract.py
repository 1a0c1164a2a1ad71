"""Model parameters of the reference, read as npz data; port of
`cryptonets_tpu/data/weights_extract.py`.

The reference ships its trained CryptoNets and LoLa MNIST models as C#
double literals (`CryptoNets/Weights.cs`, `LowLatencyCryptoNets/
SmallModel.cs`).  `extract(reference_root, out_dir)` parses those arrays
(`_parse_array`) and writes one npz a model into `out_dir`, as the JAX
package's `extract` does.  The extracted weights the port's models read
live in the JAX package's data directory (`WEIGHTS_DIR`,
`cryptonets_tpu/data/weights/*.npz`); the port reads those files by path
and imports nothing of that package.  `out_dir` has no default: an
extract into `WEIGHTS_DIR` would rewrite the reference's files.

Usage: python -m cryptonets_tpu_torch.data.weights_extract REFERENCE_ROOT OUT_DIR
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "cryptonets_tpu", "data", "weights",
)

# model -> (C# source under the reference's root, its arrays)
_ARRAYS = {
    "cryptonets": (
        "CryptoNets/Weights.cs",
        ["Weights_0", "Weights_1", "Weights_3", "Biases_2", "Biases_3"],
    ),
    "lola_small": (
        "LowLatencyCryptoNets/SmallModel.cs",
        ["Weights_0", "Weights_1", "Biases_1"],
    ),
}


def _parse_array(src: str, name: str) -> np.ndarray:
    """The C# property `name { get; } = new double[] { ... }` of `src` as
    float64 values (nested braces and // comments allowed)."""
    m = re.search(rf"{name}\s*{{\s*get;\s*}}\s*=\s*new double\[\]\s*{{", src)
    if m is None:
        raise KeyError(name)
    i = j = m.end()
    depth = 1
    while depth:
        if src[j] == "{":
            depth += 1
        elif src[j] == "}":
            depth -= 1
        j += 1
    body = re.sub(r"//[^\n]*", "", src[i:j - 1])
    return np.asarray([float(v) for v in re.split(r"[\s,]+", body) if v],
                      dtype=np.float64)


def extract(reference_root: str, out_dir: str) -> dict:
    """Parse every model of `_ARRAYS` under `reference_root` and write
    `out_dir`/<model>.npz (compressed); returns each array's shape by
    model."""
    if os.path.abspath(out_dir) == os.path.abspath(WEIGHTS_DIR):
        raise ValueError("extract would rewrite the JAX package's weights: "
                         "name another out_dir")
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for model, (rel, names) in _ARRAYS.items():
        with open(os.path.join(reference_root, rel), encoding="utf-8-sig") as fh:
            src = fh.read()
        arrs = {n: _parse_array(src, n) for n in names}
        np.savez_compressed(os.path.join(out_dir, f"{model}.npz"), **arrs)
        written[model] = {n: a.shape for n, a in arrs.items()}
    return written


def load(model: str) -> dict | None:
    """Load the extracted weights of `model`; None if absent."""
    path = os.path.join(WEIGHTS_DIR, f"{model}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def synthetic_weights(shapes: dict, seed: int = 0) -> dict:
    """Seeded stand-in weights (~N(0, 0.05)) for models whose blobs are
    missing upstream."""
    rng = np.random.default_rng(seed)
    return {
        k: rng.normal(0, 0.05, size=v).astype(np.float64)
        for k, v in shapes.items()
    }


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit("usage: python -m cryptonets_tpu_torch.data.weights_extract "
                 "REFERENCE_ROOT OUT_DIR")
    for model, arrs in extract(sys.argv[1], sys.argv[2]).items():
        print(model, arrs)
