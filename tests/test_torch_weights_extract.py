"""`data/weights_extract.extract` and `_parse_array` of the port against
the JAX package's, on C# double literals written here (the reference's
sources are not in the repository), in a temporary tree laid out as
`_ARRAYS` names the files: every npz equal key for key, every parse equal
value for value; the port refuses to write into the JAX package's
weights directory and has no default `out_dir`."""

import os

import numpy as np
import pytest

from cryptonets_tpu.data import weights_extract as jwe
from cryptonets_tpu_torch.data import weights_extract as twe

TRICKY = """
namespace CryptoNets {
    // trained weights; a comment with { braces }
    public static class Weights {
        public static double[] Weights_0 { get; } = new double[] {
            0.125, -1.5e-3, 2E+2, // row 0 { not a brace }
            -0.0, 3,
            7.25e-17
        };
        public static double[] Biases_2 { get; } = new double[] { -1, 1 };
    }
}
"""


def _literal(name, values) -> str:
    body = ",\n            ".join(", ".join(repr(float(v)) for v in values[i:i + 7])
                                   for i in range(0, len(values), 7))
    return (f"        public static double[] {name} {{ get; }} = new double[]\n"
            f"        {{\n            {body}\n        }};\n")


@pytest.fixture(scope="module")
def reference_tree(tmp_path_factory):
    """A reference root with the two C# files of `_ARRAYS`, seeded values."""
    root = tmp_path_factory.mktemp("reference")
    rng = np.random.default_rng(17)
    assert twe._ARRAYS == jwe._ARRAYS
    for model, (rel, names) in twe._ARRAYS.items():
        src = "// generated\nnamespace M {\n    public static class W {\n"
        for name in names:
            src += _literal(name, rng.normal(0, 0.05, rng.integers(3, 40)))
        src += "    }\n}\n"
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("﻿" + src, encoding="utf-8")   # with a BOM, as C# files
    return str(root)


def test_parse_array_equals_the_reference():
    for name in ("Weights_0", "Biases_2"):
        got, want = twe._parse_array(TRICKY, name), jwe._parse_array(TRICKY, name)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twe._parse_array(TRICKY, "Weights_0"),
                                  [0.125, -1.5e-3, 200.0, -0.0, 3.0, 7.25e-17])
    for mod in (twe, jwe):
        with pytest.raises(KeyError):
            mod._parse_array(TRICKY, "Weights_9")


def test_extract_writes_the_references_npz(reference_tree, tmp_path):
    ours, theirs = tmp_path / "torch", tmp_path / "jax"
    got = twe.extract(reference_tree, str(ours))
    want = jwe.extract(reference_tree, str(theirs))
    assert got == want
    for model in twe._ARRAYS:
        with np.load(ours / f"{model}.npz") as a, np.load(theirs / f"{model}.npz") as b:
            assert sorted(a.files) == sorted(b.files) == sorted(twe._ARRAYS[model][1])
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_extract_never_writes_the_jax_packages_weights(reference_tree):
    before = {f: os.path.getmtime(os.path.join(twe.WEIGHTS_DIR, f))
              for f in os.listdir(twe.WEIGHTS_DIR)}
    with pytest.raises(ValueError, match="JAX package"):
        twe.extract(reference_tree, twe.WEIGHTS_DIR)
    with pytest.raises(TypeError):
        twe.extract(reference_tree)
    assert before == {f: os.path.getmtime(os.path.join(twe.WEIGHTS_DIR, f))
                      for f in os.listdir(twe.WEIGHTS_DIR)}
