"""Caltech-101 (ref `Caltech101/Caltech101.cs`): an encrypted linear head
(102 classes) over 4096 AlexNet features, port of
`cryptonets_tpu/models/caltech101.py`.  The model comes from an INI file
parsed by regular expression, with an optional affine normalisation (ref
`IniReader.cs`); the upstream model file is missing, so seeded synthetic
parameters stand in unless files are given.

Single-line reader -> Encrypt -> Dense(102, per-row dots over SumAllSlots
ladders) over the `caltech` preset (n = 4096, three limbs, digit key
switching), under either NTT.

CLI: python -m cryptonets_tpu_torch.models.caltech101 [--records K]
     [--data FILE] [--model-ini FILE] [--affine FILE] [--no-encrypt]
     [--ntt butterfly|matmul] [--device cpu] [--no-graph]
(each record one CUDA graph replay on the card unless `--no-graph`)
It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import re
import time

import numpy as np

from ..data import weights_extract
from ..data.preprocess import synthetic_feature_records
from ..nn.forward import evaluation_forward
from ..nn.layers import EncryptLayer
from ..nn.lola import LLDenseLayer
from ..nn.readers import LLSingleLineReader
from .presets import make_factory

N_FEATURES = 4096
N_CLASSES = 102

_INI_PATTERN = re.compile(
    r"Class_(?P<cls>[0-9]+)\+(?P<feature>\(Bias\)|f[0-9]+)\t"
    r"(?P<weight>[-+]?[0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?)"
)


class IniReader:
    """Parser of the Caltech linear model's INI lines,
    `Class_<c>+f<i>\\t<w>` and `Class_<c>+(Bias)\\t<w>`."""

    def __init__(self, file_name: str, n_features: int, n_outputs: int):
        self.weights = np.zeros(n_features * n_outputs)
        self.bias = np.zeros(n_outputs)
        self.n_features = n_features
        with open(file_name) as fh:
            for line in fh:
                m = _INI_PATTERN.search(line)
                if not m:
                    continue
                w = float(m.group("weight"))
                cls = int(m.group("cls"))
                feat = m.group("feature")
                if feat == "(Bias)":
                    self.bias[cls] = w
                else:
                    self.weights[cls * n_features + int(feat[1:])] = w

    def normalize_factors(self, factors: np.ndarray):
        f = np.asarray(factors)
        reps = -(-len(self.weights) // len(f))
        self.weights *= np.tile(f, reps)[: len(self.weights)]

    def normalize(self, affine_file: str):
        """Scale by column 2 of each line after the header."""
        with open(affine_file) as fh:
            lines = fh.read().splitlines()[1:]
        self.normalize_factors(
            np.array([float(ln.split()[2]) for ln in lines if ln.strip()]))


def build(encrypt: bool = True, records=None, file_name=None, seed: int = 0,
          model_ini=None, affine_file=None, device=None, keys=None,
          ntt_impl: str | None = None):
    """(head, factory, reader) of the Caltech-101 linear head.
    encrypt=False builds the Raw oracle; `keys` imports a key set."""
    factory = make_factory(
        "caltech", encrypt, seed, device=device, ntt_impl=ntt_impl,
        **({"keys": keys} if encrypt and keys is not None else {}),
    )
    if model_ini:
        ini = IniReader(model_ini, N_FEATURES, N_CLASSES)
        if affine_file:
            ini.normalize(affine_file)
        weights, bias = ini.weights, ini.bias
    else:
        syn = weights_extract.synthetic_weights(
            {"w": N_FEATURES * N_CLASSES, "b": N_CLASSES}, seed=5)
        weights, bias = syn["w"], syn["b"]
    reader = LLSingleLineReader(
        make_factory("caltech", False), file_name=file_name,
        normalization_factor=1.0, scale=256.0,
    )
    if records is not None:
        reader.set_source_records(records)
    enc = EncryptLayer(reader)
    enc.factory = factory
    dense = LLDenseLayer(enc, weights=weights, bias=bias, weights_scale=256.0,
                         input_format="dense")
    return dense, factory, reader


def evaluate(encrypt=True, n_records=5, records=None, file_name=None, seed=0,
             graph=None, **build_kw):
    """Run records through the head; report each prediction's latency
    (encryption included) and the errors against the labels."""
    if records is None and file_name is None:
        records = synthetic_feature_records(n_records, N_FEATURES, seed=6)
    head, factory, reader = build(
        encrypt, records=records, file_name=file_name, seed=seed, **build_kw)
    head.prepare_network()
    run = evaluation_forward(head, graph) if encrypt else None
    errs = 0
    latencies = []
    for i in range(n_records):
        t0 = time.time()
        m = run() if run is not None else head.get_next()
        if m is None:
            break
        dec = m.get_column(0).decrypt()
        latencies.append(time.time() - t0)
        pred = int(np.argmax(dec[:N_CLASSES]))
        label = reader.labels[0]
        errs += int(pred != label)
        print(f"errs {errs}/{i + 1} accuracy {100 - 100.0 * errs / (i + 1):0.3f}% "
              f"Prediction+Encryption {1000 * latencies[-1]:0.0f}ms "
              f"prediction {pred} label {label}")
    return dict(errs=errs, count=len(latencies), latencies=latencies)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--records", type=int, default=5)
    ap.add_argument("--data", default=None)
    ap.add_argument("--model-ini", default=None)
    ap.add_argument("--affine", default=None)
    ap.add_argument("--no-encrypt", action="store_true")
    ap.add_argument("--ntt", default=None, choices=("butterfly", "matmul"),
                    help="NTT of the ciphertext chain (default butterfly)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a GPU) or cpu")
    ap.add_argument("--no-graph", action="store_true",
                    help="run each record eagerly, a launch a kernel, not as "
                         "one CUDA graph replay")
    args = ap.parse_args()
    evaluate(
        encrypt=not args.no_encrypt, n_records=args.records,
        file_name=args.data, model_ini=args.model_ini,
        affine_file=args.affine, device=args.device, ntt_impl=args.ntt,
        graph=False if args.no_graph else None)


if __name__ == "__main__":
    main()
