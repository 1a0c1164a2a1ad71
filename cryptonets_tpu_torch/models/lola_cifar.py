"""LoLa CIFAR-10 (ref `CifarCryptoNet/LolaCifarCryptoNet.cs`), port of
`cryptonets_tpu/models/lola_cifar.py`: a 3x32x32 image -> 8x8 stride-2
conv (83 maps, one exact contraction) -> Vectorize (83 pieces at stride
196) -> Square -> the 10x10 stride-2 pad-4 conv (112 maps) as a forced
dense 5488 x 16268 layer through BSGS (F = 2, chained babies) -> Square ->
Dense(10) over the 5488 outputs (per-row dots), over the `cifar` preset
(n = 16384, thirteen data limbs, one special prime, three ~30-bit plain
primes).  Under `cifar_bigt` (the reference's two plain primes near
2**40, encoded on the host) the conv-as-dense runs as 5488 per-row dots
with a forced dense output instead of BSGS.  The upstream weight blob (CifarWeight.csv) is missing: the
weights are the reference's seeded stand-ins unless two CSV files are
given.

CLI: python -m cryptonets_tpu_torch.models.lola_cifar [-e] [--records K]
     [--preset cifar|cifar_bigt] [--data FILE] [--weights-csv W
     --bias-csv B] [--device cpu] [--no-graph]
(each record one CUDA graph replay on the card unless `--no-graph` or
`-v` is given)
It runs on the card unless `--device cpu` is given; run the encrypted
network on a GPU only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..data import weights_extract
from ..data.preprocess import synthetic_cifar_records
from ..nn.convolution import ConvolutionEngine
from ..nn.forward import evaluation_forward
from ..nn.layers import EncryptLayer, SquareActivation
from ..nn.lola import LLDenseLayer, LLPoolLayer, LLVectorizeLayer
from ..nn.readers import LLConvReader, WeightsReader
from .presets import make_factory

GEOMETRY = dict(input_shape=[3, 32, 32], kernel_shape=[3, 8, 8],
                upper_padding=[0, 1, 1], lower_padding=[0, 1, 1],
                stride=[1000, 2, 2])


def cifar_weights(weights_csv=None, bias_csv=None):
    """(w0, b0, w1, b1, w2, b2): from the two local CSV files, else the
    reference's seeded stand-ins (seed 3)."""
    if weights_csv and bias_csv:
        wr = WeightsReader(weights_csv, bias_csv)
        return tuple(np.asarray(a) for i in range(3)
                     for a in (wr.weights[i], wr.biases[i]))
    syn = weights_extract.synthetic_weights({
        "w0": 83 * 3 * 64, "b0": 83,
        "w1": 112 * 83 * 100, "b1": 112,
        # the dense head over the conv-as-dense output: 112 maps x 7x7
        # windows = 5488 inputs
        "w2": 10 * 112 * 49, "b2": 10,
    }, seed=3)
    return tuple(syn[k] for k in ("w0", "b0", "w1", "b1", "w2", "b2"))


def build(encrypt: bool = True, records=None, file_name=None, seed: int = 0,
          weights_csv=None, bias_csv=None, device=None, keys=None,
          ntt_impl: str | None = None, preset: str = "cifar"):
    """(head, factory, reader) of LoLa-CIFAR over `preset` ("cifar" or
    "cifar_bigt").  The factory carries a single-hop Galois key for -196
    (14 x 14 windows a conv map), so the 83-piece Vectorize runs its
    uniform runs as Horner loops."""
    factory = make_factory(
        preset, encrypt, seed, device=device, ntt_impl=ntt_impl,
        rot_steps=(-196,),
        **({"keys": keys} if encrypt and keys is not None else {}),
    )
    w0, b0, w1, b1, w2, b2 = cifar_weights(weights_csv, bias_csv)
    reader = LLConvReader(
        make_factory(preset, False), file_name=file_name, sparse_format=False,
        normalization_factor=1.0 / 256.0, scale=8.0, **GEOMETRY,
    )
    if records is not None:
        reader.set_source_records(records)
    enc = EncryptLayer(reader)
    enc.factory = factory
    conv1 = LLPoolLayer(enc, map_count=[83, 1, 1], weights=w0, bias=b0,
                        weights_scale=256.0, **GEOMETRY)
    act3 = SquareActivation(LLVectorizeLayer(conv1))
    engine = ConvolutionEngine(
        input_shape=[83, 14, 14], kernel_shape=[83, 10, 10],
        upper_padding=[0, 4, 4], lower_padding=[0, 4, 4], stride=[83, 2, 2],
        map_count=[112, 1, 1],
    )
    dense4 = LLDenseLayer(
        act3, weights=engine.get_dense_weights(w1).ravel(),
        bias=engine.get_dense_bias(b1), weights_scale=512.0,
        input_format="dense", force_dense_format=True,
    )
    act5 = SquareActivation(dense4)
    dense6 = LLDenseLayer(act5, weights=w2, bias=b2, weights_scale=512.0,
                          input_format="dense")
    return dense6, factory, reader


def evaluate(encrypt=True, n_records=1, records=None, file_name=None,
             seed=0, device=None, weights_csv=None, bias_csv=None,
             preset="cifar", verbose=False, graph=None):
    """Run records through the network; report the latency of each
    prediction and the errors against the reader's labels; `verbose`
    prints each layer's report (`Layer.forward`)."""
    if records is None and file_name is None:
        records = synthetic_cifar_records(n_records, seed=4)
    head, factory, reader = build(
        encrypt, records=records, file_name=file_name, seed=seed,
        weights_csv=weights_csv, bias_csv=bias_csv, device=device,
        preset=preset)
    if verbose:
        head.set_verbose(True)
    head.prepare_network()
    run = evaluation_forward(head, graph, verbose) if encrypt else None
    errs = 0
    latencies = []
    for i in range(n_records):
        t0 = time.time()
        m = run() if run is not None else head.get_next()
        if m is None:
            break
        dec = m.get_column(0).decrypt()
        latencies.append(time.time() - t0)
        pred = int(np.argmax(dec[:10]))
        label = reader.labels[0]
        errs += int(pred != label)
        print(f"errs {errs}/{i + 1} accuracy "
              f"{100 - 100.0 * errs / (i + 1):0.3f}% "
              f"latency {latencies[-1]:0.3f}s prediction {pred} label {label}")
    return dict(errs=errs, count=len(latencies), latencies=latencies)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-e", "--encrypt", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--records", type=int, default=1)
    ap.add_argument("--preset", default="cifar", choices=("cifar", "cifar_bigt"))
    ap.add_argument("--data", default=None, help="dense CSV/TSV test file")
    ap.add_argument("--weights-csv", default=None)
    ap.add_argument("--bias-csv", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a GPU) or cpu")
    ap.add_argument("--no-graph", action="store_true",
                    help="run each record eagerly, a launch a kernel, not as "
                         "one CUDA graph replay")
    args = ap.parse_args()
    evaluate(encrypt=args.encrypt, n_records=args.records,
             file_name=args.data, device=args.device,
             weights_csv=args.weights_csv, bias_csv=args.bias_csv,
             preset=args.preset, verbose=args.verbose,
             graph=False if args.no_graph else None)


if __name__ == "__main__":
    main()
