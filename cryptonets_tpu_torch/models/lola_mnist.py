"""The LoLa MNIST networks, one image per record (ref
`LowLatencyCryptoNets/LoLaCryptonets.cs`): port of
`cryptonets_tpu/models/lola_mnist.py`.

`build_lola_bsgs` ("LoLa"): Conv (5 maps) -> Vectorize -> Square ->
Dense(100, hoisted BSGS, g=64) -> Square -> Dense(10, hoisted BSGS, g=32)
over the `lola` preset with RNS-group key switching without special primes
(ks_alpha=1).  The same weights and fixed-point scales as the reference's
LoLa (`LoLaCryptonets.cs:203-278`), so the same logits as the Raw oracle.
It needs the butterfly NTT (hoisted baby steps).

`build_lola` ("LoLaPacked", `LoLaCryptonets.cs:203-278`): the reference's
own packing of the same model, Conv -> Vectorize -> Square ->
Duplicate(8) -> PackedDense(100, shift 1024) -> Interleave(-1) -> Square
-> InterleavedDense(10), over the `lola` preset (digit key switching at
dbc=8) with the default power-of-two Galois keys.

`build_lola_large` ("LoLaLarge", `LoLaCryptonets.cs:332-410`), n = 16384:
8x8 stride-2 conv (83 maps) -> Vectorize (83 pieces at stride 144) ->
Square -> conv-as-dense(2608, BSGS with chained babies) -> Square ->
Dense(10, per-row dots) over the `lola_large` preset (eleven data limbs,
three special primes).  Seeded synthetic weights unless CSVs are given.
Under `lola_large_bigt` (the reference's three plain primes just above
2**31, encoded on the host) the conv-as-dense runs as 2608 per-row dots
with a forced dense output instead of BSGS.

`build_lola_dense` ("LoLaDense", `LoLaCryptonets.cs:118-201`), n = 16384:
the server-side im2col variant: the dense image (one ciphertext) ->
PreConv (25 permutes of 4 blocks) -> Conv (5 maps) -> Vectorize -> Square
-> Duplicate(16) -> PackedDense(100, shift 1024) -> Interleave(-1) ->
Square -> InterleavedDense(10), over the `lola_dense` preset (plain primes
near 2**35: host encode, two-plane decrypt; twelve data limbs and two
special primes) on the real weights.

`build_lola_small` ("LoLaSmall", `LoLaCryptonets.cs:280-329`): Conv ->
Vectorize -> Square -> Dense(10, per-row dots over SumAllSlots ladders)
over the `lola_small` preset (hybrid key switching, two special primes),
under either NTT.

CLI: python -m cryptonets_tpu_torch.models.lola_mnist
     -n LoLa|LoLaPacked|LoLaSmall|LoLaLarge|LoLaDense [-e]
     [--ntt butterfly|matmul] [--preset lola_large|lola_large_bigt]
     [--records K] [--data FILE] [--device cpu] [--no-graph]
It runs on the card unless `--device cpu` is given, each record as one
CUDA graph replay unless `--no-graph` (or `-v`) is given; run a full-width
encrypted network on a GPU only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..convert import weights_from_numpy
from ..data import weights_extract
from ..data.preprocess import synthetic_mnist_records
from ..nn.forward import evaluation_forward
from ..nn.layers import EncryptLayer, SquareActivation
from ..nn.convolution import ConvolutionEngine
from ..nn.lola import (
    LLDenseLayer,
    LLPreConvLayer,
    LLDuplicateLayer,
    LLInterleavedDenseLayer,
    LLInterleaveLayer,
    LLPackedDenseLayer,
    LLPoolLayer,
    LLVectorizeLayer,
)
from ..nn.readers import LLConvReader, LLSingleLineReader, WeightsReader
from .presets import make_factory

# single-hop Galois keys: baby steps 1..63, the Vectorize strides
# (rotate right by 169*k for the conv maps), and the giant hops of the two
# sparse-support BSGS layers (3136 = 64*(62-13), 3968 = 32*(127-3))
LOLA_ROT_STEPS = tuple(range(1, 64)) + (-169, -338, -507, -676, 3136, 3968)


def transpose_flat(weights, input_size: int, out_maps: int) -> np.ndarray:
    """[input_size*out_maps] row-major [in, out] -> [out, in] flat."""
    w = np.asarray(weights, float).reshape(input_size, out_maps)
    return w.T.ravel()


def _mnist_geometry():
    return dict(input_shape=[28, 28], kernel_shape=[5, 5],
                upper_padding=[1, 1], stride=[2, 2])


def load_cryptonets_weights() -> dict:
    w = weights_extract.load("cryptonets")
    if w is None:
        w = weights_extract.synthetic_weights({
            "Weights_0": 130, "Weights_1": 84500, "Weights_3": 1000,
            "Biases_2": 100, "Biases_3": 10,
        })
    return weights_from_numpy(w)


def build_lola_bsgs(encrypt: bool, records=None, file_name=None, seed: int = 0,
                    device=None, weights: dict | None = None, keys=None,
                    ntt_impl: str | None = None):
    """(head, factory, reader) of LoLa with hoisted-BSGS dense layers.

    encrypt=False builds the Raw oracle.  `weights` defaults to the real
    `cryptonets.npz`; `keys` imports a key set instead of keygen."""
    factory = make_factory(
        "lola", encrypt, seed, device=device, ntt_impl=ntt_impl,
        rot_steps=LOLA_ROT_STEPS, ks_alpha=1,
        **({"keys": keys} if encrypt and keys is not None else {}),
    )
    W = weights if weights is not None else load_cryptonets_weights()
    weightscale = 32
    geo = _mnist_geometry()
    reader = LLConvReader(
        make_factory("lola", False), file_name=file_name,
        normalization_factor=1.0 / 256.0, scale=16.0, **geo,
    )
    if records is not None:
        reader.set_source_records(records)
    enc = EncryptLayer(reader)
    enc.factory = factory
    conv = LLPoolLayer(enc, map_count=[5, 1], weights=W["Weights_0"],
                       weights_scale=weightscale, **geo)
    vec = LLVectorizeLayer(conv)
    act = SquareActivation(vec)
    dense5 = LLDenseLayer(
        act, weights=transpose_flat(W["Weights_1"], 5 * 13 * 13, 100),
        bias=W["Biases_2"], weights_scale=weightscale * weightscale,
        input_format="dense", force_dense_format=True, use_bsgs=True,
        bsgs_g=64,
    )
    act7 = SquareActivation(dense5)
    dense8 = LLDenseLayer(
        act7, weights=W["Weights_3"], bias=W["Biases_3"],
        weights_scale=weightscale, input_format="dense",
        force_dense_format=True, use_bsgs=True, bsgs_g=32,
    )
    return dense8, factory, reader


def build_lola_small(encrypt: bool, records=None, file_name=None, seed: int = 0,
                     device=None, weights: dict | None = None, keys=None,
                     ntt_impl: str | None = None):
    """(head, factory, reader) of LoLaSmall: Conv -> Vectorize -> Square ->
    Dense(10) at weight scale 64.  `weights` defaults to the real
    `lola_small.npz`."""
    factory = make_factory(
        "lola_small", encrypt, seed, device=device, ntt_impl=ntt_impl,
        **({"keys": keys} if encrypt and keys is not None else {}),
    )
    W = weights
    if W is None:
        W = weights_extract.load("lola_small")
        if W is None:
            W = weights_extract.synthetic_weights(
                {"Weights_0": 130, "Weights_1": 8450, "Biases_1": 10})
        W = weights_from_numpy(W)
    weightscale = 64
    geo = _mnist_geometry()
    reader = LLConvReader(
        make_factory("lola_small", False), file_name=file_name,
        normalization_factor=1.0 / 256.0, scale=16.0, **geo,
    )
    if records is not None:
        reader.set_source_records(records)
    enc = EncryptLayer(reader)
    enc.factory = factory
    conv = LLPoolLayer(enc, map_count=[5, 1], weights=W["Weights_0"],
                       weights_scale=weightscale, **geo)
    act = SquareActivation(LLVectorizeLayer(conv))
    dense = LLDenseLayer(act, weights=W["Weights_1"], bias=W["Biases_1"],
                         weights_scale=weightscale, input_format="dense")
    return dense, factory, reader


def build_lola(encrypt: bool, records=None, file_name=None, seed: int = 0,
               device=None, weights: dict | None = None, keys=None,
               ntt_impl: str | None = None):
    """(head, factory, reader) of LoLaPacked, the reference packing of
    LoLa: the same weights and scales as `build_lola_bsgs`, hence the same
    logits."""
    factory = make_factory(
        "lola", encrypt, seed, device=device, ntt_impl=ntt_impl,
        **({"keys": keys} if encrypt and keys is not None else {}),
    )
    W = weights if weights is not None else load_cryptonets_weights()
    weightscale = 32
    geo = _mnist_geometry()
    reader = LLConvReader(
        make_factory("lola", False), file_name=file_name,
        normalization_factor=1.0 / 256.0, scale=16.0, **geo,
    )
    if records is not None:
        reader.set_source_records(records)
    enc = EncryptLayer(reader)
    enc.factory = factory
    conv = LLPoolLayer(enc, map_count=[5, 1], weights=W["Weights_0"],
                       weights_scale=weightscale, **geo)
    act = SquareActivation(LLVectorizeLayer(conv))
    dup = LLDuplicateLayer(act, count=8)
    dense5 = LLPackedDenseLayer(
        dup, weights=transpose_flat(W["Weights_1"], 5 * 13 * 13, 100),
        bias=W["Biases_2"], packing_count=8, packing_shift=1024,
        weights_scale=weightscale * weightscale,
    )
    selected = [1023 + i * 1024 for i in range(8)]
    inter6 = LLInterleaveLayer(dense5, shift=-1, selected_indices=selected)
    act7 = SquareActivation(inter6)
    dense8 = LLInterleavedDenseLayer(
        act7, weights=W["Weights_3"], bias=W["Biases_3"],
        weights_scale=weightscale, shift=-1, selected_indices=selected,
    )
    return dense8, factory, reader


def build_lola_dense(encrypt: bool, records=None, file_name=None, seed: int = 0,
                     device=None, weights: dict | None = None, keys=None,
                     ntt_impl: str | None = None):
    """(head, factory, reader) of LoLaDense: the same weights and scales
    as LoLa.  The PreConv layer is prepared here, on the encrypted
    factory, since the conv's bias slots and the dense weights' order
    come from it."""
    factory = make_factory(
        "lola_dense", encrypt, seed, device=device, ntt_impl=ntt_impl,
        **({"keys": keys} if encrypt and keys is not None else {}),
    )
    W = weights if weights is not None else load_cryptonets_weights()
    weightscale = 32
    geo = _mnist_geometry()
    reader = LLSingleLineReader(
        make_factory("lola_dense", False), file_name=file_name,
        normalization_factor=1.0 / 256.0, scale=16.0,
    )
    if records is not None:
        reader.set_source_records(records)
    enc = EncryptLayer(reader)
    enc.factory = factory
    pre = LLPreConvLayer(enc, use_axis_for_blocks=[True, True], **geo)
    pre.factory = factory
    pre.prepare()
    pre.layer_prepared = True
    conv = LLPoolLayer(pre, map_count=[5, 1], weights=W["Weights_0"],
                       weights_scale=weightscale, hot_indices=pre.hot_indices,
                       **geo)
    act = SquareActivation(LLVectorizeLayer(conv))
    dup = LLDuplicateLayer(act, count=16)
    dense = LLPackedDenseLayer(
        dup, weights=pre.rearrange_weights(
            transpose_flat(W["Weights_1"], 5 * 13 * 13, 100)),
        bias=W["Biases_2"], packing_count=16, packing_shift=1024,
        weights_scale=weightscale * weightscale,
    )
    selected = [1023 + i * 1024 for i in range(16)]
    inter = LLInterleaveLayer(dense, shift=-1, selected_indices=selected)
    act2 = SquareActivation(inter)
    head = LLInterleavedDenseLayer(
        act2, weights=W["Weights_3"], bias=W["Biases_3"],
        weights_scale=weightscale, shift=-1, selected_indices=selected,
    )
    return head, factory, reader


def lola_large_weights(weights_csv=None, bias_csv=None):
    """(w0, b0, w1, b1, w2, b2) of LoLaLarge: from the two local CSV files
    (w0 divided by 256, `LoLaCryptonets.cs:372`), else the reference's
    seeded stand-ins at its magnitudes (w0 / 256, 0.2 x w1 and w2), which
    keep the peak message within the three ~30-bit plain primes."""
    if weights_csv and bias_csv:
        wr = WeightsReader(weights_csv, bias_csv)
        return (np.asarray(wr.weights[0]) / 256.0, np.asarray(wr.biases[0]),
                np.asarray(wr.weights[1]), np.asarray(wr.biases[1]),
                np.asarray(wr.weights[2]), np.asarray(wr.biases[2]))
    syn = weights_extract.synthetic_weights({
        "w0": 83 * 64, "b0": 83, "w1": 163 * 83 * 36, "b1": 163,
        "w2": 10 * 163 * 16, "b2": 10,
    })
    return (syn["w0"] / 256.0, syn["b0"], syn["w1"] * 0.2, syn["b1"],
            syn["w2"] * 0.2, syn["b2"])


def build_lola_large(encrypt: bool, records=None, file_name=None,
                     seed: int = 0, device=None, keys=None,
                     ntt_impl: str | None = None, weights_csv=None,
                     bias_csv=None, preset: str = "lola_large"):
    """(head, factory, reader) of LoLaLarge over `preset` ("lola_large" or
    "lola_large_bigt").  The factory carries a single-hop Galois key for
    -144, so the 83-piece Vectorize runs its uniform runs as Horner
    loops."""
    factory = make_factory(
        preset, encrypt, seed, device=device, ntt_impl=ntt_impl,
        rot_steps=(-144,),
        **({"keys": keys} if encrypt and keys is not None else {}),
    )
    w0, b0, w1, b1, w2, b2 = lola_large_weights(weights_csv, bias_csv)
    geo = dict(input_shape=[1, 28, 28], kernel_shape=[1, 8, 8],
               upper_padding=[0, 1, 1], lower_padding=[0, 1, 1],
               stride=[1000, 2, 2])
    reader = LLConvReader(
        make_factory(preset, False), file_name=file_name,
        normalization_factor=1.0, scale=16.0, **geo,
    )
    if records is not None:
        reader.set_source_records(records)
    enc = EncryptLayer(reader)
    enc.factory = factory
    conv1 = LLPoolLayer(enc, map_count=[83, 1, 1], weights=w0, bias=b0,
                        weights_scale=4096, **geo)
    act3 = SquareActivation(LLVectorizeLayer(conv1))
    engine = ConvolutionEngine(input_shape=[83, 12, 12],
                               kernel_shape=[83, 6, 6], stride=[83, 2, 2],
                               map_count=[163, 1, 1])
    dense4 = LLDenseLayer(
        act3, weights=engine.get_dense_weights(w1).ravel(),
        bias=engine.get_dense_bias(b1), weights_scale=64,
        input_format="dense", force_dense_format=True,
    )
    act5 = SquareActivation(dense4)
    dense6 = LLDenseLayer(act5, weights=w2, bias=b2, weights_scale=512,
                          input_format="dense")
    return dense6, factory, reader


BUILDERS = {
    "LoLa": build_lola_bsgs,
    "LoLaBsgs": build_lola_bsgs,
    "LoLaSmall": build_lola_small,
    "LoLaPacked": build_lola,
    "LoLaDense": build_lola_dense,
    "LoLaLarge": build_lola_large,
}


def evaluate(build, encrypt=True, n_records=10, records=None,
             file_name=None, seed=0, device=None, ntt_impl=None, preset=None,
             verbose=False, graph=None):
    """Run records through the network; report the latency of each
    prediction and the errors against the reader's labels.  `preset`,
    when given, goes to a builder that takes one (LoLaLarge); `verbose`
    prints each layer's report (`Layer.forward`)."""
    if records is None and file_name is None:
        records = synthetic_mnist_records(n_records, seed=1)
    head, factory, reader = build(
        encrypt, records=records, file_name=file_name, seed=seed,
        device=device, ntt_impl=ntt_impl,
        **({} if preset is None else {"preset": preset}))
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
    return dict(
        errs=errs, count=len(latencies), latencies=latencies,
        steady_latency=float(np.median(latencies[1:]))
        if len(latencies) > 1 else (latencies[0] if latencies else None),
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--network", required=True, choices=BUILDERS)
    ap.add_argument("-e", "--encrypt", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--records", type=int, default=10)
    ap.add_argument("--data", default=None, help="TSV test file")
    ap.add_argument("--ntt", default=None, choices=("butterfly", "matmul"),
                    help="NTT of the ciphertext chain (default butterfly)")
    ap.add_argument("--preset", default=None,
                    choices=("lola_large", "lola_large_bigt"),
                    help="LoLaLarge's preset (default lola_large)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a GPU) or cpu")
    ap.add_argument("--no-graph", action="store_true",
                    help="run each record eagerly, a launch a kernel, not as "
                         "one CUDA graph replay")
    args = ap.parse_args()
    res = evaluate(
        BUILDERS[args.network], encrypt=args.encrypt, n_records=args.records,
        file_name=args.data, device=args.device, ntt_impl=args.ntt,
        preset=args.preset, verbose=args.verbose,
        graph=False if args.no_graph else None)
    if res["count"]:
        print(f"done: {res['count']} records, steady-state latency "
              f"{res['steady_latency']:.3f}s")


if __name__ == "__main__":
    main()
