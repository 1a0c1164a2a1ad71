"""The LoLa MNIST networks, one image per record (ref
`LowLatencyCryptoNets/LoLaCryptonets.cs`): port of
`cryptonets_tpu/models/lola_mnist.py`.

`build_lola_bsgs` ("LoLa"): Conv (5 maps) -> Vectorize -> Square ->
Dense(100, hoisted BSGS, g=64) -> Square -> Dense(10, hoisted BSGS, g=32)
over the `lola` preset with RNS-group key switching without special primes
(ks_alpha=1).  The same weights and fixed-point scales as the reference's
LoLa (`LoLaCryptonets.cs:203-278`), so the same logits as the Raw oracle.
It needs the butterfly NTT (hoisted baby steps).

`build_lola_small` ("LoLaSmall", `LoLaCryptonets.cs:280-329`): Conv ->
Vectorize -> Square -> Dense(10, per-row dots over SumAllSlots ladders)
over the `lola_small` preset (hybrid key switching, two special primes),
under either NTT.

CLI: python -m cryptonets_tpu_torch.models.lola_mnist -n LoLaSmall [-e]
     [--ntt butterfly|matmul] [--records K] [--data FILE] [--device cpu]
It runs on the card unless `--device cpu` is given; run a full-width
encrypted network on a GPU only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..convert import weights_from_numpy
from ..data import weights_extract
from ..data.preprocess import synthetic_mnist_records
from ..nn.forward import EncryptedForward
from ..nn.layers import EncryptLayer, SquareActivation
from ..nn.lola import LLDenseLayer, LLPoolLayer, LLVectorizeLayer
from ..nn.readers import LLConvReader
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


def _not_ported(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"the network {name} is not ported")
    return refuse


BUILDERS = {
    "LoLa": build_lola_bsgs,
    "LoLaBsgs": build_lola_bsgs,
    "LoLaSmall": build_lola_small,
    "LoLaPacked": _not_ported("LoLaPacked"),
    "LoLaDense": _not_ported("LoLaDense"),
    "LoLaLarge": _not_ported("LoLaLarge"),
}


def evaluate(build, encrypt=True, n_records=10, records=None,
             file_name=None, seed=0, device=None, ntt_impl=None):
    """Run records through the network; report the latency of each
    prediction and the errors against the reader's labels."""
    if records is None and file_name is None:
        records = synthetic_mnist_records(n_records, seed=1)
    head, factory, reader = build(
        encrypt, records=records, file_name=file_name, seed=seed,
        device=device, ntt_impl=ntt_impl)
    head.prepare_network()
    run = EncryptedForward(head) if encrypt else None
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
    ap.add_argument("--records", type=int, default=10)
    ap.add_argument("--data", default=None, help="TSV test file")
    ap.add_argument("--ntt", default=None, choices=("butterfly", "matmul"),
                    help="NTT of the ciphertext chain (default butterfly)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a GPU) or cpu")
    args = ap.parse_args()
    res = evaluate(
        BUILDERS[args.network], encrypt=args.encrypt, n_records=args.records,
        file_name=args.data, device=args.device, ntt_impl=args.ntt)
    if res["count"]:
        print(f"done: {res['count']} records, steady-state latency "
              f"{res['steady_latency']:.3f}s")


if __name__ == "__main__":
    main()
