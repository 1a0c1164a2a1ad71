"""CryptoNets MNIST, the SIMD-batched throughput model (ref `CryptoNets/
CryptoNets.cs`), port of `cryptonets_tpu/models/cryptonets_mnist.py`:
8192 images per ciphertext batch through Conv(5 maps 5x5 s2) -> Square ->
Dense(100) -> Square -> Dense(10), over the `cryptonets` preset (three
~30-bit plain primes, digit key switching at dbc=16) or `cryptonets_bigt`
(the reference's two ~39-bit primes: host encode, two-plane decrypt),
under either NTT of the ciphertext chain.

CLI: python -m cryptonets_tpu_torch.models.cryptonets_mnist [--batch 8192]
     [--records N] [--data FILE] [--preset cryptonets|cryptonets_bigt]
     [--ntt butterfly|matmul] [--device cuda|cpu] [--no-graph]
(each batch one CUDA graph replay on the card unless `--no-graph` or
`-v` is given)
It runs on the card unless `--device cpu` is given.  At full width the
encrypted batch holds gigabytes of ciphertext: run it on a GPU only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..data.preprocess import synthetic_mnist_records
from ..nn.forward import evaluation_forward
from ..nn.layers import EncryptLayer, PoolLayer, SquareActivation, TimingLayer
from ..nn.readers import BatchReader
from .lola_mnist import load_cryptonets_weights, transpose_flat
from .presets import make_factory


def build(encrypt: bool = True, batch_size: int = 8192, records=None,
          file_name=None, seed: int = 0, preset: str = "cryptonets",
          device=None, weights: dict | None = None, keys=None,
          ntt_impl: str | None = None):
    """(head, factory, reader) of CryptoNets.  encrypt=False builds the
    Raw oracle.  `weights` defaults to the real `cryptonets.npz`; `keys`
    imports a key set instead of keygen (made under the same
    `ntt_impl`)."""
    factory = make_factory(
        preset, encrypt, seed, device=device, ntt_impl=ntt_impl,
        **({"keys": keys} if encrypt and keys is not None else {}),
    )
    W = weights if weights is not None else load_cryptonets_weights()
    weightscale = 32
    reader = BatchReader(
        make_factory(preset, False), file_name=file_name,
        max_slots=batch_size, normalization_factor=1.0 / 256.0, scale=16.0,
    )
    if records is not None:
        reader.set_source_records(records)
    enc = EncryptLayer(reader)
    enc.factory = factory
    t_start = TimingLayer(enc, start_counters=["Batch-Time"])
    conv1 = PoolLayer(
        t_start, input_shape=[28, 28], kernel_shape=[5, 5],
        upper_padding=[1, 1], stride=[2, 2], map_count=[5, 1],
        weights=W["Weights_0"], weights_scale=weightscale,
    )
    act2 = SquareActivation(conv1)
    dense3 = PoolLayer(
        act2, input_shape=[5 * 13 * 13], kernel_shape=[5 * 13 * 13],
        stride=[1000], map_count=[100],
        weights=transpose_flat(W["Weights_1"], 5 * 13 * 13, 100),
        bias=W["Biases_2"], weights_scale=weightscale * weightscale,
    )
    act4 = SquareActivation(dense3)
    dense5 = PoolLayer(
        act4, input_shape=[100], kernel_shape=[100], stride=[1000],
        map_count=[10], weights=W["Weights_3"], bias=W["Biases_3"],
        weights_scale=weightscale,
    )
    head = TimingLayer(dense5, stop_counters=["Batch-Time"])
    return head, factory, reader


def evaluate(encrypt=True, batch_size=8192, n_batches=1, records=None,
             file_name=None, seed=0, device=None, preset="cryptonets",
             ntt_impl=None, verbose=False, graph=None):
    """Run `n_batches` batches and count the prediction errors against
    the records' labels; `verbose` prints each layer's report
    (`Layer.forward`)."""
    if records is None and file_name is None:
        records = synthetic_mnist_records(batch_size * n_batches, seed=2)
    head, factory, reader = build(
        encrypt, batch_size, records=records, file_name=file_name, seed=seed,
        device=device, preset=preset, ntt_impl=ntt_impl)
    if verbose:
        head.set_verbose(True)
    head.prepare_network()
    run = evaluation_forward(head, graph, verbose) if encrypt else None
    errs = count = last = 0
    batch_times = []
    for _ in range(n_batches):
        t0 = time.time()
        m = run() if run is not None else head.get_next()
        if m is None:
            break
        dec = m.decrypt()  # [batch, 10]
        batch_times.append(time.time() - t0)
        preds = np.argmax(dec, axis=1)
        labels = np.asarray(reader.labels)
        last = len(labels)
        errs += int((preds[:last] != labels).sum())
        count += last
        print(f"errs {errs}/{count} accuracy "
              f"{100 - 100.0 * errs / max(count, 1):0.3f}% "
              f"batch time {batch_times[-1]:0.2f}s")
    # per image of the last batch (the reference divides by the running
    # count of all batches, which understates it from the second batch on)
    return dict(
        errs=errs, count=count, batch_times=batch_times,
        amortized_ms=1000.0 * batch_times[-1] / max(last, 1)
        if batch_times else None,
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--records", type=int, default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--no-encrypt", action="store_true")
    ap.add_argument("--preset", default="cryptonets",
                    choices=("cryptonets", "cryptonets_bigt"))
    ap.add_argument("--ntt", default=None, choices=("butterfly", "matmul"),
                    help="NTT of the ciphertext chain (default butterfly)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a GPU) or cpu")
    ap.add_argument("--no-graph", action="store_true",
                    help="run each record eagerly, a launch a kernel, not as "
                         "one CUDA graph replay")
    args = ap.parse_args()
    n_batches = 1
    if args.records:
        n_batches = -(-args.records // args.batch)
    res = evaluate(
        encrypt=not args.no_encrypt, batch_size=args.batch,
        n_batches=n_batches, file_name=args.data, device=args.device,
        preset=args.preset, ntt_impl=args.ntt, verbose=args.verbose,
        graph=False if args.no_graph else None,
    )
    if res["batch_times"]:
        print(f"batch size {args.batch}: {res['batch_times'][-1]:0.2f}s/batch, "
              f"{res['amortized_ms']:0.3f} ms/image amortized")


if __name__ == "__main__":
    main()
