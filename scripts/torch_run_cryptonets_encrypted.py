"""CryptoNets-MNIST encrypted batches through the PyTorch/CUDA port, with
the numbers the reference reports (port of
`scripts/run_cryptonets_encrypted.py`; ref `CryptoNets/CryptoNets.cs:20-107`,
27.9 s a batch of 8192 images).

    python3 scripts/torch_run_cryptonets_encrypted.py [--batch 8192]
        [--batches 2] [--preset cryptonets|cryptonets_bigt] [--no-graph] [--cpu]

Builds the Raw oracle and the encrypted network on the same synthetic
records (seed 2), times factory + keygen + prepare, then runs `--batches`
batches through `nn/forward.evaluation_forward` (one CUDA graph a batch
on the card unless `--no-graph`): each batch's seconds (encrypt, the
network, decrypt and decode, on the host clock), ms an image of the last
batch, and the encrypted predictions' agreement with the Raw oracle's on
every image, which must be complete.  Prints one JSON line.  Runs on the
card; `--cpu` on the CPU (a small batch only: a full batch holds
gigabytes of ciphertext).  Without `--cpu` and without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(batch: int, batches: int, device, preset: str = "cryptonets",
        graph: bool | None = None, build=None) -> dict:
    """The measurement (module docstring); `build(encrypt, batch_size,
    records, device)` -> (head, factory, reader), CryptoNets by default."""
    import torch

    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.models import cryptonets_mnist
    from cryptonets_tpu_torch.nn.forward import evaluation_forward

    if build is None:
        def build(encrypt, batch_size, records, device):
            return cryptonets_mnist.build(encrypt, batch_size, records=records,
                                          preset=preset,
                                          **({"device": device} if encrypt else {}))

    records = synthetic_mnist_records(batch * batches, seed=2)
    copy = lambda: [(lb, f.copy()) for lb, f in records]  # noqa: E731
    head_r, _, _ = build(False, batch, copy(), None)
    head_r.prepare_network()
    raw_preds = np.concatenate([np.argmax(head_r.get_next().decrypt(), axis=1)
                                for _ in range(batches)])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    head, fac, reader = build(True, batch, copy(), device)
    head.prepare_network()
    sync()
    setup_s = time.perf_counter() - t0
    fwd = evaluation_forward(head, graph)
    times, preds = [], []
    for _ in range(batches):
        sync()
        t0 = time.perf_counter()
        dec = fwd().decrypt()
        times.append(time.perf_counter() - t0)
        preds.append(np.argmax(dec, axis=1)[: len(reader.labels)])
    preds = np.concatenate(preds)
    agree = int((preds == raw_preds[: len(preds)]).sum())
    return dict(batch=batch, batches=batches, preset=preset, device=str(device),
                graph=fwd.graph, factory_keygen_prepare_s=setup_s,
                batch_s=times, last_batch_s=times[-1],
                ms_per_image=1000.0 * times[-1] / batch,
                agreement=agree, images=len(preds))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--preset", default="cryptonets",
                    choices=("cryptonets", "cryptonets_bigt"))
    ap.add_argument("--no-graph", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    from cryptonets_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    res = run(args.batch, args.batches, device, args.preset,
              False if args.no_graph else None)
    for i, s in enumerate(res["batch_s"]):
        print(f"batch {i + 1}: {s:.3f} s ({1000.0 * s / args.batch:.4f} ms an image)",
              flush=True)
    print(json.dumps(dict(metric=f"CryptoNets-MNIST encrypted batch ({args.batch} "
                                 f"images)", unit="s", vs_baseline=27.9 / res["last_batch_s"],
                          **res)))
    if res["agreement"] != res["images"]:
        print(f"encrypted predictions differ from the Raw oracle's: "
              f"{res['agreement']}/{res['images']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
