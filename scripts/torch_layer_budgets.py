"""Noise budget and agreement with the Raw oracle after every layer of one
record of the PyTorch/CUDA port, on one GPU.

    python3 scripts/torch_layer_budgets.py
        [--network CIFAR|LoLaLarge|LoLaDense|LoLaPacked] [--preset NAME]
        [--ntt butterfly|matmul] [--sample 2]

Builds the full-width network encrypted on the card (CIFAR: records of
seed 4; the MNIST networks: seed 11, as `chip_smoke.py`) and its Raw
oracle, encrypts one record and runs the layers one at a time.  After each
layer it prints the layer's seconds (device synchronised), the least
invariant noise budget over the first `--sample` output vectors and the
plain primes, and the largest difference of the decrypted values from the
Raw oracle's at that layer, relative to the largest Raw value.  A budget
of 0 means the decryption may be wrong from that layer on.  Writes
chiprun_out/torch_<network>[_<preset>]_layer_budgets.json.  Fails without
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="CIFAR",
                    choices=("CIFAR", "LoLaLarge", "LoLaDense", "LoLaPacked"))
    ap.add_argument("--preset", default=None,
                    help="the preset of CIFAR or LoLaLarge (default: the "
                         "builder's own)")
    ap.add_argument("--ntt", choices=("butterfly", "matmul"), default="butterfly")
    ap.add_argument("--sample", type=int, default=2,
                    help="output vectors of a layer whose budget is taken")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_layer_budgets: CUDA is not available", file=sys.stderr)
        return 1
    from cryptonets_tpu_torch.data.preprocess import (synthetic_cifar_records,
                                                      synthetic_mnist_records)
    from cryptonets_tpu_torch.models import lola_cifar
    from cryptonets_tpu_torch.models.lola_mnist import BUILDERS
    from cryptonets_tpu_torch.nn.forward import (EncryptedForward,
                                                 layer_agreement,
                                                 raw_layer_outputs)

    kw = {} if args.preset is None else {"preset": args.preset}
    if args.network == "CIFAR":
        build, records = lola_cifar.build, synthetic_cifar_records(1, seed=4)
    else:
        build, records = BUILDERS[args.network], synthetic_mnist_records(1, seed=11)
    copy = lambda: [(lb, f.copy()) for lb, f in records]  # noqa: E731
    head_r, _, _ = build(False, records=copy(), **kw)
    head_r.prepare_network()
    raws = raw_layer_outputs(head_r)
    dev = torch.device("cuda", 0)
    head, fac, _ = build(True, records=copy(), device=dev, ntt_impl=args.ntt, **kw)
    t0 = time.perf_counter()
    head.prepare_network()
    prepare_s = time.perf_counter() - t0

    fwd = EncryptedForward(head)
    m = fwd.encrypt(fwd.reader.get_next())
    rows = [("input", 0.0, m)]
    for layer in fwd.layers:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = layer.apply(m)
        torch.cuda.synchronize()
        rows.append((type(layer).__name__, time.perf_counter() - t0, m))
    out = []
    for (name, seconds, m), r in zip(rows, raws):
        a = layer_agreement(m, r, args.sample)
        out.append(dict(layer=name, seconds=seconds, budget_bits=a["budget"],
                        max_rel_diff=a["max_rel_diff"], vectors=a["vectors"]))
        print(f"{name:24s} {seconds:9.3f} s  budget {a['budget']:4d} bits  max "
              f"relative difference from Raw {a['max_rel_diff']:.3e}  "
              f"({a['vectors']} vectors)", flush=True)
    result = dict(card=torch.cuda.get_device_name(0), network=args.network,
                  preset=args.preset, ntt_impl=fac.ntt_impl,
                  plain_primes=list(fac.plain_primes), limbs=len(fac.coeff_modulus),
                  prepare_s=prepare_s, layers=out)
    print(json.dumps(result))
    os.makedirs("chiprun_out", exist_ok=True)
    name = f"torch_{args.network.lower()}" + (
        f"_{args.preset}" if args.preset else "") + "_layer_budgets.json"
    with open(os.path.join("chiprun_out", name), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
