"""Seed sweep of the end-of-network noise budget of the PyTorch/CUDA port
(port of `scripts/noise_sweep.py` over the port's builders).

    python3 scripts/torch_noise_sweep.py [--network LoLaDense]
        [--records 100] [--seed 101] [--preset NAME] [--device cuda]
        [--out chiprun_out/torch_noise_sweep_<network>[_<preset>].json]

Builds the network encrypted (on the card unless `--device cpu`) and its
Raw oracle over `--records` synthetic records of `--seed` (MNIST-like;
CIFAR-like for `--network CIFAR`), runs every record through the
encrypted network (fresh data and fresh encryption randomness each), and
records the final invariant noise budget of output column 0 and whether
its decoded logits equal the Raw oracle's at rtol 1e-9.  Prints the
histogram of budgets, the minimum, the median and the mismatches, then
one JSON line, which it also writes to `--out`.  `--preset` goes to the
builders that take one (LoLaLarge, CIFAR).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str | None:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import numpy as np
    import torch

    from cryptonets_tpu_torch.data.preprocess import (synthetic_cifar_records,
                                                      synthetic_mnist_records)
    from cryptonets_tpu_torch.models import lola_cifar
    from cryptonets_tpu_torch.models.lola_mnist import BUILDERS
    from cryptonets_tpu_torch.nn.forward import EncryptedForward

    builders = dict(BUILDERS, CIFAR=lola_cifar.build)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="LoLaDense", choices=builders)
    ap.add_argument("--records", type=int, default=100)
    ap.add_argument("--seed", type=int, default=101)
    ap.add_argument("--preset", default=None,
                    help="the preset of LoLaLarge or CIFAR (default: the "
                         "builder's own)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a GPU) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    build = builders[args.network]
    kw = {} if args.preset is None else {"preset": args.preset}
    make = synthetic_cifar_records if args.network == "CIFAR" else synthetic_mnist_records
    records = make(args.records, seed=args.seed)

    head_r, _, _ = build(False, records=[(lb, f.copy()) for lb, f in records], **kw)
    head_r.prepare_network()
    t0 = time.perf_counter()
    head, fac, _ = build(True, records=records, device=args.device, **kw)
    head.prepare_network()
    setup_s = time.perf_counter() - t0
    print(f"# {args.network} {args.preset or ''}: n={fac.n}, "
          f"k={len(fac.coeff_modulus)}, plain primes {fac.plain_primes}, "
          f"dbc={fac.params[0].dbc}; keygen + prepare {setup_s:.1f} s",
          file=sys.stderr, flush=True)

    fwd = EncryptedForward(head)
    budgets, seconds, mismatches = [], [], 0
    for i in range(args.records):
        t0 = time.perf_counter()
        out = fwd()
        if out is None:
            break
        col = out.get_column(0)
        dec = np.asarray(col.decrypt(), float)
        seconds.append(time.perf_counter() - t0)
        raw = np.asarray(head_r.get_next().get_column(0).decrypt(), float)
        ok = dec.shape == raw.shape and bool(np.allclose(dec, raw, rtol=1e-9, atol=0))
        mismatches += not ok
        budgets.append(col.noise_budget())
        if i % 10 == 0 or not ok:
            print(f"# [{sum(seconds):8.1f} s] record {i}: budget "
                  f"{budgets[-1]} bits, equal to the Raw oracle: {ok}",
                  file=sys.stderr, flush=True)
        del out, col
    hist = collections.Counter(budgets)
    for bits in sorted(hist):
        print(f"{bits:4d} bits: {hist[bits]:4d} {'#' * hist[bits]}")
    res = dict(
        network=args.network, preset=args.preset, seed=args.seed,
        device=str(fac.device), card=card() if fac.device.type == "cuda" else None,
        records=len(budgets), min_budget_bits=min(budgets),
        median_budget_bits=float(np.median(budgets)),
        max_budget_bits=max(budgets), mismatches=mismatches,
        histogram={str(k): v for k, v in sorted(hist.items())},
        median_record_s=float(np.median(seconds)), setup_s=setup_s,
    )
    print(f"minimum {res['min_budget_bits']} bits, median "
          f"{res['median_budget_bits']} bits, {mismatches} mismatches against "
          f"the Raw oracle over {len(budgets)} records")
    print(json.dumps(res), flush=True)
    out_path = args.out or os.path.join(
        "chiprun_out", f"torch_noise_sweep_{args.network}"
        + (f"_{args.preset}" if args.preset else "") + ".json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    return 0 if budgets else 1


if __name__ == "__main__":
    sys.exit(main())
