"""Noise budget after each step of the per-row dot products with the forced
dense output (the conv-as-dense of `cifar_bigt` and `lola_large_bigt`), on
the ring of a preset, on one GPU.

    python3 scripts/torch_mask_noise.py
        [--presets cifar_bigt,cifar,lola_large_bigt,lola_large] [--rows 52]

For each preset's factory (its ring, plain primes and Galois keys, seed 0)
it encrypts a dense vector of 16268 values in [0, 256) (seed 5) and prints
the least invariant noise budget over the plain primes after each step:
  fresh      the encryption;
  x row      times a plain row of 16268 weights in [-1024, 1024];
  ladder     the complete slot sum of that product (column swap and log2
             rotate-and-add steps);
  unit mask  the same sum forced into slot 7 (times the unit mask);
  R rows     `--rows` such rows as one row-major matvec with the forced
             dense output (their masked sums added);
with each step's cost in bits.  Beside a plaintext multiply's cost it
prints log2(t * sqrt(n / 12)), the growth of the noise under a product by
a polynomial whose coefficients are uniform mod t, as a slot vector's
encoding is.  Writes chiprun_out/torch_mask_noise.json.  Fails without
CUDA.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DIM = 16268       # CIFAR's conv-as-dense input


def steps(fac, rows: int) -> list:
    """(step, budget) over the steps of one per-row dot, then `rows` rows."""
    rng = np.random.default_rng(5)
    x = fac.get_encrypted_vector(rng.integers(0, 256, DIM).astype(float), "dense", 1.0)
    w = rng.integers(-1024, 1025, size=(rows, DIM)).astype(float)
    prod = x.pointwise_multiply(fac.get_plain_vector(w[0], "dense", 1.0))
    out = [("fresh", x), ("x row", prod), ("ladder", prod.sum_all_slots()),
           ("unit mask", prod.sum_all_slots(force_output_in_column=7)),
           (f"{rows} rows", fac.get_plain_matrix(w, "row", 1.0).mul(x, True))]
    return [(name, v.noise_budget()) for name, v in out]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", default="cifar_bigt,cifar,lola_large_bigt,lola_large")
    ap.add_argument("--rows", type=int, default=52,
                    help="rows of the matvec step (52: one piece of cifar_bigt's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mask_noise: CUDA is not available", file=sys.stderr)
        return 1
    from cryptonets_tpu_torch.models.presets import CONFIGS, make_factory

    dev = torch.device("cuda", 0)
    result = dict(card=torch.cuda.get_device_name(0), rows=args.rows, presets={})
    for preset in args.presets.split(","):
        fac = make_factory(preset, True, 0, device=dev)
        cfg = CONFIGS[preset]
        t = max(cfg["plain_primes"])
        predicted = math.log2(t * math.sqrt(cfg["n"] / 12))
        budgets = steps(fac, args.rows)
        costs = [(name, b, prev - b) for (name, b), (_, prev)
                 in zip(budgets, [budgets[0]] + budgets)]
        result["presets"][preset] = dict(
            n=cfg["n"], limbs=len(fac.coeff_modulus), plain_primes=list(cfg["plain_primes"]),
            predicted_plain_multiply_bits=predicted,
            steps=[dict(step=s, budget=b, cost=c) for s, b, c in costs])
        print(f"{preset}: n = {cfg['n']}, {len(fac.coeff_modulus)} limbs, "
              f"t up to 2**{math.log2(t):.2f}; a plaintext multiply predicted "
              f"to cost {predicted:.1f} bits", flush=True)
        for s, b, c in costs:
            print(f"  {s:10s} budget {b:4d} bits, cost {c:4d}", flush=True)
        del fac
        torch.cuda.empty_cache()
    print(json.dumps(result))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "torch_mask_noise.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
