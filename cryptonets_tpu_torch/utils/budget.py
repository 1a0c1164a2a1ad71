"""Noise budget by operation class, port of `cryptonets_tpu/utils/
budget.py` (ref `HE Wrapper Tests/BudgetAnalysis.cs:37-63`): the invariant
noise budget after a fresh encryption, an encrypted and a plain dot
product, a slot sum, a plain and an encrypted multiply, and a rotation,
for a named preset.  `docs/PARITY.md` holds the reference's table.

CLI: python -m cryptonets_tpu_torch.utils.budget [preset ...] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np


def op_budgets(factory, dim: int = 64) -> dict[str, int]:
    """Budget in bits after each operation class on `factory`."""
    from ..api.tracker import CryptoTracker

    rng = np.random.default_rng(1)
    a = rng.integers(-8, 9, dim).astype(float)
    b = rng.integers(-8, 9, dim).astype(float)
    CryptoTracker.enabled = True
    va = factory.get_encrypted_vector(a, "dense", 1.0)
    vb = factory.get_encrypted_vector(b, "dense", 1.0)
    pb = factory.get_plain_vector(b, "dense", 1.0)
    out = {}

    def probe(name, vec):
        prev = CryptoTracker.min_budget_so_far
        CryptoTracker.min_budget_so_far = None
        out[name] = CryptoTracker.test_vector_budget(vec, warn=False)
        CryptoTracker.min_budget_so_far = prev

    probe("fresh", va)
    probe("enc_dot", va.dot_product(vb))
    probe("plain_dot", va.dot_product(pb))
    probe("sum_slots", va.sum_all_slots())
    probe("plain_mult", va.pointwise_multiply(pb))
    probe("enc_mult", va.pointwise_multiply(vb))
    probe("rotate", va.rotate(3))
    return out


def main(argv=None):
    import argparse

    from ..models.presets import CONFIGS, make_factory

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("presets", nargs="*", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    for name in args.presets or list(CONFIGS):
        fac = make_factory(name, True, seed=0, device=args.device)
        print(f"{name}: n={fac.n} k={len(fac.coeff_modulus)} "
              f"plain_primes={fac.plain_primes}", flush=True)
        for op, bits in op_budgets(fac).items():
            print(f"  {op:12s} {bits} bits", flush=True)


if __name__ == "__main__":
    sys.exit(main())
