"""Basic example (ref `Basic Example/Program.cs`), port of
`cryptonets_tpu/models/basic_example.py`: keygen of the default factory,
then the encrypted norm^2, slot sum and elementwise product of a small
vector.  On a CUDA factory both times are taken after
`torch.cuda.synchronize()`.

CLI: python -m cryptonets_tpu_torch.models.basic_example [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..device import synchronize
from .presets import make_factory


def run(verbose: bool = True, device=None) -> dict:
    t0 = time.perf_counter()
    factory = make_factory("default", encrypt=True, device=device)
    synchronize(factory)
    keygen_s = time.perf_counter() - t0
    if verbose:
        print(f"Generating keys took {keygen_s:0.2f} seconds")

    v = np.arange(1.0, 11.0)  # [1..10]
    enc = factory.get_encrypted_vector(v, "dense", scale=1.0)

    t0 = time.perf_counter()
    norm2 = enc.dot_product(enc)
    s = enc.sum_all_slots()
    prod = enc.pointwise_multiply(
        factory.get_plain_vector(v[::-1], "dense", scale=1.0))
    results = dict(
        norm_squared=float(norm2.decrypt()[0]),
        sum=float(s.decrypt()[0]),
        elementwise=prod.decrypt()[: len(v)],
    )
    synchronize(factory)
    compute_s = time.perf_counter() - t0
    if verbose:
        print(f"norm^2 = {results['norm_squared']}")
        print(f"sum = {results['sum']}")
        print(f"elementwise = {results['elementwise']}")
        print(f"Computation took {compute_s:0.2f} seconds")
    results["keygen_seconds"] = keygen_s
    results["compute_seconds"] = compute_s
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a GPU) or cpu")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
