"""SEAL-parity evidence of the PyTorch/CUDA port (port of
`scripts/parity_evidence.py`): for every model,

1. the Raw oracle's peak scaled message magnitude in bits
   (`api/raw.py`'s `RawVector.max_tracker` over one record), beside the
   reference's published numbers (`REF_BITS`: 39 bits for LoLaSmall,
   `LoLaCryptonets.cs:290`; 78.55 + 1 for CIFAR,
   `LolaCifarCryptoNet.cs:28-30`) and the preset's plain capacity (the
   sum of its plain primes' widths): the headroom is capacity - 1 - peak;
2. with `--encrypted`, one encrypted record through the network and the
   end-of-network invariant noise budget of output column 0 (headroom > 0
   means the chain is adequate, SEAL's own criterion).

    python3 scripts/torch_parity_evidence.py [model ...] [--encrypted] [--cpu]

Models: basic lola lola_small lola_dense lola_large cryptonets cifar
caltech (basic has no network and no row, as in the reference).  The
encrypted records run on the card; `--cpu` runs them on the CPU (keep to
the small models there: full-width keygen takes gigabytes).  Without
`--cpu` and without a card it raises.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ALL = ["basic", "lola", "lola_small", "lola_dense", "lola_large",
       "cryptonets", "cifar", "caltech"]
# the reference's published peak message magnitudes (bits), where stated
REF_BITS = {"lola_small": 39.0, "cifar": 78.55 + 1}
PRESET = {"basic": "default", "lola": "lola", "lola_small": "lola_small",
          "lola_dense": "lola_dense", "lola_large": "lola_large",
          "cryptonets": "cryptonets", "cifar": "cifar", "caltech": "caltech"}


def build(model: str, encrypt: bool, device=None):
    """(head, factory, reader) of `model` on the reference script's
    records (seed 31; CryptoNets a batch of 4)."""
    from cryptonets_tpu_torch.data.preprocess import (synthetic_cifar_records,
                                                      synthetic_feature_records,
                                                      synthetic_mnist_records)
    from cryptonets_tpu_torch.models import (caltech101, cryptonets_mnist,
                                             lola_cifar, lola_mnist)

    dev = {"device": device} if encrypt else {}
    if model in ("lola", "lola_small", "lola_dense", "lola_large"):
        name = {"lola": "LoLa", "lola_small": "LoLaSmall",
                "lola_dense": "LoLaDense", "lola_large": "LoLaLarge"}[model]
        return lola_mnist.BUILDERS[name](
            encrypt, records=synthetic_mnist_records(1, seed=31), **dev)
    if model == "cryptonets":
        return cryptonets_mnist.build(
            encrypt, batch_size=4, records=synthetic_mnist_records(4, seed=31), **dev)
    if model == "cifar":
        return lola_cifar.build(encrypt, records=synthetic_cifar_records(1, seed=31),
                                **dev)
    if model == "caltech":
        return caltech101.build(encrypt, records=synthetic_feature_records(
            1, caltech101.N_FEATURES, seed=31), **dev)
    raise ValueError(f"unknown model {model}")


def peak_bits(model: str) -> dict | None:
    """The Raw oracle's row of `model` (t bits, peak message bits, the
    reference's bits, headroom); None for `basic` (no network)."""
    from cryptonets_tpu_torch.api.raw import RawVector
    from cryptonets_tpu_torch.models.presets import CONFIGS

    if model == "basic":
        return None
    t_bits = sum(p.bit_length() for p in CONFIGS[PRESET[model]]["plain_primes"])
    RawVector.max_tracker.reset()
    head, _, _ = build(model, False)
    head.prepare_network()
    m = head.get_next()
    (m.get_column(0) if hasattr(m, "get_column") else m).decrypt()
    msg = math.log2(max(RawVector.max_tracker.value, 1.0))
    return dict(model=model, t_bits=t_bits, msg_bits=msg, ref_bits=REF_BITS.get(model),
                headroom_bits=t_bits - 1 - msg)


def encrypted_budget(model: str, device) -> tuple[int, float]:
    """(the final budget of output column 0 of one encrypted record,
    seconds of build, keygen, prepare and the record)."""
    t0 = time.perf_counter()
    head, _, _ = build(model, True, device)
    head.prepare_network()
    m = head.get_next()
    col = m.get_column(0) if hasattr(m, "get_column") else m
    budget = col.noise_budget()
    col.decrypt()
    return budget, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("models", nargs="*", default=None)
    ap.add_argument("--encrypted", action="store_true",
                    help="also run one encrypted record and report its final budget")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    from cryptonets_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    print(f"{'model':12s} {'t bits':>7s} {'msg bits':>9s} {'ref':>6s} "
          f"{'headroom':>9s}  end budget ({device})")
    for model in args.models or ALL:
        row = peak_bits(model)
        if row is None:
            continue
        budget = ""
        if args.encrypted:
            b, s = encrypted_budget(model, device)
            budget = f"{b} bits ({s:.1f} s)"
        ref = row["ref_bits"]
        print(f"{model:12s} {row['t_bits']:7d} {row['msg_bits']:9.2f} "
              f"{('%.1f' % ref) if ref else '-':>6s} "
              f"{row['headroom_bits']:9.2f}  {budget}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
