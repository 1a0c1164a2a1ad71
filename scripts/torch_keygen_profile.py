"""The factory / keygen / prepare split of the PyTorch/CUDA port (port of
`scripts/keygen_profile.py`).

    python3 scripts/torch_keygen_profile.py [--preset lola] [--cpu]

Times, the device synchronised after each: the parameters and their
device tables of every plain prime (`BFVParams`, what a factory builds
before its keys), a first keygen (`BFV.keygen`, seed 0: the power-of-two
ladder and the column key) and a second (seed 1), then the network of the
preset built in full (a factory with its own keygen, the builder's
rotation keys) and `prepare_network`.  The networks: `lola` LoLa
(`build_lola_bsgs`), `lola_small` LoLaSmall, `caltech` Caltech-101;
another preset times the parameters and keygen only.  Runs on the card;
`--cpu` on the CPU (small presets only: full-width keygen takes
gigabytes there).  Without `--cpu` and without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timed(fn, device):
    """(fn(), its seconds), the device synchronised before and after."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def profile(cfg: dict, device, build=None) -> dict:
    """Seconds of each phase (module docstring) for the preset config
    `cfg` (CONFIGS' keys) on `device`; `build(device)` -> (head, factory,
    reader) adds the network's build and prepare."""
    from cryptonets_tpu_torch.crypto.bfv import BFV, BFVParams
    from cryptonets_tpu_torch.crypto.primes import default_coeff_modulus_128

    chain = tuple(cfg.get("coeff_modulus") or default_coeff_modulus_128(cfg["n"]))
    if cfg.get("coeff_count"):
        chain = chain[:cfg["coeff_count"]]
    kw = dict(dbc=cfg.get("dbc", 16), ks_alpha=cfg.get("ks_alpha", 0),
              n_special=cfg.get("n_special", 0))
    params, out = _timed(lambda: [BFVParams(cfg["n"], t, coeff_modulus=chain,
                                            device=device, **kw)
                                  for t in cfg["plain_primes"]], device)
    res = {"params_s": out}
    bfv = BFV(params[0])
    keys, res["keygen_1_s"] = _timed(lambda: bfv.keygen(seed=0), device)
    res["galois_keys"] = len(keys.galois)
    res["key_bytes"] = keys.nbytes()
    del keys
    _, res["keygen_2_s"] = _timed(lambda: bfv.keygen(seed=1), device)
    if build is not None:
        (head, fac, _), res["build_s"] = _timed(lambda: build(device), device)
        _, res["prepare_s"] = _timed(head.prepare_network, device)
        res["network_galois_keys"] = len(fac.keys.galois)
    return res


def network(preset: str):
    """The network `profile` builds for a preset, or None."""
    from cryptonets_tpu_torch.data.preprocess import (synthetic_feature_records,
                                                      synthetic_mnist_records)
    from cryptonets_tpu_torch.models import caltech101, lola_mnist

    if preset == "lola":
        return lambda dev: lola_mnist.build_lola_bsgs(
            True, records=synthetic_mnist_records(1, seed=1), device=dev)
    if preset == "lola_small":
        return lambda dev: lola_mnist.build_lola_small(
            True, records=synthetic_mnist_records(1, seed=1), device=dev)
    if preset == "caltech":
        return lambda dev: caltech101.build(True, records=synthetic_feature_records(
            1, caltech101.N_FEATURES, seed=1), device=dev)
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="lola")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    from cryptonets_tpu_torch.device import resolve_device
    from cryptonets_tpu_torch.models.presets import CONFIGS

    device = resolve_device("cpu" if args.cpu else None)
    res = profile(CONFIGS[args.preset], device, network(args.preset))
    for k, v in res.items():
        print(f"{k}: {v:.3f}" if isinstance(v, float) else f"{k}: {v}", flush=True)
    print(json.dumps(dict(preset=args.preset, device=str(device), **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
