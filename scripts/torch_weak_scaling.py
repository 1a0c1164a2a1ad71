"""Weak scaling of the port over the `batch` axis of a mesh of ranks, the
counterpart of `scripts/weak_scaling.py`, on the production LoLaSmall
network at n = 8192 (6 data + 1 special limbs, `dryrun.dryrun_production`):

  --mesh   records/s with 1, 2, 4, ... ranks (up to --ranks), each rank on
           --per-rank records of its own (`distributed.run_ranks`, one
           process a rank, `dryrun.production_rank`); the rate is all the
           ranks' records over the group's window, from a barrier before
           the timed forward to one after every rank's forward has
           synchronised (after one warm-up record a rank);
           efficiency(R) = throughput(R) / (R * throughput(1)).
  --batch  one process: records/s of record batches of B = 1, 2, 4, 8,
           16, the layers under `torch.func.vmap` over the records (one
           launch a kernel for the batch; `dryrun_production(batched=True)`),
           after one warm-up batch: the amortisation that the batch axis
           of a mesh inherits.

Every record is held exactly to the Raw oracle.  Defaults: the card and
NCCL, one card a rank; ranks that share a card, or the CPU, pass
`--backend gloo` (and `--device cpu`).  Prints one JSON line a mode, with
the card's name and power limit where there is a card.

Usage: python scripts/torch_weak_scaling.py [--mesh] [--batch]
       [--ranks 4] [--per-rank 16] [--backend gloo] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str | None:
    import torch

    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def run_mesh_curve(ranks: int, per_rank: int, backend, device) -> dict:
    from cryptonets_tpu_torch.parallel.distributed import run_ranks
    from cryptonets_tpu_torch.parallel.dryrun import production_rank

    rate, windows = {}, {}
    R = 1
    while R <= ranks:
        res = run_ranks(production_rank, R, per_rank, device, R, backend=backend)
        windows[R] = max(r["window_s"] for r in res)
        rate[R] = R * per_rank / windows[R]
        print(f"# {R} rank(s): {rate[R]:.2f} rec/s (window {windows[R]:.4f} s, "
              f"own forwards {[round(r['forward_s'], 4) for r in res]} s), "
              f"efficiency {rate[R] / (R * rate[1]):.3f}", file=sys.stderr)
        R *= 2
    top = max(rate)
    return {"metric": f"weak-scaling efficiency at {top} ranks (batch axis)",
            "value": rate[top] / (top * rate[1]), "unit": "fraction",
            "network": "LoLaSmall, n = 8192, 6 + 1 limbs",
            "records_per_rank": per_rank,
            "throughput_rec_s": {str(k): v for k, v in rate.items()},
            "window_s": {str(k): v for k, v in windows.items()},
            "backend": backend or "nccl", "card": card()}


def run_batch_curve(device) -> dict:
    from cryptonets_tpu_torch.parallel.dryrun import dryrun_production
    from cryptonets_tpu_torch.parallel.mesh import make_mesh

    rate = {}
    for B in (1, 2, 4, 8, 16):
        res = dryrun_production(make_mesh(), n_records=B, device=device,
                                batched=True)
        rate[B] = B / res["window_s"]
        print(f"# one device, B = {B}: {rate[B]:.2f} rec/s", file=sys.stderr)
    return {"metric": "one-device record-batch scaling (16 vs 1)",
            "value": rate[16] / rate[1], "unit": "x",
            "network": "LoLaSmall, n = 8192, 6 + 1 limbs",
            "throughput_rec_s": {str(k): v for k, v in rate.items()},
            "card": card()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--batch", action="store_true")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--per-rank", type=int, default=16)
    ap.add_argument("--backend", default=None, help="nccl (default) or gloo")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.mesh:
        print(json.dumps(run_mesh_curve(args.ranks, args.per_rank, args.backend,
                                        args.device)))
    if args.batch:
        print(json.dumps(run_batch_curve(args.device)))


if __name__ == "__main__":
    main()
