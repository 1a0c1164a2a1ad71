"""Streaming throughput of the port's layer pipeline
(`parallel/pipeline.py`), the counterpart of `scripts/pipeline_throughput.py`:
LoLa (`build_lola_bsgs`, full width and depth) as one stage and as S stages, each stage on its own CUDA
stream (all on `--device`, or one card a stage with `--spread`), records
per second of the records streamed after one that fills the stages (host
clock, every stage synchronised), every record's decoded output checked
against the Raw oracle.  Prints one JSON line with the card's name and
power limit.

Usage: python scripts/torch_pipeline_throughput.py [--records 16] [--stages 4] [--device cuda] [--spread]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(encrypt: bool, device=None):
    from cryptonets_tpu_torch.models.lola_mnist import build_lola_bsgs

    head, fac, reader = build_lola_bsgs(encrypt, device=device)
    head.prepare_network()
    return head, fac, reader


def main():
    import numpy as np
    import torch

    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.parallel import PipelineForward

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=16)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--spread", action="store_true",
                    help="one card a stage (cuda:0, cuda:1, ...)")
    args = ap.parse_args()
    recs = synthetic_mnist_records(args.records + 1, seed=29)
    raw_head, _, raw_reader = build(False)
    raw_reader.set_source_records([(lb, f.copy()) for lb, f in recs])
    raws = [raw_head.get_next().get_column(0).decrypt() for _ in recs]
    out = {}
    for s in (1, args.stages):
        head, fac, reader = build(True, args.device)
        reader.set_source_records([(lb, f.copy()) for lb, f in recs])
        devices = ([f"cuda:{i}" for i in range(s)] if args.spread
                   else [fac.device] * s)
        pipe = PipelineForward(head, n_stages=s, devices=devices)
        outs = pipe.run_stream(1)            # fills the stages
        t0 = time.perf_counter()
        outs += pipe.run_stream(args.records)
        dt = time.perf_counter() - t0
        for i, (o, want) in enumerate(zip(outs, raws)):
            got = o.get_column(0).decrypt()
            if not np.allclose(got[: len(want)], want, rtol=1e-9, atol=1e-9):
                raise SystemExit(f"{s} stages, record {i}: {got[:4]} != {want[:4]}")
        out[f"stages_{s}"] = {"layers": [len(g) for g in pipe.groups],
                              "records": args.records, "seconds": dt,
                              "records_per_sec": args.records / dt}
        print(f"# {s} stage(s): {args.records} records in {dt:.3f} s "
              f"({args.records / dt:.2f} rec/s), every record exact",
              file=sys.stderr)
    if torch.cuda.is_available():
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    out["network"] = "LoLa"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
