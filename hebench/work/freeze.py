"""Freeze the work of one request of a cell: the least time of its hand
kernels' launches at the card's peaks, by family.

    python3 -m hebench.work.freeze --workload <cell> [--seed N] [--out FILE]

Builds the cell as a run does, serves its warm-up request (which
captures the CUDA graph), then runs the captured request's body
once more, eagerly, under `WorkRecorder`: every K1/K2, K4, K6 and K7
launch adds its bound (`bounds.py`).  The launches it saw must equal
those the graph replays (the port's counts taken at capture).  Prints
the JSON that `work/<cell>.json` holds; the traced runs divide it by
measured time, so the work stays fixed whatever later implements it.
Needs the card; it patches the port's kernel wrappers, so no timed or
traced run uses it.
"""

from __future__ import annotations

import argparse
import json
import sys

from .. import spec
from ..generate import Plan
from ..run import load_weights
from .record import FAMILIES, WorkRecorder

HOW = ("one request's body (the CUDA graph's captured function) run once "
       "eagerly after the warm-up, each hand-kernel launch's least time summed "
       "by family: K1/K2 ntt_bound, K4 contract_bound, K6 mac_bound, K7 "
       "bconv_bound of hebench/work/bounds.py (HBM 3.35e12 B/s, int32 multiplies "
       "132 x 64 x 1.98e9 /s, int8 tensor 1.979e15 /s); launches equal to the "
       "graph's captured counts")


def freeze(cell_name: str, seed: int) -> dict:
    import torch

    from ..program import Program

    bench = spec.benchmark()
    cell = spec.workload(bench, cell_name)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    plan = Plan(mix, seed)
    program = Program(config, load_weights(config), plan.key_seed)
    program.serve(plan.pixels, plan.indices(-1))     # the run's warm-up
    fwd = program.forward
    (key, graph), = fwd.graphs().items()
    body = fwd.record_fn(*key[1:])
    with WorkRecorder() as rec:
        body(*graph.inputs)
        torch.cuda.synchronize()
    if rec.unbounded:
        raise SystemExit(f"launches with no bound here: {dict(rec.unbounded)}")
    captured = {k: v for table in graph.delta[1] for k, v in table.items()}
    seen = {f: rec.families[f]["launches"] for f in FAMILIES}
    want = {f: sum(captured.get(k, 0) for k in names) for f, (names, _) in FAMILIES.items()}
    if seen != want:
        raise SystemExit(f"recorded launches {seen} differ from the graph's {want}")
    fam = {f: v for f, v in rec.families.items() if v["launches"]}
    return dict(
        cell=cell_name, images=plan.per_request,
        bound_ms=dict({f: v["bound_ms"] for f, v in fam.items()},
                      total=sum(v["bound_ms"] for v in fam.values())),
        launches={f: v["launches"] for f, v in fam.items()},
        bytes_ms={f: v["bytes_ms"] for f, v in fam.items()},
        ops_ms={f: v["ops_ms"] for f, v in fam.items()},
        how=HOW, card=torch.cuda.get_device_name(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = freeze(args.workload, args.seed)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
