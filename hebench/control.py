"""The control of the comparison that decides `correct`: the reference
put in the program's place, computed in float64, the precision below the
configuration's exact integers.  It has to come out as not correct.

    python3 -m hebench.control --workload <cell> --seeds 1,2,3 --requests N

serves N requests of the cell's traffic (as many as a run of the cell
finishes in its window, PERF.md) from each seed with the control's
answers and compares them as a run does (`check.compare`); prints each
seed's count of mismatched logits beside the count compared.  `StandIn` is also
what the CPU tests drive a run with, with a fault planted or none.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import check, spec
from .generate import Plan

class StandIn:
    """A program that answers with the reference's exact logits, or with
    `control` the float64 control's; `fault` breaks each answer where it
    is produced: "altered" (one logit changed by one), "half_batch" (the
    second half of the images left out), "unchanged" (the last request's
    answer returned again)."""

    def __init__(self, config: dict, weights: dict, fault=None, control: bool = False):
        self.config, self.weights = config, weights
        self.fault, self.control = fault, control
        self.scale, self.last = None, None
        self.shape = tuple(config["network"]["input"])

    def serve(self, pixels, idx):
        images = pixels[idx].reshape((len(idx),) + self.shape)
        if self.fault == "half_batch":
            images = images.copy()
            images[len(images) // 2:] = 0
        logits, self.scale = check.reference_logits(images, self.config, self.weights,
                                                    control=self.control)
        if self.fault == "altered":
            logits = logits.copy()
            logits[0, 0] += 1
        if self.fault == "unchanged" and self.last is not None:
            logits = self.last
        self.last = logits
        return logits

    @staticmethod
    def counters() -> dict:
        return {}


def readings(cell_name: str, seed: int, requests: int, weights: dict,
             control: bool = True) -> dict:
    """The compared numbers of `requests` requests of the cell answered by
    the control (or by the exact reference)."""
    cell = spec.workload(spec.benchmark(), cell_name)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    plan = Plan(mix, seed)
    prog = StandIn(config, weights, control=control)
    served = [(r, prog.serve(plan.pixels, plan.indices(r))) for r in range(requests)]
    v = check.compare(served, prog.scale, plan, mix, config, weights)
    return dict(seed=seed, compared=v["compared"],
                **{k: c["value"] for k, c in v["checks"].items()})


def main(argv=None) -> int:
    from .run import load_weights

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    cell = spec.workload(spec.benchmark(), args.workload)
    weights = load_weights(spec.config(cell["config"]))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(dict(workload=args.workload, requests=args.requests,
                              **readings(args.workload, seed, args.requests, weights))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
