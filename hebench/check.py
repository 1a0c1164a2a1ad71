"""The comparison that decides `correct`: the logits the timed path
decoded against the plain reference's, on the same images.

Every logit is an exact integer at the output scale (BFV decrypts
exactly while noise budget is left), so the comparison is exact: the
number compared is the count of logits that differ, and its limit is 0.
Which finished requests are compared is the mix's `compare`: all, or a
sample of that many drawn from the run's seed.
"""

from __future__ import annotations

import importlib
import sys

import numpy as np

BLOCK = 8192   # images a reference block


def reference(config: dict):
    return importlib.import_module(f"hebench.reference.{config['reference']}")


def sample(count: int, rule, seed: int) -> list[int]:
    """Indices of the finished requests to compare."""
    if rule == "all" or rule >= count:
        return list(range(count))
    return sorted(np.random.default_rng(seed).choice(count, rule, replace=False).tolist())


def reference_logits(images: np.ndarray, config: dict, weights: dict,
                     control: bool = False) -> tuple[np.ndarray, float]:
    """The reference's exact logits of images [B, H, W] (or, with
    `control`, the float64 control's), in blocks; and the output scale."""
    ref = reference(config)
    net = config["network"]
    qn = ref.quantize(net, weights)
    fn = ref.float64_logits if control else ref.exact_logits
    out = [fn(images[i:i + BLOCK], qn, net) for i in range(0, len(images), BLOCK)]
    return np.concatenate(out), float(qn["out_scale"])


def compare(served: list, scale: float, plan, mix: dict, config: dict,
            weights: dict) -> dict:
    """served: [(request index, logits [images, classes] exact ints)] of
    every finished request, in order; `scale` the scale the program
    decoded them at.  Returns {number: {"value", "limit"}} and the count
    of logits compared."""
    pick = sample(len(served), mix["compare"], plan.sample_seed)
    idx = np.concatenate([plan.indices(served[i][0]) for i in pick])
    got = np.concatenate([served[i][1] for i in pick])
    want, ref_scale = reference_logits(plan.pool[idx], config, weights)
    if got.shape != want.shape or scale != ref_scale:
        print(f"hebench: served logits {got.shape} at scale {scale}, the reference's "
              f"{want.shape} at {ref_scale}", file=sys.stderr)
        wrong = want.size
    else:
        wrong = int(np.count_nonzero(got != want))
    return dict(checks={"mismatched_logits": {"value": wrong, "limit": 0}},
                compared=int(want.size))
