"""The 95th percentile of the latency of every request of the window, on
the host clock: from handing the images to the program until the decoded
logits are on the host (linear interpolation between order statistics)."""

import numpy as np


def read(rec):
    return 1e3 * float(np.percentile([b - a for a, b, _ in rec["times"]], 95))
