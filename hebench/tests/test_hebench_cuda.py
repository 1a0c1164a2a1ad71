"""On the card, at each cell's own size: the port served through a short
window comes out correct, and with each fault planted under its timed
path (an answer altered where it is produced, half of a batch left out,
the last request's answer returned unchanged) not correct.  Run on the
card with `python3 -m pytest hebench/tests/test_hebench_cuda.py -m cuda`;
skips without one."""

import pytest

from hebench import run, spec
from hebench.generate import Plan

SECONDS = {"lola-mnist.single": 3.0, "cryptonets-mnist-3p.batch8192": 6.0}
FAULTS = {"lola-mnist.single": (None, "altered", "unchanged"),
          "cryptonets-mnist-3p.batch8192": (None, "altered", "half_batch", "unchanged")}


class Planted:
    """The port's program with a fault under its serve."""

    def __init__(self, program, fault):
        self.program, self.fault, self.last = program, fault, None

    @property
    def scale(self):
        return self.program.scale

    def counters(self):
        return self.program.counters()

    def serve(self, pixels, idx):
        if self.fault == "half_batch":
            pixels = pixels.copy()
            pixels[idx[len(idx) // 2:]] = 0
        logits = self.program.serve(pixels, idx)
        if self.fault == "altered":
            logits = logits.copy()
            logits[0, 0] += 1
        if self.fault == "unchanged" and self.last is not None:
            logits = self.last
        self.last = logits
        return logits


@pytest.fixture(scope="module")
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run on the card only")
    return run.Card(1)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", list(FAULTS))
def test_planted_faults_on_the_card(cell_name, card, make_args):
    from hebench.program import Program

    bench = spec.benchmark()
    cell = spec.workload(bench, cell_name)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    weights = run.load_weights(config)
    plan = Plan(mix, 2024)
    program = Program(config, weights, plan.key_seed)
    seen = {}
    for fault in FAULTS[cell_name]:
        out = run.measure(make_args(cell_name, seed=2024, seconds=SECONDS[cell_name]),
                          bench, cell, config, mix, weights, plan,
                          Planted(program, fault), card)
        seen[fault] = (out["correct"], out["checks"]["mismatched_logits"]["value"],
                       out["attempted"])
    print(cell_name, seen)
    assert seen[None][0] is True
    assert all(v[0] is False for f, v in seen.items() if f is not None)
