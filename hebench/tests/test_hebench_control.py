"""The control (the reference in float64, the precision below the
configuration's exact integers) put in the program's place comes out as
not correct on three seeds, at a size a test run holds; the exact
reference in its place comes out correct.  At each cell's own size it
runs as `python3 -m hebench.control` (PERF.md gives its readings)."""

import pytest

from hebench import control, run, spec
from hebench.generate import Plan


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("cell", ["lola-mnist.single", "cryptonets-mnist-3p.batch8192"])
def test_control_is_not_correct(cell, seed, weights):
    c = control.readings(cell, seed, 6, weights, control=True)
    assert c["mismatched_logits"] > 0
    exact = control.readings(cell, seed, 2, weights, control=False)
    assert exact["mismatched_logits"] == 0 and exact["compared"] > 0


def test_control_through_a_run(weights, host_card, make_args, monkeypatch, capsys):
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    bench = spec.benchmark()
    cell = spec.workload(bench, "lola-mnist.single")
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    out = run.measure(make_args(cell["name"], seed=11, seconds=0.3), bench, cell, config,
                      mix, weights, Plan(mix, 11),
                      control.StandIn(config, weights, control=True), host_card)
    assert out["correct"] is False and out["checks"]["mismatched_logits"]["value"] > 0
    assert "check mismatched_logits" in capsys.readouterr().err
