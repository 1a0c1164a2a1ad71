"""A run driven on the CPU with the timed path replaced by a stand-in
that answers with the reference's logits: `correct` comes out true, and
false with each fault a cell can have planted under it (an answer
altered where it is produced, half of a batch left out, the last
request's state returned unchanged)."""

import json

import pytest

from hebench import run, spec
from hebench.generate import Plan

IMAGES = {"shape": [28, 28], "blobs": [3, 8], "center": [4, 24],
          "spread": [4.0, 16.0], "peak": 255.0}


def mix(per_request):
    return dict(loop="closed", clients=1, images_per_request=per_request,
                pool_images=40, trace_requests=0,
                compare="all", images=IMAGES)


@pytest.mark.parametrize("per_request, fault", [
    (1, None), (1, "altered"), (1, "unchanged"),
    (16, None), (16, "altered"), (16, "half_batch"), (16, "unchanged")])
def test_faults_come_out_not_correct(per_request, fault, weights, host_card, standin,
                                     make_args, monkeypatch, capsys):
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    bench = spec.benchmark()
    cell = spec.workload(bench, "lola-mnist.single")
    config, m = spec.config(cell["config"]), mix(per_request)
    plan = Plan(m, 7)
    out = run.measure(make_args(cell["name"], seconds=0.3), bench, cell, config, m,
                      weights, plan, standin(config, weights, fault=fault), host_card)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert out["attempted"] >= 2
    assert out["correct"] is (fault is None)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {"images_per_s", "latency_p95_ms", "setup_s"}
