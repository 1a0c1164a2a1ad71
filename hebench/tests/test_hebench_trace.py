"""The trace's reduction on made-up events: busy time as the union of
device intervals inside the sub-window, device time by family, idle
gaps by the innermost host event over them."""

import pytest

from hebench.trace import SPAN, reduce


def ev(name, cat, ts, dur):
    return dict(name=name, cat=cat, ts=ts, dur=dur, ph="X")


def test_reduce():
    evs = [
        ev(SPAN, "user_annotation", 100.0, 100.0),
        ev(SPAN, "gpu_user_annotation", 100.0, 100.0),
        ev("hebench.forward", "user_annotation", 100.0, 60.0),
        ev("cudaGraphLaunch", "cuda_runtime", 150.0, 5.0),
        ev("hebench.decode", "user_annotation", 160.0, 40.0),
        ev("ntt_forward_kernel<13>", "kernel", 110.0, 20.0),
        ev("mod_mac_kernel<1, 2, 4>", "kernel", 120.0, 20.0),   # overlaps
        ev("elementwise", "kernel", 170.0, 10.0),
        ev("Memcpy DtoH", "gpu_memcpy", 195.0, 10.0),            # past the end
        ev("early", "kernel", 50.0, 10.0),                        # before the span
    ]
    r = reduce(evs, {"ntt": ("ntt_forward_kernel",), "mac": ("mod_mac_kernel",)})
    assert r["span_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert r["family_s"] == pytest.approx({"ntt": 20e-6, "mac": 20e-6})
    assert r["hand_s"] == pytest.approx(40e-6)
    assert r["device_s"] == pytest.approx(55e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    # idle 100-110 and 140-170 in forward (the midpoint of 140-170 lies in
    # cudaGraphLaunch's 150-155), 180-195 in decode
    assert gaps == pytest.approx({"hebench.forward": 10e-6, "cudaGraphLaunch": 30e-6,
                                  "hebench.decode": 15e-6})
    assert r["breakdown"]["device_ops"][0][1] == pytest.approx(20e-6)


def test_reduce_needs_the_span():
    with pytest.raises(RuntimeError):
        reduce([ev("k", "kernel", 0.0, 1.0)], {})


@pytest.mark.parametrize("frozen", [True, False])
def test_a_traced_run_reads_every_listed_metric(frozen, weights, host_card, standin,
                                                make_args, monkeypatch, capsys):
    """A `--trace 1` run prints every per-layer metric that its cell lists,
    or no result: without the cell's frozen work the rooflines and
    `step_mfu` have nothing to read, and the run names them and fails."""
    from hebench import run, spec
    from hebench.generate import Plan

    def traced(program, plan, count, served):
        r = len(served)
        for i in range(count):
            served.append((r + i, program.serve(plan.pixels, plan.indices(r + i))))
        return dict(requests=count, images=count, span_s=0.5, busy_s=0.2, device_s=0.3,
                    hand_s=0.1, family_s=dict(ntt=0.05, mac=0.02, bconv=0.01),
                    counters={"launch.ntt_forward": 300, "op.rotation": 70},
                    breakdown=dict(device_ops=[["k", 0.1]], idle_gaps=[["h", 0.3]]))

    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    monkeypatch.setattr(run, "traced", traced)
    if not frozen:
        monkeypatch.setattr(spec, "frozen", lambda cell: None)
    bench = spec.benchmark()
    cell = spec.workload(bench, "lola-mnist.single")
    config, mix = spec.config(cell["config"]), dict(spec.traffic("single"), pool_images=8,
                                                    trace_requests=2)
    go = lambda: run.measure(make_args(cell["name"], seconds=0.2, trace=1), bench, cell,  # noqa: E731
                             config, mix, weights, Plan(mix, 3), standin(config, weights),
                             host_card)
    listed = {m["name"] for m in spec.metrics_of(bench, cell["name"], True)}
    if frozen:
        out = go()
        assert set(out["metrics"]) == listed and out["correct"]
        assert 0 < out["metrics"]["step_mfu"]["value"] <= 100
        return
    with pytest.raises(SystemExit) as e:
        go()
    assert e.value.code != 0
    out, err = capsys.readouterr()
    assert not any(line.startswith("{") for line in out.splitlines())
    assert "step_mfu" in err and "ntt_roofline" in err and "keyswitch_roofline" in err
