"""Everything found by name: cells, configurations, mixes, metric
readers; `BENCHMARK.json` within its contract's shape; the generator
seeded and steady in its sizes; the readers on a made-up record."""

import re

import numpy as np
import pytest

from hebench import generate, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"_dim$|_rank$|hidden|intermediate|latent|state|projection|head|"
                   r"expansion|experts|width|maps|outputs|inputs")


def test_benchmark_shape():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["hebench"] and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["file"] == f"hebench/configs/{c['name']}.json"
        assert len(c["why"]) <= 200 and c["reduced"] == spec.config(c["name"])["reduced"]
        assert not [k for k in c["reduced"] if WIDTH.search(k)]


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_every_cell_finds_its_files(cell):
    b = spec.benchmark()
    w = spec.workload(b, cell)
    config, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    assert config["name"] == w["config"]
    assert config["reduced"] == [c for c in b["configs"] if c["name"] == w["config"]][0]["reduced"]
    assert mix["loop"] == "closed" and mix["clients"] == 1
    assert (spec.ROOT / config["weights"]["file"]).exists()
    e2e = {m["name"] for m in spec.metrics_of(b, cell, False)}
    assert {"setup_s", "images_per_s"} <= e2e
    layers = spec.metrics_of(b, cell, True)
    assert layers
    for m in spec.metrics_of(b, cell, False) + layers:
        assert callable(spec.reader(m["name"]))


def test_metrics_by_cell():
    b = spec.benchmark()
    assert "latency_p95_ms" not in {m["name"] for m in
                                    spec.metrics_of(b, "cryptonets-mnist-3p.batch8192", False)}
    lola = {m["name"] for m in spec.metrics_of(b, "lola-mnist.single", True)}
    cn = {m["name"] for m in spec.metrics_of(b, "cryptonets-mnist-3p.batch8192", True)}
    assert lola - cn == {"rotations_per_image"} and len(cn) == 7


def test_unknown_names():
    with pytest.raises(SystemExit):
        spec.workload(spec.benchmark(), "no-such.cell")
    assert spec.frozen("no-such.cell") is None


def test_generator_seeded_and_steady():
    mix = spec.traffic("batch8192")
    a = generate.images(mix["images"], 50, 3)
    assert a.shape == (50, 28, 28) and a.dtype == np.uint8
    assert np.array_equal(a, generate.images(mix["images"], 50, 3))
    assert not np.array_equal(a, generate.images(mix["images"], 50, 4))
    big = 2**31 + 12345
    p, q = generate.Plan(spec.traffic("single"), big), generate.Plan(spec.traffic("single"), 5)
    assert p.per_request == q.per_request == 1 and p.pool.shape == q.pool.shape
    assert p.key_seed != q.key_seed and 0 <= p.key_seed < 2**32
    assert np.array_equal(p.pool, generate.Plan(spec.traffic("single"), big).pool)
    r = generate.Plan(dict(mix, pool_images=100, images_per_request=64), 9)
    assert [len(set(r.indices(i).tolist())) for i in range(3)] == [64] * 3
    with pytest.raises(ValueError):
        generate.Plan(dict(mix, clients=2), 1)


def test_readers_on_a_record():
    frozen = dict(bound_ms=dict(ntt=2.0, mac=1.0, bconv=0.5, total=4.0))
    trace = dict(requests=10, images=10, span_s=0.5, busy_s=0.2, device_s=0.3,
                 hand_s=0.1, family_s=dict(ntt=0.05, mac=0.02, bconv=0.01),
                 counters={"launch.ntt_forward": 300, "launch.mod_mac": 20,
                           "op.rotation": 70})
    rec = dict(setup_s=9.0, times=[(0.0, 0.1, 1), (0.1, 0.3, 1)], window_s=0.3,
               images=2, window_peak_bytes=2**31, trace=trace, frozen=frozen)
    value = {m: spec.reader(m)(rec) for m in (
        "images_per_s", "setup_s", "latency_p95_ms", "device_idle_share", "peak_mem_gib",
        "step_mfu", "ntt_roofline", "keyswitch_roofline", "glue_ms_per_image",
        "hand_launches_per_image", "rotations_per_image")}
    assert value["images_per_s"] == pytest.approx(2 / 0.3)
    assert value["latency_p95_ms"] == pytest.approx(195.0)
    assert value["device_idle_share"] == pytest.approx(60.0)
    assert value["peak_mem_gib"] == 2.0
    assert value["step_mfu"] == pytest.approx(100 * 0.04 / 0.5)
    assert value["ntt_roofline"] == pytest.approx(40.0)
    assert value["keyswitch_roofline"] == pytest.approx(100 * 0.015 / 0.03)
    assert value["glue_ms_per_image"] == pytest.approx(20.0)
    assert value["hand_launches_per_image"] == 32.0
    assert value["rotations_per_image"] == 7.0
    # nothing to read: nothing returned, never a 0 share
    rec.update(trace=None, frozen=None)
    for m in ("device_idle_share", "step_mfu", "ntt_roofline", "keyswitch_roofline",
              "glue_ms_per_image", "hand_launches_per_image", "rotations_per_image"):
        assert spec.reader(m)(rec) is None
