"""The LoLa-CIFAR cell (`lola-cifar10-3p.single`) on the CPU: its plain
reference loads nothing of the port or of JAX; its weights file is its
seeded recipe; its configuration's scheme is the port's `cifar` preset;
a run with the timed path replaced by the reference comes out correct,
and not correct with each fault planted under it; the float64 control
comes out not correct on three seeds."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from hebench import control, run, spec
from hebench.generate import Plan

CELL = "lola-cifar10-3p.single"
ROOT = str(spec.ROOT)

REFERENCE_ONLY = r"""
import sys
from hebench import spec
from hebench.check import reference_logits
from hebench.generate import images
from hebench.run import load_weights
config = spec.config("lola-cifar10-3p")
reference_logits(images(spec.traffic("single-rgb32")["images"], 2, 1), config,
                 load_weights(config))
print("LOADED", sorted({m.split(".")[0] for m in sys.modules}))
"""


@pytest.fixture(scope="module")
def cell():
    bench = spec.benchmark()
    c = spec.workload(bench, CELL)
    config, mix = spec.config(c["config"]), spec.traffic(c["traffic"])
    return bench, c, config, mix, run.load_weights(config)


def test_the_reference_loads_nothing_of_the_port():
    p = subprocess.run([sys.executable, "-c", REFERENCE_ONLY], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [x for x in p.stdout.splitlines() if x.startswith("LOADED ")][-1]
    loaded = set(json.loads(line[len("LOADED "):].replace("'", '"')))
    assert "torch" in loaded
    assert not loaded & {"cryptonets_tpu_torch", "cryptonets_tpu", "jax", "jaxlib", "flax"}


def test_weights_file_is_its_seeded_recipe(cell):
    """N(0, 0.05) from numpy's default_rng(3), drawn in the order and
    shapes of the port's stand-ins, stored as float32."""
    *_, weights = cell
    sizes = dict(w0=83 * 3 * 64, b0=83, w1=112 * 83 * 100, b1=112, w2=10 * 5488, b2=10)
    rng = np.random.default_rng(3)
    assert list(weights) == list(sizes)
    for name, size in sizes.items():
        want = rng.normal(0, 0.05, size=size).astype(np.float32).astype(np.float64)
        assert np.array_equal(weights[name], want), name


def test_scheme_is_the_ports_cifar_preset(cell):
    from cryptonets_tpu_torch.crypto.bfv import BFV, BFVParams
    from cryptonets_tpu_torch.crypto.primes import default_coeff_modulus_128
    from cryptonets_tpu_torch.models.presets import CONFIGS

    *_, config, _, _ = cell
    s, preset = config["scheme"], CONFIGS[config["scheme"]["preset"]]
    assert s["n"] == preset["n"] and s["limbs"] == preset["coeff_count"]
    assert s["plain_primes"] == list(preset["plain_primes"])
    assert config["network"]["plain_modulus"] == math.prod(s["plain_primes"])
    chain = default_coeff_modulus_128(s["n"])[:s["limbs"]]
    params = BFVParams(s["n"], s["plain_primes"][0], coeff_modulus=chain,
                       n_special=preset["n_special"], device="cpu")
    # the factory lola_cifar.build makes: the power-of-two ladder, -196 and
    # the column key
    assert len(BFV(params).galois_elements((-196,))) == s["galois_keys"]


@pytest.mark.parametrize("fault", [None, "altered", "half_batch", "unchanged"])
def test_faults_come_out_not_correct(fault, cell, host_card, make_args, monkeypatch,
                                     capsys):
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    bench, c, config, mix, weights = cell
    mix = dict(mix, pool_images=8)
    out = run.measure(make_args(CELL, seconds=1.5), bench, c, config, mix, weights,
                      Plan(mix, 2**31 + 5), control.StandIn(config, weights, fault=fault),
                      host_card)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["attempted"] >= 2
    assert out["correct"] is (fault is None)
    assert (out["checks"]["mismatched_logits"]["value"] > 0) is (fault is not None)
    assert set(out["metrics"]) == {"images_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_is_not_correct(seed, cell):
    *_, weights = cell
    c = control.readings(CELL, seed, 4, weights, control=True)
    assert c["mismatched_logits"] > 0
    exact = control.readings(CELL, seed, 2, weights, control=False)
    assert exact["mismatched_logits"] == 0 and exact["compared"] == 20
