"""What a run loads: after a tiny run no module has the top-level name of
JAX or of the JAX package; the reference loads nothing of the port; a
run without a card, or in a checkout without the port, exits non-zero
with no result."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from hebench import check, run, spec
from hebench.generate import Plan

ROOT = str(spec.ROOT)

TINY_RUN = r"""
import sys
sys.path.insert(0, "hebench/tests")
import numpy as np
from conftest import HostCard, args
from hebench.control import StandIn
from hebench import run, spec
from hebench.generate import Plan
import hebench.program, hebench.trace, hebench.work.freeze
import cryptonets_tpu_torch.nn.forward
for name in ("lola-mnist", "cryptonets-mnist-3p"):
    __import__(spec.config(name)["builder"]["module"])
bench = spec.benchmark()
cell = spec.workload(bench, "lola-mnist.single")
config, mix = spec.config(cell["config"]), dict(spec.traffic("single"), pool_images=8)
weights = run.load_weights(config)
run.measure(args(cell["name"], seconds=0.2), bench, cell, config, mix, weights,
            Plan(mix, 3), StandIn(config, weights), HostCard())
print("LOADED", sorted({m.split(".")[0] for m in sys.modules}))
"""

REFERENCE_ONLY = r"""
import sys
from hebench import spec
from hebench.check import reference_logits
from hebench.generate import images
from hebench.run import load_weights
config = spec.config("cryptonets-mnist-3p")
reference_logits(images(spec.traffic("single")["images"], 4, 1), config, load_weights(config))
print("LOADED", sorted({m.split(".")[0] for m in sys.modules}))
"""


def _loaded(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [x for x in p.stdout.splitlines() if x.startswith("LOADED ")][-1]
    return set(json.loads(line[len("LOADED "):].replace("'", '"')))


def test_a_tiny_run_loads_no_jax():
    loaded = _loaded(TINY_RUN)
    assert "cryptonets_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "cryptonets_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded(REFERENCE_ONLY)
    assert not loaded & {"cryptonets_tpu_torch", "cryptonets_tpu", "jax", "jaxlib", "torch"}


def _run(cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "hebench.run", "--workload", "lola-mnist.single",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_exits_without_a_result():
    p = _run(ROOT)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_benchmark_alone_exits_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "hebench"), tmp_path / "hebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


@pytest.mark.parametrize("where", ["reference", "reader"])
def test_a_module_loaded_after_the_window_stops_the_result(where, weights, host_card,
                                                            standin, make_args,
                                                            monkeypatch, capsys):
    """The reference and each metric reader are files found by name, loaded
    after the window: what they load is caught before the result line."""
    planted = "hebench_planted_forbidden"
    monkeypatch.setattr(run, "FORBIDDEN", run.FORBIDDEN + (planted,))

    def plant():
        monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))

    if where == "reference":
        # the comparison imports the configuration's reference module
        found = check.compare

        def compare(*args):
            plant()
            return found(*args)
        monkeypatch.setattr(check, "compare", compare)
    else:
        found = spec.reader

        def reader(metric):
            plant()
            return found(metric)
        monkeypatch.setattr(spec, "reader", reader)
    bench = spec.benchmark()
    cell = spec.workload(bench, "lola-mnist.single")
    config, mix = spec.config(cell["config"]), dict(spec.traffic("single"), pool_images=8)
    program = standin(config, weights)
    with pytest.raises(SystemExit) as e:
        run.measure(make_args(cell["name"], seconds=0.2), bench, cell, config, mix,
                    weights, Plan(mix, 3), program, host_card)
    assert e.value.code != 0
    out, err = capsys.readouterr()
    assert not any(line.startswith("{") for line in out.splitlines())
    assert planted in err
