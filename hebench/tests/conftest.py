"""Shared pieces of the benchmark's own tests: the `cuda` marker, and a
stand-in for the card and for the program, so that a run can be driven
on the CPU with the timed path replaced (`measure` in `hebench/run.py`).
Run with `python -m pytest hebench/tests` from the checkout's root; the
tests marked `cuda` skip without a card."""

import argparse

import numpy as np
import pytest

from hebench import spec
from hebench.control import StandIn


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


class HostCard:
    """The card's side of a run, on the CPU: nothing to synchronise, no
    device memory."""

    chips = 1

    def sync(self):
        pass

    def peak(self):
        return 0

    def reset_peak(self):
        pass

    def trim(self):
        pass

    def describe(self):
        return dict(platform="cpu-test", kind="none", count=0)


def args(cell, seed=7, seconds=0.3, trace=0):
    return argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)


@pytest.fixture
def weights():
    with np.load(spec.ROOT / "cryptonets_tpu/data/weights/cryptonets.npz") as z:
        return {k: np.asarray(z[k], dtype=np.float64) for k in z.files}


@pytest.fixture
def host_card():
    return HostCard()


@pytest.fixture
def standin():
    return StandIn


@pytest.fixture
def make_args():
    return args
