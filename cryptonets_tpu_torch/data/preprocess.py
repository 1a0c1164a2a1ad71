"""Seeded synthetic records, so the pipelines run without downloaded data
(the generators of `cryptonets_tpu/data/preprocess.py`, same seed -> same
records): MNIST-like images, CIFAR-like images and Caltech-101 feature
vectors."""

from __future__ import annotations

import numpy as np


def synthetic_mnist_records(count: int, seed: int = 0):
    """`count` (label, 784 float pixels) records: 28x28 uint8-valued
    images made of a few Gaussian blobs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        img = np.zeros((28, 28))
        for _ in range(rng.integers(3, 8)):
            cx, cy = rng.integers(4, 24, 2)
            yy, xx = np.mgrid[0:28, 0:28]
            img += 255.0 * np.exp(
                -((xx - cx) ** 2 + (yy - cy) ** 2) / rng.uniform(4, 16)
            )
        img = np.clip(img, 0, 255).round()
        out.append((int(rng.integers(0, 10)), img.ravel()))
    return out


def synthetic_cifar_records(count: int, seed: int = 0):
    """`count` (label, 3 * 32 * 32 float pixels) records: uniform uint8
    values, channel-major."""
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(0, 10)),
         rng.integers(0, 256, 3 * 32 * 32).astype(np.float64))
        for _ in range(count)
    ]


def synthetic_feature_records(count: int, dim: int, seed: int = 0):
    """`count` (label below 102, `dim` non-negative float features)
    records: a stand-in for the AlexNet features of Caltech-101."""
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(0, 102)), np.abs(rng.normal(0, 1.0, dim)))
        for _ in range(count)
    ]
