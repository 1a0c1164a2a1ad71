"""The one traffic generator: every mix is a data file of parameters
(`traffic/<mix>.json`) that this module reads.

A mix states its loop (`closed`: each client sends its next request when
the last has come back), its clients, the images of a request, the pool
of distinct images that the requests draw from, the requests of the
traced sub-window and which finished requests the check compares.  Images are MNIST-like: a few Gaussian
blobs of ink on a black 28 x 28 canvas, rounded to 8-bit pixel values,
all drawn from the run's seed.  Request r takes `images_per_request`
consecutive images of the pool from a seeded offset on, so every seed
sends the same sizes in the same order and only the pixels differ.
"""

from __future__ import annotations

import numpy as np

CHUNK = 1024


def seeds(seed: int) -> dict:
    """Independent 32-bit seeds for each use, from the run's seed (any
    non-negative integer)."""
    names = ("images", "keys", "offset", "sample")
    state = np.random.SeedSequence(int(seed)).generate_state(len(names), np.uint32)
    return {k: int(v) for k, v in zip(names, state)}


def images(params: dict, count: int, seed: int) -> np.ndarray:
    """`count` images [count, H, W] of uint8 pixel values."""
    h, w = params["shape"]
    lo, hi = params["blobs"]
    c_lo, c_hi = params["center"]
    s_lo, s_hi = params["spread"]
    rng = np.random.default_rng(seed)
    axis_y, axis_x = np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64)
    out = np.empty((count, h, w), np.uint8)
    for start in range(0, count, CHUNK):
        n = min(CHUNK, count - start)
        k = rng.integers(lo, hi, n)                          # blobs an image
        cx = rng.integers(c_lo, c_hi, (n, hi - 1)).astype(np.float64)
        cy = rng.integers(c_lo, c_hi, (n, hi - 1)).astype(np.float64)
        s = rng.uniform(s_lo, s_hi, (n, hi - 1))
        amp = params["peak"] * (np.arange(hi - 1)[None, :] < k[:, None])
        # a blob exp(-((x - cx)^2 + (y - cy)^2) / s) is a product of a
        # row profile and a column profile
        gy = amp[..., None] * np.exp(-(axis_y[None, None] - cy[..., None]) ** 2 / s[..., None])
        gx = np.exp(-(axis_x[None, None] - cx[..., None]) ** 2 / s[..., None])
        img = np.einsum("nby,nbx->nyx", gy, gx)
        out[start:start + n] = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return out


class Plan:
    """The requests of a run: `Plan(mix, seed)`; `indices(r)` are the
    pool's images of request r; `pixels` the pool as float64 rows, the
    form the program's readers take."""

    def __init__(self, mix: dict, seed: int):
        if mix["loop"] != "closed" or mix["clients"] != 1:
            raise ValueError("the generator drives one client in a closed loop")
        s = seeds(seed)
        self.per_request = int(mix["images_per_request"])
        self.pool = images(mix["images"], int(mix["pool_images"]), s["images"])
        self.pixels = self.pool.reshape(len(self.pool), -1).astype(np.float64)
        self.offset = int(np.random.default_rng(s["offset"]).integers(len(self.pool)))
        self.sample_seed = s["sample"]
        self.key_seed = s["keys"]

    def indices(self, r: int) -> np.ndarray:
        start = self.offset + r * self.per_request
        return (start + np.arange(self.per_request)) % len(self.pool)
