"""Fresh-ciphertext and key-switch noise of the port's keygen and encrypt
against the JAX package's own, each package with its own keys and
randomness (ROADMAP.md §3.2, and a test of §3.1's cause).

For each seed, each package makes its keys (`BFV.keygen(seed)`, the
power-of-two ladder), encrypts zero and measures the invariant noise,
log2 max |d| over the coefficients (`crypto/noise.coefficient_noise`),
of the fresh ciphertext, of its square (`multiply`, size 3), of that
square relinearized, and of the fresh ciphertext rotated by one slot
(`rotate_rows`: one Galois key switch); and the key switches' own noise,
t times the largest change they make to the phase: relin_switch the
relinearized square's phase less the square's, rotate_switch the rotated
phase less the fresh phase under the same automorphism.  With a zero
message d is t times the ciphertext's noise polynomial, free of the
rounding term (q mod t) m that a message adds (with uniform coefficients
that term alone sets max |d| for every seed).  The torch streams cannot
replay `jax.random`, so the two are compared as distributions over the
seeds.

The tier-1 test runs a small ring (n = 1024, the `lola` preset's digit
switching and the `lola_dense` preset's special-prime switching on short
chains).  The same comparison at the presets' real parameters, the
one-off measurement behind ROADMAP.md §3.2 (it imports both packages, so
it lives here and not under `scripts/torch_*`, which must not import the
JAX package):

    JAX_PLATFORMS=cpu python tests/test_torch_fresh_noise.py \
        --preset lola --seeds 32 [--out noise_lola.json]
"""

from __future__ import annotations

import math
import os
import statistics
import sys

import numpy as np

if __name__ == "__main__":       # the real-parameter run, from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import pytest
else:
    import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu.crypto import bfv as jbfv  # noqa: E402
from cryptonets_tpu.models.presets import CONFIGS as JCONFIGS  # noqa: E402
from cryptonets_tpu_torch.crypto import bfv as tbfv  # noqa: E402
from cryptonets_tpu_torch.crypto.noise import centered_phase  # noqa: E402
from cryptonets_tpu_torch.crypto.primes import default_coeff_modulus_128, ntt_primes  # noqa: E402
from cryptonets_tpu_torch.models.presets import CONFIGS  # noqa: E402

STAGES = ("fresh", "square", "relin", "rotate", "relin_switch", "rotate_switch")
# the encryptions' seed beside the keys' (as both factories derive theirs):
# one seed for both would draw the encryption's ternary u equal to the
# secret s (the generators' first draws, and jax.random's split keys), and
# the noise u e_pk - e2 s would cancel in part
ENCRYPT_SEED = 0x5EED


def _bits(d) -> float:
    x = int(max(abs(int(v)) for v in d))
    shift = max(0, x.bit_length() - 60)
    return math.log2(x >> shift) + shift if x else 0.0


def _chain(cfg) -> tuple:
    if "coeff_modulus" in cfg:
        return tuple(cfg["coeff_modulus"])
    chain = default_coeff_modulus_128(cfg["n"])
    return chain[:cfg["coeff_count"]] if cfg.get("coeff_count") else chain


def _kwargs(cfg) -> dict:
    return dict(dbc=cfg.get("dbc", 16), n_special=cfg.get("n_special", 0),
                ks_alpha=cfg.get("ks_alpha", 0))


def noise_bits(package: str, cfg: dict, seeds) -> list[dict]:
    """log2 max |d| of the four stages (module docstring) under one
    package's keygen and encrypt, plain prime cfg["plain_primes"][0], one
    dict a seed (one parameter set and BFV for every seed)."""
    n, t = cfg["n"], cfg["plain_primes"][0]
    if package == "jax":
        import jax

        p = jbfv.BFVParams(n, t, coeff_modulus=_chain(cfg), **_kwargs(cfg))
    else:
        p = tbfv.BFVParams(n, t, coeff_modulus=_chain(cfg), device="cpu",
                           **_kwargs(cfg))
    bfv = (jbfv if package == "jax" else tbfv).BFV(p)
    rows = []
    for seed in seeds:
        m = np.zeros(n, dtype=np.int64)
        keys = bfv.keygen(seed=seed, column_key=False)
        if package == "jax":
            ct = bfv.encrypt(keys, jax.numpy.asarray(p.plain_to_residues(m)),
                             jax.random.key(seed ^ ENCRYPT_SEED))
        else:
            pt = torch.from_numpy(p.plain_to_residues(m).view(np.int32))
            ct = bfv.encrypt(keys, pt, torch.Generator().manual_seed(seed ^ ENCRYPT_SEED))
        sq = bfv.multiply(ct, ct)
        outs = dict(fresh=ct, square=sq, relin=bfv.relinearize(sq, keys),
                    rotate=bfv.rotate_rows(ct, 1, keys))
        phase = {k: centered_phase(p, np.asarray(
            bfv.raw_decrypt_residues(keys, v)).view(np.uint32))
            for k, v in outs.items()}
        row = {k: _bits(t * w - p.q_big * ((2 * t * w + p.q_big) // (2 * p.q_big)))
               for k, w in phase.items()}
        src, neg = tbfv._automorphism_tables_np(n, bfv.galois_elt_rows(1))
        moved = np.where(neg, -phase["fresh"][src], phase["fresh"][src])
        row["relin_switch"] = _bits(t * (phase["relin"] - phase["square"]))
        row["rotate_switch"] = _bits(t * (phase["rotate"] - moved))
        rows.append(row)
    return rows


def compare(cfg: dict, seeds) -> dict:
    """Per package and stage: the noise bits of every seed and their
    mean, standard deviation, least and largest."""
    out = {}
    for package in ("jax", "torch"):
        rows = noise_bits(package, cfg, seeds)
        out[package] = {
            k: dict(bits=[r[k] for r in rows],
                    mean=statistics.fmean(r[k] for r in rows),
                    std=statistics.pstdev(r[k] for r in rows),
                    min=min(r[k] for r in rows), max=max(r[k] for r in rows))
            for k in STAGES}
    return out


# small rings with the presets' kinds of key switching: `lola`'s digits
# (dbc = 8, no special prime) and `lola_dense`'s special primes (groups of
# two data limbs, two special primes), plain primes of either preset's size
SMALL = {
    "lola": dict(plain_primes=(557057,), n=1024, dbc=8,
                 coeff_modulus=ntt_primes(1024, 30, 3)),
    "lola_dense": dict(plain_primes=(ntt_primes(1024, 35, 1)[0],), n=1024,
                       coeff_modulus=ntt_primes(1024, 30, 6), n_special=2),
}


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_fresh_and_key_switch_noise_match_the_reference(kind):
    """At a small ring, over 8 seeds, the port's noise after each stage
    has the JAX package's distribution: the means within half a bit and
    the extremes within one bit, key switching adding as little to the
    fresh noise in either package."""
    torch.set_num_threads(1)
    got = compare(SMALL[kind], range(8))
    for k in STAGES:
        j, t = got["jax"][k], got["torch"][k]
        assert abs(j["mean"] - t["mean"]) <= 0.5, (k, j, t)
        assert abs(j["max"] - t["max"]) <= 1.0, (k, j, t)
        assert abs(j["min"] - t["min"]) <= 1.0, (k, j, t)


def test_coefficient_noise_agrees_with_the_budget_and_the_decrypt():
    """`coefficient_noise` on a ciphertext of the JAX package: its m is
    the exact decrypt, and floor(log2(q / 2) - log2 max |d|) is the
    budget both packages report."""
    import jax

    from cryptonets_tpu.crypto.noise import noise_residues_budget as jbudget
    from cryptonets_tpu_torch.crypto.noise import (coefficient_noise,
                                                   noise_residues_budget)

    cfg = SMALL["lola_dense"]
    p = jbfv.BFVParams(cfg["n"], cfg["plain_primes"][0], coeff_modulus=_chain(cfg),
                       **_kwargs(cfg))
    bfv = jbfv.BFV(p)
    keys = bfv.keygen(seed=4, column_key=False)
    m = np.random.default_rng(4).integers(0, p.t, p.n, dtype=np.int64)
    ct = bfv.encrypt(keys, jax.numpy.asarray(p.plain_to_residues(m)),
                     jax.random.key(4 ^ ENCRYPT_SEED))
    limbs = np.asarray(bfv.raw_decrypt_residues(keys, ct))
    d, got = coefficient_noise(p, limbs)
    assert list(got) == list(m)
    assert list(got) == list(np.asarray(bfv.decrypt(keys, ct)).astype(object))
    worst = int(max(abs(int(x)) for x in d))
    want = p.q_big.bit_length() - 1 - worst.bit_length()
    assert noise_residues_budget(p, limbs) == jbudget(p, limbs) == want


def test_presets_agree_with_the_reference():
    """The two presets' parameters are the JAX package's."""
    for name in ("lola", "lola_dense"):
        assert CONFIGS[name] == JCONFIGS[name]


def main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=("lola", "lola_dense"), default="lola")
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args()
    cfg = dict(CONFIGS[args.preset])
    got = compare(cfg, range(args.seeds))
    for package, stages in got.items():
        for k, s in stages.items():
            print(f"{args.preset} {package:5s} {k:6s} mean {s['mean']:.3f} std "
                  f"{s['std']:.3f} min {s['min']:.3f} max {s['max']:.3f} bits",
                  flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(preset=args.preset, seeds=args.seeds, t=cfg["plain_primes"][0],
                           n=cfg["n"], result=got), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
