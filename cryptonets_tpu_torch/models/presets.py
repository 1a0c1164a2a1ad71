"""Parameter presets of the port.

The port's copy of the eleven entries of `cryptonets_tpu/models/presets.py`.
The reference truncates SEAL's CoeffModulus128(n) chain with
SmallModulusCount; the chains here have 31-bit limbs, so a preset matches
the TOTAL bit width of the truncated SEAL chain (`coeff_count_for`): the
same security and noise capacity over more limbs.
  * `default` (`IFactory.cs:244-253`): the reference's default factory,
    n = 4096 over the default three-limb chain, five plain primes; the
    Basic Example's ring.
  * `lola`: the full seven-limb chain at n = 8192 (217 of the 218 bits
    that 128-bit security allows), the reference's plain primes
    (`LoLaCryptonets.cs:208`) and digit key switching at dbc=8: the
    reference packing (LoLaPacked) keeps 7-11 bits of final budget at
    dbc=8 and as little as 0 at dbc=16.  LoLa's BSGS network passes
    ks_alpha=1 (RNS-group switching, where dbc plays no part).
  * `cryptonets`: the same chain, three ~30-bit NTT-friendly plain primes
    (~90 bits of CRT message capacity, more than the two ~39-bit primes of
    `CryptoNets.cs:17`), so slot encode and decode run on the device;
    digit key switching at dbc=16 (SEAL 3.2's).
  * `lola_small` (`LoLaCryptonets.cs:283`, 3 of SEAL's 5 limbs at 8192):
    five data limbs and two special primes, hybrid key switching.
  * `caltech` (`Caltech101.cs:21`, 2 of 3 limbs at 4096): three limbs,
    digit key switching at dbc=16.
  * `lola_large` (`LoLaCryptonets.cs:341`, 7 of SEAL's 9 limbs at 16384):
    eleven data limbs and three special primes, and three ~30-bit
    NTT-friendly plain primes in place of the reference's three primes
    just above 2**31, so slot encode and decode run on the device.
  * `cifar` (`LolaCifarCryptoNet.cs:35`, 8 of SEAL's 9 limbs at 16384):
    thirteen data limbs and one special prime, three ~30-bit NTT-friendly
    plain primes in place of the reference's two ~40-bit ones.
  * `lola_dense` (`LoLaCryptonets.cs:123`, 7 of 9 limbs at 16384): the
    reference's plain primes near 2**35, twelve data limbs and two special
    primes.
  * `cryptonets_bigt` (`CryptoNets.cs:17`): the reference's two ~39-bit
    plain primes at n = 8192 over the full chain.
  * `lola_large_bigt` (`LoLaCryptonets.cs:341`): `lola_large`'s ring with
    the reference's three plain primes just above 2**31.
  * `cifar_bigt` (`LolaCifarCryptoNet.cs:35`): `cifar`'s ring with the
    reference's two plain primes near 2**40.
The last four have plain primes of 2**31 and above: their factories
encode on the host and decrypt through the two-plane form, and their
conv-as-dense layers take per-row dots with a forced dense output (BSGS
needs the device encode).  Data plus
special limbs stay within the ring degree's 128-bit budget (checked
below).  A preset names no NTT: `make_factory` passes the caller's
`ntt_impl` through.
"""

from __future__ import annotations

import math

from ..crypto.primes import SECURITY_BITS_128, default_coeff_modulus_128, ntt_primes

# SEAL 3.2 CoeffModulus128 limb bit widths per ring degree (public
# constants of SEAL's defaultparams.h).
SEAL_128_CHAIN_BITS = {
    1024: [27],
    2048: [54],
    4096: [36, 36, 37],
    8192: [43, 43, 44, 44, 44],
    16384: [48, 48, 48, 49, 49, 49, 49, 49, 49],
}


def coeff_count_for(n: int, small_modulus_count: int | None = None) -> int:
    """Number of 31-bit limbs matching the (truncated) SEAL chain width."""
    bits = SEAL_128_CHAIN_BITS[n]
    if small_modulus_count is not None:
        bits = bits[:small_modulus_count]
    ours = default_coeff_modulus_128(n)
    return min(math.ceil(sum(bits) / ours[0].bit_length()), len(ours))


CONFIGS = {
    "default": dict(
        plain_primes=(40961, 65537, 114689, 147457, 188417), n=4096,
    ),
    "lola": dict(
        plain_primes=(557057, 638977, 737281, 786433), n=8192, dbc=8,
    ),
    "cryptonets": dict(
        plain_primes=ntt_primes(8192, 30, 3), n=8192, dbc=16, ks_alpha=0,
    ),
    "lola_small": dict(
        plain_primes=(2277377, 2424833), n=8192,
        coeff_count=coeff_count_for(8192, 3), n_special=2,
    ),
    "caltech": dict(
        plain_primes=(4300801,), n=4096,
        coeff_count=coeff_count_for(4096, 2),
    ),
    "lola_large": dict(
        plain_primes=ntt_primes(16384, 30, 3), n=16384,
        coeff_count=coeff_count_for(16384, 7), n_special=3,
    ),
    "cifar": dict(
        plain_primes=ntt_primes(16384, 30, 3), n=16384,
        coeff_count=coeff_count_for(16384, 8), n_special=1,
    ),
    "lola_dense": dict(
        plain_primes=(34359771137, 34360754177), n=16384,
        coeff_count=coeff_count_for(16384, 7) + 1, n_special=2,
    ),
    "cryptonets_bigt": dict(
        plain_primes=(549764251649, 549764284417), n=8192,
    ),
    "lola_large_bigt": dict(
        plain_primes=(2148728833, 2148794369, 2149810177), n=16384,
        coeff_count=coeff_count_for(16384, 7), n_special=3,
    ),
    "cifar_bigt": dict(
        plain_primes=(957181001729, 957181034497), n=16384,
        coeff_count=coeff_count_for(16384, 8), n_special=1,
    ),
}

# total-modulus security check: data + special limbs within budget
for _name, _cfg in CONFIGS.items():
    _k = _cfg.get("coeff_count") or len(default_coeff_modulus_128(_cfg["n"]))
    _bits = 31 * (_k + _cfg.get("n_special", 0))
    if _bits > SECURITY_BITS_128[_cfg["n"]]:
        raise AssertionError(f"preset {_name}: {_bits} modulus bits exceed "
                             f"the 128-bit security budget")


def make_factory(name: str, encrypt: bool = True, seed: int = 0,
                 device=None, ntt_impl: str | None = None, **overrides):
    """Build the encrypted (CrtBfv) or Raw factory for a preset;
    `ntt_impl` None means the factory's default ("butterfly")."""
    from ..api.factory import CrtBfvFactory, RawFactory

    cfg = dict(CONFIGS[name])
    cfg.update(overrides)
    if not encrypt:
        return RawFactory(cfg["n"])
    return CrtBfvFactory(seed=seed, device=device, ntt_impl=ntt_impl, **cfg)
