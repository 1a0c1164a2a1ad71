"""Parameter presets of the port.

The port's copy of two entries of `cryptonets_tpu/models/presets.py`,
both over the full seven-limb 31-bit chain at n = 8192 (217 of the 218
bits that 128-bit security allows):
  * `lola`: the reference's plain primes (`LoLaCryptonets.cs:208`); its
    network passes ks_alpha=1 (P-less key switching), so the reference's
    digit width (dbc=8) is not carried.
  * `cryptonets`: three ~30-bit NTT-friendly plain primes (~90 bits of CRT
    message capacity, more than the two ~39-bit primes of
    `CryptoNets.cs:17`), so slot encode and decode run on the device;
    digit key switching at dbc=16 (SEAL 3.2's).  The reference pins an
    NTT implementation here; the port has one NTT.
The big-t presets (`cryptonets_bigt`, plain primes >= 2**31) are not
ported.
"""

from __future__ import annotations

from ..crypto.primes import ntt_primes

CONFIGS = {
    "lola": dict(
        plain_primes=(557057, 638977, 737281, 786433), n=8192,
    ),
    "cryptonets": dict(
        plain_primes=ntt_primes(8192, 30, 3), n=8192, dbc=16, ks_alpha=0,
    ),
}


def make_factory(name: str, encrypt: bool = True, seed: int = 0,
                 device=None, **overrides):
    """Build the encrypted (CrtBfv) or Raw factory for a preset."""
    from ..api.factory import CrtBfvFactory, RawFactory

    if name not in CONFIGS:
        raise NotImplementedError(f"preset {name!r} is not ported")
    cfg = dict(CONFIGS[name])
    cfg.update(overrides)
    if not encrypt:
        return RawFactory(cfg["n"])
    return CrtBfvFactory(seed=seed, device=device, **cfg)
