"""Carry model weights, key sets and the AlexNet featurizer's parameters
across from numpy.

`keyset_from_numpy` reads the npz layout that the JAX package's
`CrtBfvFactory._save_cached_keys` writes (`s_hat_mont`, `s2_hat_mont`,
`p0_hat_mont`, `p1_hat_mont`, `relin_k0/k1`, `g_<elt>_k0/k1`, `s_small`).
A switch key is `[omega, kp, N]` in RNS-group mode (kp = k limbs of Q
without special primes, k + n_special limbs of Q*P with them) and
`[k*D, k, N]` in digit mode; all are carried as they are.
Both packages keep keys in the NTT domain and in Montgomery form, so an
imported key set makes a port factory compute exactly what the JAX factory
computes with the same keys, as long as both use the same NTT ordering.
A key set carries no mark of the ordering it was made under (the reference
keeps it only in the hash of its cache file's name): the caller must give
the port factory the `ntt_impl` of the factory that made the keys
("butterfly" for the reference's "butterfly", "pallas" and "hybrid";
"matmul" for "matmul").  The factory records it as `factory.ntt_impl`.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto.bfv import KeySet, SwitchKeys
from .device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    """uint32/int32 numpy -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


def weights_from_numpy(arrays: dict) -> dict:
    """Model weights (name -> array) as float64 numpy arrays, the form the
    port's layers take (the layers quantize them with their scales)."""
    return {k: np.asarray(v, dtype=np.float64) for k, v in arrays.items()}


def keyset_from_numpy(arrays, device=None, shard=None) -> KeySet:
    """A key set from the reference's key-cache npz layout (a mapping of
    name -> array, e.g. `np.load(path)`), on `device` (CUDA unless the
    caller names another).  Pass the factory that takes it the `ntt_impl`
    the keys were made under.  With `shard` (a `parallel/limbs.LimbShard`)
    only that rank's limbs reach the device (`KeySet.narrow`)."""
    device = resolve_device(device)
    if shard is not None:
        return keyset_from_numpy(arrays, "cpu").narrow(
            shard.lo, shard.hi, shard.k).to(device)
    galois = {}
    for name in arrays:
        if name.startswith("g_") and name.endswith("_k0"):
            g = int(name[2:-3])
            galois[g] = SwitchKeys(
                k0=_tensor(arrays[name], device),
                k1=_tensor(arrays[f"g_{g}_k1"], device),
            )
    return KeySet(
        s_hat_mont=_tensor(arrays["s_hat_mont"], device),
        s2_hat_mont=_tensor(arrays["s2_hat_mont"], device),
        p0_hat_mont=_tensor(arrays["p0_hat_mont"], device),
        p1_hat_mont=_tensor(arrays["p1_hat_mont"], device),
        relin=SwitchKeys(
            k0=_tensor(arrays["relin_k0"], device),
            k1=_tensor(arrays["relin_k1"], device),
        ),
        galois=dict(sorted(galois.items())),
        s_small=_tensor(arrays["s_small"], device),
    )


def alexnet_from_numpy(featurizer, arrays) -> None:
    """Load a featurizer's parameters (name -> array: the state_dict of the
    JAX package's `data/alexnet.AlexNetFeaturizer` model as numpy arrays)
    into the port's `data.alexnet.AlexNetFeaturizer`, on its device."""
    model = featurizer.model
    dev = next(model.parameters()).device
    model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                           for k, v in arrays.items()})
