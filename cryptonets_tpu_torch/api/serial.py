"""Persistence: keys, ciphertext vectors and matrices (port of
`cryptonets_tpu/api/serial.py`; ref key save/load `EncryptedSealBfvVector.
cs:104-134`, ciphertext framing `AtomicSealBfvVector.cs:1273-1345`).

The wire format is the reference's, key for key, so a file written by
either package loads in the other:
  * keys: one .npz with `config` (JSON: plain_primes, n, coeff_modulus,
    dbc, n_special, ks_alpha, ntt_impl, include_secret) and the arrays
    `k__s_hat_mont`, `k__s2_hat_mont`, `k__p0`, `k__p1`, `k__relin_k0`,
    `k__relin_k1`, `k__s_small` and `g<elt>__k0` / `g<elt>__k1` a Galois
    key.  A public-only file (`include_secret=False`) holds zeros of the
    same shapes in the three secret arrays (`IFactory.cs:296-304`): a
    factory loaded from it encrypts and evaluates but refuses to decrypt,
    the reference's client/server split;
  * a vector: `meta` (JSON: dim, scale, fmt, is_signed) and `data`, the
    [P, C, size, k, N] residues;
  * a matrix: `meta` (JSON: fmt and each vector's meta) and `v<i>`.
Residues travel as uint32, bit for bit the port's int32 storage
(`convert._tensor`); the ternary secret `k__s_small` as int32.
Files are written without compression (`np.savez`): uniform residues
barely compress (a 280 MB key file by 0.1 %) and zlib takes 14 times as
long to write.  `np.load` reads the reference's zlib files all the same.
"""

from __future__ import annotations

import io
import json

import numpy as np

from ..convert import _tensor
from ..crypto.bfv import KeySet, SwitchKeys
from ..device import resolve_device

_SECRET = ("k__s_hat_mont", "k__s2_hat_mont", "k__s_small")
# the reference's names; `pallas` and `hybrid` share the butterfly's order
_NTT_ORDER = {"butterfly": "butterfly", "pallas": "butterfly",
              "hybrid": "butterfly", "matmul": "matmul"}


def _u32(t) -> np.ndarray:
    """int32 tensor -> uint32 numpy with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


def _key_arrays(keys: KeySet) -> dict:
    out = {
        "k__s_hat_mont": _u32(keys.s_hat_mont),
        "k__s2_hat_mont": _u32(keys.s2_hat_mont),
        "k__p0": _u32(keys.p0_hat_mont),
        "k__p1": _u32(keys.p1_hat_mont),
        "k__relin_k0": _u32(keys.relin.k0),
        "k__relin_k1": _u32(keys.relin.k1),
        "k__s_small": keys.s_small.detach().cpu().numpy().astype(np.int32),
    }
    for g, sk in keys.galois.items():
        out[f"g{g}__k0"] = _u32(sk.k0)
        out[f"g{g}__k1"] = _u32(sk.k1)
    return out


def save_keys(factory, path: str, include_secret: bool = True) -> None:
    """Write the factory's configuration and keys, with or without the
    secret key.  A factory of one rank of a limb-sharded mesh holds only
    its limbs of the keys and raises: save from the unsharded factory."""
    if getattr(factory, "shard", None) is not None:
        raise ValueError(
            f"this factory holds only the limbs of {factory.shard} of the "
            "key set; save the keys from the unsharded factory")
    p0 = factory.params[0]
    cfg = dict(
        plain_primes=list(factory.plain_primes), n=factory.n,
        coeff_modulus=[int(q) for q in factory.coeff_modulus],
        dbc=p0.dbc, n_special=p0.n_special, ks_alpha=p0.ks_alpha,
        ntt_impl=factory.ntt_impl, include_secret=include_secret,
    )
    arrays = _key_arrays(factory.keys)
    if not include_secret:
        for name in _SECRET:
            arrays[name] = np.zeros_like(arrays[name])
    np.savez(path, config=json.dumps(cfg), **arrays)


def load_factory(path: str, device=None):
    """A CrtBfvFactory from a key file, with no keygen, on `device` (CUDA
    unless the caller names another).  A public-only file gives a factory
    with `has_secret_key` False."""
    from .factory import CrtBfvFactory

    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        cfg = json.loads(str(z["config"]))
        arrays = {k: z[k] for k in z.files if k != "config"}
    galois = {}
    for name in arrays:
        if name.startswith("g") and name.endswith("__k0"):
            g = int(name[1:].split("__")[0])
            galois[g] = SwitchKeys(k0=_tensor(arrays[f"g{g}__k0"], device),
                                   k1=_tensor(arrays[f"g{g}__k1"], device))
    keys = KeySet(
        s_hat_mont=_tensor(arrays["k__s_hat_mont"], device),
        s2_hat_mont=_tensor(arrays["k__s2_hat_mont"], device),
        p0_hat_mont=_tensor(arrays["k__p0"], device),
        p1_hat_mont=_tensor(arrays["k__p1"], device),
        relin=SwitchKeys(k0=_tensor(arrays["k__relin_k0"], device),
                         k1=_tensor(arrays["k__relin_k1"], device)),
        galois=dict(sorted(galois.items())),
        s_small=_tensor(arrays["k__s_small"], device),
    )
    fac = CrtBfvFactory(
        plain_primes=tuple(cfg["plain_primes"]), n=cfg["n"],
        coeff_modulus=tuple(cfg["coeff_modulus"]), dbc=cfg["dbc"],
        n_special=cfg.get("n_special", 0), ks_alpha=cfg.get("ks_alpha", 0),
        ntt_impl=_NTT_ORDER[cfg.get("ntt_impl") or "butterfly"],
        device=device, keys=keys,
    )
    fac.has_secret_key = bool(cfg["include_secret"])
    if not fac.has_secret_key:
        print("Warning: key file has no secret key; decryption is disabled")
    return fac


def _vector_meta(vec) -> dict:
    return dict(dim=vec.dim, scale=vec.scale, fmt=vec.fmt,
                is_signed=vec.is_signed)


def save_vector(vec, fh) -> None:
    """Write an encrypted HEVector to a binary stream."""
    buf = io.BytesIO()
    np.savez(buf, meta=json.dumps(_vector_meta(vec)), data=_u32(vec.data))
    fh.write(buf.getvalue())


def _vector(factory, data, meta: dict):
    from .vector import HEVector

    return HEVector(factory, data=_tensor(data, factory.device),
                    dim=meta["dim"], scale=meta["scale"], fmt=meta["fmt"],
                    is_signed=meta["is_signed"])


def load_vector(factory, fh):
    """An HEVector of `factory` from a stream `save_vector` wrote."""
    with np.load(io.BytesIO(fh.read()), allow_pickle=False) as z:
        return _vector(factory, z["data"], json.loads(str(z["meta"])))


def save_matrix(mat, fh) -> None:
    """Write an encrypted HEMatrix to a binary stream."""
    meta = dict(fmt=mat.fmt, vecs=[_vector_meta(v) for v in mat.vectors])
    buf = io.BytesIO()
    np.savez(buf, meta=json.dumps(meta),
             **{f"v{i}": _u32(v.data) for i, v in enumerate(mat.vectors)})
    fh.write(buf.getvalue())


def load_matrix(factory, fh):
    """An HEMatrix of `factory` from a stream `save_matrix` wrote."""
    from .matrix import HEMatrix

    with np.load(io.BytesIO(fh.read()), allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        vecs = [_vector(factory, z[f"v{i}"], m)
                for i, m in enumerate(meta["vecs"])]
    return HEMatrix(factory, vecs, meta["fmt"])
