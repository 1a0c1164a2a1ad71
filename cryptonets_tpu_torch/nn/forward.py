"""The record pipeline of an encrypted network (port of the fused path
of `EncryptedForward`, `cryptonets_tpu/nn/jit.py`).

One call pulls a record (LoLa: one image; CryptoNets: a batch of images
in the SIMD slots) from the reader and runs, on the factory's device:
slot encode + RLWE encrypt of every input column, every layer above the
EncryptLayer, gamma decrypt + slot decode of every output column.  The
host only index-maps the input slots and CRT-joins the decoded outputs.
A factory whose plain primes do not fit the device encode and decode
(`_device_encode`, `_device_decode`: LoLaDense's and CryptoNets' big-t
primes) takes the reference's other path: slot encode on the host (C++
NTT, per-limb residues) and encrypt on the device, the layers, then the
two-plane device decrypt with the host join and the C++ slot decode.
It runs eagerly, as a sequence of kernel launches; there is no
whole-network compile to trace.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api.matrix import HEMatrix
from ..api.vector import HEVector
from .layers import EncryptLayer
from .network import Layer


def split_at_encrypt(head: Layer):
    """Walk source links from `head` down to the EncryptLayer; returns
    (encrypt_layer, [layers above it, in application order])."""
    chain = []
    p = head
    while p is not None and not isinstance(p, EncryptLayer):
        chain.append(p)
        p = p.source
    if p is None:
        raise ValueError("no EncryptLayer in network")
    return p, list(reversed(chain))


class EncryptedForward:
    """fwd = EncryptedForward(head)  # after head.prepare_network()
    out = fwd()                      # one record end to end, or None"""

    def __init__(self, head: Layer):
        self.encrypt_layer, self.layers = split_at_encrypt(head)

    @property
    def reader(self):
        p = self.encrypt_layer
        while p.source is not None:
            p = p.source
        return p

    def run_encrypted(self, m: HEMatrix) -> HEMatrix:
        """The layers above the EncryptLayer on an encrypted matrix (each
        with its report in verbose mode, `Layer.forward`)."""
        for layer in self.layers:
            m = layer.forward(m)
        return m

    def slot_ints(self, raw):
        """Host side: RawMatrix -> (slot values [V*C, n] int64, (V, C,
        dim, scale))."""
        fac = self.encrypt_layer.factory
        vecs = np.asarray(raw.m, dtype=np.float64).T  # [V, dim] scaled ints
        V, dim = vecs.shape
        C = max(1, -(-dim // fac.n))
        padded = np.zeros((V, C * fac.n), np.int64)
        padded[:, :dim] = np.round(vecs).astype(np.int64)
        return padded.reshape(V * C, fac.n), (V, C, dim, float(raw.scale))

    def __call__(self):
        """Pull one record through encode, encrypt, the network, decrypt
        and decode."""
        raw = self.reader.get_next()
        if raw is None:
            return None
        fac = self.encrypt_layer.factory
        ints, (V, C, dim, scale) = self.slot_ints(raw)
        data = fac._encrypt_slotsets(ints)               # [P, V*C, 2, k, N]
        data = data.reshape(fac.P, V, C, *data.shape[2:])
        m = HEMatrix(fac, [
            HEVector(fac, data=data[:, i], dim=dim, scale=scale, fmt="dense")
            for i in range(V)
        ], "col")
        out = self.run_encrypted(m)
        # decrypt + slot decode of every output column in one pass: on
        # the device (gamma decrypt) or through the host join (big t)
        blocks = [v.data.shape[1] for v in out.vectors]
        slots = fac.decrypt_slots(torch.cat([v.data for v in out.vectors], dim=1))
        for v, s in zip(out.vectors, np.split(slots, np.cumsum(blocks)[:-1], axis=1)):
            v._dec_slots = s
        return out


def raw_layer_outputs(head_raw: Layer) -> list:
    """The Raw oracle's input to the first layer above the EncryptLayer
    and every such layer's output, for the next record of a prepared Raw
    network."""
    enc, layers = split_at_encrypt(head_raw)
    outs = [enc.apply(enc.source.get_next())]
    for layer in layers:
        outs.append(layer.apply(outs[-1]))
    return outs


def layer_agreement(m: HEMatrix, raw, sample: int = 2) -> dict:
    """An encrypted layer output against the Raw oracle's output of the
    same layer: the least noise budget over its first `sample` vectors
    (and the plain primes), the largest difference of the decryption from
    the Raw values relative to the largest Raw value, and whether the two
    agree at rtol 1e-9."""
    enc = m.decrypt()
    want = np.asarray(raw.decrypt(), dtype=float)
    same_shape = enc.shape == want.shape
    rel = (float(np.max(np.abs(enc - want)) / max(np.max(np.abs(want)), 1e-300))
           if same_shape else float("inf"))
    return dict(budget=min(v.noise_budget() for v in m.vectors[:sample]),
                max_rel_diff=rel, vectors=len(m.vectors),
                equal=same_shape and bool(np.allclose(enc, want, rtol=1e-9, atol=0)))
