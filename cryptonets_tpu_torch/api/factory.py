"""Factories: parameter/key owners and vector/matrix constructors.

Port of `cryptonets_tpu/api/factory.py`, as much as the LoLa, LoLaPacked,
LoLaLarge, LoLaDense, CIFAR, CryptoNets, LoLaSmall and Caltech-101 paths
use.  `CrtBfvFactory` is the CRT "double decker" over plain primes: each
value is split into residues mod each plain prime t_p, and every residue
stream is a BFV pipeline over the SAME coefficient chain and key set,
stacked on a leading P axis ([P, C, size, k, N] ciphertext data).

Where the plain primes allow, slot encode (inverse NTT over Z_t) and
decode (forward NTT over Z_t) run on the device with the butterfly CUDA
NTT, whichever NTT carries the ciphertext chain (`ntt_impl`): encode
when every t is below 2**31 and below every limb (`_device_encode`: the
coefficients then are the same residue on every limb), decode with the
gamma decrypt when every t is below 2**31 (`_device_decode`); the
record pipeline reads both as `encodes_on_device`.  The device encode's
input, the index-mapped slot buffers, comes from the host for the vector
API's exact integers (`encode_bufs`) or, for a record, from the reader's
values through the `slot_map` kernel on the device (`encrypt_values`).  Plain
primes of 2**31 to 2**62 (`_device_decode_big`) encode on the host (the
C++ 128-bit NTT, per-limb residues) and decrypt on the device to two
planes that the host joins exactly and decodes with the same C++ NTT.
Any other mix, plain primes of 2**62 and above among them, encodes on the
host (the object-int NTT from 2**63 on), encrypts and evaluates on the
device like the others, and decrypts exactly on the host.  Keys are made on the
factory's device; the reference's keygen on a host CPU backend, its
on-disk key cache and its environment switches answer a remote-compile
set-up the port does not have, and are not carried.  `RawFactory` is the
plaintext float64 oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bfv import BFV, BFVParams, _automorphism_tables_np
from ..crypto.encoder import BIG_T, BatchEncoder
from ..crypto.hostmath import CRT
from ..crypto.ntt import get_ntt_context, ntt_automorphism_perm
from ..crypto.primes import default_coeff_modulus_128
from ..device import canonical, resolve_device
from ..kernels import slotmap
from ..utils import trace

# Columns per piece of the device encode + encrypt.  A piece holds a few
# int64 temporaries of [piece, k, N] per plain prime (59 MB each at 128
# columns, k = 7, N = 8192), so a 784-column input never widens whole.
ENCRYPT_CHUNK = 128
# Rows per piece of the batched plaintext encode (`plain_mult_forms`): a
# piece's slot encode runs on the host, its coefficients cross to the
# device as int64 [piece, N] and widen to [piece, k, N] there (1.7 GB at
# n = 16384 and 13 limbs).
ENCODE_CHUNK = 1024


class CrtBfvFactory:
    """The encrypted factory.  Keys are generated on `device` from `seed`
    unless a key set is passed (`convert.keyset_from_numpy`).

    `ntt_impl` names the NTT of the ciphertext chain: "butterfly" (the
    default, also for None) or "matmul" (`crypto/ntt.py`).  It is an
    argument only; no environment variable overrides it.  Keys are
    NTT-domain values: a key set passed in must have been made under the
    same `ntt_impl`, which nothing in the key set records.

    `shard` (a `parallel/limbs.LimbShard`, None for one process) makes
    this the factory of one rank of a mesh whose `limb` axis shards the
    data limbs: its parameters are built from the full chain and narrowed
    to the rank's limbs (`BFVParams.narrow`), keys are made on the full
    chain (the same seed on every rank) or taken whole and narrowed
    (`KeySet.narrow`), and every ciphertext, plaintext form and table it
    makes covers `limb_moduli`, the rank's limbs.  `coeff_modulus` stays
    the full chain."""

    is_encrypted = True

    def __init__(
        self,
        plain_primes,
        n: int = 4096,
        coeff_count: int | None = None,
        coeff_modulus=None,
        dbc: int = 16,
        seed: int = 0,
        rot_steps=(),
        n_special: int = 0,
        ks_alpha: int = 0,
        ntt_impl: str | None = None,
        device=None,
        keys=None,
        shard=None,
    ):
        self.device = resolve_device(device)
        self.n = n
        self.ntt_impl = ntt_impl or "butterfly"
        self.plain_primes = tuple(int(t) for t in plain_primes)
        self.P = len(self.plain_primes)
        chain = tuple(coeff_modulus) if coeff_modulus else default_coeff_modulus_128(n)
        if coeff_count is not None:
            chain = chain[:coeff_count]
        self.coeff_modulus = chain
        self.shard = shard
        self.params = [
            BFVParams(n, t, coeff_modulus=chain, dbc=dbc, ks_alpha=ks_alpha,
                      seed=seed, n_special=n_special, ntt_impl=self.ntt_impl,
                      device=self.device)
            for t in self.plain_primes
        ]
        if keys is None:
            keys = BFV(self.params[0]).keygen(seed=seed, rot_steps=rot_steps)
        if shard is not None:
            self.params = [p.narrow(shard) for p in self.params]
            if keys.s_hat_mont.shape[0] == len(chain):    # a whole key set
                keys = keys.narrow(shard.lo, shard.hi, len(chain))
        # the data limbs this factory's ciphertexts and forms cover
        self.limb_moduli = self.params[0].limb_moduli
        self.bfv = [BFV(p) for p in self.params]
        self.keys = keys.to(self.device)
        # False for a factory loaded from a public-only key file
        # (`api/serial.py`): it encrypts and evaluates, never decrypts
        self.has_secret_key = True
        self.encoders = [BatchEncoder(n, t) for t in self.plain_primes]
        self.plain_crt = CRT(list(self.plain_primes))
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed ^ 0x5EED)
        ts = self.plain_primes
        self._device_encode = all(t < BIG_T and t < min(chain) for t in ts)
        self._device_decode = all(t < BIG_T for t in ts)
        self._device_decode_big = all(BIG_T <= t < 1 << 62 for t in ts)
        # one context over all plain primes: the device slot encode/decode
        # NTTs of every prime run as one launch with P as the limb axis
        self._plain_ntt = get_ntt_context(n, ts) if self._device_decode else None
        self._index_map = torch.from_numpy(
            self.encoders[0].index_map).to(self.device)
        # the index map depends on n only; its inverse permutation, and
        # that on the device for the slot map of a fused record
        self._slot_of_position = np.argsort(self.encoders[0].index_map)
        self._slot_positions = torch.from_numpy(
            self._slot_of_position.astype(np.int32)).to(self.device)
        self._stack_cache: dict = {}
        self._mask_cache: dict = {}

    @property
    def slot_count(self) -> int:
        return self.n

    @property
    def block_size(self) -> int:
        return self.n

    @property
    def encodes_on_device(self) -> bool:
        """Whether slot encode and decode run on the device (every plain
        prime below 2**31 and below every limb): a record's slot buffers
        are then made on the device from the reader's values (`slot_map`)
        and its outputs decoded there.  Otherwise the host encodes."""
        return bool(self._device_encode and self._device_decode)

    def to(self, device, keys=None) -> "CrtBfvFactory":
        """A factory of the same parameters on `device`, holding this one's
        key set there (`KeySet.to`), or `keys` (a part of it,
        `KeySet.select`); this factory when it lies there and no `keys`
        are given.  A factory given keys without the secret key does not
        decrypt."""
        if keys is None and canonical(device) == canonical(self.device):
            return self
        p = self.params[0]
        other = CrtBfvFactory(
            self.plain_primes, n=self.n, coeff_modulus=self.coeff_modulus,
            dbc=p.dbc, seed=p.seed, n_special=p.n_special, ks_alpha=p.ks_alpha,
            ntt_impl=self.ntt_impl, device=device,
            keys=self.keys if keys is None else keys, shard=self.shard)
        other.has_secret_key = self.has_secret_key and (
            keys is None or keys.s_hat_mont is not None)
        return other

    def fresh_key(self) -> torch.Generator:
        """A new generator on the factory's device, seeded from the
        factory's own stream: the counterpart of the reference's
        `jax.random.split` of its key (`api/factory.py:371-373`)."""
        seed = int(torch.randint(0, 2**62, (1,), generator=self._gen,
                                 device=self.device))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    # ------------------------------------------------- encrypt / decrypt
    def encode_bufs(self, slotsets_int: np.ndarray) -> np.ndarray:
        """[..., n] integer slot values -> index-mapped [P, ..., n] uint32
        buffers for the device-side encode (the only host work of encrypt)."""
        s64 = slotsets_int.astype(np.int64)
        trace.count("host_encoded_slots", self.P * s64.size)
        bufs = np.empty((self.P,) + s64.shape, np.uint32)
        for pi, t in enumerate(self.plain_primes):
            # buffer[index_map[i]] = slot i, as a gather by the inverse map
            # (ten times faster in numpy than the scatter)
            bufs[pi] = np.take((s64 % t).astype(np.uint32),
                               self._slot_of_position, axis=-1)
        return bufs

    def slot_map(self, values) -> torch.Tensor:
        """The reader's scaled values [R, dim, V] float64 -> the index-mapped
        slot buffers [P, R*V*C, n] int32 on the device: `encode_bufs` of
        each record's slot values, in order, made by the `slot_map` kernel
        (`kernels/slotmap.py`)."""
        return slotmap.slot_map(values.to(self.device), self._slot_positions,
                                self.plain_primes)

    def _encrypt_all_dev(self, bufs) -> torch.Tensor:
        """Index-mapped slot values [P, C, n] (mod t_p) -> ciphertext data
        [P, C, 2, k, N]: the Z_t inverse NTT on the device, coefficients
        broadcast over the limbs (t < every q_i), then RLWE encryption, in
        pieces of ENCRYPT_CHUNK columns; the device range `encrypt`."""
        if isinstance(bufs, np.ndarray):
            bufs = torch.from_numpy(
                np.ascontiguousarray(bufs, np.uint32).view(np.int32))
        with trace.device_range("encrypt", "encrypt"):
            return self._encrypt_bufs(bufs.to(self.device))

    def encrypt_values(self, values) -> torch.Tensor:
        """The reader's scaled values [R, dim, V] float64 -> ciphertext
        data [P, R*V*C, 2, k, N]: `_encrypt_values_dev` where the factory
        encodes on the device, else the values rounded (half to even) and
        encoded on the host (`_encode_slotsets_np`), encrypted on the
        device."""
        if self.encodes_on_device:
            return self._encrypt_values_dev(values)
        R, dim, V = values.shape
        C = slotmap.blocks_of(dim, self.n)
        ints = np.zeros((R, V, C * self.n), np.int64)
        ints[:, :, :dim] = np.round(values.cpu().numpy()).astype(np.int64).transpose(0, 2, 1)
        return self._encrypt_all(self._encode_slotsets_np(ints.reshape(R * V * C, self.n)))

    def _encrypt_values_dev(self, values) -> torch.Tensor:
        """The reader's scaled values [R, dim, V] float64 -> ciphertext
        data [P, R*V*C, 2, k, N]: the slot map, then `_encrypt_all_dev`'s
        work, both inside the device range `encrypt` (the slot map is the
        encode's first step)."""
        with trace.device_range("encrypt", "encrypt"):
            return self._encrypt_bufs(self.slot_map(values))

    def _encrypt_bufs(self, bufs) -> torch.Tensor:
        """The body of `_encrypt_all_dev`: slot buffers on the device ->
        ciphertext data, outside any range."""
        k = len(self.limb_moduli)
        C = bufs.shape[1]
        coeffs = self._plain_ntt.inverse(bufs.transpose(0, 1))  # [C, P, n]
        out = torch.empty((self.P, C, 2, k, self.n), dtype=torch.int32,
                          device=self.device)
        for c0 in range(0, C, ENCRYPT_CHUNK):
            piece = coeffs[c0 : c0 + ENCRYPT_CHUNK]
            for pi in range(self.P):
                out[pi, c0 : c0 + len(piece)] = self.bfv[pi].encrypt(
                    self.keys,
                    piece[:, pi, None, :].expand(len(piece), k, self.n),
                    self._gen)
        return out

    def _encode_slotsets_np(self, slotsets) -> np.ndarray:
        """[C, n] slot values (ints, signed ok) -> coefficient residues
        [P, C, k, N] uint32 on the host: the encoder's NTT over Z_t (the
        C++ 128-bit one for t >= 2**31), then every limb's own residue."""
        trace.count("host_encoded_slots", self.P * np.asarray(slotsets).size)
        with trace.span("slot_encode"):
            return np.stack([
                self.params[pi].plain_to_residues(self.encoders[pi].encode(slotsets))
                for pi in range(self.P)
            ])

    def _encrypt_all(self, res_all) -> torch.Tensor:
        """Coefficient residues [P, C, k, N] (uint32 numpy or int32
        tensor) -> ciphertext data [P, C, 2, k, N], in pieces of
        ENCRYPT_CHUNK columns; the device range `encrypt`."""
        if isinstance(res_all, np.ndarray):
            res_all = torch.from_numpy(
                np.ascontiguousarray(res_all, np.uint32).view(np.int32))
        with trace.device_range("encrypt", "encrypt"):
            res_all = res_all.to(self.device)
            C = res_all.shape[1]
            out = torch.empty((self.P, C, 2) + tuple(res_all.shape[2:]),
                              dtype=torch.int32, device=self.device)
            for c0 in range(0, C, ENCRYPT_CHUNK):
                for pi in range(self.P):
                    piece = res_all[pi, c0 : c0 + ENCRYPT_CHUNK]
                    out[pi, c0 : c0 + len(piece)] = self.bfv[pi].encrypt(
                        self.keys, piece, self._gen)
        return out

    def _encrypt_slotsets(self, slotsets) -> torch.Tensor:
        """[C, n] slot values (ints, object ints allowed) -> ciphertext
        data [P, C, 2, k, N]: the device encode where the plain primes
        allow it and the values fit int64, else the host encode and
        per-limb residues.  The host's part is the span `slot_buffers` (the
        device encode) or `slot_encode`."""
        ss = np.asarray(slotsets)
        if self._device_encode:
            try:
                with trace.span("slot_buffers"):
                    bufs = self.encode_bufs(ss.astype(np.int64, copy=False))
                return self._encrypt_all_dev(bufs)
            except OverflowError:
                pass
        return self._encrypt_all(self._encode_slotsets_np(ss))

    def encrypt_blocks(self, int_values, dim: int) -> torch.Tensor:
        """Signed int slot values (len <= C*n, object ints allowed) ->
        ciphertext data [P, C, 2, k, N]; C = ceil(dim / n)."""
        n = self.n
        C = max(1, -(-dim // n))
        vals = np.zeros(C * n, dtype=object)
        vv = np.asarray(int_values, dtype=object)
        vals[: len(vv)] = vv
        return self._encrypt_slotsets(vals.reshape(C, n))

    def split_big_numbers(self, values) -> list[np.ndarray]:
        """Signed ints -> per-prime residue arrays (ref SplitBigNumbers,
        `EncryptedSealBfvVector.cs:352-379`)."""
        v = np.asarray(values, dtype=object)
        return [v % t if t >= 1 << 63 else (v % t).astype(np.int64)
                for t in self.plain_primes]

    def _decrypt_big_all(self, data):
        """[P, C, size, k, N] -> (W mod 2**32 int64, W mod m2 int32)
        [P, C, N] on the device, for 2**31 <= every t < 2**62."""
        planes = [self.bfv[pi].decrypt_big_t_planes(self.keys, data[pi])
                  for pi in range(self.P)]
        return (torch.stack([lo for lo, _ in planes]),
                torch.stack([m2 for _, m2 in planes]))

    def _decode_big_slots(self, lo, m2, pi: int) -> np.ndarray:
        """Host: join the planes [C, N] of prime pi and slot-decode them
        with the C++ NTT -> slot values [C, N] int64 in [0, t)."""
        W = self.bfv[pi].join_big_t_planes(lo, m2)        # [C, N] uint64
        return self.encoders[pi].decode(W)

    def require_secret_key(self) -> None:
        """Raise where the factory was loaded without its secret key."""
        if not self.has_secret_key:
            raise RuntimeError(
                "this factory was loaded without a secret key; "
                "decryption is disabled (ref AtomicSealBfvVector.cs:121-128)")

    def decrypt_slots(self, data) -> np.ndarray:
        """[P, C, size, k, N] -> slot values mod t_p [P, C, N] on the host:
        the device decrypt and decode (t < 2**31), the two-plane device
        decrypt with the host join and C++ decode (2**31 <= t < 2**62),
        else the exact host decrypt.  Every decrypt of the port passes
        here: a factory without the secret key raises."""
        self.require_secret_key()
        if self._device_decode:
            return self._decrypt_decode_all(data).cpu().numpy().astype(np.int64)
        if self._device_decode_big:
            lo, m2 = self._decrypt_big_all(data)
            lo, m2 = lo.cpu().numpy(), m2.cpu().numpy()
            with trace.span("slot_decode"):
                return np.stack([self._decode_big_slots(lo[pi], m2[pi], pi)
                                 for pi in range(self.P)])
        return np.stack([
            self.encoders[pi].decode(self.bfv[pi].decrypt(self.keys, data[pi]))
            for pi in range(self.P)
        ])

    def decrypt_blocks(self, data, dim: int) -> np.ndarray:
        """[P, C, size, k, N] -> centered big-int slot values [dim]."""
        return self.join_decoded_blocks(self.decrypt_slots(data), dim)

    def _decrypt_all(self, data) -> torch.Tensor:
        """[P, C, size, k, N] -> plaintext coefficients mod t_p [P, C, N]."""
        return torch.stack([
            self.bfv[pi].decrypt_residues_mod_t(self.keys, data[pi])
            for pi in range(self.P)
        ])

    def _decrypt_decode_all(self, data) -> torch.Tensor:
        """[P, C, size, k, N] -> slot values mod t_p [P, C, N]: gamma
        decrypt, forward NTT over Z_t, slot gather."""
        res = self._decrypt_all(data)
        ev = self._plain_ntt.forward(res.transpose(0, 1))    # [C, P, N]
        return ev[..., self._index_map].transpose(0, 1)

    def decrypt_columns(self, data, dim: int) -> np.ndarray:
        """Batched matrix decrypt: [P, V, C, size, k, N] -> [V, dim]
        centered big ints, all V columns in one device pass."""
        P, V, C = data.shape[:3]
        flat = data.reshape(P, V * C, *data.shape[3:])
        return self.join_decoded_columns(
            self.decrypt_slots(flat).reshape(P, V, C, self.n), dim)

    def join_decoded_columns(self, slots: np.ndarray, dim: int) -> np.ndarray:
        """Decoded slot residues [P, V, C, N] (host) -> centered big-int
        values [V, dim]: one vectorized CRT join."""
        P, V = slots.shape[:2]
        host = slots.reshape(P, V, -1)
        return self.join_split_numbers([host[pi, :, :dim] for pi in range(P)])

    def join_split_numbers(self, residues) -> np.ndarray:
        """Per-prime slot values -> centered big ints (vectorized CRT)."""
        crt = self.plain_crt
        M = crt.product
        acc = None
        for r, t, p_i, ip_i in zip(
            residues, self.plain_primes, crt.punctured, crt.inv_punctured
        ):
            term = (np.asarray(r, dtype=object) % t) * ((p_i * ip_i) % M)
            acc = term if acc is None else acc + term
        acc = acc % M
        return np.where(acc > M >> 1, acc - M, acc)

    # --------------------------------------------------- CRT string codec
    def get_value_from_string(self, s: str) -> int:
        """Comma-joined per-prime residues -> CRT value in [0, prod t)
        (ref GetValueFromString, `IFactory.cs:395-403`)."""
        crt = self.plain_crt
        acc = sum(punct * inv * int(r) for r, punct, inv in zip(
            s.split(","), crt.punctured, crt.inv_punctured))
        return acc % crt.product

    def get_string_from_value(self, value: int) -> str:
        """CRT value -> comma-joined per-prime residues (ref
        GetStringFromValue, `IFactory.cs:405-408`)."""
        return ",".join(str(int(value) % t) for t in self.plain_primes)

    def join_decoded_blocks(self, slots_all: np.ndarray, dim: int):
        """Decoded slot residues [P, C, N] -> centered big-int values [dim]."""
        return self.join_split_numbers([
            slots_all[pi].reshape(-1)[:dim] for pi in range(self.P)])

    # ------------------------------------------------------ rotation keys
    def stacked_galois(self, g_tuple):
        """(src [L, N], negate [L, N], k0 [L, ...], k1 [L, ...]) of a
        ladder of Galois elements, for `BFV.rotate_accumulate_scan`.
        Cached per key set, like `stacked_baby_rotations`."""
        cached = self._stack_cache.get(g_tuple)
        if cached is not None and cached[0] is self.keys:
            return cached[1]
        tabs = [_automorphism_tables_np(self.n, g) for g in g_tuple]
        stacks = (
            torch.from_numpy(np.stack([t[0] for t in tabs])).long().to(self.device),
            torch.from_numpy(np.stack([t[1] for t in tabs])).to(self.device),
            torch.stack([self.keys.galois[g].k0 for g in g_tuple]),
            torch.stack([self.keys.galois[g].k1 for g in g_tuple]),
        )
        self._stack_cache[g_tuple] = (self.keys, stacks)
        return stacks

    def stacked_baby_rotations(self, g: int):
        """(perm [g-1, N], k0 [g-1, J, L, N], k1) for the hoisted BSGS
        baby steps 1..g-1: NTT-domain automorphism gathers plus each step's
        switch keys, J components (kD digits or omega groups) over L limbs
        (k, or kp = k without special primes).  Cached per key set, so
        replacing `self.keys` never serves stale stacks."""
        cached = self._stack_cache.get(("bsgs_baby", g))
        if cached is not None and cached[0] is self.keys:
            return cached[1]
        gs = [self.bfv[0].galois_elt_rows(b) for b in range(1, g)]
        perms = torch.from_numpy(                         # int32, as K6 reads it
            np.stack([ntt_automorphism_perm(self.n, ge) for ge in gs])
        ).to(self.device)
        k0s = torch.stack([self.keys.galois[ge].k0 for ge in gs])
        k1s = torch.stack([self.keys.galois[ge].k1 for ge in gs])
        self._stack_cache[("bsgs_baby", g)] = (self.keys, (perms, k0s, k1s))
        return perms, k0s, k1s

    # --------------------------------------------- prepared plaintext forms
    def _slot_rows(self, int_values, dim: int) -> np.ndarray:
        """Slot values -> [C, n] rows of ints, C = ceil(dim / n), zero-padded."""
        C = max(1, -(-dim // self.n))
        vals = np.zeros(C * self.n, dtype=object)
        vv = np.asarray(int_values, dtype=object)
        vals[: len(vv)] = vv
        return vals.reshape(C, self.n)

    def _plain_residue_rows(self, rows, pi: int) -> torch.Tensor:
        """Slot rows [R, n] (integers of any size, signed ok) -> coefficient
        residues [R, k, N] int32 of plain prime `pi` on the device: the
        slot encode on the host (exact mod t; the C++ NTT, in threads, for
        2**31 <= t < 2**63), each limb's residue on the device (on the
        host from 2**63 on, where the coefficients pass int64)."""
        coeffs = self.encoders[pi].encode(rows)
        if coeffs.dtype == object:   # t >= 2**63: the residues on the host
            res = self.params[pi].plain_to_residues(coeffs)
            return torch.from_numpy(res.view(np.int32)).to(self.device)
        # coefficients in [0, t) < 2**63: exact as int64
        c = torch.from_numpy(coeffs.astype(np.int64))
        return (c.to(self.device)[:, None, :] % self.bfv[0].p.chain_q.q).to(torch.int32)

    def plain_mult_forms(self, slot_rows) -> torch.Tensor:
        """Slot values [R, n] (integers of any size, signed ok) -> NTT +
        Montgomery plaintext multipliers [P, R, k, N], in pieces of
        ENCODE_CHUNK rows."""
        rows = np.asarray(slot_rows)
        R = rows.shape[0]
        bfv0 = self.bfv[0]
        out = torch.empty((self.P, R, len(self.limb_moduli), self.n),
                          dtype=torch.int32, device=self.device)
        for r0 in range(0, R, ENCODE_CHUNK):
            piece = rows[r0 : r0 + ENCODE_CHUNK]
            for pi in range(self.P):
                out[pi, r0 : r0 + len(piece)] = bfv0.prepare_plain_mult(
                    self._plain_residue_rows(piece, pi))
        return out

    def plain_mult_form(self, int_values, dim: int) -> torch.Tensor:
        """Slot values -> NTT + Montgomery plaintext multiplier [P, C, k, N]."""
        return self.plain_mult_forms(self._slot_rows(int_values, dim))

    def plain_add_forms(self, slot_rows) -> torch.Tensor:
        """Slot values [R, n] -> coefficient residues [P, R, k, N] for
        add_plain."""
        rows = np.asarray(slot_rows)
        return torch.stack([self._plain_residue_rows(rows, pi)
                            for pi in range(self.P)])

    def plain_add_form(self, int_values, dim: int) -> torch.Tensor:
        """Slot values -> coefficient residues [P, C, k, N] for add_plain."""
        return self.plain_add_forms(self._slot_rows(int_values, dim))

    def add_plain_data(self, data, form, sub: bool = False) -> torch.Tensor:
        """ct data [P, ...] +/- plain residues [P, ...]: per-prime Delta."""
        return torch.stack([
            (self.bfv[pi].sub_plain if sub else self.bfv[pi].add_plain)(
                data[pi], form[pi])
            for pi in range(self.P)
        ])

    def flat_mask_form(self, lo: int, hi: int) -> torch.Tensor:
        """0/1 mask over the flat slots [lo, hi) (it spans both rows),
        prepared for multiply: [P, 1, k, N], cached."""
        key = ("flat", lo, hi)
        if key not in self._mask_cache:
            m = np.zeros(self.n, np.int64)
            m[lo:hi] = 1
            self._mask_cache[key] = self.plain_mult_form(m, self.n)
        return self._mask_cache[key]

    def mask_mult_form(self, lo: int, hi: int) -> torch.Tensor:
        """0/1 mask over the row positions [lo, hi) of both rows (slot i
        is set iff lo <= i mod (n/2) < hi), prepared for multiply:
        [P, 1, k, N], cached."""
        key = ("rows", lo, hi)
        if key not in self._mask_cache:
            pos = np.arange(self.n) % (self.n // 2)
            m = ((pos >= lo) & (pos < hi)).astype(np.int64)
            self._mask_cache[key] = self.plain_mult_form(m, self.n)
        return self._mask_cache[key]

    def unit_mask_form(self, col: int) -> torch.Tensor:
        """The mask of flat slot `col` alone (ForceOutputInColumn),
        prepared for multiply: [P, 1, k, N], cached."""
        key = ("unit", col)
        if key not in self._mask_cache:
            m = np.zeros(self.n, np.int64)
            m[col] = 1
            self._mask_cache[key] = self.plain_mult_form(m, self.n)
        return self._mask_cache[key]

    def unit_mask_forms(self, cols) -> torch.Tensor:
        """The unit masks of flat slots `cols` [R] as one [P, R, k, N]
        tensor, equal to `unit_mask_form` of each (not cached: the matrix
        that forces its rows keeps them), built a piece at a time."""
        cols = np.asarray(cols, dtype=np.int64)
        out = torch.empty((self.P, len(cols), len(self.limb_moduli), self.n),
                          dtype=torch.int32, device=self.device)
        for r0 in range(0, len(cols), ENCODE_CHUNK):
            piece = cols[r0 : r0 + ENCODE_CHUNK]
            m = np.zeros((len(piece), self.n), np.int64)
            m[np.arange(len(piece)), piece] = 1
            out[:, r0 : r0 + len(piece)] = self.plain_mult_forms(m)
        return out

    # ------------------------------------------- vector/matrix constructors
    @staticmethod
    def _scaled_ints(values, scale: float) -> np.ndarray:
        """round(values * scale) (half to even) as Python ints; through
        int64 where every value fits, the same integers without a Python
        call per element (the 5488 x 16268 weights of CIFAR)."""
        r = np.round(np.asarray(values, dtype=np.float64) * scale)
        if np.all(np.abs(r) < 2.0**62):
            return r.astype(np.int64).astype(object)
        return np.array([int(x) for x in r], dtype=object)

    def get_plain_vector(self, values, fmt: str = "dense", scale: float = 1.0):
        from .vector import HEVector

        ints = self._scaled_ints(values, scale)
        return HEVector(self, values=ints, dim=len(ints), scale=scale, fmt=fmt)

    def get_encrypted_vector(self, values, fmt: str = "dense", scale: float = 1.0):
        """Encrypt a vector: dense (ceil(dim / n) blocks in flat slot order)
        or sparse (one ciphertext a value, replicated over the slots)."""
        from .vector import HEVector

        ints = self._scaled_ints(values, scale)
        if fmt == "sparse":
            data = self._encrypt_slotsets(np.repeat(ints[:, None], self.n, axis=1))
        else:
            data = self.encrypt_blocks(ints, len(ints))
        return HEVector(self, data=data, dim=len(ints), scale=scale, fmt=fmt)

    def get_plain_matrix(self, m, fmt: str = "col", scale: float = 1.0):
        """A matrix of plain dense vectors, its columns or its rows."""
        from .matrix import HEMatrix

        m = np.asarray(m, dtype=np.float64)
        vecs = m.T if fmt == "col" else m
        return HEMatrix(
            self, [self.get_plain_vector(v, "dense", scale) for v in vecs], fmt)

    def get_encrypted_matrix(self, m, fmt: str = "col", scale: float = 1.0):
        """Encrypt every column (or row) in one device encode + encrypt."""
        from .matrix import HEMatrix
        from .vector import HEVector

        m = np.asarray(m, dtype=np.float64)
        vecs = m.T if fmt == "col" else m
        V, dim = vecs.shape
        C = max(1, -(-dim // self.n))
        padded = np.zeros((V, C * self.n), np.int64)
        padded[:, :dim] = np.round(vecs * scale).astype(np.int64)
        data = self._encrypt_slotsets(padded.reshape(V * C, self.n))
        data = data.reshape(self.P, V, C, *data.shape[2:])
        return HEMatrix(self, [
            HEVector(self, data=data[:, i], dim=dim, scale=scale, fmt="dense")
            for i in range(V)
        ], fmt)

    def get_matrix(self, vectors, fmt: str = "col"):
        from .matrix import HEMatrix

        return HEMatrix(self, list(vectors), fmt)

    def get_zero_vector(self, dim: int, scale: float = 1.0):
        """A transparent (noise-free) encryption of zero: the padding
        columns of a convolution."""
        from .vector import HEVector

        C = max(1, -(-dim // self.n))
        data = torch.zeros((self.P, C, 2, len(self.limb_moduli), self.n),
                           dtype=torch.int32, device=self.device)
        return HEVector(self, data=data, dim=dim, scale=scale, fmt="dense")


class RawFactory:
    """Plaintext-double oracle backend (ref `IFactory.cs:138-238`)."""

    is_encrypted = False
    encodes_on_device = False

    def __init__(self, block_size: int = 8192):
        self.block_size = block_size

    @property
    def slot_count(self) -> int:
        return self.block_size

    @property
    def n(self) -> int:
        return self.block_size

    def get_plain_vector(self, values, fmt: str = "dense", scale: float = 1.0):
        from .raw import RawVector

        v = RawVector(values, scale, self.block_size)
        v.fmt = fmt
        return v

    # the raw backend "encrypts" to itself (ref RawFactory)
    get_encrypted_vector = get_plain_vector

    def get_plain_matrix(self, m, fmt: str = "col", scale: float = 1.0):
        from .raw import RawMatrix

        return RawMatrix(m, scale, fmt, self.block_size)

    get_encrypted_matrix = get_plain_matrix

    def get_matrix(self, vectors, fmt: str = "col"):
        from .raw import RawMatrix

        arr = np.stack([v.v for v in vectors])
        m = arr.T if fmt == "col" else arr
        return RawMatrix.from_scaled(m, vectors[0].scale, fmt, self.block_size)

    def get_zero_vector(self, dim: int, scale: float = 1.0):
        from .raw import RawVector

        return RawVector.from_scaled(np.zeros(dim), scale, self.block_size)
