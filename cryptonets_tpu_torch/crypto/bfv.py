"""The BFV scheme over int32 RNS limb tensors (port of `cryptonets_tpu/
crypto/bfv.py`, the parts the LoLa main path runs).

Ciphertexts are int32 tensors [..., size, k, N] in the coefficient domain;
every op accepts arbitrary leading batch axes.  Keys are NTT-domain
tensors in Montgomery form (x * 2**32 mod q), the reference's layout, so a
key set exported from the JAX package (`convert.keyset_from_numpy`) works
here unchanged and every deterministic op is bit-equal to the reference.

Ported: parameters and tables, keygen, encrypt, decrypt (raw residues,
the BEHZ gamma scale-and-round mod t for t < 2**31, the two-plane
scale-and-round for 2**31 <= t < 2**62 with its exact host join, and the
exact host decrypt, the only one for t >= 2**62), plaintext multiply, the BEHZ
ciphertext multiply, relinearization, Galois automorphisms, row/column
rotations and the rotate-and-add ladder, with three key-switching modes:
digit decomposition (base 2**dbc digits of every limb, SEAL 3.2's), in a
stacked form and a form accumulated over the digits; RNS-group switching
without special primes (`ks_alpha` limbs a group, keys mod Q); and hybrid
switching with `n_special` special primes (keys mod Q*P, groups extended
to Q*P, rounded division by P), stacked over the groups or looped over
them.  The ciphertext NTTs come from the context `ntt_impl` names
("butterfly" or "matmul", `crypto/ntt.py`); keys are NTT-domain values, so
a key set belongs to the ordering it was made under.  The key switches'
inner products run through K6 (`kernels/modmac.py` `key_inner_product`)
and every fast base conversion, the group extension included, through K7
(`kernels/bconv.py` `fast_bconv`) on the tables `BFVParams.bconv`
prepares once.  The BEHZ square is six launches: K7's lift mode, K1
over the combined chain q + Bsk, the tensor kernel (`kernels/modmac.py`
`ct_tensor`), K2, then K7's floor and Shenoy-Kumaresan modes; a product
of two operands lifts and transforms each, eight launches.

The data limbs may be sharded over the ranks of a mesh's `limb` axis
(`BFVParams.narrow` with a `parallel/limbs.LimbShard`, `KeySet.narrow`):
each rank then holds limbs [lo, hi) of every ciphertext and key.  Per-limb
operations stay local; a decrypt's fast base conversion out of base q
sums each rank's partial sums over the ranks (`_limb_sum`); a key switch
gathers its polynomial once (`gather_limbs`) and computes the rank's own
output limbs; the multiply's lift and fast floor gather the q limbs they
read, once each, and run the same modes on the rank's tables;
conversions out of a replicated base (Bsk -> q, P -> q) need no
collective.  This module never imports `torch.distributed`: without a
shard the code paths are the one-process ones, with no extra copy.
"""

from __future__ import annotations

import copy
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.bconv import BconvTable, BehzMode, behz, fast_bconv
from ..kernels.modmac import ct_tensor, key_inner_product
from . import sampling
from .hostmath import CRT, modinv
from .modular import (
    RES,
    add_mod,
    as_res,
    mont_mul,
    mont_precompute_host,
    mont_table,
    mul_const_mod,
    neg_mod,
    sub_mod,
    to_mont,
    wide,
)
from .ntt import ntt_context_for
from .primes import aux_base_primes, default_coeff_modulus_128, ntt_primes


M32 = 1 << 32
MASK32 = M32 - 1


def _col(vals, device) -> torch.Tensor:
    """Per-limb constants as an int64 [L, 1] column."""
    return torch.tensor([int(v) for v in vals], dtype=torch.int64,
                        device=device).view(-1, 1)


def _mul32(a, c):
    """a * c mod 2**32 for a in [0, 2**32) (int64) and c in [0, 2**32) (an
    int or an int64 tensor): the product split at c's 16-bit halves, so
    no partial product passes 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + ((a * hi) & 0xFFFF) * 0x10000) & MASK32


class ModChain:
    """Constants of one base of moduli on one device: the modulus column
    and Montgomery constants, shaped [L, 1] against [..., L, N] residues,
    and the fused kernels' table of them (`mont`, int32 [L, 4])."""

    def __init__(self, moduli, device):
        self.moduli = tuple(int(m) for m in moduli)
        mont = [mont_precompute_host(m) for m in self.moduli]
        self.q = _col(self.moduli, device)
        self.r_mod = _col([c["r_mod"] for c in mont], device)
        self.r_inv = _col([c["r_inv"] for c in mont], device)
        self.mont = mont_table(self.moduli, device)

    def __len__(self):
        return len(self.moduli)

    def col(self, vals):
        """Per-limb constants reduced mod each limb, [L, 1]."""
        return _col([int(v) % m for v, m in zip(vals, self.moduli)],
                    self.q.device)

    def scalar_col(self, value):
        """One integer reduced into every limb, [L, 1]."""
        return self.col([value] * len(self.moduli))

    def to_mont(self, x):
        return to_mont(x, self.q, self.r_mod)

    def mont_mul(self, a, b):
        return mont_mul(a, b, self.q, self.r_inv)

    def reduce(self, x):
        """Any non-negative int < 2**63 -> [0, q) per limb."""
        return (wide(x) % self.q).to(RES)


_CHAIN_CACHE: dict = {}


def get_mod_chain(moduli, device) -> ModChain:
    """Interned chains: the q and Bsk tables do not depend on t, so the
    BFVParams of one factory share them."""
    key = (tuple(int(m) for m in moduli), torch.device(device))
    if key not in _CHAIN_CACHE:
        _CHAIN_CACHE[key] = ModChain(key[0], key[1])
    return _CHAIN_CACHE[key]


class BFVParams:
    """Precomputation for one (n, t, q-chain) triple on one device.

    Host integers and CRT helpers mirror the reference's attributes of the
    same names; device tables hold values only (the reference also keeps
    Shoup companions, which only the CUDA NTT uses here)."""

    def __init__(
        self,
        n: int,
        plain_modulus: int,
        coeff_modulus: tuple[int, ...] | None = None,
        dbc: int = 16,
        ks_alpha: int = 0,
        seed: int = 0,
        n_special: int = 0,
        ntt_impl: str = "butterfly",
        *,
        device,
    ):
        device = torch.device(device)
        self.device = device
        self.ntt_impl = ntt_impl
        self.n = n
        self.t = int(plain_modulus)
        qs = tuple(coeff_modulus) if coeff_modulus else default_coeff_modulus_128(n)
        self.q_list = qs
        self.k = len(qs)
        self.seed = seed
        # n_special > 0: hybrid switching over Q*P with groups of
        # n_special data limbs (or ks_alpha, when given); ks_alpha > 0
        # alone: RNS groups without special primes; both 0: digits
        self.n_special = int(n_special)
        self.ks_alpha = int(ks_alpha) if ks_alpha else self.n_special
        self.ks_hybrid = self.ks_alpha > 0
        self.dbc = int(dbc)
        if min(self.n_special, self.ks_alpha) < 0:
            raise ValueError("n_special and ks_alpha must not be negative")
        if not 0 < (1 << self.dbc) < min(qs):
            raise ValueError("digit width must fit the smallest limb")
        self.digits_per_limb = -(-max(q.bit_length() for q in qs) // self.dbc)

        self.chain_q = get_mod_chain(qs, device)
        self.ntt_q = ntt_context_for(ntt_impl, n, qs)
        # the data limbs these tables cover: all of them, until `narrow`
        # gives one rank of a limb-sharded mesh its block [lo, hi)
        self.shard = None
        self.lo, self.hi, self.k_local = 0, self.k, self.k
        self.limb_moduli = qs
        self.chain_q_full = self.chain_q
        self.crt_q = CRT(list(qs))
        self.q_big = self.crt_q.product
        self.delta = self.q_big // self.t  # floor(q/t)
        self.delta_col = self.chain_q.col([self.delta % q for q in qs])

        # ---- BEHZ multiply bases: Bsk = B + m_sk, sized prod(Bsk) >= 16 t n q
        need = 16 * self.t * n * self.q_big
        n_aux = max(self.k + 1, -(-need.bit_length() // 31))
        aux = aux_base_primes(n, n_aux, avoid=qs)
        while math.prod(aux) < need:
            n_aux += 1
            aux = aux_base_primes(n, n_aux, avoid=qs)
        self.B_list, self.msk = aux[:-1], aux[-1]
        bsk = self.B_list + (self.msk,)
        self.bsk_list = bsk
        self.chain_bsk = get_mod_chain(bsk, device)
        # the multiply's chain: the q limbs, then Bsk (one NTT, one tensor
        # product over both)
        self.chain_qbsk = get_mod_chain(qs + bsk, device)
        self.ntt_qbsk = ntt_context_for(ntt_impl, n, qs + bsk)
        self.crt_B = CRT(list(self.B_list))
        self.m_tilde = 1 << 16

        q_big, B_big = self.q_big, self.crt_B.product
        self.inv_punct_q = self.chain_q.col(self.crt_q.inv_punctured)
        self.punct_q_to_bsk = self._punct_matrix(self.crt_q.punctured, self.chain_bsk)
        self.punct_q_to_mtilde = torch.tensor(
            [p % self.m_tilde for p in self.crt_q.punctured],
            dtype=torch.int64, device=device,
        ).view(-1, 1, 1)
        self.neg_qinv_mtilde = (
            -modinv(q_big % self.m_tilde, self.m_tilde)) % self.m_tilde
        self.q_mod_bsk = self.chain_bsk.scalar_col(q_big)
        self.mtilde_inv_bsk = self.chain_bsk.col(
            [modinv(self.m_tilde, m) for m in bsk])
        self.mtilde_mod_q = self.chain_q.scalar_col(self.m_tilde)
        self.t_mod_q = self.chain_q.scalar_col(self.t)
        self.t_mod_bsk = self.chain_bsk.scalar_col(self.t)
        self.qinv_mod_bsk = self.chain_bsk.col([modinv(q_big % m, m) for m in bsk])

        # ---- device scale-and-round decrypt: the BEHZ gamma correction
        # for t < 2**31, the two-plane form (W mod 2**32 and mod m2, joined
        # exactly on the host) for 2**31 <= t < 2**62; larger t decrypt
        # exactly on the host only (`decrypt`)
        self.gamma = self.big_gamma = None
        if self.t < 1 << 31:
            self._init_gamma_decrypt(qs, aux)
        elif self.t < 1 << 62:
            self._init_big_t_decrypt(qs, aux)

        # ---- B -> q back-conversion (Shenoy-Kumaresan with m_sk)
        self.chain_B = get_mod_chain(self.B_list, device)
        self.inv_punct_B = self.chain_B.col(self.crt_B.inv_punctured)
        self.punct_B_to_q = self._punct_matrix(self.crt_B.punctured, self.chain_q)
        self.msk_chain = get_mod_chain([self.msk], device)
        self.punct_B_to_msk = self._punct_matrix(self.crt_B.punctured, self.msk_chain)
        self.Binv_mod_msk = self.msk_chain.col([modinv(B_big % self.msk, self.msk)])
        self.B_mod_q = self.chain_q.scalar_col(B_big)

        # switch keys live mod Q*P; P = 1 without special primes.  The
        # choice of the special primes depends on (n, qs) only: the plain
        # primes of one factory share one key set.
        self.sp_list = ()
        if self.n_special:
            pool = ntt_primes(n, 31, self.k + len(aux) + self.n_special + 8)
            used = set(qs) | set(aux)
            self.sp_list = tuple(c for c in pool if c not in used)[: self.n_special]
            if len(self.sp_list) != self.n_special:
                raise ValueError("not enough special primes")
        self.P_big = math.prod(self.sp_list)
        self.qp_list = qs + self.sp_list
        self.chain_qp = get_mod_chain(self.qp_list, device)
        self.ntt_qp = ntt_context_for(ntt_impl, n, self.qp_list)
        if self.ks_hybrid:
            self._init_group_switching()
        else:
            self._init_digit_switching()
        if self.n_special:
            self._init_mod_down()
        self.bconv = self._bconv_tables()

    def _bconv_tables(self) -> dict:
        """The fast base conversions' tables prepared once for K7
        (`BconvTable`), over the limbs these tables cover, by name: q ->
        Bsk; Shenoy-Kumaresan's B -> q and B -> m_sk as one table into
        `chain_q_msk` (the q limbs, then m_sk: one launch); the decrypts'
        q -> (t, gamma), q -> (m2, gamma) and q -> m2; each group's
        extension q -> Q*P (`groups`, by group); the mod-down sp -> q; and
        the BEHZ modes `lift`, `floor` and `sk` (`_behz_tables`)."""
        prep = BconvTable.prepare
        self.chain_q_msk = get_mod_chain(tuple(self.limb_moduli) + (self.msk,),
                                         self.device)
        tables = {
            "q_to_bsk": prep(self.punct_q_to_bsk, self.bsk_list),
            "B_to_q_msk": prep(torch.cat([self.punct_B_to_q, self.punct_B_to_msk], 1),
                               self.chain_q_msk.moduli)}
        if self.gamma is not None:
            tables["q_to_tg"] = prep(self.punct_q_to_tg, self.chain_tg.moduli)
        if self.big_gamma is not None:
            g2 = prep(self.punct_q_to_g2, self.chain_g2.moduli)
            tables["q_to_g2"], tables["q_to_m2"] = g2, g2[:, :1]
        if self.ks_hybrid:
            grp = prep(self.ks_grp_conv, self.chain_qp.moduli)
            tables["groups"] = [grp[i0:i1] for i0, i1 in self.ks_groups]
        if self.n_special:
            tables["sp_to_q"] = prep(self.ks_punct_sp_to_q, self.chain_q.moduli)
        tables.update(self._behz_tables())
        return tables

    def _behz_tables(self) -> dict:
        """The multiply's three modes of K7 (`BehzMode`), from the host
        integers.  The lift reads every q limb (gathered on a limb-sharded
        rank) and writes this rank's own through, ahead of Bsk; the floor
        reads every q limb of the product, then its Bsk limbs; Shenoy-
        Kumaresan converts the replicated Bsk into this rank's q limbs."""
        qs, bsk, Bs = list(self.q_list), list(self.bsk_list), list(self.B_list)
        own = qs[self.lo:self.hi]
        Q, B, mt, msk, t = self.q_big, self.crt_B.product, self.m_tilde, self.msk, self.t
        pq, ipq = self.crt_q.punctured, self.crt_q.inv_punctured
        pB, ipB = self.crt_B.punctured, self.crt_B.inv_punctured
        mt_inv = [modinv(mt, m) for m in bsk]
        q_inv = [modinv(Q % m, m) for m in bsk]
        b_inv = modinv(B % msk, msk)
        dev = self.device
        return {
            # y_i = x_i m~ (q/q_i)^-1; r = -(sum y_i q/q_i) q^-1 mod m~,
            # centred; out_l = (sum y_i q/q_i + r q) m~^-1 mod m_l
            "lift": BehzMode(
                "lift", qs, [mt * i % q for i, q in zip(ipq, qs)], bsk,
                [[pi * u % m for m, u in zip(bsk, mt_inv)] for pi in pq],
                [Q * u % m for m, u in zip(bsk, mt_inv)], a=[pi % mt for pi in pq],
                M=mt, d=-modinv(Q % mt, mt) % mt, through=(self.lo, self.hi),
                device=dev),
            # y_i = c_i t (q/q_i)^-1; fl_l = (t c_l - sum y_i q/q_i) q^-1 mod m_l
            "floor": BehzMode(
                "floor", qs, [t * i % q for i, q in zip(ipq, qs)], bsk,
                [[-pi * u % m for m, u in zip(bsk, q_inv)] for pi in pq],
                [t * u % m for m, u in zip(bsk, q_inv)], device=dev),
            # z_i = fl_i (B/b_i)^-1; alpha = (sum z_i B/b_i - fl_msk) B^-1
            # mod m_sk, centred; out_l = sum z_i B/b_i - alpha B mod q_l
            "sk": BehzMode(
                "sk", Bs, list(ipB), own, [[pi % q for q in own] for pi in pB],
                [-B % q for q in own], a=[pi * b_inv % msk for pi in pB], M=msk,
                d=b_inv, device=dev)}

    def _init_gamma_decrypt(self, qs, aux):
        """Tables of the BEHZ gamma-correction decrypt (t < 2**31)."""
        n, q_big = self.n, self.q_big
        cand = ntt_primes(n, 31, self.k + len(aux) + 4)
        g = next(c for c in cand if c not in qs and c not in aux and c != self.t)
        self.gamma = g
        self.chain_tg = get_mod_chain([self.t, g], self.device)
        self.gt_mod_q = self.chain_q.scalar_col(self.t * g)
        self.punct_q_to_tg = self._punct_matrix(self.crt_q.punctured, self.chain_tg)
        self.neg_qinv_tg = self.chain_tg.col([
            (-modinv(q_big % self.t, self.t)) % self.t,
            (-modinv(q_big % g, g)) % g,
        ])
        self.gamma_mod_t = g % self.t
        self.gamma_inv_t = modinv(g % self.t, self.t)

    def _init_big_t_decrypt(self, qs, aux):
        """Tables of the two-plane decrypt (2**31 <= t < 2**62): W' =
        round(t x / q) (+ t e2) mod m2 and mod 2**32, gamma-corrected;
        the reference's constants of the same names (its Shoup companions
        aside).  Every constant is reduced from a Python int."""
        n, q_big, t = self.n, self.q_big, self.t
        cand = ntt_primes(n, 31, self.k + len(aux) + 6)
        m2, g = [c for c in cand if c not in qs and c not in aux][:2]
        self.big_gamma, self.big_m2 = g, m2    # descending scan: g < m2
        self.chain_g2 = get_mod_chain([m2, g], self.device)
        self.big_m2_chain = get_mod_chain([m2], self.device)
        self.big_gt_mod_q = self.chain_q.scalar_col(t * g)
        self.punct_q_to_g2 = self._punct_matrix(self.crt_q.punctured, self.chain_g2)
        self.punct_q_to_m1 = torch.tensor(
            [int(p) % M32 for p in self.crt_q.punctured], dtype=torch.int64,
            device=self.device).view(-1, 1)
        # gamma plane: s_g = -conv_y * q^-1 mod gamma (g t x = 0 mod g)
        self.big_neg_qinv_g = (-modinv(q_big % g, g)) % g
        # m2 and 2**32 planes carry V' = (g t conv_x - conv_y) * q^-1
        self.big_gt_m2 = t * g % m2
        self.big_qinv_m2 = modinv(q_big % m2, m2)
        self.big_gamma_mod_m2 = g % m2
        self.big_ginv_m2 = modinv(g % m2, m2)
        self.big_gt_m1 = t * g % M32
        self.big_qinv_m1 = modinv(q_big % M32, M32)
        self.big_ginv_m1 = modinv(g, M32)

    def _init_digit_switching(self):
        """Digit key switching: w_ij = 2^(dbc*j) on limb i, zero on the
        others (delta_i is the CRT unit of limb i), [kD, k, 1]."""
        D = self.digits_per_limb
        dw = np.zeros((self.k * D, self.k), np.int64)
        for i, q in enumerate(self.q_list):
            for j in range(D):
                dw[i * D + j, i] = (1 << (self.dbc * j)) % q
        self.ks_digit_w = torch.from_numpy(dw[:, :, None]).to(self.device)

    def _init_group_switching(self):
        """RNS-group key switching: groups of ks_alpha data limbs, each
        extended to Q*P; the key of group j hides P * Qtilde_j * target."""
        qs, qp, device = self.q_list, self.qp_list, self.device
        alpha = self.ks_alpha
        self.ks_groups = [(i0, min(i0 + alpha, self.k)) for i0 in range(0, self.k, alpha)]
        self.ks_omega = len(self.ks_groups)
        inv_grp = []
        grp_w = np.zeros((self.k, len(qp)), np.int64)
        pqt = np.zeros((self.ks_omega, len(qp)), np.int64)
        for gi, (i0, i1) in enumerate(self.ks_groups):
            Qj = math.prod(qs[i0:i1])
            for i in range(i0, i1):
                pj = Qj // qs[i]
                inv_grp.append(modinv(pj % qs[i], qs[i]))
                grp_w[i] = [pj % m for m in qp]
            # P * Q~_j mod each limb (Q~_j: the CRT unit of group j)
            Qoj = self.q_big // Qj
            val = self.P_big * Qoj * modinv(Qoj % Qj, Qj)
            pqt[gi] = [val % m for m in qp]
        self.ks_inv_punct_grp = self.chain_q.col(inv_grp)
        self.ks_grp_conv = torch.from_numpy(grp_w[:, :, None]).to(device)
        self.ks_pqt = torch.from_numpy(pqt[:, :, None]).to(device)

    def _init_mod_down(self):
        """Tables of the rounded division by P that ends a hybrid switch:
        base conversion P -> q, P/2 in both bases, P^-1 mod q."""
        sp = self.sp_list
        self.chain_sp = get_mod_chain(sp, self.device)
        crt_sp = CRT(list(sp))
        self.ks_inv_punct_sp = self.chain_sp.col(crt_sp.inv_punctured)
        self.ks_punct_sp_to_q = self._punct_matrix(crt_sp.punctured, self.chain_q)
        half = self.P_big >> 1
        self.ks_phalf_sp = self.chain_sp.scalar_col(half)
        self.ks_phalf_q = self.chain_q.scalar_col(half)
        self.ks_pinv_q = self.chain_q.col(
            [modinv(self.P_big % q, q) for q in self.q_list])

    # per-limb [k, 1] columns, and the FastBConv tables out of base q
    # (source axis 0) and into it (target axis 1), narrowed by `narrow`
    _LIMB_COLUMNS = ("delta_col", "t_mod_q", "mtilde_mod_q", "inv_punct_q",
                     "gt_mod_q", "big_gt_mod_q", "B_mod_q", "ks_phalf_q",
                     "ks_pinv_q", "punct_q_to_bsk", "punct_q_to_mtilde",
                     "punct_q_to_tg", "punct_q_to_g2", "punct_q_to_m1")
    _LIMB_TARGETS = ("punct_B_to_q", "ks_punct_sp_to_q")

    def narrow(self, shard) -> "BFVParams":
        """These parameters on one rank of a limb-sharded mesh: a copy whose
        ciphertext tables cover the data limbs [shard.lo, shard.hi) only.
        Everything that depends on the whole chain (Delta, the Bsk primes
        and m~, the special primes, gamma and m2, the punctured products,
        the group CRT constants) is kept from the full chain this object
        was built from; only the per-limb tables are cut, the FastBConv
        tables out of base q on their source axis and those into it on
        their target axis.  The rank's Q*P chain is its own q limbs
        followed by every special prime; the Bsk, (t, gamma), (m2, gamma)
        and special-prime chains are the same on every rank.  The RNS-group
        switching keeps its source tables whole (a group reads the gathered
        polynomial) and cuts its targets."""
        if self.shard is not None:
            raise ValueError("these parameters are already narrowed")
        lo, hi = shard.lo, shard.hi
        if shard.k != self.k or not 0 <= lo < hi <= self.k:
            raise ValueError(f"{shard} does not fit a chain of {self.k} limbs")
        p = copy.copy(self)
        p.shard = shard
        p.lo, p.hi, p.k_local = lo, hi, hi - lo
        p.limb_moduli = local = self.q_list[lo:hi]
        p.chain_q = get_mod_chain(local, self.device)
        p.ntt_q = ntt_context_for(self.ntt_impl, self.n, local)
        p.chain_qbsk = get_mod_chain(local + self.bsk_list, self.device)
        p.ntt_qbsk = ntt_context_for(self.ntt_impl, self.n, local + self.bsk_list)
        for name in self._LIMB_COLUMNS:
            if getattr(self, name, None) is not None:
                setattr(p, name, getattr(self, name)[lo:hi])
        for name in self._LIMB_TARGETS:
            if hasattr(self, name):
                setattr(p, name, getattr(self, name)[:, lo:hi])
        qp_local = local + self.sp_list
        p.chain_qp = get_mod_chain(qp_local, self.device)
        p.ntt_qp = ntt_context_for(self.ntt_impl, self.n, qp_local)

        def targets(x):    # [J, kp, 1] -> the rank's q limbs + every special prime
            return torch.cat([x[:, lo:hi], x[:, self.k:]], dim=1)

        if self.ks_hybrid:
            p.ks_grp_conv, p.ks_pqt = targets(self.ks_grp_conv), targets(self.ks_pqt)
        else:
            p.ks_digit_w = targets(self.ks_digit_w)
        p.bconv = p._bconv_tables()
        return p

    def _punct_matrix(self, punctured, to_chain: ModChain) -> torch.Tensor:
        """[Lf, Lt, 1] constants |punct_i|_{m_t} for FastBConv against
        [..., Lf, 1, N] inputs."""
        vals = [[int(p) % m for m in to_chain.moduli] for p in punctured]
        return torch.tensor(vals, dtype=torch.int64,
                            device=self.device).unsqueeze(-1)

    def plain_to_residues(self, coeffs) -> np.ndarray:
        """Plain poly coeffs (ints mod t, leading axes allowed) -> [..., L,
        N] uint32 residues (host) of the L limbs these tables cover
        (`limb_moduli`: every limb unless narrowed).  Integer arrays reduce
        in int64 or uint64 (coefficients in [0, t), t < 2**63); object
        arrays, and every array for t >= 2**63, exactly."""
        c = np.asarray(coeffs)
        if c.dtype == object or self.t >= 1 << 63:
            c = c.astype(object) % self.t
            return np.stack([(c % q).astype(np.uint32) for q in self.limb_moduli],
                            axis=-2)
        if c.dtype == np.uint64:
            cu = c % np.uint64(self.t)
        else:
            cu = (c.astype(np.int64) % self.t).astype(np.uint64)
        return np.stack([(cu % np.uint64(q)).astype(np.uint32)
                         for q in self.limb_moduli], axis=-2)


class SwitchKeys(NamedTuple):
    """Key-switching keys, NTT + Montgomery domain, one per RNS group
    (k0, k1 [omega, kp, N], kp limbs of Q*P) or, in digit mode, one per
    (limb, digit) pair ([k*D, k, N])."""

    k0: torch.Tensor
    k1: torch.Tensor

    def narrow(self, lo: int, hi: int, k: int) -> "SwitchKeys":
        """The keys of data limbs [lo, hi) of k and every special prime:
        [J, hi - lo + n_special, N], the J axis (digits or groups) still
        indexing the full chain; copies, so the full keys can be freed."""
        return SwitchKeys(*(torch.cat([x[:, lo:hi], x[:, k:]], dim=1) for x in self))


class HeldGaloisKeys(dict):
    """The Galois keys one holder (a pipeline stage) holds, out of a key
    set that has more: `g in keys` answers for the whole set (`known`), so
    every branch that asks whether a single-hop key exists takes the path
    it takes with the whole set; a lookup of a key that is not held raises
    a KeyError naming the holder and the Galois element."""

    def __init__(self, held: dict, known, owner: str):
        super().__init__(held)
        self.known = frozenset(known)
        self.owner = owner

    def __contains__(self, g) -> bool:
        return g in self.known

    def __getitem__(self, g):
        if not dict.__contains__(self, g):
            raise KeyError(f"{self.owner} holds no Galois key for element {g}")
        return dict.__getitem__(self, g)

    def map(self, fn) -> "HeldGaloisKeys":
        return HeldGaloisKeys({g: fn(sk) for g, sk in self.items()},
                              self.known, self.owner)


class _RecordedGaloisKeys(dict):
    """A view of a Galois key dict that adds every element looked up to
    `seen`; membership and lookups answer as the dict it views."""

    def __init__(self, keys: dict, seen: set):
        super().__init__(keys)
        self.inner, self.seen = keys, seen

    def __contains__(self, g) -> bool:
        return g in self.inner

    def __getitem__(self, g):
        self.seen.add(g)
        return self.inner[g]


def _map_galois(galois: dict, fn) -> dict:
    return galois.map(fn) if isinstance(galois, HeldGaloisKeys) else {
        g: fn(sk) for g, sk in galois.items()}


class KeySet(NamedTuple):
    s_hat_mont: torch.Tensor   # NTT(s) in Montgomery form [k, N]
    s2_hat_mont: torch.Tensor  # NTT(s^2) in Montgomery form
    p0_hat_mont: torch.Tensor  # public key polys, NTT + Montgomery
    p1_hat_mont: torch.Tensor
    relin: SwitchKeys
    galois: dict               # Galois element -> SwitchKeys
    s_small: torch.Tensor      # ternary secret [N] (host checks)

    def to(self, device) -> "KeySet":
        """The same keys on `device` (no copy for tensors already there);
        a selected set (`select`) stays one."""
        def mv(x):
            if x is None:
                return None
            if isinstance(x, SwitchKeys):
                return SwitchKeys(x.k0.to(device), x.k1.to(device))
            return x.to(device)

        return KeySet(
            mv(self.s_hat_mont), mv(self.s2_hat_mont), mv(self.p0_hat_mont),
            mv(self.p1_hat_mont), mv(self.relin), _map_galois(self.galois, mv),
            mv(self.s_small),
        )

    def narrow(self, lo: int, hi: int, k: int) -> "KeySet":
        """One rank's keys on a limb-sharded mesh: data limbs [lo, hi) of
        k of the secret and public keys, and of every switch key with
        every special prime (`SwitchKeys.narrow`); copies."""
        def cut(x):
            return x[lo:hi].clone()

        return KeySet(
            cut(self.s_hat_mont), cut(self.s2_hat_mont), cut(self.p0_hat_mont),
            cut(self.p1_hat_mont), self.relin.narrow(lo, hi, k),
            _map_galois(self.galois, lambda sk: sk.narrow(lo, hi, k)),
            self.s_small,
        )

    def recording(self, seen: set | None = None) -> tuple["KeySet", set]:
        """(a view of these keys that records what is read, `seen`): every
        Galois element looked up (an int) and every other field read (its
        name: "relin", "p0_hat_mont", ...), added to `seen` (a new set by
        default).  Put the view in a factory's place for one run to learn
        which keys that run uses."""
        seen = set() if seen is None else seen

        class _Recorded(KeySet):
            __slots__ = ()

        for i, name in enumerate(KeySet._fields):
            if name != "galois":
                setattr(_Recorded, name, property(
                    lambda ks, i=i, name=name: seen.add(name) or tuple.__getitem__(ks, i)))
        return _Recorded(*self._replace(galois=_RecordedGaloisKeys(self.galois, seen))), seen

    def select(self, galois=(), relin: bool = False, keep=(),
               owner: str = "this key set") -> "KeySet":
        """The keys one holder uses and nothing more: the Galois keys of
        the elements `galois`, the relinearization key if `relin`, and of
        the secret and public keys the fields named in `keep`; every other
        field is None.  `g in keys.galois` still answers for the whole set
        (`HeldGaloisKeys`); a missing key raises, naming `owner`.  No copy."""
        galois = set(galois)
        missing = galois - set(self.galois)
        if missing:
            raise KeyError(f"the key set has no Galois key for {sorted(missing)}")
        keep = set(keep)

        def field(name):
            return getattr(self, name) if name in keep else None

        return KeySet(
            field("s_hat_mont"), field("s2_hat_mont"), field("p0_hat_mont"),
            field("p1_hat_mont"), self.relin if relin else None,
            HeldGaloisKeys({g: self.galois[g] for g in sorted(galois)},
                           set(self.galois), owner),
            field("s_small"),
        )

    def nbytes(self) -> int:
        """Bytes of every tensor the key set holds."""
        tensors = [self.s_hat_mont, self.s2_hat_mont, self.p0_hat_mont,
                   self.p1_hat_mont, self.s_small,
                   *(self.relin if self.relin is not None else ())]
        tensors += [x for sk in self.galois.values() for x in sk]
        return sum(x.numel() * x.element_size() for x in tensors if x is not None)


@lru_cache(maxsize=None)
def _automorphism_tables_np(n: int, g: int):
    """Host gather indices + negate mask for a(x) -> a(x^g) mod x^n + 1."""
    i = np.arange(n, dtype=np.int64)
    r = (i * g) % (2 * n)
    pos = r % n
    src = np.empty(n, np.int32)
    neg = np.empty(n, bool)
    src[pos] = i
    neg[pos] = r >= n
    return src, neg


class BFV:
    """Keygen, encrypt, decrypt and evaluation over one BFVParams."""

    # A digit key switch whose stacked digit tensor [k*D, ..., k, N]
    # (int32) would pass this many bytes accumulates over the digits
    # instead: the same sums, one digit's temporaries at a time.  Callers
    # may set it per instance (a test sets 0 to force the accumulated
    # form).
    digit_stack_bytes = 1 << 31
    # The same for a group key switch and its stacked group tensor
    # [omega, ..., kp, N]: past this it loops over the groups.
    group_stack_bytes = 1 << 31

    def __init__(self, params: BFVParams):
        self.p = params
        self._auto: dict = {}

    # ------------------------------------------------- limbs of other ranks
    def gather_limbs(self, x):
        """x [..., L, N] over this rank's data limbs -> [..., k, N] over
        every limb (an all-gather over the limb group); x itself when the
        limbs are not sharded."""
        shard = self.p.shard
        return x if shard is None else shard.all_gather(x, dim=-2)

    def _limb_sum(self, x, m):
        """A sum over this rank's source limbs, reduced mod m -> the sum
        over every limb mod m (int64; an all-reduce over the limb group:
        each partial sum is below m <= 2**32, so the ranks' sum is exact);
        x itself when the limbs are not sharded."""
        shard = self.p.shard
        return x if shard is None else shard.all_reduce_sum(x) % m

    # ------------------------------------------------------------------ keys
    def galois_elt_rows(self, steps: int) -> int:
        """Galois element realizing a row rotation by `steps` slots."""
        return pow(3, steps % (self.p.n // 2), 2 * self.p.n)

    def galois_elements(self, rot_steps=(), column_key=True) -> list[int]:
        """The power-of-two ladder (both signs) plus `rot_steps`, and the
        column swap: the reference's keygen order."""
        p = self.p
        row = p.n // 2
        steps_set = set()
        for j in range(int(math.log2(row))):
            steps_set.add(1 << j)
            steps_set.add(row - (1 << j))
        steps_set.update(s % row for s in rot_steps if s % row)
        g_list = [self.galois_elt_rows(st) for st in sorted(steps_set)]
        if column_key:
            g_list.append(2 * p.n - 1)
        return g_list

    def keygen(self, seed: int | None = None, rot_steps=(),
               column_key=True) -> KeySet:
        """All keys from one seeded generator on the params' device, over
        the full chain (a limb-sharded rank narrows them: `KeySet.narrow`)."""
        p = self.p
        if p.shard is not None:
            raise ValueError("keys are made on the full chain, then narrowed")
        c = p.chain_q
        gen = torch.Generator(device=p.device)
        gen.manual_seed(p.seed if seed is None else seed)

        s_small = sampling.ternary(gen, (p.n,))
        s_hat = p.ntt_q.forward(sampling.small_to_residues(s_small, c.q))
        s_mont = c.to_mont(s_hat)
        s2_hat = c.mont_mul(s_hat, s_mont)
        a_hat = sampling.uniform_mod_q(gen, (p.k, p.n), c.q, c.r_mod)
        e_hat = p.ntt_q.forward(
            sampling.small_to_residues(sampling.gauss(gen, (p.n,)), c.q))
        p0_hat = neg_mod(add_mod(c.mont_mul(a_hat, s_mont), e_hat, c.q), c.q)

        # switch-key targets: s^2, then sigma_g(s) per Galois element,
        # over the key-switching base Q*P (= q without special primes)
        ck, nttk = p.chain_qp, p.ntt_qp
        sk_hat = nttk.forward(sampling.small_to_residues(s_small, ck.q))
        sk_mont = ck.to_mont(sk_hat)
        g_list = self.galois_elements(rot_steps, column_key)
        targets = [ck.mont_mul(sk_hat, sk_mont)[None]]
        if g_list:
            tabs = [_automorphism_tables_np(p.n, g) for g in g_list]
            srcg = torch.from_numpy(np.stack([t[0] for t in tabs])).long()
            negm = torch.from_numpy(np.stack([t[1] for t in tabs]))
            sg = s_small[srcg.to(p.device)]
            sg = torch.where(negm.to(p.device), -sg, sg)
            targets.append(nttk.forward(sampling.small_to_residues(sg, ck.q)))
        k0_all, k1_all = self._make_switch_keys(torch.cat(targets), sk_mont, gen)
        return KeySet(
            s_hat_mont=s_mont,
            s2_hat_mont=c.to_mont(s2_hat),
            p0_hat_mont=c.to_mont(p0_hat),
            p1_hat_mont=c.to_mont(a_hat),
            relin=SwitchKeys(k0_all[0], k1_all[0]),
            galois={
                g: SwitchKeys(k0_all[i + 1], k1_all[i + 1])
                for i, g in enumerate(g_list)
            },
            s_small=s_small.to(torch.int32),
        )

    def _make_switch_keys(self, targets_hat, s_mont, gen):
        """K_j = (-(a s + e) + w_j * T, a) for every target T [G, kp, N]
        and every component j: the RNS groups (w_j = Qtilde_j) or, in digit
        mode, the (limb, digit) pairs (w_ij = 2^(dbc*j) * delta_i).
        Returns (k0, k1) [G, components, kp, N]."""
        p = self.p
        c = p.chain_qp
        G = targets_hat.shape[0]
        w = p.ks_pqt if p.ks_hybrid else p.ks_digit_w
        a_hat = sampling.uniform_mod_q(
            gen, (G, w.shape[0], len(p.qp_list), p.n), c.q, c.r_mod)
        e_hat = p.ntt_qp.forward(sampling.small_to_residues(
            sampling.gauss(gen, (G, w.shape[0], p.n)), c.q))
        k0 = add_mod(
            neg_mod(add_mod(c.mont_mul(a_hat, s_mont), e_hat, c.q), c.q),
            mul_const_mod(targets_hat[:, None], w, c.q),
            c.q,
        )
        return c.to_mont(k0), c.to_mont(a_hat)

    # --------------------------------------------------------------- encrypt
    def encrypt(self, keys: KeySet, pt_residues, gen: torch.Generator):
        """Public-key encryption of plaintext residues [..., k, N] ->
        ciphertext [..., 2, k, N]."""
        p = self.p
        c = p.chain_q
        lead = tuple(pt_residues.shape[:-2])
        u_hat = p.ntt_q.forward(sampling.small_to_residues(
            sampling.ternary(gen, lead + (p.n,)), c.q))
        e1 = sampling.small_to_residues(sampling.gauss(gen, lead + (p.n,)), c.q)
        e2 = sampling.small_to_residues(sampling.gauss(gen, lead + (p.n,)), c.q)
        c0 = p.ntt_q.inverse(c.mont_mul(u_hat, keys.p0_hat_mont))
        c1 = p.ntt_q.inverse(c.mont_mul(u_hat, keys.p1_hat_mont))
        dm = mul_const_mod(pt_residues, p.delta_col, c.q)
        c0 = add_mod(add_mod(c0, e1, c.q), dm, c.q)
        c1 = add_mod(c1, e2, c.q)
        return torch.stack([c0, c1], dim=-3)

    # --------------------------------------------------------------- decrypt
    def raw_decrypt_residues(self, keys: KeySet, ct):
        """[c0 + c1 s (+ c2 s^2)]_q -> [..., k, N]."""
        p = self.p
        c = p.chain_q
        acc = c.mont_mul(p.ntt_q.forward(ct[..., 1, :, :]), keys.s_hat_mont)
        if ct.shape[-3] == 3:
            acc = add_mod(acc, c.mont_mul(
                p.ntt_q.forward(ct[..., 2, :, :]), keys.s2_hat_mont), c.q)
        return add_mod(ct[..., 0, :, :], p.ntt_q.inverse(acc), c.q)

    def decrypt_residues_mod_t(self, keys: KeySet, ct):
        """Device scale-and-round decrypt (BEHZ gamma correction):
        plaintext coefficients mod t as int32 [..., N]."""
        p = self.p
        cq, ctg = p.chain_q, p.chain_tg
        x = self.raw_decrypt_residues(keys, ct)            # [..., k, N]
        xs = mul_const_mod(x, p.gt_mod_q, cq.q)            # |gamma*t*x|_q
        y = mul_const_mod(xs, p.inv_punct_q, cq.q)
        conv = as_res(self._limb_sum(                      # [..., 2, N]
            fast_bconv(y, p.bconv["q_to_tg"], ctg), ctg.q))
        s = mul_const_mod(conv, p.neg_qinv_tg, ctg.q)
        s_t, s_g = s[..., 0, :], s[..., 1, :]
        t = p.t
        s_g_red = wide(s_g) % t
        # s_g > gamma/2 means a negative value: center before reducing
        s_g_cent = torch.where(
            s_g > (p.gamma >> 1), sub_mod(s_g_red, p.gamma_mod_t, t),
            s_g_red.to(RES))
        diff = sub_mod(s_t, s_g_cent, t)
        return mul_const_mod(diff, p.gamma_inv_t, t)

    def decrypt_big_t_planes(self, keys: KeySet, ct):
        """Device scale-and-round decrypt for 2**31 <= t < 2**62: the
        planes (W' mod 2**32 as int64 in [0, 2**32), W' mod m2 as int32),
        [..., N] each, with W' = round(t x / q) + t e2 (0 <= e2 < k from
        the approximate base conversion of x; it cancels mod t).
        `join_big_t_planes` composes W' on the host and reduces it mod t.
        The mod-2**32 plane wraps around as the reference's uint32
        arithmetic does: int64 here, every product and sum masked to 32
        bits (`_mul32`)."""
        p = self.p
        if p.big_gamma is None:
            raise ValueError("the two-plane decrypt needs 2**31 <= t < 2**62")
        g, m2 = p.big_gamma, p.big_m2
        cq = p.chain_q
        x = self.raw_decrypt_residues(keys, ct)            # [..., k, N]
        xs = mul_const_mod(x, p.big_gt_mod_q, cq.q)        # |g t x|_q
        y = mul_const_mod(xs, p.inv_punct_q, cq.q)
        yx = mul_const_mod(x, p.inv_punct_q, cq.q)
        # conv_y over {m2, gamma}; conv_x over {m2}
        conv_y = as_res(self._limb_sum(                    # [..., 2, N]
            fast_bconv(y, p.bconv["q_to_g2"], p.chain_g2), p.chain_g2.q))
        conv_x_m2 = as_res(self._limb_sum(fast_bconv(
            yx, p.bconv["q_to_m2"], p.big_m2_chain), m2))[..., 0, :]
        # gamma plane: s_g = V mod gamma, V = Z - e  (g t x = 0 mod g)
        s_g = mul_const_mod(conv_y[..., 1, :], p.big_neg_qinv_g, g)
        # V' mod m2 = (g t conv_x - conv_y) * q^-1
        v_m2 = mul_const_mod(
            sub_mod(mul_const_mod(conv_x_m2, p.big_gt_m2, m2),
                    conv_y[..., 0, :], m2),
            p.big_qinv_m2, m2)
        # V' mod 2**32
        conv_y_m1 = self._limb_sum(
            (_mul32(wide(y), p.punct_q_to_m1).sum(dim=-2)) & MASK32, M32)
        conv_x_m1 = self._limb_sum(
            (_mul32(wide(yx), p.punct_q_to_m1).sum(dim=-2)) & MASK32, M32)
        v_m1 = _mul32((_mul32(conv_x_m1, p.big_gt_m1) - conv_y_m1) & MASK32,
                      p.big_qinv_m1)
        # center the gamma residue and divide by gamma: W' = (V' - e) / g
        neg = s_g > (g >> 1)
        e_m2 = torch.where(neg, sub_mod(s_g, p.big_gamma_mod_m2, m2), s_g)
        w_m2 = mul_const_mod(sub_mod(v_m2, e_m2, m2), p.big_ginv_m2, m2)
        e_m1 = (wide(s_g) - neg.to(torch.int64) * g) & MASK32
        w_lo = _mul32((v_m1 - e_m1) & MASK32, p.big_ginv_m1)
        return w_lo, w_m2

    def join_big_t_planes(self, w_lo, w_m2) -> np.ndarray:
        """Host: (W' mod 2**32, W' mod m2) -> exact uint64 W' (< t (k + 1)
        < 2**63), reduced mod t.  All arithmetic fits int64: the high
        digit u = W' >> 32 < 2**31 <= m2 is recovered exactly mod m2."""
        m2 = self.p.big_m2
        inv32 = modinv(M32 % m2, m2)
        lo = np.asarray(w_lo).astype(np.int64)
        r2 = np.asarray(w_m2).astype(np.int64)
        d = (r2 - (lo % m2)) % m2
        u = (d * inv32) % m2            # < 2**31; the product < 2**62
        return (lo + (u << 32)).astype(np.uint64) % np.uint64(self.p.t)

    def decrypt(self, keys: KeySet, ct) -> np.ndarray:
        """Exact host decrypt of [..., size, k, N]: plaintext coefficients
        as object ints [..., N] in [0, t), round(t w / q) mod t of the
        centered CRT composition w (any t; the plain twin of the device
        decrypts).  Sharded limbs are gathered first."""
        p = self.p
        limbs = self.gather_limbs(self.raw_decrypt_residues(keys, ct))
        limbs = limbs.cpu().numpy().astype(object)
        acc = None
        for i, (inv, punct, q) in enumerate(zip(
                p.crt_q.inv_punctured, p.crt_q.punctured, p.crt_q.moduli)):
            term = (limbs[..., i, :] * inv % q) * punct
            acc = term if acc is None else acc + term
        Q = p.q_big
        w = acc % Q
        w = np.where(w > Q >> 1, w - Q, w)
        return ((2 * p.t * w + Q) // (2 * Q)) % p.t

    # ------------------------------------------------------- add / plain ops
    @staticmethod
    def _match_size(a, b):
        """Pad the smaller ciphertext with zero polynomials to the size
        of the larger (size-2 + size-3)."""
        sa, sb = a.shape[-3], b.shape[-3]
        if sa == sb:
            return a, b

        def pad(x, size):
            shape = x.shape[:-3] + (size - x.shape[-3],) + x.shape[-2:]
            return torch.cat([x, x.new_zeros(shape)], dim=-3)

        return (pad(a, sb), b) if sa < sb else (a, pad(b, sa))

    def add(self, a, b):
        a, b = self._match_size(a, b)
        return add_mod(a, b, self.p.chain_q.q)

    def sub(self, a, b):
        a, b = self._match_size(a, b)
        return sub_mod(a, b, self.p.chain_q.q)

    def neg(self, a):
        return neg_mod(a, self.p.chain_q.q)

    def _plain_on_c0(self, a, pt_residues, op):
        """a with c0 replaced by op(c0, Delta * pt)."""
        q = self.p.chain_q.q
        dm = mul_const_mod(pt_residues, self.p.delta_col, q)
        c0 = op(a[..., 0, :, :], dm, q)
        return torch.cat([c0.unsqueeze(-3), a[..., 1:, :, :]], dim=-3)

    def add_plain(self, a, pt_residues):
        """a + Delta * pt on the c0 polynomial."""
        return self._plain_on_c0(a, pt_residues, add_mod)

    def sub_plain(self, a, pt_residues):
        """a - Delta * pt on the c0 polynomial."""
        return self._plain_on_c0(a, pt_residues, sub_mod)

    def prepare_plain_mult(self, pt_residues):
        """Plaintext poly -> NTT + Montgomery domain [..., k, N]."""
        return self.p.chain_q.to_mont(self.p.ntt_q.forward(pt_residues))

    def mul_plain(self, a, pt_hat_mont):
        p = self.p
        return p.ntt_q.inverse(
            p.chain_q.mont_mul(p.ntt_q.forward(a), pt_hat_mont))

    # ------------------------------------------------------------- multiply
    def _behz(self, a, b):
        """BEHZ full-RNS product of a and b (b None: a's square), size-2
        ciphertexts [..., 2, k, N] -> size 3: each operand lifted to Bsk
        beside its q limbs, one NTT over the chain q + Bsk, the tensor
        product, the inverse NTT, the fast floor of t c / q into Bsk and
        Shenoy-Kumaresan's conversion back to q, in the modes of K7 (their
        twin on the CPU).  A limb-sharded rank gathers the q limbs that the
        lift and the floor read, once each."""
        p = self.p
        if a.shape[-3] != 2 or (b is not None and b.shape[-3] != 2):
            raise ValueError("multiply takes size-2 ciphertexts")
        tabs, ntt = p.bconv, p.ntt_qbsk
        xh = ntt.forward(behz(self.gather_limbs(a), tabs["lift"]))
        yh = None if b is None else ntt.forward(behz(self.gather_limbs(b), tabs["lift"]))
        c = ntt.inverse(ct_tensor(xh, yh, p.chain_qbsk))
        if p.shard is not None:
            kl = p.k_local
            c = torch.cat([self.gather_limbs(c[..., :kl, :]), c[..., kl:, :]], dim=-2)
        return behz(behz(c, tabs["floor"]), tabs["sk"])

    def multiply(self, a, b):
        """BFV ciphertext multiply (BEHZ full-RNS) of two size-2
        ciphertexts -> size-3 ciphertext; relinearize() reduces it."""
        return self._behz(a, b)

    def square(self, a):
        """`multiply(a, a)`, bit for bit, lifting and transforming a once."""
        return self._behz(a, None)

    # ----------------------------------------------------------- key switch
    def _digit(self, poly, d: int):
        """Digit d = (limb, position) of poly [..., k, N] (every limb):
        base-2^dbc digit `position` of that limb's residues, broadcast over
        the limbs these tables cover (a digit is a valid residue of every
        limb: 2^dbc < min q), [..., L, N]."""
        p = self.p
        i, j = divmod(d, p.digits_per_limb)
        dig = (poly[..., i, :] >> (p.dbc * j)) & ((1 << p.dbc) - 1)
        return dig[..., None, :].expand(*poly.shape[:-2], p.k_local, p.n)

    def _decompose_digits(self, poly):
        """poly [..., k, N] (every limb) -> all k*D digits, [k*D, ..., L,
        N] over the limbs these tables cover."""
        p = self.p
        return torch.stack(
            [self._digit(poly, d) for d in range(p.k * p.digits_per_limb)])

    def _switch_key_digits_accumulated(self, poly, keys: SwitchKeys):
        """The digit key switch one digit at a time: the sums of the
        stacked form with one digit's NTT and products live at once."""
        p = self.p
        t_hat = None
        for d in range(p.k * p.digits_per_limb):
            dhat = p.ntt_q.forward(self._digit(poly, d))
            t_hat = key_inner_product(dhat[None], keys.k0[d:d + 1],
                                      keys.k1[d:d + 1], p.chain_q, t_hat)
        return p.ntt_q.inverse(t_hat)

    def _switch_key_inner(self, poly, keys: SwitchKeys):
        """Key switch of poly [..., L, N] -> two polys [..., 2, L, N] in
        the coefficient domain, by digits or by RNS groups.  A digit or a
        group reads whole source limbs: with sharded limbs the polynomial
        is gathered once here, and each rank computes its own output
        limbs.  The stacked-or-looped choices read the gathered sizes, so
        every rank of the limb group takes the same branch."""
        p = self.p
        cq = p.chain_q
        poly = self.gather_limbs(poly)                     # [..., k, N]
        if p.ks_hybrid:
            return self._switch_key_inner_hybrid(poly, keys)
        stacked = 4 * p.k * p.digits_per_limb * poly.numel()
        if stacked > self.digit_stack_bytes:
            return self._switch_key_digits_accumulated(poly, keys)
        dhat = p.ntt_q.forward(self._decompose_digits(poly))  # [kD, ..., k, N]
        return p.ntt_q.inverse(key_inner_product(dhat, keys.k0, keys.k1, cq))

    def _switch_key_inner_hybrid(self, poly, keys: SwitchKeys):
        """RNS-group key switch of poly [..., k, N] (every limb): each
        group of data limbs is extended to Q*P (to this rank's limbs of
        it), one inner product with the keys runs over the extended chain,
        and with special primes a rounded division by P brings the result
        back to Q.  The groups are stacked, or looped over when the stack
        [omega, ..., kp, N] would pass `group_stack_bytes`: the same sums."""
        p = self.p
        cq, cqp = p.chain_q, p.chain_qp
        kp = len(p.qp_list)
        stacked = 4 * p.ks_omega * (poly.numel() // p.k) * kp
        if stacked > self.group_stack_bytes:
            y = mul_const_mod(poly, p.ks_inv_punct_grp, p.chain_q_full.q)
            t_hat = None
            for gi in range(p.ks_omega):
                dhat = p.ntt_qp.forward(self._group_extend(y, gi))
                t_hat = key_inner_product(dhat[None], keys.k0[gi:gi + 1],
                                          keys.k1[gi:gi + 1], cqp, t_hat)
        else:
            dhat = p.ntt_qp.forward(self._group_decompose(poly))  # [omega, ..., kp, N]
            t_hat = key_inner_product(dhat, keys.k0, keys.k1, cqp)
        tt = p.ntt_qp.inverse(t_hat)                              # [..., 2, kp, N]
        if p.n_special == 0:
            return tt
        # rounded division by P: (t + P/2 - [(t + P/2) mod P]) / P, each
        # rank its own q limbs out of the replicated special primes
        t_q, t_sp = tt[..., : p.k_local, :], tt[..., p.k_local :, :]
        csp = p.chain_sp
        z = add_mod(t_sp, p.ks_phalf_sp, csp.q)
        y2 = mul_const_mod(z, p.ks_inv_punct_sp, csp.q)
        conv = fast_bconv(y2, p.bconv["sp_to_q"], cq)
        num = sub_mod(add_mod(t_q, p.ks_phalf_q, cq.q), conv, cq.q)
        return mul_const_mod(num, p.ks_pinv_q, cq.q)

    def _group_extend(self, y, gi: int):
        """Group gi of y [..., k, N] (already * ks_inv_punct_grp) extended
        to the chain Q*P (this rank's limbs of it): [..., kp, N]."""
        p = self.p
        i0, i1 = p.ks_groups[gi]
        return fast_bconv(y[..., i0:i1, :], p.bconv["groups"][gi], p.chain_qp)

    def _group_decompose(self, poly):
        """poly [..., k, N] (every limb) -> per-group base extensions
        [omega, ..., kp, N] (the RNS-group digits of the key switch,
        coefficient domain)."""
        p = self.p
        y = mul_const_mod(poly, p.ks_inv_punct_grp, p.chain_q_full.q)
        return torch.stack(
            [self._group_extend(y, gi) for gi in range(p.ks_omega)], dim=0)

    def relinearize(self, ct, keys: KeySet):
        if ct.shape[-3] == 2:
            return ct
        if keys.relin is None:
            raise KeyError(f"{getattr(keys.galois, 'owner', 'the key set')} "
                           f"holds no relinearization key")
        ks = self._switch_key_inner(ct[..., 2, :, :], keys.relin)
        return add_mod(ct[..., :2, :, :], ks, self.p.chain_q.q)

    # ------------------------------------------------------------ rotations
    def _automorphism(self, g: int):
        """(src, negate) device tables of a(x) -> a(x^g), cached."""
        if g not in self._auto:
            src, neg = _automorphism_tables_np(self.p.n, g)
            self._auto[g] = (
                torch.from_numpy(src).long().to(self.p.device),
                torch.from_numpy(neg).to(self.p.device),
            )
        return self._auto[g]

    def _apply_automorphism(self, ct, src, negm, sk: SwitchKeys):
        """a(x) -> a(x^g) on both polynomials by the gather tables of g,
        then the key switch of the second one back to the secret key."""
        q = self.p.chain_q.q
        d = ct[..., src]
        d = torch.where(negm, neg_mod(d, q), d)
        ks = self._switch_key_inner(d[..., 1, :, :], sk)
        c0 = add_mod(d[..., 0, :, :], ks[..., 0, :, :], q)
        return torch.stack([c0, ks[..., 1, :, :]], dim=-3)

    def apply_galois(self, ct, g: int, keys: KeySet):
        return self._apply_automorphism(ct, *self._automorphism(g), keys.galois[g])

    def rotate_accumulate_scan(self, data, stacked):
        """acc <- acc + rotate(acc, g_l) over a stacked ladder of Galois
        elements: the log2 rotation tree of SumAllSlots.  `stacked` is
        (src [L, N], negate [L, N], k0 [L, ...], k1 [L, ...]), made once
        per ladder by the factory (`stacked_galois`).  A plain loop over
        the levels."""
        acc = data
        for src, negm, k0, k1 in zip(*stacked):
            rot = self._apply_automorphism(acc, src, negm, SwitchKeys(k0, k1))
            acc = add_mod(acc, rot, self.p.chain_q.q)
        return acc

    def rotate_rows(self, ct, steps: int, keys: KeySet):
        """Rotate the two (n/2)-slot rows left by `steps`; one single-hop
        key when present, else composed from the power-of-two ladder."""
        row = self.p.n // 2
        steps %= row
        if steps == 0:
            return ct
        g = self.galois_elt_rows(steps)
        if g in keys.galois:
            return self.apply_galois(ct, g, keys)
        out, bit = ct, 1
        while steps:
            if steps & 1:
                out = self.apply_galois(out, self.galois_elt_rows(bit), keys)
            steps >>= 1
            bit <<= 1
        return out

    def rotate_columns(self, ct, keys: KeySet):
        """Swap the two slot rows: Galois element 2n - 1."""
        return self.apply_galois(ct, 2 * self.p.n - 1, keys)
