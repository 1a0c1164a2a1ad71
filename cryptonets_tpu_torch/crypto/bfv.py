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
a key set belongs to the ordering it was made under.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import sampling
from .hostmath import CRT, modinv
from .modular import (
    RES,
    add_mod,
    mod_sum,
    mont_mul,
    mont_precompute_host,
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
    and Montgomery constants, shaped [L, 1] against [..., L, N] residues."""

    def __init__(self, moduli, device):
        self.moduli = tuple(int(m) for m in moduli)
        mont = [mont_precompute_host(m) for m in self.moduli]
        self.q = _col(self.moduli, device)
        self.r_mod = _col([c["r_mod"] for c in mont], device)
        self.r_inv = _col([c["r_inv"] for c in mont], device)

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
        self.ntt_bsk = ntt_context_for(ntt_impl, n, bsk)
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

    def _punct_matrix(self, punctured, to_chain: ModChain) -> torch.Tensor:
        """[Lf, Lt, 1] constants |punct_i|_{m_t} for FastBConv against
        [..., Lf, 1, N] inputs."""
        vals = [[int(p) % m for m in to_chain.moduli] for p in punctured]
        return torch.tensor(vals, dtype=torch.int64,
                            device=self.device).unsqueeze(-1)

    def plain_to_residues(self, coeffs) -> np.ndarray:
        """Plain poly coeffs (ints mod t, leading axes allowed) -> [..., k,
        N] uint32 residues (host).  Integer arrays reduce in int64 or
        uint64 (coefficients in [0, t), t < 2**63); object arrays, and
        every array for t >= 2**63, exactly."""
        c = np.asarray(coeffs)
        if c.dtype == object or self.t >= 1 << 63:
            c = c.astype(object) % self.t
            return np.stack([(c % q).astype(np.uint32) for q in self.q_list], axis=-2)
        if c.dtype == np.uint64:
            cu = c % np.uint64(self.t)
        else:
            cu = (c.astype(np.int64) % self.t).astype(np.uint64)
        return np.stack([(cu % np.uint64(q)).astype(np.uint32) for q in self.q_list],
                        axis=-2)


class SwitchKeys(NamedTuple):
    """Key-switching keys, NTT + Montgomery domain, one per RNS group
    (k0, k1 [omega, kp, N], kp limbs of Q*P) or, in digit mode, one per
    (limb, digit) pair ([k*D, k, N])."""

    k0: torch.Tensor
    k1: torch.Tensor


class KeySet(NamedTuple):
    s_hat_mont: torch.Tensor   # NTT(s) in Montgomery form [k, N]
    s2_hat_mont: torch.Tensor  # NTT(s^2) in Montgomery form
    p0_hat_mont: torch.Tensor  # public key polys, NTT + Montgomery
    p1_hat_mont: torch.Tensor
    relin: SwitchKeys
    galois: dict               # Galois element -> SwitchKeys
    s_small: torch.Tensor      # ternary secret [N] (host checks)

    def to(self, device) -> "KeySet":
        """The same keys on `device` (no copy for tensors already there)."""
        def mv(sk: SwitchKeys) -> SwitchKeys:
            return SwitchKeys(sk.k0.to(device), sk.k1.to(device))

        return KeySet(
            self.s_hat_mont.to(device), self.s2_hat_mont.to(device),
            self.p0_hat_mont.to(device), self.p1_hat_mont.to(device),
            mv(self.relin), {g: mv(sk) for g, sk in self.galois.items()},
            self.s_small.to(device),
        )


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
        """All keys from one seeded generator on the params' device."""
        p = self.p
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
        conv = self._fast_bconv(y, p.punct_q_to_tg, ctg)   # [..., 2, N]
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
        conv_y = self._fast_bconv(y, p.punct_q_to_g2, p.chain_g2)    # [..., 2, N]
        conv_x_m2 = self._fast_bconv(
            yx, p.punct_q_to_g2[:, :1], p.big_m2_chain)[..., 0, :]
        # gamma plane: s_g = V mod gamma, V = Z - e  (g t x = 0 mod g)
        s_g = mul_const_mod(conv_y[..., 1, :], p.big_neg_qinv_g, g)
        # V' mod m2 = (g t conv_x - conv_y) * q^-1
        v_m2 = mul_const_mod(
            sub_mod(mul_const_mod(conv_x_m2, p.big_gt_m2, m2),
                    conv_y[..., 0, :], m2),
            p.big_qinv_m2, m2)
        # V' mod 2**32
        conv_y_m1 = (_mul32(wide(y), p.punct_q_to_m1).sum(dim=-2)) & MASK32
        conv_x_m1 = (_mul32(wide(yx), p.punct_q_to_m1).sum(dim=-2)) & MASK32
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
        decrypts)."""
        p = self.p
        limbs = self.raw_decrypt_residues(keys, ct).cpu().numpy().astype(object)
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
    def _fast_bconv(self, y, punct, to_chain: ModChain):
        """y [..., Lf, N] (already * inv_punct) -> [..., Lt, N] =
        sum_i y_i * |punct_i|_m mod m."""
        terms = mul_const_mod(y[..., :, None, :], punct, to_chain.q[None])
        return mod_sum(terms, to_chain.q, dim=-3)

    def _lift_to_bsk(self, x_q):
        """BEHZ input lift with m_tilde correction: x (base q, [..., k, N])
        -> |x|_q (+ small q-multiple) in base Bsk [..., k+1, N]."""
        p = self.p
        cq, cb = p.chain_q, p.chain_bsk
        mt = p.m_tilde
        xt = mul_const_mod(x_q, p.mtilde_mod_q, cq.q)      # |m_tilde x|_q
        y = mul_const_mod(xt, p.inv_punct_q, cq.q)
        conv = self._fast_bconv(y, p.punct_q_to_bsk, cb)
        # residue mod m_tilde: the low 16 bits of the wrap-around sum
        conv_mt = ((wide(y)[..., :, None, :] * p.punct_q_to_mtilde) % mt).sum(dim=-3) % mt
        r = conv_mt.squeeze(-2) * p.neg_qinv_mtilde % mt
        r_c = torch.where(r >= mt >> 1, r - mt, r)         # centered, small
        corr = mul_const_mod(r_c[..., None, :] % cb.q, p.q_mod_bsk, cb.q)
        return mul_const_mod(add_mod(conv, corr, cb.q), p.mtilde_inv_bsk, cb.q)

    def multiply(self, a, b):
        """BFV ciphertext multiply (BEHZ full-RNS) of two size-2
        ciphertexts -> size-3 ciphertext; relinearize() reduces it."""
        p = self.p
        cq, cb = p.chain_q, p.chain_bsk
        if a.shape[-3] != 2 or b.shape[-3] != 2:
            raise ValueError("multiply takes size-2 ciphertexts")

        def tensor(x, y, ntt, chain):
            xh = ntt.forward(x)
            yh = chain.to_mont(ntt.forward(y))
            x0, x1 = xh[..., 0, :, :], xh[..., 1, :, :]
            y0, y1 = yh[..., 0, :, :], yh[..., 1, :, :]
            c0 = chain.mont_mul(x0, y0)
            c1 = add_mod(chain.mont_mul(x0, y1), chain.mont_mul(x1, y0), chain.q)
            c2 = chain.mont_mul(x1, y1)
            return ntt.inverse(torch.stack([c0, c1, c2], dim=-3))

        c_q = tensor(a, b, p.ntt_q, cq)
        c_bsk = tensor(self._lift_to_bsk(a), self._lift_to_bsk(b), p.ntt_bsk, cb)

        # scale by t/q with the fast floor
        tc_q = mul_const_mod(c_q, p.t_mod_q, cq.q)
        tc_bsk = mul_const_mod(c_bsk, p.t_mod_bsk, cb.q)
        y = mul_const_mod(tc_q, p.inv_punct_q, cq.q)
        u = self._fast_bconv(y, p.punct_q_to_bsk, cb)
        fl = mul_const_mod(sub_mod(tc_bsk, u, cb.q), p.qinv_mod_bsk, cb.q)

        # Shenoy-Kumaresan back-conversion Bsk -> q
        nB = len(p.B_list)
        y_B, y_msk = fl[..., :nB, :], fl[..., nB, :]
        z = mul_const_mod(y_B, p.inv_punct_B, p.chain_B.q)
        conv_q = self._fast_bconv(z, p.punct_B_to_q, cq)
        conv_msk = self._fast_bconv(z, p.punct_B_to_msk, p.msk_chain)
        alpha = mul_const_mod(
            sub_mod(conv_msk, y_msk[..., None, :], p.msk_chain.q),
            p.Binv_mod_msk, p.msk_chain.q,
        )  # [..., 1, N]: small, centered residue mod msk
        alpha_res = torch.where(
            alpha > (p.msk >> 1),
            neg_mod(cq.reduce(p.msk - wide(alpha)), cq.q),
            cq.reduce(alpha),
        )
        return sub_mod(conv_q, mul_const_mod(alpha_res, p.B_mod_q, cq.q), cq.q)

    def square(self, a):
        return self.multiply(a, a)

    # ----------------------------------------------------------- key switch
    def _digit(self, poly, d: int):
        """Digit d = (limb, position) of poly [..., k, N]: base-2^dbc
        digit `position` of that limb's residues, broadcast over the limb
        axis (a digit is a valid residue of every limb: 2^dbc < min q)."""
        p = self.p
        i, j = divmod(d, p.digits_per_limb)
        dig = (poly[..., i, :] >> (p.dbc * j)) & ((1 << p.dbc) - 1)
        return dig[..., None, :].expand(poly.shape)

    def _decompose_digits(self, poly):
        """poly [..., k, N] -> all k*D digits, [k*D, ..., k, N]."""
        p = self.p
        return torch.stack(
            [self._digit(poly, d) for d in range(p.k * p.digits_per_limb)])

    def _switch_key_digits_accumulated(self, poly, keys: SwitchKeys):
        """The digit key switch one digit at a time: the sums of the
        stacked form with one digit's NTT and products live at once."""
        p = self.p
        cq = p.chain_q
        t0 = t1 = None
        for d in range(p.k * p.digits_per_limb):
            dhat = p.ntt_q.forward(self._digit(poly, d))
            m0 = cq.mont_mul(dhat, keys.k0[d])
            m1 = cq.mont_mul(dhat, keys.k1[d])
            t0 = m0 if t0 is None else add_mod(t0, m0, cq.q)
            t1 = m1 if t1 is None else add_mod(t1, m1, cq.q)
        return p.ntt_q.inverse(torch.stack([t0, t1], dim=-3))

    def _switch_key_inner(self, poly, keys: SwitchKeys):
        """Key switch of poly [..., k, N] -> two polys [..., 2, k, N] in
        the coefficient domain, by digits or by RNS groups."""
        p = self.p
        cq = p.chain_q
        if p.ks_hybrid:
            return self._switch_key_inner_hybrid(poly, keys)
        stacked = 4 * p.k * p.digits_per_limb * poly.numel()
        if stacked > self.digit_stack_bytes:
            return self._switch_key_digits_accumulated(poly, keys)
        dhat = p.ntt_q.forward(self._decompose_digits(poly))  # [kD, ..., k, N]
        return p.ntt_q.inverse(self._key_inner_product(dhat, keys, cq))

    @staticmethod
    def _key_inner_product(dhat, keys: SwitchKeys, chain: ModChain):
        """sum_j dhat[j] * (k0[j], k1[j]) over the stacked components
        (digits or groups): [J, ..., L, N] -> [..., 2, L, N], NTT domain."""
        kshape = (keys.k0.shape[0],) + (1,) * (dhat.dim() - 3) + tuple(keys.k0.shape[1:])
        return torch.stack([
            mod_sum(chain.mont_mul(dhat, k.reshape(kshape)), chain.q, dim=0)
            for k in keys
        ], dim=-3)

    def _switch_key_inner_hybrid(self, poly, keys: SwitchKeys):
        """RNS-group key switch: each group of data limbs is extended to
        Q*P, one inner product with the keys runs over the extended chain,
        and with special primes a rounded division by P brings the result
        back to Q.  The groups are stacked, or looped over when the stack
        [omega, ..., kp, N] would pass `group_stack_bytes`: the same sums."""
        p = self.p
        cq, cqp = p.chain_q, p.chain_qp
        kp = len(p.qp_list)
        stacked = 4 * p.ks_omega * (poly.numel() // p.k) * kp
        if stacked > self.group_stack_bytes:
            y = mul_const_mod(poly, p.ks_inv_punct_grp, cq.q)
            t0 = t1 = None
            for gi in range(p.ks_omega):
                dhat = p.ntt_qp.forward(self._group_extend(y, gi))
                m0 = cqp.mont_mul(dhat, keys.k0[gi])
                m1 = cqp.mont_mul(dhat, keys.k1[gi])
                t0 = m0 if t0 is None else add_mod(t0, m0, cqp.q)
                t1 = m1 if t1 is None else add_mod(t1, m1, cqp.q)
            t_hat = torch.stack([t0, t1], dim=-3)
        else:
            dhat = p.ntt_qp.forward(self._group_decompose(poly))  # [omega, ..., kp, N]
            t_hat = self._key_inner_product(dhat, keys, cqp)
        tt = p.ntt_qp.inverse(t_hat)                              # [..., 2, kp, N]
        if p.n_special == 0:
            return tt
        # rounded division by P: (t + P/2 - [(t + P/2) mod P]) / P
        t_q, t_sp = tt[..., : p.k, :], tt[..., p.k :, :]
        csp = p.chain_sp
        z = add_mod(t_sp, p.ks_phalf_sp, csp.q)
        y2 = mul_const_mod(z, p.ks_inv_punct_sp, csp.q)
        conv = self._fast_bconv(y2, p.ks_punct_sp_to_q, cq)
        num = sub_mod(add_mod(t_q, p.ks_phalf_q, cq.q), conv, cq.q)
        return mul_const_mod(num, p.ks_pinv_q, cq.q)

    def _group_extend(self, y, gi: int):
        """Group gi of y [..., k, N] (already * ks_inv_punct_grp) extended
        to the chain Q*P: [..., kp, N]."""
        p = self.p
        i0, i1 = p.ks_groups[gi]
        qp = p.chain_qp.q
        terms = mul_const_mod(y[..., i0:i1, None, :], p.ks_grp_conv[i0:i1], qp[None])
        return mod_sum(terms, qp, dim=-3) if i1 - i0 > 1 else terms[..., 0, :, :]

    def _group_decompose(self, poly):
        """poly [..., k, N] -> per-group base extensions [omega, ..., kp, N]
        (the RNS-group digits of the key switch, coefficient domain)."""
        p = self.p
        y = mul_const_mod(poly, p.ks_inv_punct_grp, p.chain_q.q)
        return torch.stack(
            [self._group_extend(y, gi) for gi in range(p.ks_omega)], dim=0)

    def relinearize(self, ct, keys: KeySet):
        if ct.shape[-3] == 2:
            return ct
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
