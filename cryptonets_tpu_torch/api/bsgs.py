"""Baby-step/giant-step diagonal matvec for dense layers (port of
`cryptonets_tpu/api/bsgs.py`: hoisted babies, sparse diagonal support).

Slot (r, c) has row r in {0, 1} and column c in [0, n/2).  Grouping the
entries W[i, j] by column displacement d = (c_j - c_i) mod (n/2) and row
flip f = r_i ^ r_j, with d = g*a + b (baby b < g, giant a < G = (n/2)/g)
and the diagonals pre-rotated by -g*a on the host:

    y = sum_a rot_{g*a}( sum_{b,f} diag'[a, b, f] * rot_b(u_f) )

Where `hoist_eligible` holds, the babies rot_b(u) are HOISTED: the input
is decomposed and NTT'd once, then every baby is an NTT-domain gather
(`ntt_automorphism_perm`) plus one switch-key inner product, with no
further NTT.  Otherwise (special primes, the four-step NTT, missing
per-step keys) they are CHAINED: g - 1 single-step rotations, then one
forward NTT of all babies.  The giant sum is a Horner chain: over the
giant indices whose diagonals are not all zero when they are few (sparse
support), else over every giant index, zero chunks included (dense
support).  The diagonal plaintexts are encoded on the device per record,
one giant chunk at a time, from a slot table that stays on the host (or
is made resident for a CUDA graph): two launches of the NTT kernels' lift
load (`kernels/ntt.cu`), the Z_t inverse NTT of every plain prime from
the signed table, then NTT_q of the coefficients broadcast over the limbs
in Montgomery form, with no copy or elementwise pass between them.

Counts (`utils/opcount.OPS`, beside the reference's `rotation`): the
diagonal plaintext forms encoded, P x g x F a giant chunk
(`bsgs_diagonal_form`), and the baby steps by how they ran, F x (g - 1)
a layer (`baby_rotation_hoisted`, `baby_rotation_chained`).  Device
ranges (`utils/trace.py`) inside the layer's own: `babies` (the F = 2
column rotation and the baby stack) and `giants` (the giant loop: the
diagonals' encode, K6, the giant rotations), kinds outside
`trace.KINDS`, so they are not summed twice with the layer's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.modular import add_mod
from ..crypto.ntt import NTTContext
from ..kernels.modmac import mod_mac
from ..utils import trace
from ..utils.opcount import OPS

BABY_CHUNK = 16  # babies a K6 launch (bounds the twin's int64 temporaries)


def _choose_g(row: int, F: int, cap: int = 256) -> int:
    """Power-of-two baby count minimising F*(g-1) + (row/g - 1), the
    rotations of a chained BSGS; the smallest g on a tie."""
    best_g, best_cost = 1, None
    g = 1
    while g <= min(row, cap):
        cost = F * (g - 1) + (row // g - 1)
        if best_cost is None or cost < best_cost:
            best_g, best_cost = g, cost
        g *= 2
    return best_g


class BsgsDenseForm:
    """Host preparation of W [R, D]: the diagonal slot-value table
    [G, g, F, n] (index-mapped for the encoder) and its non-zero giant
    indices.  The table stays on the host (pinned when the factory is on
    CUDA): `chunk(a)` copies one giant chunk to the device at its turn.
    `g` None takes `_choose_g`."""

    def __init__(self, factory, w_int: np.ndarray, out_dim: int,
                 in_dim: int, g: int | None = None):
        n = factory.n
        row = n // 2
        R, D = int(out_dim), int(in_dim)
        if not (R <= n and D <= n and w_int.shape == (R, D)):
            raise ValueError(f"BSGS form shape {w_int.shape} vs ({R}, {D}), n={n}")
        w_int = np.asarray(w_int, dtype=np.int64)
        # _encode_diag_chunk adds t once to negatives (no general mod-t
        # reduction): every |weight| must sit below the smallest plain prime
        t_min = min(factory.plain_primes)
        if np.abs(w_int).max(initial=0) >= t_min:
            raise ValueError(f"BSGS weight magnitude >= smallest plain prime {t_min}")
        # the diagonals are encoded on the device, one residue for every
        # limb: that needs every plain prime below 2**31 and every limb
        if not factory.encodes_on_device:
            raise ValueError(
                "BSGS dense matvec needs device-side encoding (every plain "
                "prime below 2**31 and below every limb); use the per-row path")
        self.factory = factory
        self.out_dim, self.in_dim = R, D
        F = 2 if (R > row or D > row) else 1
        if g is None:
            g = _choose_g(row, F)
        if g & (g - 1) or not 1 <= g <= row:
            raise ValueError(f"baby count {g} must be a power of two <= n/2")
        G = row // g
        self.F, self.g, self.G = F, g, G

        # diag[f][r][c', d] = W[r*row + c', (r^f)*row + (c' + d) % row]:
        # block (r, r^f) of W with row c' rotated left by c'
        Wfull = np.zeros((n, n), np.int32)  # |w| < t_min < 2**31
        Wfull[:R, :D] = w_int
        diag = [[None, None] for _ in range(F)]
        for f in range(F):
            for r in range(2):
                blk = Wfull[r * row:(r + 1) * row,
                            (r ^ f) * row:((r ^ f) + 1) * row]
                dg = np.empty((row, row), np.int32)
                for cc in range(row):
                    dg[cc] = np.roll(blk[cc], -cc)
                diag[f][r] = dg
        del Wfull
        # the encoder's slot order: buffer position p holds slot inv[p]
        inv = torch.from_numpy(np.argsort(factory.encoders[0].index_map))
        table = torch.zeros((G, g, F, n), dtype=torch.int32)
        active = []
        for a in range(G):
            # chunk[b, f, r*row + c] = diag[f][r][(c - g*a) % row, g*a + b]
            chunk = np.empty((g, F, n), np.int32)
            for f in range(F):
                for r in range(2):
                    cols = diag[f][r][:, g * a : g * a + g]
                    chunk[:, f, r * row:(r + 1) * row] = np.roll(cols, g * a, axis=0).T
            if chunk.any():
                active.append(a)
                torch.index_select(torch.from_numpy(chunk), 2, inv, out=table[a])
        self._host = table.pin_memory() if factory.device.type == "cuda" else table
        self.table = self._host.numpy()
        self.active = active  # ascending
        self._device_table = None

    def make_resident(self) -> None:
        """Keep the whole table on the device, so that `chunk` copies
        nothing from the host: what a CUDA graph of the record needs (a
        copy from the host cannot be captured).  Costs the table's bytes
        of device memory (G g F n int32) for the form's life."""
        if self._device_table is None:
            self._device_table = self._host.to(self.factory.device)

    def chunk(self, a: int) -> torch.Tensor:
        """Giant chunk a [g, F, n] on the factory's device."""
        if self._device_table is not None:
            return self._device_table[a]
        if self.factory.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a BSGS table copy cannot be captured in a CUDA "
                               "graph: make the form resident first")
        return self._host[a].to(self.factory.device, non_blocking=True)


def _encode_diag_chunk(fac, tbl_a):
    """Device encode: [g, F, n] int32 index-mapped slot values (|v| below
    every plain prime) -> plaintext mult forms [P, g, F, k, N].  The Z_t
    inverse NTT of every prime reads the signed table once a prime and
    adds t to a negative value as it loads it (`inverse_lift`: [P, g F,
    n]); the butterfly NTT_q reads each coefficient row once for every
    limb, since t < every q, and scales it by R mod q as it loads it
    (`forward_lift`: Montgomery form).  The four-step NTT has no lift
    load: its coefficients are broadcast, transformed and scaled apart."""
    g, F, n = tbl_a.shape
    k = len(fac.limb_moduli)
    bfv0 = fac.bfv[0]
    coeffs = fac._plain_ntt.inverse_lift(tbl_a.reshape(g * F, n))  # mod t_p
    if isinstance(bfv0.p.ntt_q, NTTContext):
        forms = bfv0.p.ntt_q.forward_lift(coeffs.reshape(fac.P * g * F, n))
    else:
        forms = bfv0.prepare_plain_mult(coeffs[:, :, None].expand(fac.P, g * F, k, n))
    return forms.reshape(fac.P, g, F, k, n)


def hoist_eligible(fac, g: int) -> bool:
    """True when the baby steps can be hoisted: every step 1..g-1 has its
    own Galois key (the factory's rot_steps), the switched result stays
    in the NTT domain (digit switching, or RNS groups without special
    primes, hence no mod-down), and the NTT has the bit-reversed ordering
    that `ntt_automorphism_perm` encodes (the four-step NTT has its
    own)."""
    bfv0 = fac.bfv[0]
    p = bfv0.p
    return (
        g > 1
        and p.n_special == 0
        and p.ntt_q.ordering == "bit-reversed"
        and all(bfv0.galois_elt_rows(b) in fac.keys.galois
                for b in range(1, g))
    )


def _hoisted_babies_hat(fac, ub, g):
    """All baby rotations of ub [P, F, 2, k, N] in the NTT domain:
    one decomposition of c1 + NTT (base-2^dbc digits, or RNS groups
    extended to Q*P with kp = k), then per baby a gather by the
    automorphism permutation and the switch-key inner product over the J
    components, in one K6 launch a chunk of babies (`mod_mac` with the
    gather: dhat is read in place, never gathered into a tensor).
    Returns bab_hat [P, g, F, 2, k, N]."""
    bfv0 = fac.bfv[0]
    p = bfv0.p
    c0, c1 = ub[..., 0, :, :], ub[..., 1, :, :]           # [P, F, k, N]
    c0_hat = p.ntt_q.forward(c0)
    c1_hat = p.ntt_q.forward(c1)
    c1_all = bfv0.gather_limbs(c1)      # every limb: one gather on a limb mesh
    if p.ks_hybrid:
        dhat = p.ntt_qp.forward(bfv0._group_decompose(c1_all))  # [omega, P, F, kp, N]
    else:
        dhat = p.ntt_q.forward(bfv0._decompose_digits(c1_all))  # [kD, P, F, k, N]
    perms, k0s, k1s = fac.stacked_baby_rotations(g)       # keys [g-1, J, k, N]
    J, P, F, L, N = dhat.shape
    OPS.count("baby_rotation_hoisted", F * (g - 1))
    a = dhat.reshape(J, 1, P * F, L, N)
    c0 = c0_hat.reshape(1, 1, P * F, L, N)
    rots = []
    for b0 in range(0, g - 1, BABY_CHUNK):
        perm = perms[b0 : b0 + BABY_CHUNK]                # [B, N]
        keys = tuple(k[b0 : b0 + BABY_CHUNK, :, None] for k in (k0s, k1s))
        acc = (c0.expand(perm.shape[0], -1, -1, -1, -1), None)
        out = mod_mac(a, keys, p.chain_q, acc, perm)      # [B, 1, P F, 2, k, N]
        rots.append(out.reshape(perm.shape[0], P, F, 2, L, N))
    base = torch.stack([c0_hat, c1_hat], dim=-3)[None]
    return torch.cat([base, *rots], dim=0).movedim(0, 1)  # [P, g, F, 2, k, N]


def _chained_babies_hat(fac, ub, g):
    """The baby rotations of ub [P, F, 2, k, N] as a chain of g - 1
    single-step rotations, then one forward NTT of all of them:
    bab_hat [P, g, F, 2, k, N]."""
    bfv0 = fac.bfv[0]
    OPS.count("baby_rotation_chained", ub.shape[1] * (g - 1))
    babies, cur = [ub], ub
    for _ in range(1, g):
        cur = bfv0.rotate_rows(cur, 1, fac.keys)
        babies.append(cur)
    return bfv0.p.ntt_q.forward(torch.stack(babies, dim=1))


def bsgs_matvec(form: BsgsDenseForm, data):
    """Apply the prepared form to ciphertext data [P, 1, 2, k, N] ->
    [P, 1, 2, k, N], y[i] in flat slot i: the babies, then the giant
    loop, each in its device range."""
    fac = form.factory
    bfv0 = fac.bfv[0]
    p = bfv0.p
    q = p.chain_q.q
    keys = fac.keys
    g, G, F = form.g, form.G, form.F
    if not form.active:
        raise ValueError("BSGS form has no nonzero diagonals")

    u = data[:, 0]                                        # [P, 2, k, N]
    with trace.device_range("babies", "babies"):
        if F == 2:
            OPS.count("rotation", 1)
            ub = torch.stack([u, bfv0.rotate_columns(u, keys)], dim=1)
        else:
            ub = u[:, None]
        # g - 1 baby rotations either way (the reference's scanned chain
        # for g > 8 runs and counts g, the last one discarded)
        OPS.count("rotation", F * (g - 1))
        if hoist_eligible(fac, g):
            bab_hat = _hoisted_babies_hat(fac, ub, g)     # [P, g, F, 2, k, N]
        else:
            bab_hat = _chained_babies_hat(fac, ub, g)

    def chunk_acc(a):
        """Giant chunk a -> coefficient-domain acc [P, 2, k, N]: the sum
        over the g F babies of bab_hat times the chunk's diagonal forms,
        K6 over the g babies where they lie in bab_hat (one launch a flip
        f, the second accumulating onto the first)."""
        forms = _encode_diag_chunk(fac, form.chunk(a))    # [P, g, F, k, N]
        OPS.count("bsgs_diagonal_form", fac.P * g * F)
        acc_hat = None
        for f in range(F):
            x = bab_hat[:, :, f].transpose(0, 1)              # [g, P, 2, k, N]
            w = forms[:, :, f].transpose(0, 1)[None]          # [1, g, P, k, N]
            acc_hat = mod_mac(x, (w,), p.chain_q,
                              None if acc_hat is None else (acc_hat[None],))[0, :, :, 0]
        return p.ntt_q.inverse(acc_hat)

    with trace.device_range("giants", "giants"):
        if len(form.active) > max(4, G // 4):
            # dense support: every giant step, zero chunks included, from
            # a zero accumulator (G key switches, the first of a zero
            # ciphertext)
            OPS.count("plain_multiplication", g * F * G)
            OPS.count("rotation", G)
            z = torch.zeros_like(u)
            for a in reversed(range(G)):
                z = add_mod(bfv0.rotate_rows(z, g, keys), chunk_acc(a), q)
            return z[:, None]
        # sparse support: Horner over the non-zero giant chunks, last
        # first (counted as the reference counts it: a rotation a chunk)
        OPS.count("plain_multiplication", g * F * len(form.active))
        OPS.count("rotation", len(form.active))
        z, prev = None, None
        for a in reversed(form.active):
            acc = chunk_acc(a)
            if z is None:
                z = acc
            else:
                z = add_mod(bfv0.rotate_rows(z, g * (prev - a), keys), acc, q)
            prev = a
        if prev:
            z = bfv0.rotate_rows(z, g * prev, keys)
        return z[:, None]
