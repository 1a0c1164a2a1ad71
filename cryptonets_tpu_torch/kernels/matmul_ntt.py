"""The four-step negacyclic NTT: tables, the binding of the hand-written
Hopper kernels (`matmul_ntt.cu`) and their plain PyTorch versions.

`matmul_ntt_forward` / `matmul_ntt_inverse` are the only entry points.  A
tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, which is built from `matmul_ntt.cu` at first use
(`kernels/build.py`).  A build or launch failure raises: nothing falls
back to the plain version.  `LAUNCHES` counts kernel launches.  A tensor
inside `torch.func.vmap` goes through the operator
`cryptonets_torch::matmul_ntt`, whose vmap rule moves the record axis to
the front: one launch over the rows of every record (`batching.py`).

Replaces `MatmulNTTContext._forward` / `_inverse` and `_exact_modmat` of
`cryptonets_tpu/kernels/matmul_ntt.py`.  With N = N1 * N2 (`split4`), a
row x is twisted by psi^i, reshaped to [N2, N1], multiplied from the left
by Wa = omega^(N1 a b) mod q, scaled by tw = omega^(i1 j2) and multiplied
from the right by Wb = omega^(N2 a b); the inverse runs the inverse
tables backwards and ends with post = psi^-i * N^-1.  The evaluation
ordering is this transform's own, not the bit-reversed order of
`kernels/ntt.py`: keys and NTT-domain gathers made under one do not fit
the other.  Outputs are canonical residues, so kernel, plain version and
reference are bit-equal.  The kernel multiplies u8 digit planes on the
int8 tensor cores; `host_tables` lays out the planes of the four DFT
matrices once per chain, exactly as the kernel keeps them in shared
memory (`dft_planes`).  No PyTorch call is a modular matrix product, so
there is no library counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..crypto.hostmath import modinv
from ..crypto.primes import min_primitive_2n_root
from .batching import LIB, handle, is_batched, lookup, unbatched
from .build import load_library, source
from .modmatmul import swizzle

_SRC = source("matmul_ntt.cu")
MIN_N, MAX_N = 16, 16384  # the kernel's instances: N1, N2 from 4 to 128
PLANES = 4                # 8-bit planes of a residue below 2**31

LAUNCHES = {"matmul_ntt_forward": 0, "matmul_ntt_inverse": 0}


def split4(n: int) -> tuple[int, int]:
    """(N1, N2) with N = N1 * N2, N2 >= N1, both powers of two (the
    reference's `_split4`)."""
    log = n.bit_length() - 1
    l2 = (log + 1) // 2
    return 1 << (log - l2), 1 << l2


@dataclass(frozen=True)
class Geometry:
    """The kernel's tiles for a ring of N = N1 * N2 (`Ring` in
    matmul_ntt.cu): `mt` tiles of 64 rows a (`mp` = 64 mt rows, N2
    padded), `np_` output columns (N1 padded to a wgmma width, at least
    8) in chunks of `nc` (at most 32), `cg` groups of `nch` chunks; a
    block has mt * cg warpgroups.  Plane rows are `row_l` bytes for the
    products over N2 terms and `row_r` over N1 terms (at least 32)."""
    n1: int
    n2: int
    mt: int
    mp: int
    np_: int
    nc: int
    cg: int
    nch: int
    row_l: int
    row_r: int

    @property
    def wg(self) -> int:
        return self.mt * self.cg


def geometry(n: int) -> Geometry:
    N1, N2 = split4(n)
    mt, np_ = max(1, N2 // 64), max(8, N1)
    nc = min(np_, 32)
    cg = min(np_ // nc, 4 // mt)
    return Geometry(N1, N2, mt, 64 * mt, np_, nc, cg, np_ // (nc * cg),
                    max(32, N2), max(32, N1))


def limb_constants(moduli) -> np.ndarray:
    """uint32 [L, 8] a limb: q, then the Shoup pairs (w, floor(w * 2**32 /
    q)) of w = 2**32 mod q and 2**64 mod q, the companion of w = 1, 0, 0
    (the constants of the kernel's exact combine and reductions)."""
    out = np.zeros((len(moduli), 8), np.uint64)
    for i, q in enumerate(moduli):
        c32, c64 = (1 << 32) % q, (1 << 64) % q
        out[i, :6] = (q, c32, (c32 << 32) // q, c64, (c64 << 32) // q,
                      (1 << 32) // q)
    return out.astype(np.uint32)


def dft_planes(w: np.ndarray, rows: int, row: int) -> np.ndarray:
    """Matrices [L, R, K] of residues below 2**32 -> uint8 [L, PLANES,
    rows, row]: per limb the four byte planes, row r holding the K bytes of
    w[r] under the `row`-byte swizzle (the K-major operand tile of the
    kernel's wgmma, rows and bytes past R and K zero)."""
    L, R, K = w.shape
    logical = np.zeros((L, PLANES, rows, row), np.uint8)
    for p in range(PLANES):
        logical[:, p, :R, :K] = (w >> np.uint64(8 * p)) & np.uint64(255)
    out = np.zeros_like(logical)
    phys = swizzle(rows, row)
    out[..., np.broadcast_to(np.arange(rows)[:, None], phys.shape), phys] = logical
    return out


@dataclass(frozen=True)
class MatmulNTTTables:
    """Per-limb tables on one device.  q [L, 1] int32.  pre, tw, twi, post
    [L, N, 2], wa, wai [L, N2, N2, 2], wb, wbi [L, N1, N1, 2] are int32
    pairs of uint32 (w, floor(w * 2**32 / q)) (tw/twi are [N2, N1]
    flattened; the plain versions read the w of the matrices).  The
    kernel's tables fold the twist pre[i] = psi**(N1 b + c) of the forward
    into Wa' = Wa diag(psi**(N1 b)) and tw' = tw psi**c, and the factor
    post[i] = psi**-(N1 a + c) N**-1 of the inverse into Wai' =
    diag(psi**(-N1 a)) Wai and twi' = twi psi**-c N**-1 (i = a N1 + c):
    tw_fold, twi_fold [L, N, 2] pairs; the DFT planes (`dft_planes`) of Wa'
    and Wai', uint8 [L, 4, mp, row_l] (the A operand: rows a, K the
    contraction), and of Wb and Wbi, [L, 4, np_, row_r] (the B operand:
    rows the output columns); limbs int32 [L, 8], `limb_constants`."""

    q: torch.Tensor
    pre: torch.Tensor
    wa: torch.Tensor
    tw: torch.Tensor
    wb: torch.Tensor
    wbi: torch.Tensor
    twi: torch.Tensor
    wai: torch.Tensor
    post: torch.Tensor
    wa_planes: torch.Tensor
    wai_planes: torch.Tensor
    wb_planes: torch.Tensor
    wbi_planes: torch.Tensor
    tw_fold: torch.Tensor
    twi_fold: torch.Tensor
    limbs: torch.Tensor


def _powers(base: int, count: int, q: int) -> np.ndarray:
    out = np.empty(count, np.uint64)
    c = 1
    for i in range(count):
        out[i] = c
        c = c * base % q
    return out


def host_values(n: int, moduli) -> dict:
    """The tables' values as uint32 numpy arrays stacked over the limbs,
    under the reference's names (`_tables`: Wa, Wb, Wai, Wbi, tw, twi,
    pre, post)."""
    N1, N2 = split4(n)
    a2, a1 = np.arange(N2), np.arange(N1)
    ia = (N1 * np.outer(a2, a2)) % n      # Wa: omega^(N1 a b)
    ib = (N2 * np.outer(a1, a1)) % n      # Wb: omega^(N2 a b)
    it = np.outer(a2, a1) % n             # tw: omega^(i1 j2)
    out = {k: [] for k in ("Wa", "Wb", "Wai", "Wbi", "tw", "twi", "pre", "post")}
    for q in moduli:
        q = int(q)
        psi = min_primitive_2n_root(q, n)
        om = psi * psi % q
        pw = _powers(om, n, q)
        pwi = _powers(modinv(om, q), n, q)
        out["Wa"].append(pw[ia])
        out["Wb"].append(pw[ib])
        out["Wai"].append(pwi[ia])
        out["Wbi"].append(pwi[ib])
        out["tw"].append(pw[it])
        out["twi"].append(pwi[it])
        out["pre"].append(_powers(psi, n, q))
        # both factors below 2**31: the product fits uint64
        out["post"].append(
            _powers(modinv(psi, q), n, q) * np.uint64(modinv(n, q)) % np.uint64(q))
    return {k: np.stack(v).astype(np.uint32) for k, v in out.items()}


def host_tables(n: int, moduli) -> MatmulNTTTables:
    """Host tables of one (ring degree, modulus chain) pair."""
    moduli = tuple(int(q) for q in moduli)
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise ValueError(f"ring degree {n} outside [{MIN_N}, {MAX_N}] or not 2^k")
    if any(not 2 < q < 1 << 31 for q in moduli):
        raise ValueError("moduli must be odd primes below 2**31")
    v = {k: w.astype(np.uint64) for k, w in host_values(n, moduli).items()}
    N1, N2 = split4(n)
    L = len(moduli)
    q3 = np.array(moduli, np.uint64).reshape(L, 1, 1)

    def pairs(w, shape):
        sh = (w << np.uint64(32)) // q3.reshape((L,) + (1,) * (w.ndim - 1))
        both = np.stack([w, sh], axis=-1).astype(np.uint32)   # w < 2**31
        return torch.from_numpy(both.view(np.int32).reshape((L,) + shape + (2,)))

    # the kernel's tables, twist and post folded in (see MatmulNTTTables)
    pre, post = v["pre"][:, None, :], v["post"][:, None, :]
    n_q = np.uint64(n) % q3
    wa = v["Wa"] * pre[..., ::N1] % q3                          # psi**(N1 b)
    wai = v["Wai"] * (post[..., ::N1] * n_q % q3).transpose(0, 2, 1) % q3
    tw = v["tw"].reshape(L, N2, N1) * pre[..., :N1] % q3        # psi**c
    twi = v["twi"].reshape(L, N2, N1) * post[..., :N1] % q3     # psi**-c / N
    geo = geometry(n)

    def planes(w, rows, row):
        return torch.from_numpy(dft_planes(w, rows, row))

    return MatmulNTTTables(
        q=torch.from_numpy(np.array(moduli, np.uint32).view(np.int32).reshape(L, 1)),
        pre=pairs(v["pre"], (n,)), wa=pairs(v["Wa"], (N2, N2)),
        tw=pairs(v["tw"], (n,)), wb=pairs(v["Wb"], (N1, N1)),
        wbi=pairs(v["Wbi"], (N1, N1)), twi=pairs(v["twi"], (n,)),
        wai=pairs(v["Wai"], (N2, N2)), post=pairs(v["post"], (n,)),
        wa_planes=planes(wa, geo.mp, geo.row_l),
        wai_planes=planes(wai, geo.mp, geo.row_l),
        # the B operand's rows are output columns, its K the matrix's rows
        wb_planes=planes(v["Wb"].transpose(0, 2, 1), geo.np_, geo.row_r),
        wbi_planes=planes(v["Wbi"].transpose(0, 2, 1), geo.np_, geo.row_r),
        tw_fold=pairs(tw.reshape(L, n), (n,)),
        twi_fold=pairs(twi.reshape(L, n), (n,)),
        limbs=torch.from_numpy(limb_constants(moduli).view(np.int32)),
    )


# ---------------------------------------------------------- plain versions
def _values(t: torch.Tensor) -> torch.Tensor:
    """The w of a table of (w, w') pairs, as int64."""
    return t[..., 0].to(torch.int64)


def _modmat(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact (a @ b) mod q of int64 residues below 2**31, contraction at
    most 2**13 long.  CUDA has no int64 matmul, so both operands are split
    into 16-bit halves and multiplied in float64: every product of halves
    is below 2**32 and a sum of up to 2**13 of them below 2**45, exact in
    float64's 53 bits.  The halves recombine in int64."""
    ah, al = (a >> 16).double(), (a & 0xFFFF).double()
    bh, bl = (b >> 16).double(), (b & 0xFFFF).double()
    hh = torch.matmul(ah, bh).to(torch.int64)
    mid = (torch.matmul(ah, bl) + torch.matmul(al, bh)).to(torch.int64)
    ll = torch.matmul(al, bl).to(torch.int64)
    # (2**32 mod q) * (hh mod q) < 2**62, (mid mod q) * 2**16 < 2**47
    return (hh % q * ((1 << 32) % q) + mid % q * 65536 + ll) % q


def matmul_ntt_forward_plain(x: torch.Tensor, tab: MatmulNTTTables) -> torch.Tensor:
    """Forward transform along the last axis of x [..., L, N] in plain
    PyTorch: the reference of the kernel, and the path of CPU tensors."""
    L, n = x.shape[-2], x.shape[-1]
    N1, N2 = split4(n)
    q = tab.q.to(torch.int64)                              # [L, 1]
    q3 = q.view(L, 1, 1)
    y = x.to(torch.int64) * _values(tab.pre) % q
    y = y.reshape(*x.shape[:-1], N2, N1)
    b = _modmat(_values(tab.wa), y, q3)                    # Wa @ y
    c = b * _values(tab.tw).view(L, N2, N1) % q3
    o = _modmat(c, _values(tab.wb), q3)                    # c @ Wb
    return o.reshape(x.shape).to(torch.int32)


def matmul_ntt_inverse_plain(x: torch.Tensor, tab: MatmulNTTTables) -> torch.Tensor:
    """Inverse of `matmul_ntt_forward_plain`, N^-1 included."""
    L, n = x.shape[-2], x.shape[-1]
    N1, N2 = split4(n)
    q = tab.q.to(torch.int64)
    q3 = q.view(L, 1, 1)
    y = x.to(torch.int64).reshape(*x.shape[:-1], N2, N1)
    d = _modmat(y, _values(tab.wbi), q3)                   # y @ Wbi
    e = d * _values(tab.twi).view(L, N2, N1) % q3
    a = _modmat(_values(tab.wai), e, q3)                   # Wai @ e
    return (a.reshape(x.shape) * _values(tab.post) % q).to(torch.int32)


# ------------------------------------------------------------------ kernel
@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile `matmul_ntt.cu` (once per source content) and load it."""
    lib = load_library(_SRC)
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in (lib.matmul_ntt_forward, lib.matmul_ntt_inverse):
        fn.argtypes = [ptr] * 6 + [ll, i, i, i, ptr]
        fn.restype = i
    lib.matmul_ntt_kernel_info.argtypes = [i, i, ctypes.POINTER(i)]
    lib.matmul_ntt_kernel_info.restype = i
    lib.matmul_ntt_error_string.argtypes = [i]
    lib.matmul_ntt_error_string.restype = ctypes.c_char_p
    return lib


KERNEL_INFO_KEYS = ("registers", "local_bytes", "threads", "shared_bytes",
                    "blocks_per_sm")


def kernel_info(n: int, inverse: bool) -> dict:
    """What the compiler and the current card made of the kernel instance
    of ring n (forward or inverse): registers and local (spilled) bytes a
    thread, threads and dynamic shared bytes of a block, resident blocks
    an SM."""
    lib = build()
    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = lib.matmul_ntt_kernel_info(n.bit_length() - 1, int(inverse), out)
    if err != 0:
        raise RuntimeError("matmul_ntt_kernel_info failed: "
                           f"{lib.matmul_ntt_error_string(err).decode()}")
    return dict(zip(KERNEL_INFO_KEYS, out))


def _check(x: torch.Tensor, tab: MatmulNTTTables) -> tuple[int, int]:
    if x.dim() < 2:
        raise ValueError(f"NTT needs [..., L, N] residues: {tuple(x.shape)}")
    L, n = x.shape[-2], x.shape[-1]
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise ValueError(
            f"NTT needs [..., L, 2^k] with {MIN_N} <= 2^k <= {MAX_N}: {tuple(x.shape)}")
    if tuple(tab.pre.shape) != (L, n, 2):
        raise ValueError(f"tables {tuple(tab.pre.shape)} do not fit {tuple(x.shape)}")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("NTT kernel takes contiguous int32 residues")
    if tab.pre.device != x.device:
        raise ValueError("NTT tables and input lie on different devices")
    return L, n


def _launch(name: str, x: torch.Tensor, tab: MatmulNTTTables, *tables) -> torch.Tensor:
    L, n = _check(x, tab)
    y = torch.empty_like(x)
    rows = x.numel() // n
    if rows == 0:
        return y
    if any(t.data_ptr() % 16 for t in (x, y, tab.limbs) + tables):
        raise ValueError("the NTT kernel needs 16-byte aligned rows and tables")
    N1, N2 = split4(n)
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [x.data_ptr(), y.data_ptr(), tab.limbs.data_ptr()]
    ptrs += [t.data_ptr() for t in tables]
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(*ptrs, rows, L, N1, N2, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.matmul_ntt_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return y


@torch.library.custom_op(f"{LIB}::matmul_ntt", mutates_args=())
def _matmul_ntt_op(x: torch.Tensor, tables: int, inverse: bool) -> torch.Tensor:
    """The four-step NTT of a tensor that is not batched, tables by
    handle."""
    fn = matmul_ntt_inverse if inverse else matmul_ntt_forward
    return fn(x, lookup(tables))


@torch.library.register_vmap(_matmul_ntt_op)
def _matmul_ntt_vmap(info, in_dims, x, tables, inverse):
    """[B, ..., L, N]: the records are more rows of the same launch."""
    unbatched(in_dims, "matmul_ntt")
    if in_dims[0] is None:
        return _matmul_ntt_op(x, tables, inverse), None
    x = x.movedim(in_dims[0], 0).contiguous()
    return _matmul_ntt_op(x, tables, inverse), 0


def matmul_ntt_forward(x: torch.Tensor, tab: MatmulNTTTables) -> torch.Tensor:
    """Forward four-step NTT of int32 residues [..., L, N]: the kernel on
    CUDA, the plain version on the CPU."""
    if is_batched(x):
        return _matmul_ntt_op(x, handle(tab), False)
    if x.device.type == "cpu":
        return matmul_ntt_forward_plain(x, tab)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT for device {x.device}")
    return _launch("matmul_ntt_forward", x, tab, tab.wa_planes, tab.tw_fold,
                   tab.wb_planes)


def matmul_ntt_inverse(x: torch.Tensor, tab: MatmulNTTTables) -> torch.Tensor:
    """Inverse four-step NTT of int32 residues [..., L, N] (see
    `matmul_ntt_forward`)."""
    if is_batched(x):
        return _matmul_ntt_op(x, handle(tab), True)
    if x.device.type == "cpu":
        return matmul_ntt_inverse_plain(x, tab)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT for device {x.device}")
    return _launch("matmul_ntt_inverse", x, tab, tab.wai_planes,
                   tab.twi_fold, tab.wbi_planes)
