"""K6: the modular multiply-accumulate over a stacked axis (`modmac.cu`)
and its plain PyTorch twin.

    out[z, r1, r2, c, l, n] = ( acc_c[z, r1, r2, l, src(n)]
        + sum_j a[j, r1, r2, l, src(n)] * b_c[z, j, r1, l, n] * R^-1 ) mod q_l

with R = 2**32, `b_c` in Montgomery form, one or two of them (the two keys
of a switch read `a` once), `src(n)` the identity or a gather `perm[z, n]`
(an NTT-domain automorphism, int32; an int64 one is narrowed) and `acc_c`
optional.  `mod_mac` is the entry point; `key_inner_product` is its form
for the key switch.  A tensor on the CPU goes to the twin
(`mod_sum(mont_mul(...))` with the gathers and `add_mod`); a CUDA tensor
goes to the kernel, built from `modmac.cu` at first use
(`kernels/build.py`).  A build or launch failure raises: nothing falls
back to the twin.  `LAUNCHES` counts kernel launches.  Operands are
read through their strides (the last one 1), so a caller passes views: the
stacked axis where it lies, keys broadcast by `expand`.  A tensor inside
`torch.func.vmap` goes through the operator `cryptonets_torch::mod_mac`,
whose vmap rule folds the record axis of `a` and `acc` into the rows (no
copy); batched keys or gathers are refused.

`ct_tensor` is the BEHZ multiply's NTT-domain tensor product (`modmac.cu`
`ct_tensor_kernel`, beside K6 and not of its family): c0, c1 and c2 of two
size-2 ciphertexts, or of one's square, in one launch, counted under
`LAUNCHES["ct_tensor"]`; its twin `ct_tensor_plain` is `to_mont`, four
`mont_mul`, an `add_mod` and a `stack` in int64.

Replaces the XLA fusions of the key-switch inner product and the BSGS
multiply-accumulates; see `modmac.cu` for the design and `plan` for the
launch: coefficients and rows a thread, the grid.  No PyTorch call
computes a modular sum of products (`torch.einsum` on int64 would pass
2**63 and has no modulus), so there is no library counterpart.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from types import MappingProxyType
from typing import Optional

import torch

from ..crypto.modular import add_mod, mod_sum, mont_mul
from .batching import LIB, handle, is_batched, lookup
from .build import load_library, source

_SRC = source("modmac.cu")

LAUNCHES = {"mod_mac": 0, "ct_tensor": 0}


# ------------------------------------------------------------ plain twin
def mod_mac_plain(a, b, chain, acc, perm) -> torch.Tensor:
    """The multiply-accumulate in plain PyTorch (int64 arithmetic), on the
    kernel's form: a [J, R1, RA, RB, L, N], each of b [Z, J, R1, L, N],
    acc [Z, R1, RA, RB, L, N] or None, perm [Z, N] -> [Z, R1, RA, RB, C,
    L, N]."""
    if perm is None:
        ag = a[None]                                      # [1, J, R1, RA, RB, L, N]
    else:
        perm = perm.long()
        ag = a[..., perm].movedim(-2, 0)                  # [Z, J, R1, RA, RB, L, N]
    outs = []
    for c, bc in enumerate(b):
        s = mod_sum(mont_mul(ag, bc[:, :, :, None, None], chain.q, chain.r_inv),
                    chain.q, dim=1)                       # [Z, R1, RA, RB, L, N]
        if acc[c] is not None:
            ac = acc[c]
            if perm is not None:     # acc[z, ..., perm[z, n]]
                idx = perm.view(perm.shape[0], *(1,) * (ac.dim() - 2), -1)
                ac = torch.gather(ac, -1, idx.expand(ac.shape))
            s = add_mod(ac, s, chain.q)
        outs.append(s)
    return torch.stack(outs, dim=-3)


# ------------------------------------------------------------------ build
@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile `modmac.cu` (once per source content) and load it."""
    lib = load_library(_SRC)
    lib.mod_mac.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.mod_mac.restype = ctypes.c_int
    lib.mod_mac_param_count.restype = ctypes.c_int
    lib.mod_mac_threads.restype = ctypes.c_int
    lib.mod_mac_kernel_info.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.mod_mac_kernel_info.restype = ctypes.c_int
    lib.ct_tensor.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.ct_tensor.restype = ctypes.c_int
    lib.ct_tensor_kernel_info.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.ct_tensor_kernel_info.restype = ctypes.c_int
    lib.mod_mac_error_string.argtypes = [ctypes.c_int]
    lib.mod_mac_error_string.restype = ctypes.c_char_p
    if (lib.mod_mac_param_count(), lib.mod_mac_threads()) != (_PARAMS, THREADS):
        raise RuntimeError("modmac.cu's parameter block does not match modmac.py")
    return lib


_PARAMS = 50
THREADS = 128            # a block (`kThreads`)
ROWS_MAX = {1: 4, 2: 2}  # rows a thread by outputs (`modmac.cu`'s instances)
MIN_THREADS = 1 << 15    # fewer rows a thread, then fewer coefficients, below this
GRID_YZ = 65535          # the most blocks along grid y and z


@functools.lru_cache(maxsize=None)
def fast_div(d: int) -> tuple[int, int]:
    """(mul, shift) with x // d == (umulhi(x, mul) + x) >> shift for every
    0 <= x < 2**31 (`modmac.cu` `fdiv`)."""
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d) // d + 1, shift)


@functools.lru_cache(maxsize=None)
def plan(Z, R1, RA, RB, L, N, C, vector: bool) -> MappingProxyType:
    """The launch of one call: V coefficients (4 where every 16-byte
    access is aligned, `vector`, else 1) and RT rows rb a thread, THREADS
    threads a block, and the grid x = rbt + RBT ((l << log_tiles) |
    tile), y = z R1 + r1, z = ra, with RBT = ceil(RB / RT) row tiles and
    2**log_tiles coefficient tiles a row.  Where the grid would hold fewer
    than MIN_THREADS threads, RT and then V shrink (a small launch is
    launch latency either way)."""
    V = 4 if vector and N % 4 == 0 else 1
    RT = min(ROWS_MAX[C], 1 << (RB - 1).bit_length())
    while True:
        tiles = max(1, N // (V * THREADS))
        RBT = -(-RB // RT)
        grid = (RBT * L * tiles, Z * R1, RA)
        if grid[0] * grid[1] * grid[2] * THREADS >= MIN_THREADS or (RT == 1 and V == 1):
            break
        if RT > 1:
            RT //= 2
        else:
            V = 1
    if grid[1] > GRID_YZ or grid[2] > GRID_YZ or grid[0] >= 1 << 31:
        raise ValueError(f"mod_mac: too many rows for one launch: grid {grid}")
    return MappingProxyType(dict(V=V, RT=RT, RBT=RBT, log_tiles=tiles.bit_length() - 1,
                                 grid=grid))


def _aligned(ptrs, strides) -> bool:
    """16-byte accesses of 4 elements fall on 16-byte boundaries: every
    address a multiple of 16 and every stride but the last of 4."""
    return (functools.reduce(operator.or_, ptrs, 0) & 15
            | functools.reduce(operator.or_, strides, 0) & 3) == 0


KERNEL_INFO_KEYS = ("registers", "local_bytes", "threads", "shared_bytes",
                    "blocks_per_sm")


def kernel_info(C: int, RT: int, V: int) -> dict:
    """What the compiler and the current card made of the instance with C
    outputs, RT rows and V coefficients a thread: registers and local
    (spilled) bytes a thread, threads and static shared bytes of a block,
    resident blocks an SM."""
    lib = build()
    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = lib.mod_mac_kernel_info(C, RT, V, out)
    if err != 0:
        raise RuntimeError(f"mod_mac_kernel_info failed: "
                           f"{lib.mod_mac_error_string(err).decode()}")
    return dict(zip(KERNEL_INFO_KEYS, out))


# ----------------------------------------------------------------- launch
def check(a, b, chain, acc, perm) -> None:
    """Raise unless the operands fit the kernel's form (see
    `mod_mac_plain`): int32 residues, the last stride 1, N a power of two,
    one chain table row a limb, perm int32 or int64 [Z, N] contiguous."""
    if a.dim() != 6 or not 1 <= len(b) <= 2 or len(acc) != len(b):
        raise ValueError(f"mod_mac needs a [J, R1, RA, RB, L, N] and one or "
                         f"two keys: {tuple(a.shape)}, {len(b)} keys")
    J, R1, RA, RB, L, N = a.shape
    Z = b[0].shape[0]
    if N & (N - 1) or N == 0:
        raise ValueError(f"mod_mac needs N a power of two: {N}")
    if tuple(chain.mont.shape) != (L, 4) or chain.mont.device != a.device:
        raise ValueError(f"the chain's table does not fit {L} limbs on {a.device}")
    for x in (a, *b, *(c for c in acc if c is not None)):
        if x.dtype != torch.int32 or x.stride(-1) != 1 or x.device != a.device:
            raise ValueError("mod_mac takes int32 residues on one device, "
                             "each with its last stride 1")
    for bc in b:
        if tuple(bc.shape) != (Z, J, R1, L, N):
            raise ValueError(f"key {tuple(bc.shape)} does not fit a {tuple(a.shape)}")
    for c in acc:
        if c is not None and tuple(c.shape) != (Z, R1, RA, RB, L, N):
            raise ValueError(f"accumulator {tuple(c.shape)} does not fit "
                             f"a {tuple(a.shape)}")
    if perm is not None and (perm.dtype not in (torch.int32, torch.int64)
                             or not perm.is_contiguous()
                             or tuple(perm.shape) != (Z, N)
                             or perm.device != a.device):
        raise ValueError(f"mod_mac's gather must be int32 or int64 [{Z}, {N}]")


def _operands(a, b, acc, perm):
    """The addresses and the strides but the last of a, the two keys and
    the two accumulators (0 and zeros for an absent one), and the plan
    (`plan`) with 16-byte accesses where the keys, the gather and, without
    a gather, a and acc allow."""
    J, R1, RA, RB, L, N = a.shape
    C = len(b)
    ops = (a, *b, *(None,) * (2 - C), *acc, *(None,) * (2 - C))
    ptrs = [0 if x is None else x.data_ptr() for x in ops]
    sts = [(0,) * (5 if i in (0, 3, 4) else 4) if x is None else x.stride()[:-1]
           for i, x in enumerate(ops)]
    vec = [1, 2] if perm is not None else [0, 1, 2, 3, 4]
    vector = _aligned([ptrs[i] for i in vec] + ([perm.data_ptr()] if perm is not None else []),
                      [s for i in vec for s in sts[i]] + ([N] if perm is not None else []))
    return ptrs, sts, plan(b[0].shape[0], R1, RA, RB, L, N, C, vector)


def plan_of(a, b, acc, perm) -> MappingProxyType:
    """`plan` for these operands (the kernel's form, an int32 gather)."""
    return _operands(a, b, acc, perm)[2]


def _launch(a, b, chain, acc, perm) -> torch.Tensor:
    check(a, b, chain, acc, perm)
    J, R1, RA, RB, L, N = a.shape
    Z, C = b[0].shape[0], len(b)
    out = torch.empty((Z, R1, RA, RB, C, L, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    if perm is not None and perm.dtype != torch.int32:
        perm = perm.to(torch.int32)
    ptrs, sts, pl = _operands(a, b, acc, perm)
    v = [a.device.index, *ptrs[:3], *ptrs[3:], 0 if perm is None else perm.data_ptr(),
         out.data_ptr(), chain.mont.data_ptr(),
         R1, RA, RB, J, L, N.bit_length() - 1, C,
         pl["V"], pl["RT"], pl["log_tiles"], pl["RBT"], *fast_div(pl["RBT"]),
         *fast_div(R1), *pl["grid"], *sts[0], *sts[1], *sts[2], *sts[3], *sts[4]]
    lib = build()
    err = lib.mod_mac((ctypes.c_longlong * _PARAMS)(*v),
                      torch._C._cuda_getCurrentRawStream(a.device.index))
    if err != 0:
        raise RuntimeError(f"mod_mac launch failed: {lib.mod_mac_error_string(err).decode()}")
    LAUNCHES["mod_mac"] += 1
    return out


def _mod_mac6(a, b, chain, acc, perm) -> torch.Tensor:
    """The kernel's form on any device: the kernel on CUDA, the twin on
    the CPU."""
    if a.device.type == "cpu":
        return mod_mac_plain(a, b, chain, acc, perm)
    if a.device.type != "cuda":
        raise ValueError(f"no mod_mac for device {a.device}")
    return _launch(a, b, chain, acc, perm)


@torch.library.custom_op(f"{LIB}::mod_mac", mutates_args=())
def _mac_op(a: torch.Tensor, b0: torch.Tensor, b1: Optional[torch.Tensor],
            acc0: Optional[torch.Tensor], acc1: Optional[torch.Tensor],
            perm: Optional[torch.Tensor], chain: int) -> torch.Tensor:
    """The multiply-accumulate of tensors that are not batched, the chain
    by handle."""
    b = (b0,) if b1 is None else (b0, b1)
    return _mod_mac6(a, b, lookup(chain), (acc0, acc1)[: len(b)], perm)


@torch.library.register_vmap(_mac_op)
def _mac_vmap(info, in_dims, a, b0, b1, acc0, acc1, perm, chain):
    """The records are more rows: a's and acc's record axis joins ra (a
    view where the strides allow, as they do for a record batch's
    stacked tensors); the output's record axis is ra's."""
    a_dim, b0_dim, b1_dim, c0_dim, c1_dim, p_dim, _ = in_dims
    if any(d is not None for d in (b0_dim, b1_dim, p_dim)):
        raise ValueError("mod_mac batches its data and accumulators only, "
                         "not its keys or gathers")
    B = info.batch_size

    def fold(x, d, at):
        """[..., RA, ...] with the records at d -> RA * B rows at `at`."""
        if x is None:
            return None
        x = x.unsqueeze(at).expand(*x.shape[:at], B, *x.shape[at:]) if d is None \
            else x.movedim(d, at)
        return x.flatten(at, at + 1)

    RA = a.shape[2 + (a_dim is not None and a_dim <= 2)]
    out = _mac_op(fold(a, a_dim, 2), b0, b1, fold(acc0, c0_dim, 2),
                  fold(acc1, c1_dim, 2), perm, chain)
    return out.unflatten(2, (B, RA)), 2


def mod_mac(a, b, chain, acc=None, perm=None) -> torch.Tensor:
    """sum_j a[j] * b_c[j] * R^-1 (+ acc_c) mod q for each key b_c.

    a:     int32 [J, R1, R2, L, N] residues (any strides, the last 1).
    b:     one or two int32 [Z, J, R1, L, N] (Montgomery form; `expand` to
           broadcast), a tuple.
    chain: the `ModChain` of the L limbs (`chain.mont`, `chain.q`).
    acc:   None, or a tuple of one entry a key, each None or int32
           [Z, R1, R2, L, N] added to that output (gathered through perm;
           `expand` to share one over z).
    perm:  None, or int32 [Z, N]: out[..., n] reads a[..., perm[z, n]]
           (int64 is narrowed at each call).
    Returns int32 [Z, R1, R2, C, L, N], C = len(b)."""
    b = tuple(b)
    acc = (None,) * len(b) if acc is None else tuple(acc)
    a6 = a.unsqueeze(2)
    acc6 = tuple(None if c is None else c.unsqueeze(2) for c in acc)
    if any(x is not None and is_batched(x) for x in (a, *b, *acc, perm)):
        pad = (None,) * (2 - len(b))
        out = _mac_op(a6, b[0], *(b[1:] + pad), *(acc6 + pad), perm,
                      handle(chain))
    else:
        out = _mod_mac6(a6, b, chain, acc6, perm)
    return out.squeeze(2)


def key_inner_product(dhat, k0, k1, chain, acc=None) -> torch.Tensor:
    """The key switch's inner product over the stacked components (digits
    or groups): dhat [J, ..., L, N] (NTT domain) and keys [J, L, N] ->
    [..., 2, L, N] = sum_j dhat[j] * (k0[j], k1[j]) * R^-1, plus acc
    [..., 2, L, N] when given (the loops over the components)."""
    J, L, N = dhat.shape[0], dhat.shape[-2], dhat.shape[-1]
    lead = dhat.shape[1:-2]
    a = dhat.reshape(J, 1, -1, L, N)
    keys = tuple(k.reshape(1, J, 1, L, N) for k in (k0, k1))
    if acc is not None:
        acc = tuple(acc[..., c, :, :].reshape(1, 1, -1, L, N) for c in (0, 1))
    out = mod_mac(a, keys, chain, acc)                    # [1, 1, R, 2, L, N]
    return out.reshape(*lead, 2, L, N)


# ------------------------------------------------------------- ct_tensor
def ct_tensor_plain(x, y, chain) -> torch.Tensor:
    """The NTT-domain tensor product in plain PyTorch: x, y [..., 2, L, N]
    (y None: x's square) -> [..., 3, L, N] = (x0 y0, x0 y1 + x1 y0, x1 y1)
    mod each limb of `chain`."""
    yh = chain.to_mont(x if y is None else y)
    x0, x1 = x[..., 0, :, :], x[..., 1, :, :]
    y0, y1 = yh[..., 0, :, :], yh[..., 1, :, :]
    c0 = chain.mont_mul(x0, y0)
    c1 = add_mod(chain.mont_mul(x0, y1), chain.mont_mul(x1, y0), chain.q)
    c2 = chain.mont_mul(x1, y1)
    return torch.stack([c0, c1, c2], dim=-3)


@functools.lru_cache(maxsize=None)
def tensor_plan(R, L, N, vector: bool) -> MappingProxyType:
    """The launch of one tensor product over R rows of L limbs: V = 4
    coefficients a thread where the 16-byte accesses are aligned
    (`vector`), THREADS threads a block, the grid x = (r << log_tiles) |
    tile, y = the limb; V falls to 1 below MIN_THREADS threads."""
    V = 4 if vector and N % 4 == 0 else 1
    while True:
        tiles = max(1, N // (V * THREADS))
        if R * L * tiles * THREADS >= MIN_THREADS or V == 1:
            break
        V = 1
    grid = (R * tiles, L, 1)
    if grid[1] > GRID_YZ or grid[0] >= 1 << 31:
        raise ValueError(f"ct_tensor: too many rows for one launch: grid {grid}")
    return MappingProxyType(dict(V=V, log_tiles=tiles.bit_length() - 1, grid=grid))


def tensor_kernel_info(square: bool, V: int) -> dict:
    """`kernel_info` of the tensor kernel's instance."""
    lib = build()
    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = lib.ct_tensor_kernel_info(int(square), V, out)
    if err != 0:
        raise RuntimeError(f"ct_tensor_kernel_info failed: "
                           f"{lib.mod_mac_error_string(err).decode()}")
    return dict(zip(KERNEL_INFO_KEYS, out))


def tensor_check(x, y, chain) -> None:
    """Raise unless x (and y) are int32 [..., 2, L, N] alike, N a power of
    two, on the chain's device with one table row a limb."""
    N, L = x.shape[-1], x.shape[-2]
    if x.dim() < 3 or x.shape[-3] != 2 or N & (N - 1) or N == 0:
        raise ValueError(f"ct_tensor takes [..., 2, L, N], N a power of two: "
                         f"{tuple(x.shape)}")
    for t in (x,) if y is None else (x, y):
        if t.dtype != torch.int32 or t.device != x.device or t.shape != x.shape:
            raise ValueError("ct_tensor takes int32 ciphertexts of one shape "
                             "on one device")
    if tuple(chain.mont.shape) != (L, 4) or chain.mont.device != x.device:
        raise ValueError(f"the chain's table does not fit {L} limbs on {x.device}")


def _launch_tensor(x, y, chain) -> torch.Tensor:
    tensor_check(x, y, chain)
    x = x.contiguous()
    y = None if y is None else y.contiguous()
    L, N = x.shape[-2:]
    out = torch.empty((*x.shape[:-3], 3, L, N), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    R = x.numel() // (2 * L * N)
    ptrs = [x.data_ptr(), 0 if y is None else y.data_ptr(), out.data_ptr()]
    pl = tensor_plan(R, L, N, _aligned(ptrs, ()))
    v = [*ptrs, chain.mont.data_ptr(), L, N.bit_length() - 1, pl["V"],
         pl["log_tiles"], pl["grid"][0], pl["grid"][1], x.device.index]
    lib = build()
    err = lib.ct_tensor((ctypes.c_longlong * len(v))(*v),
                        torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"ct_tensor launch failed: {lib.mod_mac_error_string(err).decode()}")
    LAUNCHES["ct_tensor"] += 1
    return out


def _ct_tensor3(x, y, chain) -> torch.Tensor:
    """The tensor product of tensors that are not batched: the kernel on
    CUDA, the twin on the CPU."""
    if x.device.type == "cpu":
        return ct_tensor_plain(x, y, chain)
    if x.device.type != "cuda":
        raise ValueError(f"no ct_tensor for device {x.device}")
    return _launch_tensor(x, y, chain)


@torch.library.custom_op(f"{LIB}::ct_tensor", mutates_args=())
def _tensor_op(x: torch.Tensor, y: Optional[torch.Tensor], chain: int) -> torch.Tensor:
    """The tensor product of tensors that are not batched, the chain by
    handle."""
    return _ct_tensor3(x, y, lookup(chain))


@torch.library.register_vmap(_tensor_op)
def _tensor_vmap(info, in_dims, x, y, chain):
    """The records are more rows; an operand without them is broadcast."""
    x_dim, y_dim, _ = in_dims
    B = info.batch_size

    def rows(t, d):
        if t is None:
            return None
        return t.expand(B, *t.shape) if d is None else t.movedim(d, 0)

    return _tensor_op(rows(x, x_dim), rows(y, y_dim), chain), 0


def ct_tensor(x, y, chain) -> torch.Tensor:
    """The BEHZ multiply's NTT-domain tensor product: x, y int32 [..., 2,
    L, N] (y None: x's square, from one read; leading axes broadcast, the
    kernel reading them expanded) -> [..., 3, L, N] = (x0 y0, x0 y1 + x1
    y0, x1 y1) mod each limb of `chain`: one launch on CUDA, the twin on
    the CPU."""
    if y is not None and y.shape != x.shape:
        shape = torch.broadcast_shapes(x.shape, y.shape)
        x, y = x.expand(shape), y.expand(shape)
    if is_batched(x) or (y is not None and is_batched(y)):
        return _tensor_op(x, y, handle(chain))
    return _ct_tensor3(x, y, chain)
