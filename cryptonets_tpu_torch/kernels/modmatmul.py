"""Exact modular contraction: out[m] = sum_o W[m, o] * x[o] mod q.

The conv of `LLPoolLayer` and the dense layers of `PoolLayer` contract
ciphertext columns against an integer weight matrix.  `exact_mod_contract`
is the only entry point.  A tensor on the CPU goes to the plain version;
a CUDA tensor goes to the hand-written kernel of `modmatmul.cu`, built at
first use (`kernels/build.py`).  A build or launch failure raises: nothing
falls back to the plain version.  `LAUNCHES` counts kernel launches.  A
tensor inside `torch.func.vmap` goes through the operator
`cryptonets_torch::mod_contract`, whose vmap rule folds the records into
the column axis C: [P, O, B*C, s, k, N], one launch (`batching.py`).

Replaces `exact_mod_contract` of `cryptonets_tpu/kernels/modmatmul.py`.
The kernel runs on the int8 tensor cores: both operands split into four
8-bit planes, the 16 plane-pair products are summed exactly in s32 by
shift group s = i + j over chunks of `kc` values of o, and each group sum
is folded into a canonical accumulator by a Shoup product with
2**(8s) mod q.  The result is canonical, hence bit-equal to the plain
version and to the reference.  `prepare_contract` makes the weights'
side once per layer: the reduced weights, the planes in the layout and
swizzle the kernel keeps in shared memory, and the fold constants.  No
PyTorch call computes an integer matrix product mod q on CUDA (no int64
`matmul` there, `torch._int_mm` takes int8 only), so there is no library
counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..crypto.modular import RES, wide
from .batching import LIB, handle, is_batched, lookup, unbatched
from .build import load_library, source

_SRC = source("modmatmul.cu")

PLANES = 4          # 8-bit planes of a residue below 2**31
GROUPS = 2 * PLANES - 1   # shift groups s = i + j of the plane pairs
KC_MAX = 128        # values of o a chunk
WIDTHS = (8, 16, 32, 64, 112)   # the kernel's tiles of outputs (wgmma N)
TILE = 64           # positions of a block (wgmma M); N >= TILE
MAX_PAIRS = PLANES  # plane pairs in the largest shift group
# the longest chunk whose group sums stay exact in s32: every pair of
# planes is at most 255 * 255 a term, four pairs in the largest group
KF_MAX = (2**31 - 1) // (MAX_PAIRS * 255 * 255)

LAUNCHES = {"mod_contract": 0}


def reduce_weights(w_int, q_list) -> np.ndarray:
    """Integer weights [M, O] of any sign and size -> int64 [M, O, k]
    residues in [0, q_l).  Fixed-width integer arrays are reduced by
    numpy (exact: the remainder of an int64 by a positive q is in range);
    anything else (object arrays, nested lists of Python ints) one Python
    int at a time, so magnitudes past 2**63 stay exact."""
    w = np.asarray(w_int)
    if w.ndim != 2:
        raise ValueError(f"weights must be [M, O]: {w.shape}")
    if w.dtype.kind in "iu" and w.dtype.itemsize <= 8 and w.dtype != np.uint64:
        w64 = w.astype(np.int64)
        return np.stack([np.mod(w64, int(q)) for q in q_list], axis=-1)
    return np.array(
        [[[int(v) % int(q) for q in q_list] for v in row] for row in w],
        dtype=np.int64,
    ).reshape(w.shape + (len(q_list),))


# ------------------------------------------------------- prepared weights
def tiling(M: int, O: int) -> tuple[int, int, int, int]:
    """(nw, mt, kc, chunks): M padded to mt tiles of nw outputs (nw one of
    WIDTHS, the least that covers M / mt), and O cut into chunks of kc
    values (a multiple of 32, at most KC_MAX)."""
    mt = -(-M // WIDTHS[-1])
    nw = min(w for w in WIDTHS if w * mt >= M)
    kc = min(KC_MAX, 32 * -(-O // 32))
    return nw, mt, kc, -(-O // kc)


def row_bytes(kc: int) -> int:
    """Bytes of a plane row in shared memory: 32 for chunks of 32 values
    of o, else 128 (a chunk of 64 or 96 leaves the rest of the row zero)."""
    return 32 if kc == 32 else KC_MAX


def swizzle(rows: int, row: int) -> np.ndarray:
    """[rows, row] byte offset within a row of `row` bytes (128 or 32) of
    logical byte kb of row r, under the 128- or 32-byte swizzle: the
    16-byte chunk kb // 16 moves to (kb // 16) ^ ((r // (128 // row)) %
    (row // 16))."""
    r = np.arange(rows)[:, None]
    kb = np.arange(row)[None, :]
    return ((((kb >> 4) ^ (r // (128 // row))) % (row // 16)) << 4) | (kb & 15)


def weight_planes(wq: np.ndarray, nw: int, mt: int, kc: int,
                  chunks: int) -> np.ndarray:
    """Reduced weights [k, M, O] -> uint8 [k, mt, chunks, PLANES, nw, row]:
    per limb, output tile and chunk of o, the four byte planes W_i[m, o]
    with o contiguous, zero past M and O, swizzled as in shared memory."""
    k, M, O = wq.shape
    rows = nw
    pad = np.zeros((k, mt * rows, chunks * kc), np.int64)
    pad[:, :M, :O] = wq
    b = (pad[None] >> (8 * np.arange(PLANES)).reshape(-1, 1, 1, 1)) & 255
    b = b.reshape(PLANES, k, mt, rows, chunks, kc).transpose(1, 2, 4, 0, 3, 5)
    logical = np.zeros(b.shape[:-1] + (row_bytes(kc),), np.uint8)
    logical[..., :kc] = b
    out = np.zeros_like(logical)
    phys = swizzle(rows, row_bytes(kc))
    out[..., np.broadcast_to(np.arange(rows)[:, None], phys.shape), phys] = logical
    return out


def fold_constants(q_list) -> np.ndarray:
    """uint32 [k, GROUPS, 2]: 2**(8s) mod q and its Shoup companion
    floor(c * 2**32 / q), per limb and shift group."""
    return np.array([[[c, (c << 32) // int(q)]
                      for c in (pow(2, 8 * s, int(q)) for s in range(GROUPS))]
                     for q in q_list], np.uint64).astype(np.uint32)


@dataclass(frozen=True)
class ContractWeights:
    """The weights' side of the contraction, made once per layer and
    device by `prepare_contract`."""
    M: int
    O: int
    q: tuple
    nw: int
    mt: int
    kc: int
    chunks: int
    reduced: torch.Tensor   # int64 [M, O, k], residues in [0, q_l)
    planes: torch.Tensor    # uint8 [k, mt, chunks, PLANES, nw, row_bytes(kc)]
    fold: torch.Tensor      # int32 [k, GROUPS, 2] (uint32 bits)
    mods: torch.Tensor      # int32 [k]


def _i32(a: np.ndarray, device) -> torch.Tensor:
    """Values below 2**32 -> int32 tensor with those bits."""
    return torch.from_numpy(
        np.ascontiguousarray(a).astype(np.uint32).view(np.int32)).to(device)


def prepare_contract(w_int, q_list, device) -> ContractWeights:
    """Reduce integer weights [M, O] per limb and lay out their planes and
    the fold constants on `device`, for every later contraction with
    them."""
    red = reduce_weights(w_int, q_list)               # [M, O, k]
    M, O, _ = red.shape
    if M == 0 or O == 0:
        raise ValueError(f"empty weights [{M}, {O}]")
    if any(not 0 < int(q) < 1 << 31 for q in q_list):
        raise ValueError("the contraction needs moduli below 2**31")
    nw, mt, kc, chunks = tiling(M, O)
    planes = weight_planes(red.transpose(2, 0, 1), nw, mt, kc, chunks)
    return ContractWeights(
        M=M, O=O, q=tuple(int(q) for q in q_list), nw=nw, mt=mt, kc=kc,
        chunks=chunks, reduced=torch.from_numpy(red).to(device),
        planes=torch.from_numpy(planes).to(device),
        fold=_i32(fold_constants(q_list), device),
        mods=_i32(np.array([int(q) for q in q_list]), device))


class ContractCache:
    """A layer's prepared weights, remade only for another factory or
    device: `get(factory, device, weights)` calls `weights()` for the
    integer matrix and `prepare_contract` on a miss."""

    def __init__(self):
        self._entry = None

    def get(self, factory, device, weights) -> ContractWeights:
        e = self._entry
        if e is None or e[0] is not factory or e[1] != device:
            e = self._entry = (factory, device, prepare_contract(
                weights(), factory.limb_moduli, device))
        return e[2]


# ------------------------------------------------------------ plain version
def exact_mod_contract_plain(w, x, q_list, q_col):
    """The contraction in plain PyTorch (int64 arithmetic): the reference
    of the kernel, and the path of CPU tensors.  `w` is raw integer
    weights or a `ContractWeights`."""
    M, O = _check(w, x, q_list)
    if isinstance(w, ContractWeights):
        wq = w.reduced.to(x.device)
    else:
        wq = torch.from_numpy(reduce_weights(w, q_list)).to(x.device)
    acc = None
    for o in range(O):
        wo = wq[:, o].view(1, M, 1, 1, len(q_list), 1)
        term = wide(x[:, o, None]) * wo % q_col           # [P, M, C, s, k, N]
        acc = term if acc is None else acc + term
    return (acc % q_col).to(RES)


# ------------------------------------------------------------------- kernel
@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile `modmatmul.cu` (once per source content) and load it."""
    lib = load_library(_SRC)
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mod_contract.argtypes = [ptr] * 5 + [i, i, i, ll] + [i] * 6 + [ptr]
    lib.mod_contract.restype = i
    lib.mod_contract_kernel_info.argtypes = [i, i, ctypes.POINTER(i)]
    lib.mod_contract_kernel_info.restype = i
    lib.mod_contract_error_string.argtypes = [i]
    lib.mod_contract_error_string.restype = ctypes.c_char_p
    return lib


KERNEL_INFO_KEYS = ("registers", "local_bytes", "threads", "shared_bytes",
                    "blocks_per_sm")


def kernel_info(nw: int, kc: int) -> dict:
    """What the compiler and the current card made of the kernel instance
    with tiles of nw outputs and chunks of kc: registers and local
    (spilled) bytes a thread, threads and dynamic shared bytes of a block,
    resident blocks an SM."""
    lib = build()
    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = lib.mod_contract_kernel_info(nw, row_bytes(kc), out)
    if err != 0:
        raise RuntimeError("mod_contract_kernel_info failed: "
                           f"{lib.mod_contract_error_string(err).decode()}")
    return dict(zip(KERNEL_INFO_KEYS, out))


def _check(w, x, q_list) -> tuple[int, int]:
    if x.dim() != 6 or x.shape[-2] != len(q_list):
        raise ValueError(
            f"contraction needs [P, O, C, s, k, N] residues with "
            f"k = {len(q_list)}: {tuple(x.shape)}")
    if isinstance(w, ContractWeights):
        if w.q != tuple(int(q) for q in q_list):
            raise ValueError("prepared weights were made for other moduli")
        M, O = w.M, w.O
    else:
        M, O = len(w), len(w[0]) if len(w) else 0
    if M == 0 or O != x.shape[1]:
        raise ValueError(f"weights [{M}, {O}] do not fit {tuple(x.shape)}")
    return M, O


def _launch(w, x, q_list) -> torch.Tensor:
    M, O = _check(w, x, q_list)
    P, k, N = x.shape[0], x.shape[-2], x.shape[-1]
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("the contraction kernel takes contiguous int32 residues")
    if N & (N - 1) or N < TILE:
        raise ValueError(f"the kernel needs N a power of two >= {TILE}: {N}")
    if not isinstance(w, ContractWeights):
        w = prepare_contract(w, q_list, x.device)
    if w.planes.device != x.device:
        raise ValueError("prepared weights and input lie on different devices")
    out = torch.empty((P, M) + tuple(x.shape[2:]), dtype=RES, device=x.device)
    if out.numel() == 0:
        return out
    inner = x[0, 0].numel()
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.mod_contract(
            x.data_ptr(), out.data_ptr(), w.planes.data_ptr(),
            w.fold.data_ptr(), w.mods.data_ptr(), P, M, O, inner, k, N,
            w.nw, w.mt, w.kc, w.chunks, stream)
    if err != 0:
        raise RuntimeError(
            "mod_contract launch failed: "
            f"{lib.mod_contract_error_string(err).decode()}")
    LAUNCHES["mod_contract"] += 1
    return out


def exact_mod_contract(w, x, q_list, q_col):
    """sum_o W[m, o] * x[:, o] mod q_l, batched over the RNS limbs.

    w:     [M, O] integer weights (any sign and size; reduced mod q_l), or
           a `ContractWeights` from `prepare_contract` (no host work then).
    x:     int32 [P, O, C, s, k, N] residues (k = len(q_list)).
    q_col: [k, 1] modulus column.  Returns int32 [P, M, C, s, k, N]:
    the kernel on CUDA, the plain version on the CPU."""
    if is_batched(x):
        if not isinstance(w, ContractWeights):
            w = prepare_contract(w, q_list, x.device)
        return _contract_op(x, handle(w), [int(q) for q in q_list])
    if x.device.type == "cpu":
        return exact_mod_contract_plain(w, x, q_list, q_col)
    if x.device.type != "cuda":
        raise ValueError(f"no contraction for device {x.device}")
    return _launch(w, x, q_list)


@torch.library.custom_op(f"{LIB}::mod_contract", mutates_args=())
def _contract_op(x: torch.Tensor, weights: int, q_list: list[int]) -> torch.Tensor:
    """The contraction of a tensor that is not batched, prepared weights
    by handle."""
    q_col = (torch.tensor(q_list, dtype=torch.int64).view(-1, 1)
             if x.device.type == "cpu" else None)    # the kernel needs none
    return exact_mod_contract(lookup(weights), x, q_list, q_col)


@torch.library.register_vmap(_contract_op)
def _contract_vmap(info, in_dims, x, weights, q_list):
    """[B, P, O, C, s, k, N] -> [P, O, B*C, s, k, N]: the records are more
    columns of the same launch; the output unfolds to [P, M, B, C, ...]."""
    unbatched(in_dims, "mod_contract")
    if in_dims[0] is None:
        return _contract_op(x, weights, q_list), None
    x = x.movedim(in_dims[0], 3)                    # [P, O, C, B, s, k, N]
    P, O, C, B = x.shape[:4]
    x = x.transpose(2, 3).reshape(P, O, B * C, *x.shape[4:]).contiguous()
    out = _contract_op(x, weights, q_list)
    return out.view(P, out.shape[1], B, C, *out.shape[3:]), 2
