"""Exact modular contraction: out[m] = sum_o W[m, o] * x[o] mod q.

The conv of `LLPoolLayer` and the dense layers of `PoolLayer` contract
ciphertext columns against an integer weight matrix.  `exact_mod_contract`
is the only entry point.  A tensor on the CPU goes to the plain version;
a CUDA tensor goes to the hand-written kernel of `modmatmul.cu`, built at
first use (`kernels/build.py`).  A build or launch failure raises: nothing
falls back to the plain version.  `LAUNCHES` counts kernel launches.

Replaces `exact_mod_contract` of `cryptonets_tpu/kernels/modmatmul.py`,
whose 7-bit int8 digit planes exist only because the TPU's matrix unit has
no integers.  Here the weights are reduced per limb on the host, each
product W[m, o] * x[o] is reduced mod q and the O reduced terms are summed
exactly in 64 bits before one final reduction.  The result is canonical,
hence bit-equal to the reference.  No PyTorch call computes an integer
matrix product mod q on CUDA (no int64 `matmul` there, `torch._int_mm`
takes int8 only), so there is no library counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..crypto.modular import RES, wide
from .build import load_library, source

_SRC = source("modmatmul.cu")
TILES = (10, 8, 5)  # outputs m per thread the kernel is compiled for

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


# ------------------------------------------------------------ plain version
def exact_mod_contract_plain(w_int, x, q_list, q_col):
    """The contraction in plain PyTorch (int64 arithmetic): the reference
    of the kernel, and the path of CPU tensors."""
    M, O = _check(w_int, x, q_list)
    wq = torch.from_numpy(reduce_weights(w_int, q_list)).to(x.device)
    acc = None
    for o in range(O):
        w = wq[:, o].view(1, M, 1, 1, len(q_list), 1)
        term = wide(x[:, o, None]) * w % q_col            # [P, M, C, s, k, N]
        acc = term if acc is None else acc + term
    return (acc % q_col).to(RES)


# ------------------------------------------------------------------- kernel
@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile `modmatmul.cu` (once per source content) and load it."""
    lib = load_library(_SRC)
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mod_contract.argtypes = [ptr] * 5 + [i, i, i, ll, i, i, i, ptr]
    lib.mod_contract.restype = i
    lib.mod_contract_error_string.argtypes = [i]
    lib.mod_contract_error_string.restype = ctypes.c_char_p
    return lib


def _check(w_int, x, q_list) -> tuple[int, int]:
    if x.dim() != 6 or x.shape[-2] != len(q_list):
        raise ValueError(
            f"contraction needs [P, O, C, s, k, N] residues with "
            f"k = {len(q_list)}: {tuple(x.shape)}")
    M, O = len(w_int), x.shape[1]
    if M == 0 or O == 0 or len(w_int[0]) != O:
        raise ValueError(f"weights [{M}, ...] do not fit {tuple(x.shape)}")
    if O >= 1 << 31:
        raise ValueError("contraction too long for an exact 64-bit sum")
    return M, O


def tile_for(M: int) -> int:
    """The compiled tile of m that pads M least (the larger on a tie)."""
    return min(TILES, key=lambda t: (-(-M // t) * t, -t))


def _i32(a: np.ndarray, device) -> torch.Tensor:
    """Values below 2**32 held in int64 -> int32 tensor with those bits."""
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device)


def _launch(w_int, x, q_list) -> torch.Tensor:
    M, O = _check(w_int, x, q_list)
    P, k, N = x.shape[0], x.shape[-2], x.shape[-1]
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("the contraction kernel takes contiguous int32 residues")
    if N & (N - 1) or any(not 0 < int(q) < 1 << 31 for q in q_list):
        raise ValueError("the kernel needs N a power of two and moduli below 2**31")
    out = torch.empty((P, M) + tuple(x.shape[2:]), dtype=RES, device=x.device)
    if out.numel() == 0:
        return out
    wq = reduce_weights(w_int, q_list).transpose(2, 0, 1)      # [k, M, O]
    qs = np.array([int(q) for q in q_list], np.int64).reshape(-1, 1, 1)
    w = _i32(np.ascontiguousarray(wq), x.device)
    w_sh = _i32(np.ascontiguousarray((wq << 32) // qs), x.device)
    mods = _i32(qs.reshape(-1), x.device)
    inner = x[0, 0].numel()
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.mod_contract(
            x.data_ptr(), out.data_ptr(), w.data_ptr(), w_sh.data_ptr(),
            mods.data_ptr(), P, M, O, inner, k, N, tile_for(M), stream)
    if err != 0:
        raise RuntimeError(
            "mod_contract launch failed: "
            f"{lib.mod_contract_error_string(err).decode()}")
    LAUNCHES["mod_contract"] += 1
    return out


def exact_mod_contract(w_int, x, q_list, q_col):
    """sum_o W[m, o] * x[:, o] mod q_l, batched over the RNS limbs.

    w_int: [M, O] integer weights (any sign and size; reduced mod q_l).
    x:     int32 [P, O, C, s, k, N] residues (k = len(q_list)).
    q_col: [k, 1] modulus column.  Returns int32 [P, M, C, s, k, N]:
    the kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return exact_mod_contract_plain(w_int, x, q_list, q_col)
    if x.device.type != "cuda":
        raise ValueError(f"no contraction for device {x.device}")
    return _launch(w_int, x, q_list)
