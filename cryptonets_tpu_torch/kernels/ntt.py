"""Binding of the hand-written Hopper NTT kernels (`ntt.cu`) and their
plain PyTorch twins.

`ntt_forward` / `ntt_inverse` are the only entry points.  A tensor on the
CPU goes to the twin; a CUDA tensor goes to the kernel, which is built
from `ntt.cu` at first use (`kernels/build.py`: `nvcc` for `sm_90a`, a
shared library with a plain C interface, loaded with ctypes).  A build or
launch failure raises: nothing falls back to the twin.  `LAUNCHES` counts kernel launches, so a
run can show that its path went through the kernels.  A tensor inside
`torch.func.vmap` goes through the operator `cryptonets_torch::ntt`,
whose vmap rule moves the record axis to the front: one launch over the
rows of every record (`batching.py`).

Replaces `PallasNTTContext._fwd_kernel` / `_inv_kernel`
(`cryptonets_tpu/kernels/pallas_ntt.py`); see `ntt.cu` for the design.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .batching import LIB, handle, is_batched, lookup, unbatched
from .build import load_library, source

_SRC = source("ntt.cu")
MAX_LOGN = 15  # one row of 2**15 uint32 = 128 KB of shared memory

LAUNCHES = {"ntt_forward": 0, "ntt_inverse": 0}


@dataclass(frozen=True)
class NTTTables:
    """Per-limb tables on one device, int32 storage of uint32 values.

    q [L, 1]; psi/ipsi [L, n] compact bit-reversed powers of the 2n-th
    root and its inverse, *_sh their Shoup companions; ninv/ninv_sh [L]."""

    q: torch.Tensor
    psi: torch.Tensor
    psi_sh: torch.Tensor
    ipsi: torch.Tensor
    ipsi_sh: torch.Tensor
    ninv: torch.Tensor
    ninv_sh: torch.Tensor


# ------------------------------------------------------------ plain twins
def ntt_forward_plain(x: torch.Tensor, tab: NTTTables) -> torch.Tensor:
    """Forward negacyclic NTT along the last axis of x [..., L, n]:
    Cooley-Tukey, standard order in, bit-reversed out (int64 arithmetic)."""
    n, L = x.shape[-1], x.shape[-2]
    q = tab.q.to(torch.int64).view(L, 1, 1)
    y = x.to(torch.int64)
    m = 1
    while m < n:
        t = n // (2 * m)
        v = y.reshape(*y.shape[:-1], m, 2, t)
        u, w = v[..., 0, :], v[..., 1, :]
        tw = tab.psi[:, m : 2 * m].to(torch.int64).view(L, m, 1)
        wv = w * tw % q
        y = torch.stack([(u + wv) % q, (u - wv) % q], dim=-2).reshape(y.shape)
        m *= 2
    return y.to(torch.int32)


def ntt_inverse_plain(x: torch.Tensor, tab: NTTTables) -> torch.Tensor:
    """Inverse of `ntt_forward_plain`: Gentleman-Sande, bit-reversed in,
    standard order out, scaled by n^-1."""
    n, L = x.shape[-1], x.shape[-2]
    q = tab.q.to(torch.int64).view(L, 1, 1)
    y = x.to(torch.int64)
    h = n // 2
    while h >= 1:
        t = n // (2 * h)
        v = y.reshape(*y.shape[:-1], h, 2, t)
        u, w = v[..., 0, :], v[..., 1, :]
        tw = tab.ipsi[:, h : 2 * h].to(torch.int64).view(L, h, 1)
        y = torch.stack([(u + w) % q, (u - w) % q * tw % q], dim=-2).reshape(
            y.shape
        )
        h //= 2
    return (y * tab.ninv.to(torch.int64).view(L, 1) % q.view(L, 1)).to(
        torch.int32
    )


# ------------------------------------------------------------------ build
@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile `ntt.cu` (once per source content) and load it."""
    lib = load_library(_SRC)
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ntt_forward.argtypes = [ptr] * 5 + [ll, i, i, ptr]
    lib.ntt_forward.restype = i
    lib.ntt_inverse.argtypes = [ptr] * 7 + [ll, i, i, ptr]
    lib.ntt_inverse.restype = i
    lib.ntt_kernel_info.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.ntt_kernel_info.restype = i
    lib.ntt_error_string.argtypes = [i]
    lib.ntt_error_string.restype = ctypes.c_char_p
    return lib


# ----------------------------------------------------------------- launch
def _check(x: torch.Tensor, tab: NTTTables) -> tuple[int, int]:
    if x.dim() < 2:
        raise ValueError(f"NTT needs [..., L, n] residues: {tuple(x.shape)}")
    n, L = x.shape[-1], x.shape[-2]
    logn = n.bit_length() - 1
    if n != 1 << logn or not 1 <= logn <= MAX_LOGN:
        raise ValueError(f"NTT needs [..., L, 2^k] with k <= {MAX_LOGN}: {x.shape}")
    if tuple(tab.psi.shape) != (L, n):
        raise ValueError(f"tables {tuple(tab.psi.shape)} do not fit {tuple(x.shape)}")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("NTT kernel takes contiguous int32 residues")
    if tab.psi.device != x.device:
        raise ValueError("NTT tables and input lie on different devices")
    if any(t.data_ptr() % 16 for t in (x, tab.psi, tab.psi_sh, tab.ipsi, tab.ipsi_sh)):
        raise ValueError("NTT kernel reads rows and tables as 16-byte vectors: "
                         "x or a table is not 16-byte aligned")
    return L, logn


def _launch(name: str, x: torch.Tensor, tab: NTTTables, *tables) -> torch.Tensor:
    L, logn = _check(x, tab)
    y = torch.empty_like(x)
    rows = x.numel() >> logn
    if rows == 0:
        return y
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [x.data_ptr(), y.data_ptr(), tab.q.data_ptr()]
    ptrs += [t.data_ptr() for t in tables]
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(*ptrs, rows, L, logn, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.ntt_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return y


KERNEL_INFO_KEYS = ("registers", "local_bytes", "threads", "shared_bytes",
                    "blocks_per_sm", "coefficients_per_thread", "passes")


def kernel_info(logn: int, inverse: bool) -> dict:
    """What the compiler and the current card made of the kernel instance
    for rows of 2**logn: registers and local (spilled) bytes a thread,
    threads and dynamic shared bytes a block, resident blocks an SM,
    coefficients a thread and passes a row."""
    lib = build()
    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = lib.ntt_kernel_info(logn, int(inverse), out)
    if err != 0:
        raise RuntimeError(f"ntt_kernel_info failed: {lib.ntt_error_string(err).decode()}")
    return dict(zip(KERNEL_INFO_KEYS, out))


@torch.library.custom_op(f"{LIB}::ntt", mutates_args=())
def _ntt_op(x: torch.Tensor, tables: int, inverse: bool) -> torch.Tensor:
    """The NTT of a tensor that is not batched, tables by handle."""
    return (ntt_inverse if inverse else ntt_forward)(x, lookup(tables))


@torch.library.register_vmap(_ntt_op)
def _ntt_vmap(info, in_dims, x, tables, inverse):
    """[B, ..., L, n]: the records are more rows of the same launch."""
    unbatched(in_dims, "ntt")
    if in_dims[0] is None:
        return _ntt_op(x, tables, inverse), None
    return _ntt_op(x.movedim(in_dims[0], 0).contiguous(), tables, inverse), 0


def ntt_forward(x: torch.Tensor, tab: NTTTables) -> torch.Tensor:
    """Forward NTT of int32 residues [..., L, n]: the kernel on CUDA, the
    plain twin on the CPU."""
    if is_batched(x):
        return _ntt_op(x, handle(tab), False)
    if x.device.type == "cpu":
        return ntt_forward_plain(x, tab)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT for device {x.device}")
    return _launch("ntt_forward", x, tab, tab.psi, tab.psi_sh)


def ntt_inverse(x: torch.Tensor, tab: NTTTables) -> torch.Tensor:
    """Inverse NTT of int32 residues [..., L, n] (see `ntt_forward`)."""
    if is_batched(x):
        return _ntt_op(x, handle(tab), True)
    if x.device.type == "cpu":
        return ntt_inverse_plain(x, tab)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT for device {x.device}")
    return _launch(
        "ntt_inverse", x, tab, tab.ipsi, tab.ipsi_sh, tab.ninv, tab.ninv_sh
    )
