"""Binding of the hand-written Hopper NTT kernels (`ntt.cu`) and their
plain PyTorch twins.

`ntt_forward` / `ntt_inverse` are the entry points of the transforms;
`ntt_forward_lift` / `ntt_inverse_lift` those of the same kernels' lift
load (`ntt.cu`), which read plain coefficient rows once for every limb:
the BSGS diagonal encode (`api/bsgs.py`) alone calls them.  A tensor on
the CPU goes to the twin; a CUDA tensor goes to the kernel, which is built
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

LAUNCHES = {"ntt_forward": 0, "ntt_inverse": 0,
            "ntt_forward_lift": 0, "ntt_inverse_lift": 0}


@dataclass(frozen=True)
class NTTTables:
    """Per-limb tables on one device, int32 storage of uint32 values.

    q [L, 1]; psi/ipsi [L, n] compact bit-reversed powers of the 2n-th
    root and its inverse, *_sh their Shoup companions; ninv/ninv_sh [L];
    rmod/rmod_sh [L] R mod q (R = 2**32, the Montgomery constant) and its
    companion, the forward lift's scale."""

    q: torch.Tensor
    psi: torch.Tensor
    psi_sh: torch.Tensor
    ipsi: torch.Tensor
    ipsi_sh: torch.Tensor
    ninv: torch.Tensor
    ninv_sh: torch.Tensor
    rmod: torch.Tensor
    rmod_sh: torch.Tensor


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


def ntt_forward_lift_plain(x: torch.Tensor, tab: NTTTables) -> torch.Tensor:
    """x [S, n] values in [0, 2**31) -> [S, L, n]: each row broadcast over
    the L limbs, `ntt_forward_plain`, then times R mod q (Montgomery
    form)."""
    S, n = x.shape
    L = tab.q.shape[0]
    y = ntt_forward_plain(x[:, None, :].expand(S, L, n).contiguous(), tab)
    return (y.to(torch.int64) * tab.rmod.to(torch.int64).view(L, 1)
            % tab.q.to(torch.int64)).to(torch.int32)


def ntt_inverse_lift_plain(x: torch.Tensor, tab: NTTTables) -> torch.Tensor:
    """x [S, n] signed values in (-q, q) for every limb -> [L, S, n]: each
    row broadcast over the L limbs with q added to a negative value, then
    `ntt_inverse_plain`, limb-major."""
    S, n = x.shape
    L = tab.q.shape[0]
    flat = x[:, None, :]
    q = tab.q.view(1, L, 1)
    y = ntt_inverse_plain(torch.where(flat < 0, flat + q, flat), tab)
    return y.transpose(0, 1).contiguous()


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
    lib.ntt_forward_lift.argtypes = [ptr] * 7 + [ll, i, i, ptr]
    lib.ntt_forward_lift.restype = i
    lib.ntt_inverse_lift.argtypes = [ptr] * 7 + [ll, i, i, ptr]
    lib.ntt_inverse_lift.restype = i
    lib.ntt_kernel_info.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.ntt_kernel_info.restype = i
    lib.ntt_error_string.argtypes = [i]
    lib.ntt_error_string.restype = ctypes.c_char_p
    return lib


# ----------------------------------------------------------------- launch
def _check_tables(x: torch.Tensor, tab: NTTTables, L: int, n: int) -> int:
    """log2 n, once rows of n over L limbs fit the tables and the kernel."""
    logn = n.bit_length() - 1
    if n != 1 << logn or not 1 <= logn <= MAX_LOGN:
        raise ValueError(f"NTT needs rows of 2^k with k <= {MAX_LOGN}: {tuple(x.shape)}")
    if tuple(tab.psi.shape) != (L, n):
        raise ValueError(f"tables {tuple(tab.psi.shape)} do not fit {tuple(x.shape)}")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("NTT kernel takes contiguous int32 residues")
    if tab.psi.device != x.device:
        raise ValueError("NTT tables and input lie on different devices")
    if any(t.data_ptr() % 16 for t in (x, tab.psi, tab.psi_sh, tab.ipsi, tab.ipsi_sh)):
        raise ValueError("NTT kernel reads rows and tables as 16-byte vectors: "
                         "x or a table is not 16-byte aligned")
    return logn


def _check(x: torch.Tensor, tab: NTTTables) -> tuple[int, int]:
    if x.dim() < 2:
        raise ValueError(f"NTT needs [..., L, n] residues: {tuple(x.shape)}")
    L = x.shape[-2]
    return L, _check_tables(x, tab, L, x.shape[-1])


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


def _check_lift(x: torch.Tensor, tab: NTTTables) -> tuple[int, int, int]:
    """(S, L, logn) of a lift's source rows x [S, n] under tables of L limbs."""
    if is_batched(x):
        raise ValueError("the NTT lift takes no batched tensor (it serves the "
                         "BSGS diagonal encode, whose tables are not batched)")
    if x.dim() != 2:
        raise ValueError(f"the NTT lift takes rows [S, n]: {tuple(x.shape)}")
    L = tab.psi.shape[0]
    return x.shape[0], L, _check_tables(x, tab, L, x.shape[1])


def _launch_lift(name: str, x: torch.Tensor, tab: NTTTables, out_shape,
                 *args) -> torch.Tensor:
    """One launch of the lift load `name` ("ntt_forward_lift" or
    "ntt_inverse_lift") from x [S, n] into a fresh [out_shape]; `args`
    the tables and ints after the moduli."""
    y = torch.empty(out_shape, dtype=torch.int32, device=x.device)
    if y.numel() == 0:
        return y
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(x.data_ptr(), y.data_ptr(), tab.q.data_ptr(),
                                 *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.ntt_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return y


KERNEL_INFO_KEYS = ("registers", "local_bytes", "threads", "shared_bytes",
                    "blocks_per_sm", "coefficients_per_thread", "passes")


def kernel_info(logn: int, inverse: bool, lift: bool = False) -> dict:
    """What the compiler and the current card made of the kernel instance
    for rows of 2**logn (with the lift load if `lift`): registers and
    local (spilled) bytes a thread, threads and dynamic shared bytes a
    block, resident blocks an SM, coefficients a thread and passes a
    row."""
    lib = build()
    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = lib.ntt_kernel_info(logn, int(inverse), int(lift), out)
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


def ntt_forward_lift(x: torch.Tensor, tab: NTTTables) -> torch.Tensor:
    """Plain coefficient rows x [S, n] (int32 values in [0, 2**31)) ->
    [S, L, n]: each row broadcast over the limbs, its forward NTT, times
    R mod q; bit-equal to `to_mont(ntt_forward(broadcast x))`.  One launch
    of the forward kernel's lift load on CUDA, the plain twin on the CPU;
    a batched tensor raises."""
    S, L, logn = _check_lift(x, tab)
    if x.device.type == "cpu":
        return ntt_forward_lift_plain(x, tab)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT for device {x.device}")
    return _launch_lift("ntt_forward_lift", x, tab, (S, L, 1 << logn),
                        tab.psi.data_ptr(), tab.psi_sh.data_ptr(),
                        tab.rmod.data_ptr(), tab.rmod_sh.data_ptr(), S, L, logn)


def ntt_inverse_lift(x: torch.Tensor, tab: NTTTables) -> torch.Tensor:
    """Signed rows x [S, n] (int32 values in (-q, q) for every limb q) ->
    [L, S, n]: each row's inverse NTT under every limb, q added to a
    negative value first; bit-equal to the inverse NTT of `where(x < 0,
    x + q, x)` broadcast over the limbs, limb-major.  One launch of the
    inverse kernel's lift load on CUDA, the plain twin on the CPU; a
    batched tensor raises."""
    S, L, logn = _check_lift(x, tab)
    if x.device.type == "cpu":
        return ntt_inverse_lift_plain(x, tab)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT for device {x.device}")
    return _launch_lift("ntt_inverse_lift", x, tab, (L, S, 1 << logn),
                        tab.ipsi.data_ptr(), tab.ipsi_sh.data_ptr(),
                        tab.ninv.data_ptr(), tab.ninv_sh.data_ptr(), S, L, logn)
