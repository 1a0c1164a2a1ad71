"""K7: the RNS fast base conversion (`bconv.cu`) and its plain PyTorch
twin.

    out[..., l, n] = sum_i y[..., i, n] * c[i, l]  mod m_l

for y [..., Lf, N] already multiplied by the inverse punctured products,
c the int64 [Lf, Lt, 1] table of punctured products reduced mod each
target (`BFVParams._punct_matrix`, the group extension's `ks_grp_conv`)
and the targets' `ModChain`.  `fast_bconv` is the entry point.  A tensor
on the CPU goes to the twin (`mod_sum(mul_const_mod(...))`); a CUDA tensor
goes to the kernel, built from `bconv.cu` at first use
(`kernels/build.py`).  A build or launch failure raises: nothing falls
back to the twin.  `LAUNCHES` counts kernel launches.  y and the table
are read through their strides (a group's slice of the source limbs, a
limb shard's slice of the table: no copy).  A tensor inside
`torch.func.vmap` goes through the operator `cryptonets_torch::
fast_bconv`, whose vmap rule folds the record axis into the rows; a
batched table is refused.

Replaces the XLA fusion of BEHZ's `_fast_bconv` and the hybrid group
extension; see `bconv.cu` for the design.  No PyTorch call computes a
base conversion (a modular matrix product), so there is no library
counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..crypto.modular import mod_sum, mul_const_mod
from .batching import LIB, handle, is_batched, lookup
from .build import load_library, source

_SRC = source("bconv.cu")

LAUNCHES = {"fast_bconv": 0}
MAX_TABLE = 1024    # Lf * Lt, the kernel's shared table (`kMaxTable`)
_PARAMS = 15


# ------------------------------------------------------------ plain twin
def fast_bconv_plain(y, c, chain) -> torch.Tensor:
    """The conversion in plain PyTorch (int64 arithmetic): y [..., Lf, N],
    c [Lf, Lt, 1] -> [..., Lt, N]."""
    terms = mul_const_mod(y[..., :, None, :], c, chain.q[None])
    return mod_sum(terms, chain.q, dim=-3)


# ------------------------------------------------------------------ build
@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile `bconv.cu` (once per source content) and load it."""
    lib = load_library(_SRC)
    lib.fast_bconv.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.fast_bconv.restype = ctypes.c_int
    lib.fast_bconv_param_count.restype = ctypes.c_int
    lib.fast_bconv_max_table.restype = ctypes.c_int
    lib.fast_bconv_error_string.argtypes = [ctypes.c_int]
    lib.fast_bconv_error_string.restype = ctypes.c_char_p
    if (lib.fast_bconv_param_count(), lib.fast_bconv_max_table()) != (_PARAMS, MAX_TABLE):
        raise RuntimeError("bconv.cu's parameter block does not match bconv.py")
    return lib


# ----------------------------------------------------------------- launch
def check(y, c, chain) -> None:
    """Raise unless the operands fit the kernel: y int32 [RA, RB, Lf, N]
    with its last stride 1, N a power of two, c int64 [Lf, Lt, 1] on y's
    device, one chain table row a target limb."""
    if y.dim() != 4 or c.dim() != 3 or c.shape[0] != y.shape[2] or c.shape[2] != 1:
        raise ValueError(f"fast_bconv needs y [RA, RB, Lf, N] and c [Lf, Lt, 1]: "
                         f"{tuple(y.shape)}, {tuple(c.shape)}")
    RA, RB, Lf, N = y.shape
    Lt = c.shape[1]
    if N & (N - 1) or N == 0 or Lf == 0:
        raise ValueError(f"fast_bconv needs N a power of two: {tuple(y.shape)}")
    if Lf * Lt > MAX_TABLE:
        raise ValueError(f"fast_bconv's table [{Lf}, {Lt}] passes {MAX_TABLE} entries")
    if y.dtype != torch.int32 or y.stride(-1) != 1 or c.dtype != torch.int64:
        raise ValueError("fast_bconv takes int32 residues (last stride 1) "
                         "and an int64 table")
    if tuple(chain.mont.shape) != (Lt, 4):
        raise ValueError(f"the chain's table does not fit {Lt} target limbs")
    if c.device != y.device or chain.mont.device != y.device:
        raise ValueError("fast_bconv's operands lie on different devices")
    if RA * RB * Lt >= 1 << 31:
        raise ValueError("fast_bconv: too many rows for one launch")


def _launch(y, c, chain) -> torch.Tensor:
    check(y, c, chain)
    RA, RB, Lf, N = y.shape
    Lt = c.shape[1]
    out = torch.empty((RA, RB, Lt, N), dtype=torch.int32, device=y.device)
    if out.numel() == 0:
        return out
    v = [y.device.index, y.data_ptr(), c.data_ptr(), out.data_ptr(),
         chain.mont.data_ptr(), RA, RB, Lf, Lt, N.bit_length() - 1,
         y.stride(0), y.stride(1), y.stride(2), c.stride(0), c.stride(1)]
    lib = build()
    err = lib.fast_bconv((ctypes.c_longlong * _PARAMS)(*v),
                         torch._C._cuda_getCurrentRawStream(y.device.index))
    if err != 0:
        raise RuntimeError("fast_bconv launch failed: "
                           f"{lib.fast_bconv_error_string(err).decode()}")
    LAUNCHES["fast_bconv"] += 1
    return out


def _fast_bconv4(y, c, chain) -> torch.Tensor:
    """The kernel's form [RA, RB, Lf, N] on any device."""
    if y.device.type == "cpu":
        return fast_bconv_plain(y, c, chain)
    if y.device.type != "cuda":
        raise ValueError(f"no fast_bconv for device {y.device}")
    return _launch(y, c, chain)


@torch.library.custom_op(f"{LIB}::fast_bconv", mutates_args=())
def _bconv_op(y: torch.Tensor, c: torch.Tensor, chain: int) -> torch.Tensor:
    """The conversion of a tensor that is not batched, the chain by
    handle."""
    return _fast_bconv4(y, c, lookup(chain))


@torch.library.register_vmap(_bconv_op)
def _bconv_vmap(info, in_dims, y, c, chain):
    """[B, ...]: the records join ra (a view where the strides allow)."""
    y_dim, c_dim, _ = in_dims
    if c_dim is not None:
        raise ValueError("fast_bconv batches its data only, not its tables")
    if y_dim is None:
        return _bconv_op(y, c, chain), None
    RA = y.shape[1 if y_dim == 0 else 0]
    out = _bconv_op(y.movedim(y_dim, 0).flatten(0, 1), c, chain)
    return out.unflatten(0, (info.batch_size, RA)), 0


def fast_bconv(y, c, chain) -> torch.Tensor:
    """sum_i y[..., i, :] * c[i, l] mod m_l: y int32 [..., Lf, N] (any
    strides, the last 1; leading axes that merge into one stride are read
    in place), c int64 [Lf, Lt, 1], chain the targets' `ModChain` ->
    int32 [..., Lt, N]: the kernel on CUDA, the twin on the CPU."""
    lead = y.shape[:-2]
    y4 = y.reshape(1, -1, *y.shape[-2:])
    if is_batched(y) or is_batched(c):
        out = _bconv_op(y4, c, handle(chain))
    else:
        out = _fast_bconv4(y4, c, chain)
    return out.reshape(*lead, *out.shape[-2:])
