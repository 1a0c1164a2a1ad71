"""K7: the RNS fast base conversion (`bconv.cu`) and its plain PyTorch
twin.

    out[..., l, n] = sum_i y[..., i, n] * c[i, l]  mod m_l

for y [..., Lf, N] already multiplied by the inverse punctured products,
c the table of punctured products reduced mod each target and the
targets' `ModChain`.  The table is a `BconvTable`, prepared once per
table (`BFVParams.bconv`): the int64 [Lf, Lt, 1] values
(`BFVParams._punct_matrix`, the group extension's `ks_grp_conv`), which
the twin reads, beside their Montgomery form u32 c R mod m_l [Lf, Lt],
which the kernel reads; a bare int64 table is prepared at the call.
`fast_bconv` is the entry point.  A tensor on the CPU goes to the twin
(`mod_sum(mul_const_mod(...))`); a CUDA tensor goes to the kernel, built
from `bconv.cu` at first use
(`kernels/build.py`).  A build or launch failure raises: nothing falls
back to the twin.  `LAUNCHES` counts kernel launches.  y and the table
are read through their strides (a group's slice of the source limbs, a
limb shard's slice of the table: no copy).  A tensor inside
`torch.func.vmap` goes through the operator `cryptonets_torch::
fast_bconv`, whose vmap rule folds the record axis into the rows; a
batched table is refused.

Replaces the XLA fusion of BEHZ's `_fast_bconv` and the hybrid group
extension; see `bconv.cu` for the design and `plan` for the launch.  No
PyTorch call computes a base conversion (a modular matrix product), so
there is no library counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from types import MappingProxyType

import torch

from ..crypto.modular import mod_sum, mul_const_mod
from .batching import LIB, handle, is_batched, lookup
from .build import load_library, source

_SRC = source("bconv.cu")

LAUNCHES = {"fast_bconv": 0}
MAX_TABLE = 1024    # Lf * Lt, the kernel's shared table (`kMaxTable`)
MAX_CHUNK = 256     # targets a block (`kMaxChunk`)
THREADS = 128       # a block (`kThreads`)
MIN_THREADS = 1 << 15   # more target chunks, then fewer coefficients a thread, below this
GRID_YZ = 65535
_PARAMS = 21


class BconvTable:
    """A conversion table in both forms: `c` int64 [Lf, Lt, 1] (the twin's)
    and `mont` int32 [Lf, Lt], the u32 bits of c R mod m_l (the kernel's).
    Indexing cuts both alike (views: a group's source rows, a shard's
    target columns)."""

    def __init__(self, c: torch.Tensor, mont: torch.Tensor):
        self.c, self.mont = c, mont

    @classmethod
    def prepare(cls, c: torch.Tensor, moduli) -> "BconvTable":
        """c int64 [Lf, Lt, 1] (entries below their target modulus) and
        its Montgomery form against `moduli`, the Lt targets."""
        q = torch.tensor([int(m) for m in moduli], dtype=torch.int64, device=c.device)
        return cls(c, ((c[..., 0] << 32) % q).to(torch.int32))

    def __getitem__(self, idx) -> "BconvTable":
        return BconvTable(self.c[idx], self.mont[idx])

    @property
    def shape(self):
        return self.c.shape


def _table(c, chain) -> BconvTable:
    return c if isinstance(c, BconvTable) else BconvTable.prepare(c, chain.moduli)


@functools.lru_cache(maxsize=None)
def plan(RA, RB, Lf, Lt, N, vector: bool) -> MappingProxyType:
    """The launch of one call: V coefficients a thread (4 where y's 16-byte
    reads are aligned, `vector`, else 1), THREADS threads a block, the Lt
    targets in chunks of `chunk` (a block each), and the grid x = (rb <<
    log_tiles) | tile, y = ra, z = the chunk.  Where the grid would hold
    fewer than MIN_THREADS threads, the targets split into more chunks
    (each rereads its column of y), then V falls to 1: a small launch is
    launch latency either way."""
    V = 4 if vector and N % 4 == 0 else 1
    cap = min(Lt, MAX_CHUNK, MAX_TABLE // Lf)
    while True:
        tiles = max(1, N // (V * THREADS))
        threads = RA * RB * tiles * THREADS
        chunks = max(-(-Lt // cap), min(Lt, -(-MIN_THREADS // threads)))
        chunk = -(-Lt // chunks)
        chunks = -(-Lt // chunk)
        if threads * chunks >= MIN_THREADS or V == 1:
            break
        V = 1
    grid = (RB * tiles, RA, chunks)
    if grid[1] > GRID_YZ or grid[2] > GRID_YZ or grid[0] >= 1 << 31:
        raise ValueError(f"fast_bconv: too many rows for one launch: grid {grid}")
    return MappingProxyType(dict(V=V, log_tiles=tiles.bit_length() - 1, chunk=chunk,
                                 log_chunk_p2=(chunk - 1).bit_length(), grid=grid))


# ------------------------------------------------------------ plain twin
def fast_bconv_plain(y, c, chain) -> torch.Tensor:
    """The conversion in plain PyTorch (int64 arithmetic): y [..., Lf, N],
    c [Lf, Lt, 1] (or a `BconvTable`) -> [..., Lt, N]."""
    if isinstance(c, BconvTable):
        c = c.c
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
    lib.fast_bconv_threads.restype = ctypes.c_int
    lib.fast_bconv_max_chunk.restype = ctypes.c_int
    lib.fast_bconv_kernel_info.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.fast_bconv_kernel_info.restype = ctypes.c_int
    lib.fast_bconv_error_string.argtypes = [ctypes.c_int]
    lib.fast_bconv_error_string.restype = ctypes.c_char_p
    if ((lib.fast_bconv_param_count(), lib.fast_bconv_max_table(),
         lib.fast_bconv_threads(), lib.fast_bconv_max_chunk())
            != (_PARAMS, MAX_TABLE, THREADS, MAX_CHUNK)):
        raise RuntimeError("bconv.cu's parameter block does not match bconv.py")
    return lib


KERNEL_INFO_KEYS = ("registers", "local_bytes", "threads", "shared_bytes",
                    "blocks_per_sm")


def kernel_info(Lf: int, V: int) -> dict:
    """What the compiler and the current card made of the instance that
    serves Lf source limbs with V coefficients a thread (Lf above 16: the
    one that reads them per target): registers and local (spilled) bytes a
    thread, threads and static shared bytes of a block, resident blocks an
    SM."""
    lib = build()
    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = lib.fast_bconv_kernel_info(Lf, V, out)
    if err != 0:
        raise RuntimeError(f"fast_bconv_kernel_info failed: "
                           f"{lib.fast_bconv_error_string(err).decode()}")
    return dict(zip(KERNEL_INFO_KEYS, out))


# ----------------------------------------------------------------- launch
def check(y, c, chain) -> None:
    """Raise unless the operands fit the kernel: y int32 [RA, RB, Lf, N]
    with its last stride 1, N a power of two, c an int64 [Lf, Lt, 1] table
    (or a `BconvTable` of one) on y's device, one chain table row a target
    limb."""
    if isinstance(c, BconvTable):
        if c.mont.dtype != torch.int32 or tuple(c.mont.shape) != tuple(c.c.shape[:2]):
            raise ValueError("fast_bconv's prepared table does not fit its values")
        c = c.c
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


def plan_of(y, c, ys=None) -> MappingProxyType:
    """`plan` for y [RA, RB, Lf, N] (its strides `ys`, read here if not
    given) and a table of Lt targets: 16-byte reads where y's address and
    strides allow."""
    RA, RB, Lf, N = y.shape
    sa, sb, sl, _ = y.stride() if ys is None else ys
    vector = (y.data_ptr() & 15 | (sa | sb | sl) & 3) == 0
    return plan(RA, RB, Lf, c.shape[1], N, vector)


def _launch(y, c, chain) -> torch.Tensor:
    check(y, c, chain)
    table = _table(c, chain)
    RA, RB, Lf, N = y.shape
    Lt = table.shape[1]
    out = torch.empty((RA, RB, Lt, N), dtype=torch.int32, device=y.device)
    if out.numel() == 0:
        return out
    ys = y.stride()
    pl = plan_of(y, table, ys)
    m = table.mont
    v = [y.device.index, y.data_ptr(), m.data_ptr(), out.data_ptr(),
         chain.mont.data_ptr(), RB, Lf, Lt, N.bit_length() - 1,
         pl["V"], pl["log_tiles"], pl["chunk"], pl["log_chunk_p2"], *pl["grid"],
         *ys[:3], *m.stride()]
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
def _bconv_op(y: torch.Tensor, c: torch.Tensor, mont: torch.Tensor,
              chain: int) -> torch.Tensor:
    """The conversion of a tensor that is not batched, the table in both
    forms, the chain by handle."""
    return _fast_bconv4(y, BconvTable(c, mont), lookup(chain))


@torch.library.register_vmap(_bconv_op)
def _bconv_vmap(info, in_dims, y, c, mont, chain):
    """[B, ...]: the records join ra (a view where the strides allow)."""
    y_dim, c_dim, m_dim, _ = in_dims
    if c_dim is not None or m_dim is not None:
        raise ValueError("fast_bconv batches its data only, not its tables")
    if y_dim is None:
        return _bconv_op(y, c, mont, chain), None
    RA = y.shape[1 if y_dim == 0 else 0]
    out = _bconv_op(y.movedim(y_dim, 0).flatten(0, 1), c, mont, chain)
    return out.unflatten(0, (info.batch_size, RA)), 0


def fast_bconv(y, c, chain) -> torch.Tensor:
    """sum_i y[..., i, :] * c[i, l] mod m_l: y int32 [..., Lf, N] (any
    strides, the last 1; leading axes that merge into one stride are read
    in place), c a `BconvTable` (or int64 [Lf, Lt, 1], prepared here),
    chain the targets' `ModChain` -> int32 [..., Lt, N]: the kernel on
    CUDA, the twin on the CPU."""
    lead = y.shape[:-2]
    y4 = y.reshape(1, -1, *y.shape[-2:])
    if is_batched(y) or (not isinstance(c, BconvTable) and is_batched(c)):
        t = _table(c, chain)
        out = _bconv_op(y4, t.c, t.mont, handle(chain))
    else:
        out = _fast_bconv4(y4, c, chain)
    return out.reshape(*lead, *out.shape[-2:])
