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

The BEHZ modes of the same kernel (`behz`, on a `BehzMode`) are three
conversions, each one launch with the scalings and corrections around it
in registers.  Each scales its Lf source rows at load, y_i = x_i w_i mod
q_i, and writes each target l as (e_l + sum_i y_i T[i, l]) mod m_l:

  * lift: e_l = r K_l for r = d sum_i y_i a_i mod M (M = 2**16),
    centred (r - M where 2 r >= M); the source rows [lo, hi) are
    written through ahead of the targets;
  * floor: e_l = x[Lf + l] K_l, the target's own residue read from the
    rows after the sources;
  * sk: e_l = v K_l for v = d (M - x[Lf]) + sum_i y_i a_i mod M, centred
    as the lift's, the M residue read from the row after the sources.

The scheme prepares the numbers (`crypto/bfv.py` `BFVParams._behz_tables`:
the BEHZ lift with its m~ correction, the fast floor of t c / q and
Shenoy-Kumaresan's Bsk -> q); this module knows only the modes.  Their
plain twin `behz_plain` computes the same from the same tables in int64
PyTorch.  `LAUNCHES` counts the modes apart (`fast_bconv_lift`,
`fast_bconv_floor`, `fast_bconv_sk`); under `torch.func.vmap` they go
through the operator `cryptonets_torch::behz`, the tables by handle.

Replaces the XLA fusion of BEHZ's `_fast_bconv` and the hybrid group
extension; see `bconv.cu` for the design and `plan` for the launch.  No
PyTorch call computes a base conversion (a modular matrix product), so
there is no library counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from types import MappingProxyType

import numpy as np
import torch

from ..crypto.hostmath import modinv
from ..crypto.modular import as_res, mod_sum, mul_const_mod, wide
from .batching import LIB, handle, is_batched, lookup
from .build import load_library, source

_SRC = source("bconv.cu")

LAUNCHES = {"fast_bconv": 0, "fast_bconv_lift": 0, "fast_bconv_floor": 0,
            "fast_bconv_sk": 0}
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
    lib.fast_bconv_behz.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.fast_bconv_behz.restype = ctypes.c_int
    lib.fast_bconv_behz_param_count.restype = ctypes.c_int
    lib.fast_bconv_behz_max_lf.restype = ctypes.c_int
    lib.fast_bconv_behz_kernel_info.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.fast_bconv_behz_kernel_info.restype = ctypes.c_int
    if ((lib.fast_bconv_param_count(), lib.fast_bconv_max_table(),
         lib.fast_bconv_threads(), lib.fast_bconv_max_chunk(),
         lib.fast_bconv_behz_param_count(), lib.fast_bconv_behz_max_lf())
            != (_PARAMS, MAX_TABLE, THREADS, MAX_CHUNK, _MODE_PARAMS, MODE_MAX_LF)):
        raise RuntimeError("bconv.cu's parameter block does not match bconv.py")
    return lib


KERNEL_INFO_KEYS = ("registers", "local_bytes", "threads", "shared_bytes",
                    "blocks_per_sm")


def kernel_info(Lf: int, V: int, mode: str | None = None) -> dict:
    """What the compiler and the current card made of the instance that
    serves Lf source limbs with V coefficients a thread (Lf above 16: the
    one that reads them per target), of the plain conversion or of a BEHZ
    `mode`: registers and local (spilled) bytes a thread, threads and
    static shared bytes of a block, resident blocks an SM."""
    lib = build()
    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = (lib.fast_bconv_kernel_info(Lf, V, out) if mode is None
           else lib.fast_bconv_behz_kernel_info(MODES[mode], Lf, V, out))
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


# ------------------------------------------------------------- BEHZ modes
MODES = {"lift": 1, "floor": 2, "sk": 3}   # `bconv.cu`'s kLift, kFloor, kSk
MODE_MAX_LF = 64    # source limbs of a mode launch (`kMaxModeLf`)
_MODE_PARAMS = 23


def _u32(rows, device) -> torch.Tensor:
    """int32 tensor with the u32 bits of the non-negative ints `rows`."""
    a = np.array(rows, dtype=object).astype(np.uint64).astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


class BehzMode:
    """One BEHZ conversion for its mode of the kernel (module docstring):
    Lf sources (moduli `q`, load scales `w`, the correction's weights `a`),
    Lt targets (moduli `m`, correction constants `K`), the table `T`
    [Lf][Lt], the correction's modulus `M` and factor `d` (lift, sk), and
    the source rows [lo, hi) the lift writes through (`through`).  Rows
    of `Lin` limbs in, `Lout` out, the targets from row `out0`.

    Two forms: int64 tensors for the twin (`q`, `w`, `a`, `m`, `K` as
    columns, `T` [Lf, Lt, 1]) and int32 tensors with the u32 bits for
    the kernel (`src` [Lf, 4]: q_i, w_i, its Shoup companion, a_i (a_i R
    mod M for sk); `tab` [Lf, Lt]: T R mod m_l; `tgt` [Lt, 4]: m_l,
    -m_l^-1 mod 2**32, K_l R and -K_l R mod m_l; three scalars
    `consts`).  `moduli` holds the sources' and targets' moduli as ints,
    `row_moduli` those of the Lin rows read."""

    def __init__(self, mode, q, w, m, T, K, a=None, M=0, d=0, through=(0, 0),
                 device="cpu"):
        if mode not in MODES:
            raise ValueError(f"no BEHZ mode {mode!r}")
        Lf, Lt = len(q), len(m)
        a = [0] * Lf if a is None else list(a)
        self._args = dict(q=list(q), w=list(w), m=list(m), T=[list(r) for r in T],
                          K=list(K), a=a, M=M, d=d, through=tuple(through))
        self.mode, self.Lf, self.Lt, self.M, self.d = mode, Lf, Lt, M, d
        self.moduli = (tuple(q), tuple(m))
        self.row_moduli = tuple(q) + {"lift": (), "floor": tuple(m), "sk": (M,)}[mode]
        self.lo, self.out0 = through[0], through[1] - through[0]
        self.Lin = Lf + {"lift": 0, "floor": Lt, "sk": 1}[mode]
        self.Lout = self.out0 + Lt

        def col(v):
            return torch.tensor(v, dtype=torch.int64, device=device).view(-1, 1)

        self.q, self.w, self.a, self.m, self.K = col(q), col(w), col(a), col(m), col(K)
        self.T = torch.tensor(T, dtype=torch.int64, device=device).view(Lf, Lt, 1)
        R = 1 << 32
        ak = [ai * R % M for ai in a] if mode == "sk" else a
        self.src = _u32([[qi, wi, (wi << 32) // qi, ai]
                         for qi, wi, ai in zip(q, w, ak)], device)
        self.tab = _u32([[c * R % ml for c, ml in zip(row, m)] for row in T], device)
        self.tgt = _u32([[ml, -modinv(ml, R) % R, k * R % ml, -k * R % ml]
                         for ml, k in zip(m, K)], device)
        # lift: d; sk: M, -M^-1 mod 2**32, d R mod M
        self.consts = (M, -modinv(M, R) % R, d * R % M) if mode == "sk" else (d, 0, 0)

    def to(self, device) -> "BehzMode":
        """The same tables on another device."""
        return BehzMode(self.mode, **self._args, device=device)


def behz_plain(x, tab: BehzMode) -> torch.Tensor:
    """The mode in plain PyTorch (int64 arithmetic) on the same tables:
    x [..., Lin, N] -> [..., Lout, N]."""
    Lf = tab.Lf
    y = wide(mul_const_mod(x[..., :Lf, :], tab.w, tab.q))           # [..., Lf, N]
    conv = (y[..., :, None, :] * tab.T % tab.m).sum(dim=-3)          # [..., Lt, N]
    if tab.mode == "floor":
        e = wide(x[..., Lf:, :]) * tab.K
    else:
        M = tab.M
        if tab.mode == "lift":
            s = (y * tab.a).sum(dim=-2) % M * tab.d % M
        else:
            s = ((M - wide(x[..., Lf, :])) * tab.d + (y * tab.a % M).sum(dim=-2)) % M
        e = torch.where(2 * s >= M, s - M, s)[..., None, :] * tab.K  # centred
    out = as_res((conv + e) % tab.m)
    if tab.mode == "lift":
        out = torch.cat([x[..., tab.lo:tab.lo + tab.out0, :], out], dim=-2)
    return out


# ------------------------------------------------------ BEHZ mode launch
@functools.lru_cache(maxsize=None)
def mode_plan(R, Lf, Lt, N, align: int) -> MappingProxyType:
    """The launch of one mode call on R rows: V coefficients a thread (the
    most the instance holds, `bconv.cu` `kModeV`: 4 up to 8 source limbs,
    else 2, where every row's V-coefficient accesses are `align`-byte
    aligned, else 1), THREADS threads a block, the Lt targets in chunks
    of `chunk` (a block each), the grid x = (r << log_tiles) | tile, z =
    the chunk.  Where the grid would hold fewer than MIN_THREADS threads,
    the targets split into more chunks, then V falls to 1 (`plan`)."""
    V = 4 if 1 <= Lf <= 8 else 2
    V = V if N % V == 0 and align % (4 * V) == 0 else 1
    cap = min(Lt, MAX_CHUNK, MAX_TABLE // Lf)
    while True:
        tiles = max(1, N // (V * THREADS))
        threads = R * tiles * THREADS
        chunks = max(-(-Lt // cap), min(Lt, -(-MIN_THREADS // threads)))
        chunk = -(-Lt // chunks)
        chunks = -(-Lt // chunk)
        if threads * chunks >= MIN_THREADS or V == 1:
            break
        V = 1
    grid = (R * tiles, 1, chunks)
    if grid[2] > GRID_YZ or grid[0] >= 1 << 31:
        raise ValueError(f"fast_bconv ({Lf} -> {Lt}): too many rows for one launch: {grid}")
    return MappingProxyType(dict(V=V, log_tiles=tiles.bit_length() - 1, chunk=chunk,
                                 log_chunk_p2=(chunk - 1).bit_length(), grid=grid))


def _align(*ptrs) -> int:
    """The largest power of two up to 16 that divides every address."""
    a = 16
    for ptr in ptrs:
        while ptr % a:
            a //= 2
    return a


def mode_check(x, tab: BehzMode) -> None:
    """Raise unless x fits the mode: int32 [..., Lin, N] on the tables'
    device, N a power of two, at most MODE_MAX_LF source limbs."""
    N = x.shape[-1]
    if x.dim() < 2 or x.shape[-2] != tab.Lin or N & (N - 1) or N == 0:
        raise ValueError(f"fast_bconv {tab.mode} takes [..., {tab.Lin}, N], N a "
                         f"power of two: {tuple(x.shape)}")
    if x.dtype != torch.int32 or x.device != tab.tab.device:
        raise ValueError(f"fast_bconv {tab.mode} takes int32 residues on "
                         f"{tab.tab.device}")
    if tab.Lf > MODE_MAX_LF:
        raise ValueError(f"fast_bconv {tab.mode}: {tab.Lf} source limbs, above "
                         f"{MODE_MAX_LF}")


def _launch_behz(x, tab: BehzMode) -> torch.Tensor:
    """One launch of the mode `tab.mode` on x [..., Lin, N] -> [..., Lout, N]."""
    mode_check(x, tab)
    x = x.contiguous()
    N = x.shape[-1]
    out = torch.empty((*x.shape[:-2], tab.Lout, N), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    R = x.numel() // (tab.Lin * N)
    pl = mode_plan(R, tab.Lf, tab.Lt, N, _align(x.data_ptr(), out.data_ptr()))
    v = [x.device.index, x.data_ptr(), out.data_ptr(), tab.src.data_ptr(),
         tab.tab.data_ptr(), tab.tgt.data_ptr(), MODES[tab.mode], tab.Lf, tab.Lt,
         tab.Lin, tab.Lout, tab.out0, tab.lo, N.bit_length() - 1, pl["V"],
         pl["log_tiles"], pl["chunk"], pl["log_chunk_p2"], pl["grid"][0],
         pl["grid"][2], *tab.consts]
    lib = build()
    err = lib.fast_bconv_behz((ctypes.c_longlong * _MODE_PARAMS)(*v),
                              torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"fast_bconv {tab.mode} launch failed: "
                           f"{lib.fast_bconv_error_string(err).decode()}")
    LAUNCHES[f"fast_bconv_{tab.mode}"] += 1
    return out


def _behz_rows(x, tab: BehzMode) -> torch.Tensor:
    """The mode on a tensor that is not batched: the kernel on CUDA, the
    twin on the CPU."""
    if x.device.type == "cpu":
        return behz_plain(x, tab)
    if x.device.type != "cuda":
        raise ValueError(f"no fast_bconv for device {x.device}")
    return _launch_behz(x, tab)


@torch.library.custom_op(f"{LIB}::behz", mutates_args=())
def _behz_op(x: torch.Tensor, tab: int) -> torch.Tensor:
    """A BEHZ mode on a tensor that is not batched, the tables by handle."""
    return _behz_rows(x, lookup(tab))


@torch.library.register_vmap(_behz_op)
def _behz_vmap(info, in_dims, x, tab):
    """[B, ...]: the records are more rows of the same launch."""
    if in_dims[0] is None:
        return _behz_op(x, tab), None
    return _behz_op(x.movedim(in_dims[0], 0), tab), 0


def behz(x, tab: BehzMode) -> torch.Tensor:
    """The BEHZ mode `tab.mode` on x int32 [..., Lin, N] -> [..., Lout, N]:
    one launch on CUDA, `behz_plain` on the CPU."""
    if is_batched(x):
        return _behz_op(x, handle(tab))
    return _behz_rows(x, tab)
