"""`slot_map`: the slot buffers of the device encode, built on the card
(`slotmap.cu`), and its plain PyTorch twin.

    out[p, (r V + v) C + c, j] = rint(x[r, c n + pos[j], v]) mod t_p

for the reader's scaled values x float64 [R, dim, V] (R records, each a
`RawMatrix.m`), the factory's inverse index map `pos` int32 [n] and the
plain primes t_p; 0 where c n + pos[j] >= dim, C = ceil(dim / n).  It is
`CrtBfvFactory.encode_bufs` of each record's values rounded (half to
even) and padded to C n slots a column (a floor modulus), the R records'
buffers one after another: what the device encode's inverse NTT reads.  `slot_map`
is the entry point.  A tensor on the CPU goes to the twin; a CUDA tensor
goes to the kernel, built from `slotmap.cu` at first use
(`kernels/build.py`).  A build or launch failure raises: nothing falls
back to the twin.  `LAUNCHES` counts kernel launches.  x is read through
its strides.  The values must lie inside int64 once rounded, as the
host's `astype(np.int64)` needs too.

Replaces no TPU kernel (the JAX package builds these buffers on the host
as well); see `slotmap.cu` for why it was added, its bound (bytes) and
its design, and `plan` for the launch.  No PyTorch call computes it in one
pass: the twin is five.
"""

from __future__ import annotations

import ctypes
import functools
from types import MappingProxyType

import torch

from .build import load_library, source

_SRC = source("slotmap.cu")

LAUNCHES = {"slot_map": 0}
TILE_J = 64         # buffer positions a block (`kTileJ`)
TILE_V = 64         # columns a block (`kTileV`)
THREADS = 256       # a block (`kThreads`)
MAX_PRIMES = 8      # plain primes a launch (`kMaxP`)
GRID_YZ = 65535
_PARAMS = 16 + 2 * MAX_PRIMES


def blocks_of(dim: int, n: int) -> int:
    """C, the slot blocks of a column of `dim` values in a ring of n."""
    return max(1, -(-dim // n))


# ------------------------------------------------------------ plain twin
def slot_map_plain(x, pos, primes) -> torch.Tensor:
    """The slot map in plain PyTorch: x float64 [R, dim, V], pos [n],
    primes (ints) -> int32 [P, R*V*C, n]."""
    R, dim, V = x.shape
    n = pos.shape[0]
    C = blocks_of(dim, n)
    ints = torch.zeros((R, V, C * n), dtype=torch.int64, device=x.device)
    ints[:, :, :dim] = torch.round(x).to(torch.int64).transpose(1, 2)
    ints = ints.reshape(R * V * C, n)[:, pos.long()]
    t = torch.tensor([int(p) for p in primes], dtype=torch.int64, device=x.device)
    return torch.remainder(ints[None], t.view(-1, 1, 1)).to(torch.int32)


# ------------------------------------------------------------------ build
@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile `slotmap.cu` (once per source content) and load it."""
    lib = load_library(_SRC)
    lib.slot_map.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.slot_map.restype = ctypes.c_int
    lib.slot_map_param_count.restype = ctypes.c_int
    lib.slot_map_tile.argtypes = [ctypes.c_int]
    lib.slot_map_tile.restype = ctypes.c_int
    lib.slot_map_kernel_info.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.slot_map_kernel_info.restype = ctypes.c_int
    lib.slot_map_error_string.argtypes = [ctypes.c_int]
    lib.slot_map_error_string.restype = ctypes.c_char_p
    if ((lib.slot_map_param_count(), *(lib.slot_map_tile(i) for i in range(4)))
            != (_PARAMS, TILE_J, TILE_V, THREADS, MAX_PRIMES)):
        raise RuntimeError("slotmap.cu's parameter block does not match slotmap.py")
    return lib


KERNEL_INFO_KEYS = ("registers", "local_bytes", "threads", "shared_bytes",
                    "blocks_per_sm")


def kernel_info() -> dict:
    """What the compiler and the current card made of the kernel:
    registers and local (spilled) bytes a thread, threads and static
    shared bytes of a block, resident blocks an SM."""
    lib = build()
    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = lib.slot_map_kernel_info(out)
    if err != 0:
        raise RuntimeError(f"slot_map_kernel_info failed: "
                           f"{lib.slot_map_error_string(err).decode()}")
    return dict(zip(KERNEL_INFO_KEYS, out))


# ----------------------------------------------------------------- launch
@functools.lru_cache(maxsize=None)
def barrett(primes: tuple) -> tuple:
    """The kernel's constants of the plain primes: floor(2**64 / t) each."""
    return tuple((1 << 64) // t for t in primes)


def check(x, pos, primes) -> None:
    """Raise unless the operands fit the kernel: x float64 [R, dim, V],
    pos int32 [n] on x's device with n a multiple of 4, 1 to MAX_PRIMES
    odd primes below 2**31."""
    if x.dim() != 3 or x.dtype != torch.float64:
        raise ValueError(f"slot_map takes float64 values [R, dim, V]: "
                         f"{x.dtype} {tuple(x.shape)}")
    if pos.dim() != 1 or pos.dtype != torch.int32 or pos.device != x.device:
        raise ValueError("slot_map takes an int32 index map [n] on the values' device")
    if pos.shape[0] % 4:
        raise ValueError(f"slot_map needs n a multiple of 4: {pos.shape[0]}")
    if not 1 <= len(primes) <= MAX_PRIMES or any(
            t % 2 == 0 or not 2 < t < 1 << 31 for t in primes):
        raise ValueError(f"slot_map takes 1 to {MAX_PRIMES} odd plain primes "
                         f"below 2**31: {primes}")


@functools.lru_cache(maxsize=None)
def plan(R: int, dim: int, V: int, n: int) -> MappingProxyType:
    """The launch of one call: the grid x = the position tiles of TILE_J,
    y = the column tiles of TILE_V within each of the C blocks, z = the
    records."""
    C = blocks_of(dim, n)
    v_tiles = -(-V // TILE_V)
    grid = (-(-n // TILE_J), C * v_tiles, R)
    if grid[1] > GRID_YZ or grid[2] > GRID_YZ:
        raise ValueError(f"slot_map: too many columns or records for one "
                         f"launch: grid {grid}")
    return MappingProxyType(dict(C=C, v_tiles=v_tiles, grid=grid))


def _launch(x, pos, primes) -> torch.Tensor:
    primes = tuple(int(t) for t in primes)
    R, dim, V = x.shape
    n = pos.shape[0]
    pl = plan(R, dim, V, n)
    out = torch.empty((len(primes), R * V * pl["C"], n), dtype=torch.int32,
                      device=x.device)
    if out.numel() == 0:
        return out
    pad = (0,) * (MAX_PRIMES - len(primes))
    v = [x.device.index, x.data_ptr(), pos.data_ptr(), out.data_ptr(), *x.stride(),
         dim, V, pl["C"], n, len(primes), pl["v_tiles"], *pl["grid"],
         *primes, *pad, *barrett(primes), *pad]
    lib = build()
    err = lib.slot_map((ctypes.c_longlong * _PARAMS)(*v),
                       torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"slot_map launch failed: "
                           f"{lib.slot_map_error_string(err).decode()}")
    LAUNCHES["slot_map"] += 1
    return out


def slot_map(x, pos, primes) -> torch.Tensor:
    """rint(x[r, c n + pos[j], v]) mod each prime, index-mapped: x float64
    [R, dim, V], pos int32 [n] on x's device, the plain primes -> int32
    [P, R*V*C, n]: the kernel on CUDA, the twin on the CPU."""
    check(x, pos, tuple(int(t) for t in primes))
    if x.device.type == "cpu":
        return slot_map_plain(x, pos, primes)
    if x.device.type != "cuda":
        raise ValueError(f"no slot_map for device {x.device}")
    return _launch(x, pos, primes)
