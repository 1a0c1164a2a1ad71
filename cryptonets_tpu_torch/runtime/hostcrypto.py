"""ctypes binding of the host runtime (`hostcrypto.cpp`): the exact
negacyclic NTT over Z_t for plain moduli 2**31 <= t < 2**63, whose
products need 128 bits.  It carries the slot encode and decode of a
factory whose plain primes do not fit the device NTT.  A call over many
rows splits them into contiguous pieces, one C call a piece, run in
threads (ctypes releases the GIL during a foreign call).

The library is compiled with `c++` at first use, from `hostcrypto.cpp`
only, into `_build/` beside it, named by a hash of the compiler command
and the source; it is written under a temporary name and renamed into
place, so parallel processes that build it at once each get a whole
library.  A failed build raises: nothing falls back to object integers
(the exact object-int NTT of `crypto/encoder.py` is the plain twin the
tests hold this one against).  Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SRC = Path(__file__).with_name("hostcrypto.cpp")
BUILD_DIR = Path(__file__).with_name("_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
# Coefficients a thread takes at least: below it one thread runs all rows
# (a row of 16384 takes 1-2 ms, so a piece of 16 rows takes 16-32 ms)
THREAD_COEFFS = 1 << 18

_lib = None


def library_path() -> Path:
    """The library of the source, named by a hash of the command and the
    source, so a changed source is rebuilt and an unchanged one reused."""
    cxx = os.environ.get("CXX", "c++")
    tag = hashlib.sha256(repr((cxx,) + CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libhostcrypto_{tag.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "c++"), *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"no C++ compiler for the host runtime: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building the host runtime failed "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.ntt_forward_rows_u64.argtypes = [
            u64p, ctypes.c_long, u64p, ctypes.c_uint64, ctypes.c_int]
        lib.ntt_inverse_rows_u64.argtypes = [
            u64p, ctypes.c_long, u64p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int]
        lib.reduce_residues_u64.argtypes = [
            u64p, ctypes.c_long, u32p, ctypes.c_long, u32p]
        for fn in (lib.ntt_forward_rows_u64, lib.ntt_inverse_rows_u64,
                   lib.reduce_residues_u64):
            fn.restype = None
        _lib = lib
    return _lib


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _rows(x: np.ndarray, table: np.ndarray, t: int):
    """A C-contiguous uint64 copy of x [..., n], its rows [R, n], log2(n)
    and the table as contiguous uint64; checks n, the table's length and
    t before any pointer is passed."""
    buf = np.array(x, dtype=np.uint64, order="C", copy=True)
    n = buf.shape[-1]
    table = np.ascontiguousarray(table, dtype=np.uint64)
    if n < 2 or n & (n - 1) or table.shape != (n,) or not 1 < t < 1 << 63:
        raise ValueError(f"host NTT: rows of {n}, table {table.shape}, t = {t}")
    return buf, buf.reshape(-1, n), n.bit_length() - 1, table


def _over_pieces(call, rows: np.ndarray) -> None:
    """call(pointer, count) over contiguous pieces of rows [R, n]: one
    piece, or one a thread when the rows hold THREAD_COEFFS coefficients a
    thread or more."""
    R = rows.shape[0]
    workers = min(os.cpu_count() or 1, rows.size // THREAD_COEFFS, R)
    if workers <= 1:
        call(_u64p(rows), R)
        return
    cuts = np.linspace(0, R, workers + 1).astype(int)
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(lambda ab: call(_u64p(rows[ab[0]:ab[1]]), ab[1] - ab[0]),
                      zip(cuts[:-1], cuts[1:])))


def ntt_forward(x: np.ndarray, tw: np.ndarray, t: int) -> np.ndarray:
    """Forward negacyclic NTT mod t (t < 2**63) of every row of x [..., n]
    (values in [0, t)): standard order in, bit-reversed out, uint64."""
    lib = get_lib()
    buf, rows, logn, tw = _rows(x, tw, t)
    _over_pieces(lambda ptr, count: lib.ntt_forward_rows_u64(
        ptr, count, _u64p(tw), t, logn), rows)
    return buf


def ntt_inverse(x: np.ndarray, itw: np.ndarray, n_inv: int, t: int) -> np.ndarray:
    """Inverse negacyclic NTT mod t, times n^-1, of every row of x [..., n]:
    bit-reversed order in, standard out, uint64."""
    lib = get_lib()
    buf, rows, logn, itw = _rows(x, itw, t)
    _over_pieces(lambda ptr, count: lib.ntt_inverse_rows_u64(
        ptr, count, _u64p(itw), n_inv, t, logn), rows)
    return buf
