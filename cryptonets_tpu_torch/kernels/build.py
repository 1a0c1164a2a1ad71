"""Build of the hand-written CUDA sources of this package.

Each `*.cu` here has a plain C interface and includes no PyTorch header:
`nvcc` compiles it for `sm_90a` into a shared library under `_build/`
(named by a hash of the flags, the source and the local headers it
includes, so a changed source or header is rebuilt and an unchanged one
is reused), and the binding module loads it
with ctypes.  `build_sources` starts one `nvcc` per missing library, all
at once, and waits for them; a failed build raises.  Nothing is built
when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17")
# wall seconds of every nvcc run of this process, by source file name
BUILD_SECONDS: dict[str, float] = {}


def source(name: str) -> Path:
    """Path of the CUDA source `name` (e.g. "ntt.cu") of this package."""
    return Path(__file__).with_name(name)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: cannot build the kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path(src: Path) -> Path:
    """The library of `src`, named by a hash of the flags, the source and
    the local headers it includes (`#include "x.cuh"`), so a changed
    header rebuilds every source that includes it."""
    text = src.read_bytes()
    tag = hashlib.sha256(repr(NVCC_FLAGS).encode() + text)
    for name in re.findall(rb'^#include "([^"]+)"', text, re.M):
        tag.update((src.parent / name.decode()).read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{tag.hexdigest()[:16]}.so"


def build_sources(srcs) -> dict[Path, Path]:
    """Compile every source whose library is missing, in parallel (one
    `nvcc` each); returns {source: library}."""
    out = {Path(s): library_path(Path(s)) for s in srcs}
    running = []
    for src, so in out.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, so, tmp, proc, time.perf_counter()))
    failures = []
    for src, so, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        BUILD_SECONDS[src.name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name} "
                            f"({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load_library(src: Path) -> ctypes.CDLL:
    """The library of one source, built first if it is missing."""
    return ctypes.CDLL(str(build_sources([src])[Path(src)]))
