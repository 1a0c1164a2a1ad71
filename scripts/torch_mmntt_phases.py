"""Where a block of the four-step NTT kernel (K5,
cryptonets_tpu_torch/kernels/matmul_ntt.cu) spends its time, phase by
phase, on one GPU.

    python3 scripts/torch_mmntt_phases.py [--shapes 64,7,8192 6,1,102,1,3,4096]

Copies `matmul_ntt.cu` with a `clock64()` stamp, taken by thread 0 of
every block, at each phase boundary of a row: the copies of the DFT
planes issued, the row split into planes, the wait for the copies, the
first product, the twiddles, the second split, the second product and the
stores.  Builds the copy as `kernels/build.py` builds the kernels (into
`kernels/_build/`), runs the forward and inverse kernels on random
residues of 31-bit primes at each shape, holds their outputs bit-equal
to the plain versions, and prints per direction the median over blocks
of each phase's SM cycles, the median block total and the launch's time
(CUDA events over 20 back-to-back launches of the stamped build).  Writes
the same to chiprun_out/torch_mmntt_phases.json.  Needs the CUDA toolkit
and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("issue plane copies", "split the row", "wait for the copies",
          "first product", "twiddles", "second split", "second product",
          "store")
# the stamp k goes in front of the k-th anchor; the last one ends the row
ANCHORS = (
    "  const Mod md = load_mod(limbs + 2 * limb);",
    "  run_row<LOGN, INV>(x + row * R::N",
    "  copy_wait();\n  fence_async_shared();\n  __syncthreads();\n",
    "  // warpgroup g: rows a from",
    "  // times tw' (forward) or twi' (inverse)",
    "  __syncthreads();  // every warpgroup's products",
    "  if constexpr (!INV)  // . Wb",
    "  each_pair<LOGN>(g, warp, lane, [&](int ch, int e, int a, int c) {\n"
    "    *reinterpret_cast<uint2*>(dst",
)
MAX_BLOCKS = 1 << 14
STAMPS = 16


def stamped_source(src: str, header: str) -> str:
    for k, anchor in enumerate(ANCHORS):
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor {k} not found once in matmul_ntt.cu: "
                             "update ANCHORS with the kernel")
        src = src.replace(anchor, f"  STAMP({k});\n" + anchor)
    end = "        make_uint2(r[ch][e], r[ch][e + 1]);\n  });\n}\n"
    if src.count(end) != 1:
        raise SystemExit("the end of run_row not found: update the script")
    src = src.replace(end, end[:-2] + f"  STAMP({len(ANCHORS)});\n}}\n")
    return src.replace('#include "u8mma.cuh"', f'''#include "{header}"
__device__ long long g_stamps[{MAX_BLOCKS} * {STAMPS}];
#define STAMP(k) if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) \\
  g_stamps[blockIdx.x * {STAMPS} + (k)] = clock64();
extern "C" int phase_stamps(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}}''')


def build_stamped():
    from cryptonets_tpu_torch.kernels import build as B

    src = B.source("matmul_ntt.cu")
    text = stamped_source(src.read_text(), str(B.source("u8mma.cuh")))
    B.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = B.BUILD_DIR / "matmul_ntt_phases.cu"
    so = B.BUILD_DIR / "libmatmul_ntt_phases.so"
    cu.write_text(text)
    subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in (lib.matmul_ntt_forward, lib.matmul_ntt_inverse):
        fn.argtypes = [ptr] * 6 + [ll, i, i, i, ptr]
        fn.restype = i
    lib.phase_stamps.argtypes = [ptr]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+",
                    default=["64,7,8192", "3,2,10,1,7,8192", "6,1,102,1,3,4096"],
                    help="launch shapes [..., L, N], comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mmntt_phases: CUDA is not available", file=sys.stderr)
        return 1
    from cryptonets_tpu_torch.crypto.ntt import ntt_context_for
    from cryptonets_tpu_torch.crypto.primes import ntt_primes
    from cryptonets_tpu_torch.kernels import matmul_ntt as M

    lib = build_stamped()
    gen = torch.Generator(device="cuda").manual_seed(3)
    result = {"card": torch.cuda.get_device_name(0), "phases": PHASES,
              "shapes": []}
    for text in args.shapes:
        shape = tuple(int(v) for v in text.split(","))
        n, L = shape[-1], shape[-2]
        tab = ntt_context_for("matmul", n, ntt_primes(n, 31, L)).tables("cuda")
        x = (torch.randint(0, 1 << 31, shape, generator=gen, device="cuda")
             % tab.q.long()).to(torch.int32)
        rows = x.numel() // n
        N1, N2 = M.split4(n)
        for name, plain, tables in (
                ("forward", M.matmul_ntt_forward_plain,
                 (tab.wa_planes, tab.tw_fold, tab.wb_planes)),
                ("inverse", M.matmul_ntt_inverse_plain,
                 (tab.wai_planes, tab.twi_fold, tab.wbi_planes))):
            fn = getattr(lib, f"matmul_ntt_{name}")
            y = torch.empty_like(x)

            def call():
                err = fn(x.data_ptr(), y.data_ptr(), tab.limbs.data_ptr(),
                         *[t.data_ptr() for t in tables], rows, L, N1, N2,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"launch failed: {err}")

            call()
            torch.cuda.synchronize()
            if not torch.equal(y, plain(x, tab)):
                raise SystemExit(f"stamped {name} kernel disagrees at {shape}")
            stamps = np.zeros(MAX_BLOCKS * STAMPS, np.int64)
            lib.phase_stamps(stamps.ctypes.data)
            stamps = stamps.reshape(MAX_BLOCKS, STAMPS)[:min(rows, MAX_BLOCKS),
                                                        :len(ANCHORS) + 1]
            cycles = np.diff(stamps, axis=1)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                call()
            b.record()
            b.synchronize()
            entry = dict(shape=list(shape), direction=name,
                         events_ms=a.elapsed_time(b) / 20,
                         block_cycles=float(np.median(stamps[:, -1] - stamps[:, 0])),
                         phase_cycles=dict(zip(PHASES, np.median(cycles, axis=0).tolist())))
            result["shapes"].append(entry)
            print(json.dumps(entry))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "torch_mmntt_phases.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
