"""What the butterfly NTT kernels (cryptonets_tpu_torch/kernels/ntt.cu)
compile to, and the least time their instructions take to issue.

    python3 scripts/torch_ntt_sass.py [--logn 13] [--rows 448]

Builds `ntt.cu` as the port does (`kernels/build.py`), disassembles the
library with `cuobjdump -sass` and counts the instructions of the forward
and inverse kernel instances for rows of 2**logn, by the unit that runs
them.  The kernels are straight-line code (every loop unrolled, one row a
block), so a row costs each instruction once per thread.  From the counts
and the per-SM rates of compute capability 9.0 (CUDA C++ Programming
Guide, arithmetic instruction throughput: 64 results a clock for 32-bit
integer multiply, and 64 for add, compare, min/max, logic and shift; 128
instructions issued a clock by the four schedulers) it gives, for
`--rows` rows on 132 SMs at 1.98 GHz, the least time the multiplies
alone, the other integer instructions alone and the issue alone take:
the larger of the three is what the kernel as compiled cannot beat.
Needs the CUDA toolkit; writes chiprun_out/torch_ntt_sass_<logn>.json.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SMS, CLOCK_HZ = 132, 1.98e9
UNIT_PER_CLOCK, ISSUE_PER_CLOCK = 64, 128   # per SM, compute capability 9.0
# the unit of each opcode family (the part before the first dot)
UNITS = {
    "integer multiply": ("IMAD", "IMUL"),
    "integer add, min, compare, logic": (
        "IADD3", "IADD", "VIADD", "VIADDMNMX", "VIMNMX", "IMNMX", "ISETP",
        "SEL", "LOP3", "SHF", "LEA", "IABS", "SGXT", "PRMT"),
    "memory": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ULDC"),
    "uniform datapath": ("UMOV", "UIADD3", "ULOP3", "USHF", "UIMAD", "ULEA",
                         "USEL", "UISETP", "S2UR", "R2UR"),
}


def unit_of(op: str) -> str:
    for unit, ops in UNITS.items():
        if op in ops:
            return unit
    return "other"


def count_ops(sass: str, name: str) -> collections.Counter:
    """Opcode families of the function whose mangled name holds `name`."""
    for part in sass.split("Function : ")[1:]:
        if name in part.split("\n", 1)[0]:
            return collections.Counter(
                m.group(1).split(".")[0] for m in re.finditer(
                    r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                    part))
    raise SystemExit(f"no function {name} in the disassembly")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--logn", type=int, default=13)
    ap.add_argument("--rows", type=int, default=448,
                    help="rows of one launch (448: [64, 7, 8192])")
    args = ap.parse_args()
    from torch.utils.cpp_extension import CUDA_HOME

    from cryptonets_tpu_torch.kernels import build as B

    lib = B.build_sources([B.source("ntt.cu")])[B.source("ntt.cu")]
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True).stdout
    logn = args.logn
    r = logn if logn <= 4 else (5 if logn == 15 else 4)   # Plan<LOGN>::R
    threads = 1 << (logn - r)
    result = {"logn": logn, "rows": args.rows, "threads_per_row": threads}
    for kernel in ("ntt_forward_kernel", "ntt_inverse_kernel"):
        ops = count_ops(sass, f"{kernel}ILi{logn}E")
        by_unit = collections.Counter()
        for op, k in ops.items():
            by_unit[unit_of(op)] += k
        total = sum(ops.values())
        per_sm = args.rows * threads / SMS   # rows x threads on one SM
        ms = {f"{unit}_ms": 1e3 * per_sm * by_unit[unit] / UNIT_PER_CLOCK
              / CLOCK_HZ for unit in ("integer multiply",
                                      "integer add, min, compare, logic")}
        ms["issue_ms"] = 1e3 * per_sm * total / ISSUE_PER_CLOCK / CLOCK_HZ
        result[kernel] = dict(
            instructions_per_thread=total, by_unit=dict(by_unit),
            butterflies_per_thread=(1 << r) // 2 * logn,
            top_opcodes=ops.most_common(16), **ms)
        print(f"{kernel}<{logn}>: {total} instructions a thread "
              f"({(1 << r) // 2 * logn} butterflies), by unit "
              f"{dict(by_unit)}; {args.rows} rows on {SMS} SMs, least "
              f"time of each unit and of the issue: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()),
              flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"torch_ntt_sass_{logn}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
