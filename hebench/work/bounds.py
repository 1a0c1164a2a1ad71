"""The yardstick of the rooflines and of `step_mfu`: the card's peaks and
the least time each hand kernel's launch could take on it.

Copied from the port's measuring script (`chip_smoke.py`: the peaks,
`ntt_bound`, `modmat_bound`, `fused_bound` and the byte counts of its K4,
K6 and K7 cases), so that the benchmark keeps its own copy whatever later
changes there.  A bound is the larger of two times: the bytes that the
function must move (each input element read once, each output written
once) at the HBM rate, and the operations that it must do at the rate of
the unit that does them.
"""

from __future__ import annotations

import math

# H100 SXM data sheet: HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiplies (IMAD, IMAD.HI): derived, not published: 64 an
# SM a clock at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput) x 132 SMs x the H100 SXM's 1.98 GHz
# boost clock; one multiply counts as one operation
INT32_MUL_PER_S = 132 * 64 * 1.98e9
# H100 SXM data sheet: dense int8 tensor-core operations
INT8_TENSOR_OPS_PER_S = 1.979e15


def _bound(t_bytes: float, t_ops: float) -> dict:
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops)


def ntt_bound(rows: int, n: int, L: int, inverse: bool) -> dict:
    """K1 (forward) or K2 (inverse): `rows` butterfly NTTs of length n over
    L limbs.  Bytes: the data read and written once, each limb's twiddle
    tables (twiddles and Shoup companions, and for the inverse n^-1 and
    its companion) and the moduli once.  Operations: one 32 x 32 -> 64 bit
    product (two 32-bit multiplies) a butterfly, and for the inverse a
    row's n products by n^-1."""
    logn = int(math.log2(n))
    nbytes = 2 * rows * n * 4 + 2 * L * n * 4 + L * 4 + (8 * L if inverse else 0)
    products = rows * (n // 2) * logn + (rows * n if inverse else 0)
    return _bound(nbytes / HBM_BYTES_PER_S, 2 * products / INT32_MUL_PER_S)


def modmat_bound(terms: int, nbytes: int) -> dict:
    """K4: an exact matrix product modulo 31-bit primes with `terms`
    multiply-adds moving `nbytes`: one 32 x 32 -> 64 bit product (two
    32-bit multiplies) a term on the integer pipe, or 16 plane pairs of
    8-bit digits a term (a multiply and an add each) on the int8 tensor
    cores, whichever is faster."""
    t_int32 = 2 * terms / INT32_MUL_PER_S
    t_int8 = 16 * 2 * terms / INT8_TENSOR_OPS_PER_S
    return _bound(nbytes / HBM_BYTES_PER_S, min(t_int32, t_int8))


def contract_bound(x_numel: int, out_numel: int, M: int, O: int, limbs: int) -> dict:
    """K4 at one launch: input [P, O, C, s, k, N] read once, output [P, M,
    ...] written once, the weights [M, O] once a limb; out_numel * O
    terms."""
    nbytes = 4 * (x_numel + out_numel) + 4 * M * O * limbs
    return modmat_bound(out_numel * O, nbytes)


def fused_bound(nbytes: int, products: int, outputs: int) -> dict:
    """K6 or K7: a sum of `products` modular products into `outputs`
    residues moving `nbytes`; one product (two 32-bit multiplies) a term
    and one reduction (two) an output on the integer pipe."""
    return _bound(nbytes / HBM_BYTES_PER_S,
                  2 * (products + outputs) / INT32_MUL_PER_S)


def distinct(shape, stride) -> int:
    """Elements a view reads once each: its sizes over the dims whose
    stride is not 0 (a broadcast dim reads the same elements again)."""
    return math.prod(s for s, st in zip(shape, stride) if st != 0)


def mac_bound(a_layout, b_layouts, acc_layouts, perm_numel: int | None,
              limbs: int) -> dict:
    """K6 at one launch from its operands' (shape, stride) layouts: a [J,
    R1, RA, RB, L, N], b C keys [Z, ...], optional accumulators, an
    optional int32 gather index; outputs Z R1 RA RB C L N, J terms each."""
    J, R1, RA, RB, L, N = a_layout[0]
    Z, C = b_layouts[0][0][0], len(b_layouts)
    outputs = Z * R1 * RA * RB * C * L * N
    nbytes = 4 * (distinct(*a_layout) + sum(distinct(*x) for x in b_layouts)
                  + sum(distinct(*x) for x in acc_layouts if x is not None)
                  + outputs + 4 * limbs)
    nbytes += 0 if perm_numel is None else 4 * perm_numel
    return fused_bound(nbytes, outputs * J, outputs)


def bconv_bound(y_layout, table_numel: int, targets: int) -> dict:
    """K7 at one launch: y [RA, RB, Lf, N] (read once) to `targets`
    moduli, with its [Lf, Lt] table; outputs RA RB Lt N, Lf terms each."""
    RA, RB, Lf, N = y_layout[0]
    outputs = RA * RB * targets * N
    nbytes = 4 * (distinct(*y_layout) + outputs + 4 * targets + table_numel)
    return fused_bound(nbytes, outputs * Lf, outputs)
