"""The port's hand-written CUDA kernels.  `LAUNCH_TABLES`: every kernel
module's launch counts (`LAUNCHES`, kernel name -> launches), the one list
that the record graph's counts and the smoke run's kernel checks read."""

from . import bconv, matmul_ntt, modmac, modmatmul, ntt, slotmap

LAUNCH_TABLES = (ntt.LAUNCHES, modmatmul.LAUNCHES, matmul_ntt.LAUNCHES,
                 modmac.LAUNCHES, bconv.LAUNCHES, slotmap.LAUNCHES)
