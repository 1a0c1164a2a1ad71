"""Every hand-kernel launch of one request, with its bound.

A copy of the port's `LaunchShapes` (`chip_smoke.py`), changed to keep
every launch and not only each shape once: within `with`, each kernel
module's `_launch` is swapped for a wrapper that adds the launch's least
time (`bounds.py`) to its family, then launches.  It patches the port's
internals, so it runs only in `freeze.py`, never in a timed or traced
run.
"""

from __future__ import annotations

from collections import defaultdict

from . import bounds

# family -> the port's kernel names (`LAUNCHES` keys) and the substrings
# of the CUDA kernels' names in a profiler trace
FAMILIES = {
    "ntt": (("ntt_forward", "ntt_inverse"),
            ("ntt_forward_kernel", "ntt_inverse_kernel")),
    "contract": (("mod_contract",), ("mod_contract_kernel",)),
    "mmntt": (("matmul_ntt_forward", "matmul_ntt_inverse"), ("matmul_ntt_kernel",)),
    "mac": (("mod_mac",), ("mod_mac_kernel",)),
    "bconv": (("fast_bconv",), ("fast_bconv_kernel",)),
}


def _layout(x):
    return None if x is None else (tuple(x.shape), tuple(x.stride()))


class WorkRecorder:
    """`with WorkRecorder() as rec:` ... `rec.families` maps a family to
    {"launches", "bound_ms", "bytes_ms", "ops_ms"}, summed over the
    launches made inside; `rec.unbounded` counts launches of a family
    with no bound here (K5)."""

    def __init__(self):
        self.families = defaultdict(lambda: dict(launches=0, bound_ms=0.0,
                                                 bytes_ms=0.0, ops_ms=0.0))
        self.unbounded = defaultdict(int)

    def _add(self, family: str, b: dict) -> None:
        f = self.families[family]
        f["launches"] += 1
        f["bound_ms"] += b["bound_ms"]
        f["bytes_ms"] += b["bytes_ms"]
        f["ops_ms"] += b["ops_ms"]

    def __enter__(self):
        from cryptonets_tpu_torch.kernels import bconv as K7
        from cryptonets_tpu_torch.kernels import matmul_ntt as K5
        from cryptonets_tpu_torch.kernels import modmac as K6
        from cryptonets_tpu_torch.kernels import modmatmul as K4
        from cryptonets_tpu_torch.kernels import ntt as K

        self._modules = (K, K5, K4, K6, K7)
        self._orig = orig = tuple(m._launch for m in self._modules)

        def ntt_launch(name, x, tab, *tables):
            L, logn = K._check(x, tab)
            rows = x.numel() >> logn
            if rows:
                self._add("ntt", bounds.ntt_bound(rows, 1 << logn, L,
                                                  name == "ntt_inverse"))
            return orig[0](name, x, tab, *tables)

        def mmntt_launch(name, x, tab, *tables):
            self.unbounded["mmntt"] += 1
            return orig[1](name, x, tab, *tables)

        def contract_launch(w, x, q_list):
            M, O = K4._check(w, x, q_list)
            out = orig[2](w, x, q_list)
            if out.numel():
                self._add("contract", bounds.contract_bound(
                    x.numel(), out.numel(), M, O, len(q_list)))
            return out

        def mac_launch(a, b, chain, acc, perm):
            out = orig[3](a, b, chain, acc, perm)
            if out.numel():
                self._add("mac", bounds.mac_bound(
                    _layout(a), [_layout(x) for x in b],
                    [_layout(x) for x in acc],
                    None if perm is None else perm.numel(), a.shape[-2]))
            return out

        def bconv_launch(y, c, chain):
            out = orig[4](y, c, chain)
            if out.numel():
                table = getattr(c, "mont", c)
                self._add("bconv", bounds.bconv_bound(
                    _layout(y), table.numel(), len(chain.moduli)))
            return out

        for m, fn in zip(self._modules, (ntt_launch, mmntt_launch, contract_launch,
                                         mac_launch, bconv_launch)):
            m._launch = fn
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self._modules, self._orig):
            m._launch = fn
