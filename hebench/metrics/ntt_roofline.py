"""K1 and K2 (`kernels/ntt.cu`) against their roofline: the frozen least
time of one request's NTT launches, times the traced requests, over the
device time of `ntt_forward_kernel` and `ntt_inverse_kernel` in the
traced sub-window."""


def read(rec):
    t, f = rec["trace"], rec["frozen"]
    if t is None or f is None or not t["family_s"].get("ntt"):
        return None
    return 100.0 * 1e-3 * f["bound_ms"]["ntt"] * t["requests"] / t["family_s"]["ntt"]
