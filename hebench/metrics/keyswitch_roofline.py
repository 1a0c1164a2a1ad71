"""K6 and K7 (`kernels/modmac.cu`, `kernels/bconv.cu`) against their
roofline: the frozen least time of one request's multiply-accumulate and
base-conversion launches, times the traced requests, over the device
time of `mod_mac_kernel` and `fast_bconv_kernel` in the traced
sub-window."""


def read(rec):
    t, f = rec["trace"], rec["frozen"]
    if t is None or f is None:
        return None
    spent = t["family_s"].get("mac", 0.0) + t["family_s"].get("bconv", 0.0)
    least = f["bound_ms"].get("mac", 0.0) + f["bound_ms"].get("bconv", 0.0)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * 1e-3 * least * t["requests"] / spent
