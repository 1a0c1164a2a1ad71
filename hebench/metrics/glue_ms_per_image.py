"""Device milliseconds of everything that is not one of the port's hand
kernels (PyTorch's elementwise kernels, copies, memcpy, memset) in the
traced sub-window, per image served there."""


def read(rec):
    t = rec["trace"]
    if t is None or not t["images"]:
        return None
    return 1e3 * (t["device_s"] - t["hand_s"]) / t["images"]
