"""The port's hand-kernel launches (the sum of every kernel module's
`LAUNCHES`, which a graph replay adds to) over the traced sub-window, per
image served there."""


def read(rec):
    t = rec["trace"]
    if t is None or not t["images"]:
        return None
    n = sum(v for k, v in t["counters"].items() if k.startswith("launch."))
    return n / t["images"] if n else None
