"""The port's rotation count (`OPS["rotation"]`, which a graph replay adds
to) over the traced sub-window, per image served there."""


def read(rec):
    t = rec["trace"]
    if t is None or not t["images"]:
        return None
    n = t["counters"].get("op.rotation", 0)
    return n / t["images"] if n else None
