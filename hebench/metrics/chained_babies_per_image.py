"""The baby steps the BSGS dense layers take as a chain of single-step
rotations (`OPS["baby_rotation_chained"]`: F x (g - 1) a layer whose
babies cannot be hoisted, which a graph replay adds to) over the traced
sub-window, per image served there.  Hoisted babies count apart
(`baby_rotation_hoisted`)."""


def read(rec):
    t = rec["trace"]
    if t is None or not t["images"]:
        return None
    n = t["counters"].get("op.baby_rotation_chained", 0)
    return n / t["images"] if n else None
