"""The diagonal plaintext forms the BSGS dense layers encode on the card
(`OPS["bsgs_diagonal_form"]`: P x g x F for each giant chunk encoded,
which a graph replay adds to) over the traced sub-window, per image
served there.  A change that keeps encoded diagonals resident trades it
for `peak_mem_gib`."""


def read(rec):
    t = rec["trace"]
    if t is None or not t["images"]:
        return None
    n = t["counters"].get("op.bsgs_diagonal_form", 0)
    return n / t["images"] if n else None
