"""Images of every request completed in the window, over the window (its
start to the end of its last request), on the host clock."""


def read(rec):
    return rec["images"] / rec["window_s"]
