"""The device memory the process held from the card over the window:
`torch.cuda.max_memory_reserved` after set-up's freed blocks went back
to the card and a reset at the window's start, in GiB.  It counts the
keys, the layers' prepared forms and the CUDA graph's private pool whole
(the pool's blocks are reserved, not allocated, between replays)."""


def read(rec):
    return rec["window_peak_bytes"] / 2**30
