"""Seconds from the harness's start to the end of the warm-up requests:
torch and the card, the traffic's images, the weights, keygen, the
layers' preparation, the kernels' load (or build, in a checkout's first
run) and the graph's capture."""


def read(rec):
    return rec["setup_s"]
