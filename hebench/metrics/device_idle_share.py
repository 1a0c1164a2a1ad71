"""Share of the traced sub-window in which no kernel, copy or memset ran
on the device (the union of their intervals in the profiler's trace)."""


def read(rec):
    t = rec["trace"]
    if t is None or t["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
