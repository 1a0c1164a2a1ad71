"""The whole request's share of the card's peak: the frozen least time of
one request's hand-kernel launches at the published peaks (`work/`),
times the requests of the traced sub-window, over its wall time."""


def read(rec):
    t, f = rec["trace"], rec["frozen"]
    if t is None or f is None or t["span_s"] <= 0:
        return None
    least_s = 1e-3 * f["bound_ms"]["total"] * t["requests"]
    return 100.0 * least_s / t["span_s"]
