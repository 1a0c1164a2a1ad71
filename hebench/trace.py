"""The traced sub-window: `torch.profiler` over a few steady requests,
reduced to what the per-layer metrics read.

The trace is written to the run's temporary directory, read back and
deleted.  Device activity is every kernel, copy and memset event, cut to the
sub-window's span; busy time is the union of their intervals, so
overlapping streams count once.
An idle gap is labelled by the innermost host event that covers its
middle (a PyTorch operator, a CUDA runtime call or one of the harness's
own spans, `hebench.*`).
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN = "hebench.subwindow"
NAME_CHARS = 100


def events(prof) -> list[dict]:
    """The complete events of a finished profiler's trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.unlink(path)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def _union(intervals) -> list[tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(evs: list[dict], families: dict, top: int = 10) -> dict:
    """What the metrics read from the trace's events: the sub-window's
    span (`SPAN`), its device busy seconds, device seconds by kernel
    family (`families`: family -> substrings of kernel names) and in all,
    and the breakdown: the `top` device operations by time and the
    longest idle time by what the host was doing."""
    span = [e for e in evs if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not span:
        raise RuntimeError(f"the trace has no {SPAN} span")
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])
    dev = []          # (start, end, name) of device events, cut to the span
    for e in evs:
        if e.get("cat") in DEVICE_CATS:
            a = max(float(e["ts"]), t0)
            b = min(float(e["ts"]) + float(e["dur"]), t1)
            if b > a:
                dev.append((a, b, e.get("name", "")))
    busy = _union((a, b) for a, b, _ in dev)
    by_name = defaultdict(float)
    fam = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += b - a
        for f, keys in families.items():
            if any(k in name for k in keys):
                fam[f] += b - a
    hosts = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
                   for e in evs if e.get("cat") in HOST_CATS and e.get("name") != SPAN)
    gaps = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    active, i = [], 0
    for a, b in zip(edges[0::2], edges[1::2]):       # gaps, in time order
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while i < len(hosts) and hosts[i][0] <= mid:
            active.append(hosts[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        label = min(active, key=lambda h: h[1] - h[0])[2] if active else "host"
        gaps[label[:NAME_CHARS]] += (b - a) * 1e-6
    return dict(
        span_s=(t1 - t0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_s=sum(by_name.values()) * 1e-6,
        family_s={f: v * 1e-6 for f, v in fam.items()},
        hand_s=sum(fam.values()) * 1e-6,
        breakdown=dict(
            device_ops=[[n[:NAME_CHARS], v * 1e-6] for n, v in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            idle_gaps=[[n, v] for n, v in
                       sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]),
    )
