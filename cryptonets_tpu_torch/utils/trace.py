"""Spans, counters and device ranges of the record pipeline.

Three kinds of record, all in one table (`TABLE`, a `Counter` as
`opcount.OPS` is), under prefixed keys:

- `count.<name>`: integer counts that always count (`count`): the slot
  values the host encodes (`host_encoded_slots`) and those a fused record
  hands to the device's slot map (`device_encoded_slots`), a CUDA graph's
  nodes a replay (`graph_nodes`, the event-record nodes of the device
  ranges also apart as `graph_event_nodes`), `graph_captures`,
  `graph_replays`
  (`per_request` reads them: a capture inside a served window is a
  rebuild).
- `span_ms.<name>`, `span_n.<name>`: host milliseconds and entries of a
  span (`span`), while tracing is on.
- `device_ms.<kind>`, `range_ms.<name>`, `range_n.<name>`: device
  milliseconds of the ranges (`device_range`) inside a replayed CUDA
  graph, by kind and by name, while tracing is on.

Tracing is on while `torch.profiler` records, or after `enable()` (an
operator's run without the profiler).  When it is off, `span` and
`device_range` outside a capture return one shared no-op context: a flag
test, no profiler call, no clock read.  A span enters the profiler's
record-function range `cryptonets_tpu_torch.<name>` (the fast form,
`torch._C._profiler._RecordFunctionFast`, whose keyword arguments a trace
taken with `record_shapes=True` shows), so it lies on the trace's own
clock beside the device's work.

A device range entered while `RecordGraph` captures a graph records two
timing events into it (`torch.cuda.Event(enable_timing=True,
external=True)`: event-record nodes), whatever the tracing; after a
replay whose outputs were copied to the host (a synchronise the record
makes anyway), `read_ranges` adds the time between each pair, when
tracing is on.  Outside a capture a device range is a record-function
range while tracing is on.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from collections import Counter

import torch
from torch.autograd import profiler as _profiler

PREFIX = "cryptonets_tpu_torch."
# the kinds of the network's device ranges, which tile a record's device
# work; a TimingLayer's range ("timing") spans layers and is left out
KINDS = ("encrypt", "conv", "dense", "square", "vectorize", "packing", "decrypt")
TABLE: Counter = Counter()
_NULL = contextlib.nullcontext()
_record = torch._C._profiler._RecordFunctionFast
_enabled = False
_ranges: list | None = None     # the ranges of the graph being captured


def enable(flag: bool = True) -> None:
    """Turn tracing on (or off with `flag` False) without the profiler."""
    global _enabled
    _enabled = bool(flag)


def on() -> bool:
    """Whether tracing is on: `enable()`d, or a profiler recording."""
    return _enabled or _profiler._is_profiler_enabled


def count(name: str, n: int = 1) -> None:
    TABLE["count." + name] += n


def snapshot() -> dict:
    """The table as it is, copied."""
    return dict(TABLE)


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.rf = _record(PREFIX + name, (), attrs)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        TABLE["span_ms." + self.name] += 1e3 * (time.perf_counter() - self.t0)
        TABLE["span_n." + self.name] += 1
        self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A host stage `name` (keyword `attrs` go to the trace with it)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, attrs)


class _Captured:
    """A device range inside a graph being captured: its two events."""

    __slots__ = ("name", "kind", "start", "end")

    def __init__(self, name: str, kind: str):
        self.name, self.kind = name, kind
        self.start = torch.cuda.Event(enable_timing=True, external=True)
        self.end = torch.cuda.Event(enable_timing=True, external=True)

    def __enter__(self):
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        _ranges.append(self)
        return False


def device_range(name: str, kind: str | None):
    """The device work of a stretch of the record, `name` of kind `kind`
    (`KINDS`, or "timing"); a layer of no kind (None) takes none."""
    if kind is None:
        return _NULL
    if _ranges is not None:
        return _Captured(name, kind)
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _record(PREFIX + name, (), {"kind": kind})


@contextlib.contextmanager
def capturing():
    """Collect the device ranges entered inside: the list yielded."""
    global _ranges
    _ranges = []
    try:
        yield _ranges
    finally:
        _ranges = None


def read_ranges(ranges) -> None:
    """Add the device ms of each range of the last replay (its events
    completed: the replay's outputs were copied to the host), when tracing
    is on."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    for r in ranges:
        ms = r.start.elapsed_time(r.end)
        TABLE["device_ms." + r.kind] += ms
        TABLE["range_ms." + r.name] += ms
        TABLE["range_n." + r.name] += 1


# CUgraphNodeType (cuda.h)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record", 8: "ext_signal",
              9: "ext_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
              13: "conditional"}


def graph_node_types(raw_graph: int) -> Counter:
    """The nodes of a captured, not yet destroyed CUDA graph
    (`CUDAGraph.raw_cuda_graph()`, a `cudaGraph_t`, which is libcuda's
    `CUgraph`) by type, through libcuda's `cuGraphGetNodes`."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphGetNodes.restype = lib.cuGraphNodeGetType.restype = ctypes.c_int
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    check(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind = ctypes.c_int(0)
    types = Counter()
    for node in nodes:
        check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        types[NODE_TYPES.get(kind.value, str(kind.value))] += 1
    return types


def per_request(delta: dict, requests: int, images: int) -> dict:
    """What a window's table difference `delta` (`snapshot()` after less
    before) reads per request or per image: the host stages' ms a request,
    graph nodes a request and a replay, graph replays a request, the
    graphs captured in the window (0 on a warm served path: more is a
    rebuild), slots the host and the device encoded an image, and device
    ms an image by kind and over the kinds.  A count or kind that did not
    move reads 0."""
    out = {f"{k[len('span_ms.'):]}_ms_per_request": v / requests
           for k, v in delta.items() if k.startswith("span_ms.")}
    replays = delta.get("count.graph_replays", 0)
    out["graph_captures"] = delta.get("count.graph_captures", 0)
    out["graph_replays_per_request"] = replays / requests
    out["graph_nodes_per_request"] = delta.get("count.graph_nodes", 0) / requests
    out["graph_nodes_per_replay"] = (
        delta.get("count.graph_nodes", 0) / replays if replays else 0.0)
    out["graph_event_nodes_per_request"] = (
        delta.get("count.graph_event_nodes", 0) / requests)
    for where in ("host", "device"):
        out[f"{where}_encoded_slots_per_image"] = (
            delta.get(f"count.{where}_encoded_slots", 0) / images)
    for kind in KINDS:
        out[f"{kind}_device_ms_per_image"] = delta.get("device_ms." + kind, 0.0) / images
    out["ranges_device_ms_per_request"] = sum(
        delta.get("device_ms." + kind, 0.0) for kind in KINDS) / requests
    return out
