"""The port's tracing (`cryptonets_tpu_torch/utils/trace.py`): spans,
counters and device ranges of the record pipeline.

On the CPU, on the tiny LoLa of `parallel/dryrun.py` (n = 256) with one
torch thread: tracing off costs no profiler call and leaves the table as
it is; under `torch.profiler` the pipeline's spans and ranges lie inside
the record's span, which carries the record's number; the host slot
encode counts P x rows x n, and an eager record and a record batch count
their device slots and no host slots; what `trace.per_request` reads of a
window's table (graph replays, captures and nodes among it, host and
device slots); the layer kinds of LoLa and CryptoNets.

The `cuda`-marked cases need the card (a graph cannot be captured on the
CPU) and run there with `python -m pytest --noconftest
tests/test_torch_trace.py -q -m cuda`: logits bit-equal with and without
the ranges' event nodes, the graph's node count against one replay's
device operations and a warm window's replays and captures, a warm
window's slots encoded on the device and none on the host, the ranges'
device time against the replay's device span and busy time, and the
TimingLayer's "Batch-Time"."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu_torch.nn.forward import (  # noqa: E402
    EncryptedForward, evaluation_forward, split_at_encrypt)
from cryptonets_tpu_torch.parallel import dryrun  # noqa: E402
from cryptonets_tpu_torch.utils import trace  # noqa: E402

STAGES = ("reader", "slot_buffers", "encrypt", "0.LLPoolLayer",
          "1.LLVectorizeLayer", "2.SquareActivation", "3.LLDenseLayer", "decrypt")


@pytest.fixture
def tiny():
    torch.set_num_threads(1)
    head, fac, reader = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    reader.set_source_records(dryrun.records_for(4, seed=31))
    head.prepare_network()
    return EncryptedForward(head), fac


def test_tracing_off_calls_no_profiler_and_leaves_the_table(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record-function range was entered")

    monkeypatch.setattr(trace, "_record", refuse)
    trace.enable(False)
    before = trace.snapshot()
    ctx = trace.span("reader", seq=3)
    assert ctx is trace.span("slot_buffers") is trace.device_range("0.L", "conv")
    with ctx:
        pass
    with trace.device_range("decrypt", "decrypt"):
        pass
    trace.read_ranges([object()])            # nothing read while off
    assert trace.snapshot() == before


def test_enabled_span_adds_its_ms_and_entries():
    trace.enable()
    try:
        before = trace.snapshot()
        for _ in range(3):
            with trace.span("unit_test_stage"):
                pass
    finally:
        trace.enable(False)
    after = trace.snapshot()
    assert after["span_n.unit_test_stage"] - before.get("span_n.unit_test_stage", 0) == 3
    assert after["span_ms.unit_test_stage"] > before.get("span_ms.unit_test_stage", 0)


def test_pipeline_spans_nest_in_the_record(tiny, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    fwd, _ = tiny
    fwd()                                        # the lazy forms made
    before = trace.snapshot()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fwd()
        out.vectors[0].decrypt_full_precision()
    assert not trace.on()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X" and e.get("name", "").startswith(trace.PREFIX)]
    by = {e["name"][len(trace.PREFIX):]: e for e in evs}
    rec = by["record"]
    assert rec["args"]["seq"] == fwd.records == 2
    t0, t1 = rec["ts"], rec["ts"] + rec["dur"]
    for name in STAGES:
        e = by[name]
        assert t0 <= e["ts"] and e["ts"] + e["dur"] <= t1, name
    kinds = {by[n]["args"]["kind"] for n in STAGES[2:]}
    assert kinds == {"encrypt", "conv", "vectorize", "square", "dense", "decrypt"}
    assert "join" in by                          # the vector's decrypt
    delta = {k: v - before.get(k, 0) for k, v in trace.snapshot().items()}
    for name in ("record", "reader", "slot_buffers", "join"):
        assert delta[f"span_n.{name}"] == 1 and delta[f"span_ms.{name}"] > 0
    # eager layers are profiler ranges only: no device ms without a graph
    assert not any(k.startswith(("device_ms.", "range_")) and v for k, v in delta.items())


@pytest.mark.parametrize("path", ["device_bufs", "host_encode"])
def test_host_encoded_slots_count_p_rows_n(tiny, path):
    _, fac = tiny
    rows = 3
    ints = np.arange(rows * fac.n, dtype=np.int64).reshape(rows, fac.n) - 7
    before = trace.TABLE["count.host_encoded_slots"]
    if path == "device_bufs":
        fac.encode_bufs(ints)
    else:
        fac._encode_slotsets_np(ints)
    assert trace.TABLE["count.host_encoded_slots"] - before == fac.P * rows * fac.n


def test_a_record_counts_its_slot_buffers(tiny):
    """An eager record hands its values to the record body's slot map:
    P x V x C x n device slots, no host slots."""
    fwd, fac = tiny
    _, (V, C, _, _) = fwd.slot_values(fwd.reader.get_next())
    before = trace.snapshot()
    fwd()
    delta = {k: v - before.get(k, 0) for k, v in trace.snapshot().items()}
    assert delta.get("count.host_encoded_slots", 0) == 0
    assert delta["count.device_encoded_slots"] == fac.P * V * C * fac.n


def test_per_request_reads_replays_captures_and_a_true_zero():
    delta = {"count.graph_nodes": 6000, "count.graph_event_nodes": 32,
             "count.graph_replays": 2, "count.graph_captures": 1,
             "span_ms.reader": 8.0, "device_ms.square": 3.0, "device_ms.dense": 5.0}
    read = trace.per_request(delta, 4, 8)
    assert read["graph_replays_per_request"] == 0.5
    assert read["graph_nodes_per_request"] == 1500 and read["graph_nodes_per_replay"] == 3000
    assert read["graph_event_nodes_per_request"] == 8
    assert read["graph_captures"] == 1                  # a rebuild in the window
    assert read["reader_ms_per_request"] == 2.0
    assert read["square_device_ms_per_image"] == 0.375
    assert read["ranges_device_ms_per_request"] == 2.0
    # an eager window: no replay, no capture, no host encode; each reads 0
    read = trace.per_request({"span_ms.record": 4.0}, 2, 2)
    assert read["graph_nodes_per_replay"] == read["graph_captures"] == 0
    assert read["host_encoded_slots_per_image"] == read["conv_device_ms_per_image"] == 0


def test_per_request_reads_the_bsgs_ranges_apart():
    """A BSGS layer's `babies` and `giants` lie inside its `dense` range:
    read by image, never added to the ranges' sum."""
    delta = {"device_ms.dense": 10.0, "device_ms.babies": 1.0,
             "device_ms.giants": 8.0, "device_ms.square": 2.0}
    read = trace.per_request(delta, 2, 2)
    assert read["babies_device_ms_per_image"] == 0.5
    assert read["giants_device_ms_per_image"] == 4.0
    assert read["ranges_device_ms_per_request"] == 6.0


def test_per_request_reads_host_and_device_encoded_slots():
    delta = {"count.device_encoded_slots": 4 * 819200, "count.graph_replays": 4}
    read = trace.per_request(delta, 4, 4)
    assert read["device_encoded_slots_per_image"] == 819200
    assert read["host_encoded_slots_per_image"] == 0
    read = trace.per_request({"count.host_encoded_slots": 6 * 2352,
                              "count.device_encoded_slots": 3 * 8192 * 2352}, 3, 3 * 8192)
    assert read["host_encoded_slots_per_image"] == 6 * 2352 / (3 * 8192)
    assert read["device_encoded_slots_per_image"] == 2352


def test_a_record_batch_counts_device_slots_not_host(tiny):
    """The batch body takes the reader's values and slot-maps them on its
    device (here the CPU twin): P x records x V x C x n device slots, no
    host slots."""
    fwd, fac = tiny
    raws = [fwd.reader.get_next() for _ in range(2)]
    _, (V, C, _, _) = fwd.slot_values(raws[0])
    before = trace.snapshot()
    fwd.run_batch(raws)
    delta = {k: v - before.get(k, 0) for k, v in trace.snapshot().items()}
    assert delta.get("count.host_encoded_slots", 0) == 0
    assert delta["count.device_encoded_slots"] == fac.P * 2 * V * C * fac.n


def _kinds(head):
    return [layer.kind for layer in split_at_encrypt(head)[1]]


def test_layer_kinds_of_the_benchmark_networks():
    from cryptonets_tpu_torch.models import cryptonets_mnist
    from cryptonets_tpu_torch.models.lola_mnist import build_lola_bsgs

    assert _kinds(build_lola_bsgs(False)[0]) == [
        "conv", "vectorize", "square", "dense", "square", "dense"]
    assert _kinds(cryptonets_mnist.build(False)[0]) == [
        None, "conv", "square", "dense", "square", "dense", None]


# ------------------------------------------------------------- on the card
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU counterpart")


@pytest.fixture(scope="module")
def lola_cuda():
    """Full-width LoLa on the card, served as one graph replay a record,
    with and without the ranges' event nodes (two forwards of one
    network)."""
    _needs_cuda()
    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.models.lola_mnist import build_lola_bsgs

    head, fac, reader = build_lola_bsgs(True, device="cuda", seed=3)
    head.prepare_network()
    images = synthetic_mnist_records(6, seed=5)
    fwds = {}
    for ranges in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not ranges:                        # a capture without the events
                mp.setattr(trace, "device_range", lambda name, kind: trace._NULL)
            fwd = evaluation_forward(head, graph=True)
            reader.set_source_records(images[:1])
            fwd()                                 # captures, replays
        fwds[ranges] = fwd
    return fwds, reader, images


def _graph(fwd):
    (g,) = fwd.graphs().values()
    return g


def _logits(fwd, reader, images):
    reader.set_source_records(images)
    outs = [fwd() for _ in images]
    return [np.stack([v.decrypt_full_precision() for v in o.vectors]) for o in outs]


@pytest.mark.cuda
def test_event_nodes_leave_logits_bit_equal(lola_cuda):
    fwds, reader, images = lola_cuda
    with_r, without = (_logits(fwds[r], reader, images) for r in (True, False))
    for a, b in zip(with_r, without):
        assert a.dtype == object and np.array_equal(a, b)
    g, h = _graph(fwds[True]), _graph(fwds[False])
    layers = fwds[True].layers
    ranged = sum(layer.kind is not None for layer in layers)
    # each BSGS dense layer holds two ranges of its own, babies and giants
    bsgs = sum(getattr(layer, "bsgs_form", None) is not None for layer in layers)
    assert bsgs == 2
    events = 2 * (ranged + 2 + 2 * bsgs)
    assert g.nodes["event_record"] == events
    assert h.nodes["event_record"] == 0
    assert g.nodes.total() - h.nodes.total() == events


def _replay_trace(g):
    """One bare replay of `g` under the profiler: (the trace's events, the
    ranges' device ms of that replay)."""
    from torch.profiler import ProfilerActivity, profile

    from hebench import trace as htrace

    torch.cuda.synchronize()
    before = trace.snapshot()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(htrace.SPAN):
            g.graph.replay()
            torch.cuda.synchronize()
        g.read_ranges()
    after = trace.snapshot()
    ms = sum(after.get(f"device_ms.{k}", 0) - before.get(f"device_ms.{k}", 0)
             for k in trace.KINDS)
    return htrace.events(prof), ms


@pytest.mark.cuda
def test_graph_nodes_are_a_replays_device_operations_and_events(lola_cuda):
    """`count.graph_nodes` adds the graph's nodes at each replay, and they
    are the device operations of the replay's `cudaGraphLaunch` (those
    with its correlation id) and the ranges' event nodes.  The replay's
    other operations, the generator state's fills before the launch, are
    not the graph's."""
    fwds, reader, images = lola_cuda
    g = _graph(fwds[True])
    before = trace.snapshot()
    _logits(fwds[True], reader, images[:2])
    read = trace.per_request(
        {k: v - before.get(k, 0) for k, v in trace.snapshot().items()}, 2, 2)
    assert read["graph_nodes_per_request"] == read["graph_nodes_per_replay"] == g.nodes.total()
    assert read["graph_replays_per_request"] == 1 and read["graph_captures"] == 0
    evs = _replay_trace(g)[0]
    (launch,) = [e["args"]["correlation"] for e in evs if e.get("name") == "cudaGraphLaunch"]
    ops = [e for e in evs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    mine = [e for e in ops if e["args"].get("correlation") == launch]
    others = sorted(e["name"][:60] for e in ops if e["args"].get("correlation") != launch)
    assert len(mine) + g.nodes["event_record"] == g.nodes.total(), (dict(g.nodes), others)


@pytest.mark.cuda
def test_warm_window_encodes_on_the_device(lola_cuda):
    """A warm LoLa window: the slot buffers are made by the slot map inside
    the replay, 819,200 device slots an image (4 primes x 25 columns x
    8192), none on the host, one slot-map launch a record."""
    from cryptonets_tpu_torch.kernels import slotmap

    fwds, reader, images = lola_cuda
    before, launches = trace.snapshot(), slotmap.LAUNCHES["slot_map"]
    _logits(fwds[True], reader, images[:3])
    read = trace.per_request(
        {k: v - before.get(k, 0) for k, v in trace.snapshot().items()}, 3, 3)
    assert read["host_encoded_slots_per_image"] == 0
    assert read["device_encoded_slots_per_image"] == 819200
    assert read["graph_captures"] == 0
    assert slotmap.LAUNCHES["slot_map"] - launches == 3


@pytest.mark.cuda
def test_ranges_tile_the_replays_device_span(lola_cuda):
    """The ranges' device ms of a replay lie within 5 % of the replay's
    device span (its first operation's start to its last one's end), and
    above its busy time (the union of its operations): a range counts the
    gaps between the graph's nodes, which busy time does not."""
    from hebench import trace as htrace

    fwds, _, _ = lola_cuda
    evs, ranges = _replay_trace(_graph(fwds[True]))
    ops = [e for e in evs if e.get("cat") in htrace.DEVICE_CATS]
    span = 1e-3 * (max(e["ts"] + e["dur"] for e in ops) - min(e["ts"] for e in ops))
    busy = 1e3 * htrace.reduce(evs, {})["busy_s"]
    assert busy < ranges and abs(ranges - span) <= 0.05 * span, (ranges, span, busy)


@pytest.mark.cuda
def test_timing_layer_gives_the_layers_device_ms():
    _needs_cuda()
    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.models import cryptonets_mnist
    from cryptonets_tpu_torch.nn.layers import TimingLayer

    batch = 64
    head, fac, reader = cryptonets_mnist.build(True, batch, device="cuda", seed=3)
    head.prepare_network()
    fwd = evaluation_forward(head, graph=True)
    reader.set_source_records(synthetic_mnist_records(3 * batch, seed=7))
    fwd()
    TimingLayer.reset()
    trace.enable()
    try:
        before = trace.snapshot()
        fwd()
        fwd()
        delta = {k: v - before.get(k, 0) for k, v in trace.snapshot().items()}
    finally:
        trace.enable(False)
    name, ms = TimingLayer.get_stats().split()
    assert name == "Batch-Time"
    layers = sum(v for k, v in delta.items() if k.startswith("range_ms.")
                 and k[len("range_ms."):][0].isdigit()) / 2
    assert delta["range_n.Batch-Time"] == 2
    assert 0.95 * layers <= float(ms) <= 1.05 * layers + 0.01
