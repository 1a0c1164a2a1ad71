"""The record pipeline of an encrypted network, port of `EncryptedForward`
(`cryptonets_tpu/nn/jit.py`).

One call pulls a record (LoLa: one image; CryptoNets: a batch of images
in the SIMD slots) from the reader and runs one record body on the
factory's device.  Where the factory encodes and decodes on the device
(`CrtBfvFactory.encodes_on_device`), the host hands over the reader's
values and the body (`record_fn`) does the rest: the `slot_map` kernel
makes the slot buffers (each plain prime's residues, index-mapped), then
slot encode + RLWE encrypt of every input column, every layer above the
EncryptLayer, gamma decrypt + slot decode of every output column; the
host takes back the decoded slots and CRT-joins them.  A factory whose
plain primes do not fit the device encode and decode (LoLaDense's and the
big-t presets' primes) takes the reference's other path: slot encode on
the host (C++ NTT, per-limb residues) and encrypt on the device, a body
of the layers, then the factory's decrypt (the two-plane device decrypt
with the host join and the C++ slot decode).

`graph=True` is the counterpart of the reference's `jit=True`: where the
reference compiles one XLA program, the body runs as one CUDA graph,
captured once per signature and replayed (`RecordGraph`); without it the
same body runs directly.  `run_batch` is the counterpart of `bench.py`'s
`BENCH_VMAP` record batch: B records' columns slot-mapped and encrypted in
one pass, the layers under `torch.func.vmap` over the record axis (each
kernel folds the records into its rows, `kernels/batching.py`), every
output decrypted and decoded in one pass; under `graph=True` one replay
for B records.  One routine (`_run`) serves the record, the layers-only
record and the batch.  Whether a signature is captured is decided after
the warm-up and before the capture: the pool the capture is reckoned to
take (the warm-up's peak over the memory allocated before it) against the
card's free memory (`GRAPH_FREE_SHARE`).  The decision is printed; a
signature that does not fit runs its body directly from then on (the
warm-up was its first record), which is how the big-t presets' multi-GiB
records are guarded.  Nothing else falls back: a graph on a CPU factory,
a capture that starts and fails, and a batch on a factory that encodes on
the host raise.

A graph's operation and kernel counts (`utils/opcount.OPS`, each
kernel's `LAUNCHES`) are taken at capture and added at every replay, as
the reference's `hoist_jit` replays its trace-time counts: a replayed
record counts what a direct record counts, and the warm-up and capture
count nothing.  Under vmap the layers count once for the B records; the
batch adds the other B - 1 records' operation counts, while `LAUNCHES`
keep the launches that ran (one for the B records).

Tracing (`utils/trace.py`): a record is the span `record` (its sequence
number an argument), and inside it the spans `reader`, `slot_buffers`
(the values handed over; `slot_encode` too where the host encodes),
`upload`, `replay`, `output` and, in the vector's decrypt, `join`.  A
record whose values go to the device encode counts its slots there
(`count.device_encoded_slots`: P x rows x n) when they are handed over.
Encrypt, every layer of a kind (`Layer.kind`) and decrypt with decode are
device ranges, named `encrypt`, `<position>.<class>`, `decrypt`: inside a
graph's capture their events become nodes of the graph, read after the
replay's outputs reached the host.  A capture counts the graph's nodes
from the graph itself (`trace.graph_node_types`), and every replay adds
them to `count.graph_nodes`, as it adds its operation and launch counts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..api.matrix import HEMatrix
from ..api.vector import HEVector
from ..kernels import LAUNCH_TABLES, slotmap
from ..utils import trace
from ..utils.opcount import OPS
from .layers import EncryptLayer
from .network import Layer

# a capture goes ahead when its reckoned pool is at most this share of the
# card's free memory (the allocator's cache emptied), else the record runs
# eagerly: a capture that runs out of memory half-way fails the run.  The
# pools the big-t presets' captures took were 1.38-1.68 times the reckoning
# on an H100 (PERF.md §6), hence the half
GRAPH_FREE_SHARE = 0.5


def split_at_encrypt(head: Layer):
    """Walk source links from `head` down to the EncryptLayer; returns
    (encrypt_layer, [layers above it, in application order])."""
    chain = []
    p = head
    while p is not None and not isinstance(p, EncryptLayer):
        chain.append(p)
        p = p.source
    if p is None:
        raise ValueError("no EncryptLayer in network")
    return p, list(reversed(chain))


def _counts() -> tuple[dict, list[dict]]:
    """The operation counts and every kernel's launch counts, copied."""
    return OPS.snapshot(), [dict(t) for t in LAUNCH_TABLES]


def _restore(counts) -> None:
    ops, launches = counts
    OPS.counters.clear()
    OPS.counters.update(ops)
    for table, saved in zip(LAUNCH_TABLES, launches):
        table.update(saved)


def _difference(after, before) -> tuple[dict, list[dict]]:
    ops = {k: v - before[0].get(k, 0) for k, v in after[0].items()
           if v != before[0].get(k, 0)}
    return ops, [{k: a[k] - b[k] for k in a} for a, b in zip(after[1], before[1])]


def _add(delta) -> None:
    ops, launches = delta
    for k, v in ops.items():
        OPS.count(k, v)
    for table, d in zip(LAUNCH_TABLES, launches):
        for k, v in d.items():
            table[k] += v


def _split(slots: np.ndarray, blocks) -> list:
    """Decoded slots [P, sum blocks, N] on the host -> one array a column
    ([P, blocks[i], N])."""
    return np.split(slots, np.cumsum(blocks)[:-1], axis=1)


class RecordGraph:
    """A function of device tensors captured as one CUDA graph.

    `RecordGraph(fn, inputs, generators)`: `inputs` are the static input
    tensors (their values are the warm-up's); `fn` runs once eagerly on a
    side stream, which fills every lazy cache it reads (stacked Galois
    keys, masks, the contraction's prepared weights, BSGS forms).  Then
    the capture is decided (module docstring; `need_bytes`, `free_bytes`,
    `decision`, printed): where the reckoned pool does not fit, `graph` is
    None, `outputs` are the warm-up's and its counts stand (it was an
    eager run).  Otherwise `fn` is captured with `generators` registered,
    so every replay draws fresh randomness from them.  `replay(*values)`
    copies the values into the static inputs and replays; the outputs
    (`self.outputs`, whatever `fn` returned) are static tensors that the
    next replay overwrites.  The counts of the capture are added at each
    replay (module docstring), the graph's nodes among them (`nodes`, by
    type); `ranges` are the device ranges captured into it, which
    `read_ranges` reads after a replay whose outputs reached the host.
    `capture_s` is the wall seconds of warm-up and capture, `warm_s` of
    the warm-up alone; `pool_bytes` the device memory the capture took
    from the allocator."""

    def __init__(self, fn, inputs, generators=()):
        dev = inputs[0].device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, not {dev}")
        self.inputs = inputs
        before = _counts()
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm_out = fn(*inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warm_s = time.perf_counter() - t0
        warm = _counts()
        self.need_bytes = torch.cuda.max_memory_allocated(dev) - start
        torch.cuda.empty_cache()         # as the capture does on entering
        self.free_bytes = torch.cuda.mem_get_info(dev)[0]
        fits = self.need_bytes <= GRAPH_FREE_SHARE * self.free_bytes
        self.decision = (
            f"record graph: {self.need_bytes / 2**30:.2f} GiB reckoned for the "
            f"pool, {self.free_bytes / 2**30:.2f} GiB free: "
            + ("capture" if fits else "eager, the pool does not fit"))
        print(self.decision, flush=True)
        if not fits:
            self.graph, self.outputs, self.pool_bytes = None, warm_out, 0
            self.capture_s = time.perf_counter() - t0
            return
        del warm_out
        reserved = torch.cuda.memory_reserved(dev)
        # kept after the capture, so that its nodes can be counted
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in generators:
            # fresh randomness at every replay: replaying one encryption's
            # noise for every record would be a silent security fault
            self.graph.register_generator_state(gen)
        with trace.capturing() as self.ranges, torch.cuda.graph(self.graph):
            self.outputs = fn(*inputs)
        self.nodes = trace.graph_node_types(self.graph.raw_cuda_graph())
        self.graph.instantiate()
        trace.count("graph_captures")
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.delta = _difference(_counts(), warm)
        _restore(before)

    def replay(self, *values):
        with trace.span("upload"):
            for static, v in zip(self.inputs, values):
                static.copy_(v)
        with trace.span("replay"):
            self.graph.replay()
        _add(self.delta)
        trace.count("graph_replays")
        trace.count("graph_nodes", self.nodes.total())
        trace.count("graph_event_nodes", self.nodes["event_record"])
        return self.outputs

    def read_ranges(self) -> None:
        """The device ranges' ms of the last replay, whose outputs have
        reached the host (`trace.read_ranges`)."""
        trace.read_ranges(self.ranges)


class EncryptedForward:
    """fwd = EncryptedForward(head, graph=False)
                                     # after head.prepare_network()
    out = fwd()                      # one record end to end, or None
    outs = fwd.run_batch(raws)       # B records, one pass each way

    `graph` mirrors the reference's `jit` (module docstring); the record
    body follows from the factory (`encodes_on_device`)."""

    def __init__(self, head: Layer, graph: bool = False):
        self.encrypt_layer, self.layers = split_at_encrypt(head)
        fac = self.encrypt_layer.factory
        self.graph = bool(graph)
        if self.graph and getattr(fac, "device", torch.device("cpu")).type != "cuda":
            raise ValueError("graph=True needs a factory on a CUDA device: "
                             "a CUDA graph has no CPU counterpart")
        self._graphs: dict = {}
        self._meta: dict = {}
        self.records = 0                  # records pulled: the trace's numbers
        # signatures whose graph did not fit: the decision, printed once
        self.eager: dict = {}
        if self.graph:
            # a graph copies nothing from the host: BSGS tables resident
            for layer in self.layers:
                form = getattr(layer, "bsgs_form", None)
                if form is not None:
                    form.make_resident()

    @property
    def reader(self):
        p = self.encrypt_layer
        while p.source is not None:
            p = p.source
        return p

    @property
    def factory(self):
        return self.encrypt_layer.factory

    def release(self) -> None:
        """Drop every captured graph (its memory pool goes with it)."""
        self._graphs.clear()

    def graphs(self) -> dict:
        """The captured graphs by signature."""
        return dict(self._graphs)

    # ------------------------------------------------------------ layers
    def _range(self, i: int):
        """The device range of layer i (`trace.device_range`)."""
        layer = self.layers[i]
        return trace.device_range(f"{i}.{type(layer).__name__}", layer.kind)

    def run_encrypted(self, m: HEMatrix) -> HEMatrix:
        """The layers above the EncryptLayer on an encrypted matrix, each
        in its device range (with its report in verbose mode,
        `Layer.forward`)."""
        for i, layer in enumerate(self.layers):
            with self._range(i):
                m = layer.forward(m)
        return m

    def _apply_layers(self, m: HEMatrix, key) -> HEMatrix:
        """`run_encrypted` inside a record body, recording the output's
        metadata under `key` (the body returns its columns' data only)."""
        m = self.run_encrypted(m)
        self._meta[key] = ([(v.dim, v.scale, v.fmt, v.is_signed)
                            for v in m.vectors], m.fmt)
        return m

    def _matrix(self, datas, metas, fmt, slots=None) -> HEMatrix:
        """A matrix of columns' data and metadata ((dim, scale, fmt,
        is_signed) each) and, when decoded already, their host slots
        ([P, C, N] each)."""
        fac = self.factory
        vecs = []
        for i, (d, (dim, sc, f, sg)) in enumerate(zip(datas, metas)):
            v = HEVector(fac, data=d, dim=dim, scale=sc, fmt=f, is_signed=sg)
            if slots is not None:
                v._dec_slots = slots[i]
            vecs.append(v)
        return HEMatrix(fac, vecs, fmt)

    def _output_matrix(self, key, datas, slots=None) -> HEMatrix:
        """The output matrix of a record of signature `key` from its
        columns' data and, when decoded already, their host slots."""
        metas, fmt = self._meta[key]
        return self._matrix(datas, metas, fmt, slots)

    # --------------------------------------------------------- host side
    def slot_values(self, raw):
        """Host side of a record: RawMatrix -> (its scaled values [1, dim,
        V] float64 tensor, a view of `raw.m`, (V, C, dim, scale)).  Where
        the factory encodes them on the device, they count P x V x C x n
        device-encoded slots."""
        fac = self.factory
        with trace.span("slot_buffers"):
            m = np.ascontiguousarray(raw.m, dtype=np.float64)
            dim, V = m.shape
            C = slotmap.blocks_of(dim, fac.n)
            if fac.encodes_on_device:
                trace.count("device_encoded_slots", fac.P * V * C * fac.n)
            return torch.from_numpy(m)[None], (V, C, dim, float(raw.scale))

    def input_matrix(self, datas, dim: int, scale: float) -> HEMatrix:
        """The encrypted input matrix of a record from its columns' data
        ([P, C, 2, k, N] each) and the record's dim and scale."""
        fac = self.factory
        return HEMatrix(fac, [HEVector(fac, data=d, dim=dim, scale=scale, fmt="dense")
                              for d in datas], "col")

    def _columns(self, data, V: int, C: int, dim: int, scale: float) -> HEMatrix:
        """A record's ciphertext data [P, V*C, 2, k, N] -> its input matrix."""
        cols = data.reshape(self.factory.P, V, C, *data.shape[2:])
        return self.input_matrix([cols[:, i] for i in range(V)], dim, scale)

    def encrypt(self, raw) -> HEMatrix:
        """A reader record (RawMatrix) -> its encrypted input matrix: every
        column encoded and encrypted in one pass
        (`CrtBfvFactory.encrypt_values`)."""
        x, sig = self.slot_values(raw)
        return self._columns(self.factory.encrypt_values(x), *sig)

    # ------------------------------------------------------ record bodies
    def record_fn(self, V: int, C: int, dim: int, scale: float):
        """The record body on a factory that encodes and decodes on the
        device, fn(x) -> (output column datas, decoded slots [P, sum
        C_out, N], encrypted input [P, V*C, 2, k, N]), from the reader's
        values [1, dim, V] float64 on the device: the slot map and
        encrypt, the layers, decrypt and decode, no host work (the
        counterpart of `fused_record_fn`, `jit.py:130-162`).  A factory
        without its secret key raises here, before any record runs."""
        fac = self.factory
        fac.require_secret_key()
        key = ("fused", V, C, dim, scale)

        def forward(x):
            data = fac._encrypt_values_dev(x)             # [P, V*C, 2, k, N]
            m = self._apply_layers(self._columns(data, V, C, dim, scale), key)
            datas = [v.data for v in m.vectors]
            with trace.device_range("decrypt", "decrypt"):
                slots = fac._decrypt_decode_all(torch.cat(datas, dim=1))
            return datas, slots, data

        return forward

    def _layers_fn(self, m: HEMatrix, key):
        """The record body on a factory that encodes on the host, fn(*the
        input columns' data) -> (output column datas, None): the layers on
        an input matrix of m's form; the factory decrypts outside."""
        metas = [(v.dim, v.scale, v.fmt, v.is_signed) for v in m.vectors]

        def forward(*datas):
            out = self._apply_layers(self._matrix(datas, metas, m.fmt), key)
            return [v.data for v in out.vectors], None

        return forward

    def _run(self, key, body, inputs, generators=()):
        """The record (or record batch) of signature `key`: `body(*inputs)`
        -> (output column datas, decoded slots [P, R, N] on the device or
        None, ...).  Without a graph, or for a signature whose graph did
        not fit (`self.eager`), the body runs directly on the inputs
        copied to the device.  Otherwise the signature's graph, captured
        at its first record (`RecordGraph`, with `generators`; a capture
        declined marks the signature eager and its warm-up was this
        record), is replayed on them and its outputs cloned.  Returns (the
        output datas, the decoded slots on the host [P, R, N] int64): the
        body's, or the factory's decrypt of the datas where it has none."""
        dev = self.factory.device
        g, outs = self._graphs.get(key), None
        if g is None and self.graph and key not in self.eager:
            g = RecordGraph(body, [x.to(dev, copy=True) for x in inputs], generators)
            if g.graph is None:               # the warm-up was this record's run
                self.eager[key], outs, g = g.decision, g.outputs, None
            else:
                self._graphs[key] = g
        if g is not None:
            outs = g.replay(*inputs)
        elif outs is None:
            with trace.span("upload"):
                inputs = [x.to(dev) for x in inputs]
            outs = body(*inputs)
        datas, slots = outs[0], outs[1]
        with trace.span("output"):
            if g is not None:
                datas = [d.clone() for d in datas]
            host = None if slots is None else slots.cpu().numpy().astype(np.int64)
        if host is None:
            with trace.device_range("decrypt", "decrypt"):
                host = self.factory.decrypt_slots(torch.cat(datas, dim=1))
        if g is not None:
            g.read_ranges()
        return datas, host

    def _layers_record(self, m: HEMatrix) -> HEMatrix:
        key = ("layers", m.fmt, tuple((v.dim, v.scale, v.fmt, v.is_signed,
                                       tuple(v.data.shape)) for v in m.vectors))
        datas, host = self._run(key, self._layers_fn(m, key), [v.data for v in m.vectors])
        return self._output_matrix(key, datas, _split(host, [d.shape[1] for d in datas]))

    def run_graph(self, m: HEMatrix) -> HEMatrix:
        """The layers on an encrypted matrix as one CUDA graph replay, the
        graph captured at the first matrix of its signature, then the
        factory's decrypt and decode: the record body of a factory that
        encodes on the host, on any factory.  A signature whose graph does
        not fit runs the layers directly (`self.eager`)."""
        if not self.graph:
            raise ValueError("run_graph needs graph=True")
        return self._layers_record(m)

    def __call__(self):
        """Pull one record through encode, encrypt, the network, decrypt
        and decode."""
        self.records += 1
        with trace.span("record", seq=self.records):
            with trace.span("reader"):
                raw = self.reader.get_next()
            if raw is None:
                return None
            fac = self.factory
            if not fac.encodes_on_device:
                return self._layers_record(self.encrypt(raw))
            x, sig = self.slot_values(raw)
            key = ("fused",) + sig
            datas, host = self._run(key, self.record_fn(*sig), [x], [fac._gen])
            return self._output_matrix(key, datas, _split(host, [d.shape[1] for d in datas]))

    # -------------------------------------------------- the record batch
    def _vmapped_layers(self, cols, dim: int, scale: float, key) -> list:
        """The layers on B records' input columns ([B, P, C, 2, k, N]
        each) under `torch.func.vmap` over the records -> the output
        columns ([B, P, C_out, s, k, N] each).  The layers count their
        operations once under vmap: the other B - 1 records' are added."""
        B = cols[0].shape[0]

        def layers(cs):
            m = self._apply_layers(self.input_matrix(cs, dim, scale), key)
            return [v.data for v in m.vectors]

        before = OPS.snapshot()
        outs = torch.func.vmap(layers)(list(cols))
        for k, v in OPS.snapshot().items():
            OPS.count(k, (B - 1) * (v - before.get(k, 0)))
        return outs

    def run_encrypted_batch(self, cols, dim: int, scale: float) -> list:
        """The layers on B records' encrypted input columns ([B, P, C, 2,
        k, N] each, one signature) under `torch.func.vmap`: the B output
        matrices (the counterpart of the reference's `jax.vmap` of its
        record program, `parallel/dryrun.py:92-115`)."""
        key = ("layers batch", dim, scale, tuple(tuple(c.shape) for c in cols))
        outs = self._vmapped_layers(cols, dim, scale, key)
        return [self._output_matrix(key, [o[b] for o in outs])
                for b in range(cols[0].shape[0])]

    def record_batch_fn(self, B: int, V: int, C: int, dim: int, scale: float):
        """The body of B records, fn(x) -> (output column datas [B, P,
        C_out, s, k, N] each, decoded slots [P, B * sum C_out, N],
        encrypted input [B, P, V, C, 2, k, N]), from the B records' values
        [B, dim, V] float64 on the device: every column slot-mapped (one
        launch) and encrypted in one pass, the layers under
        `torch.func.vmap` over the records, every output decrypted and
        decoded in one pass (the counterpart of `bench.py:237-366`).  A
        factory without its secret key raises here."""
        fac = self.factory
        fac.require_secret_key()
        key = ("batch", B, V, C, dim, scale)

        def forward(x):
            data = fac._encrypt_values_dev(x)             # [P, B*V*C, 2, k, N]
            data = data.reshape(fac.P, B, V, C, *data.shape[2:]).movedim(1, 0)
            outs = self._vmapped_layers([data[:, :, i] for i in range(V)],
                                        dim, scale, key)
            flat = torch.cat([o.movedim(0, 1).reshape(fac.P, B * o.shape[2], *o.shape[3:])
                              for o in outs], dim=1)
            with trace.device_range("decrypt", "decrypt"):
                slots = fac._decrypt_decode_all(flat)
            return outs, slots, data

        return forward

    def run_batch(self, raws) -> list:
        """B reader records (RawMatrix, one signature) -> their B output
        matrices, decoded: one encrypt pass, the layers vmapped over the
        records, one decrypt pass; one CUDA graph replay under
        `graph=True`.  The counterpart of `bench.py`'s `BENCH_VMAP`; like
        it, it needs a factory that encodes and decodes on the device."""
        fac = self.factory
        if not fac.encodes_on_device:
            raise ValueError(
                "a record batch needs a factory that encodes and decodes on "
                "the device (every plain prime below 2**31 and below every "
                "limb); this one encodes on the host: run its records one "
                "at a time")
        sigs, xs = set(), []
        for raw in raws:
            x, sig = self.slot_values(raw)
            sigs.add(sig)
            xs.append(x)
        if len(sigs) != 1:
            raise ValueError(f"a record batch needs one signature: {sigs}")
        (V, C, dim, scale), = sigs
        B = len(xs)
        key = ("batch", B, V, C, dim, scale)
        outs, host = self._run(key, self.record_batch_fn(B, V, C, dim, scale),
                               [torch.cat(xs)], [fac._gen])
        # column i's B records lie in a row: record b's C_i columns from
        # B * (C_0 + ... + C_(i-1)) + b * C_i on
        cols = [np.split(c, B, axis=1) for c in _split(host, [B * o.shape[2] for o in outs])]
        return [self._output_matrix(key, [o[b] for o in outs], [c[b] for c in cols])
                for b in range(B)]


def evaluation_forward(head: Layer, graph: bool | None = None,
                       verbose: bool = False) -> EncryptedForward:
    """The forward a model's command line evaluates with (the reference's
    `EncryptedForward(head, jit=True)`): one CUDA graph a record, the
    whole record where the factory encodes and decodes on the card.
    `graph` None takes the graph on a factory on the card outside verbose
    mode (a graph prints no layer reports), False runs eagerly (the
    `--no-graph` flag), True insists (and raises on the CPU).  The big-t
    presets (`cifar_bigt`, `lola_large_bigt`, `cryptonets_bigt`) encode on
    the host, so their graph holds the layers; a signature whose reckoned
    pool does not fit the card's free memory runs eagerly, as the printed
    decision says (`RecordGraph`)."""
    if graph is None:
        fac = split_at_encrypt(head)[0].factory
        graph = fac.device.type == "cuda" and not verbose
    return EncryptedForward(head, graph=graph)


def raw_layer_outputs(head_raw: Layer) -> list:
    """The Raw oracle's input to the first layer above the EncryptLayer
    and every such layer's output, for the next record of a prepared Raw
    network."""
    enc, layers = split_at_encrypt(head_raw)
    outs = [enc.apply(enc.source.get_next())]
    for layer in layers:
        outs.append(layer.apply(outs[-1]))
    return outs


def layer_agreement(m: HEMatrix, raw, sample: int = 2) -> dict:
    """An encrypted layer output against the Raw oracle's output of the
    same layer: the least noise budget over its first `sample` vectors
    (and the plain primes), the largest difference of the decryption from
    the Raw values relative to the largest Raw value, and whether the two
    agree at rtol 1e-9."""
    enc = m.decrypt()
    want = np.asarray(raw.decrypt(), dtype=float)
    same_shape = enc.shape == want.shape
    rel = (float(np.max(np.abs(enc - want)) / max(np.max(np.abs(want)), 1e-300))
           if same_shape else float("inf"))
    return dict(budget=min(v.noise_budget() for v in m.vectors[:sample]),
                max_rel_diff=rel, vectors=len(m.vectors),
                equal=same_shape and bool(np.allclose(enc, want, rtol=1e-9, atol=0)))
