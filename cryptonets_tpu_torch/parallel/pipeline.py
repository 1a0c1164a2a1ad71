"""Layer-pipeline parallelism: the encrypted layer chain split into
stages, each on its own device and CUDA stream; port of
`cryptonets_tpu/parallel/pipeline.py`.

The reference has no pipeline axis (layers run one after another through
`GetNext`); the JAX package pins each segment's program to a device and
lets asynchronous dispatch overlap record b's segment s with record
b + 1's segment s - 1.  Here the layers above the EncryptLayer are split
into S contiguous groups of near-equal length, one torch device a stage
(repeats allowed, so one card can hold several stages), and each stage
runs on its own `torch.cuda.Stream`: launches return at once, so while
stage s works on record b the host already queues record b + 1 on stage
s - 1's stream.  Each stage's output reaches the next by an event
(`wait_event`); every tensor that crosses streams is marked with
`record_stream`, so the caching allocator does not hand its memory to
another stream's work before the reader is done.  On the CPU the stages
run one after another.

The first record runs through every stage once before streaming and the
devices are synchronised (the reference's `_build`): that fills the
factory's lazily built caches (stacked Galois keys, masks, the
contraction's weights) before two streams can read them.

Each stage holds only the keys its own layers use, as the reference's
stage holds only what its own program references: at the first record
the layers run once on the head's factory with a key set that records
every lookup (`KeySet.recording`), which gives each layer's Galois
elements and whether it relinearizes; each stage then gets a factory of
the same parameters on its device holding the union of its layers' keys
(`KeySet.select`: no secret or public key, a missing key raises naming
the stage and the Galois element), and its layers are prepared again on
it.  `stage_key_bytes()` gives each stage's key bytes.  A stage's output
crosses to the next stage's card on the producing stage's stream, after
its work, so the copy reads finished data and the consumer waits for it
by the event; the last stage's output goes back to the head's factory
(which holds the secret key) the same way.

Use `PipelineForward(head, n_stages=...)` like `EncryptedForward`; use
`run_stream(n)` to pull n records with cross-record overlap.
"""

from __future__ import annotations

import torch

from ..api.matrix import HEMatrix
from ..api.vector import HEVector
from ..device import canonical, resolve_device
from ..nn.forward import EncryptedForward


def _groups(layers, S: int) -> list:
    """S contiguous groups of near-equal length (the longer ones first)."""
    base, extra = divmod(len(layers), S)
    out, i = [], 0
    for s in range(S):
        take = base + (1 if s < extra else 0)
        out.append(layers[i:i + take])
        i += take
    return out


class PipelineForward:
    """Stages of the encrypted layers, one device and stream a stage."""

    def __init__(self, head, n_stages: int | None = None, devices=None):
        self._fwd = EncryptedForward(head)
        self.encrypt_layer, self.layers = self._fwd.encrypt_layer, self._fwd.layers
        if devices is None:
            resolve_device()          # raises without CUDA
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [canonical(d) for d in devices]
        S = n_stages or min(len(devices), len(self.layers))
        if not 1 <= S <= len(self.layers):
            raise ValueError(f"{S} stages for {len(self.layers)} layers")
        if S > len(devices):
            raise ValueError(f"{S} stages > {len(devices)} devices")
        self.groups = _groups(self.layers, S)
        self.devices = devices[:S]
        self.factories = None      # the stages' factories, from the first record
        self.layer_keys = None     # what each layer looked up, from the same
        self.streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
                        for dev in self.devices]
        self._warm = False

    def _plan(self, enc: HEMatrix) -> None:
        """Run the layers once on the head's factory over `enc` with a key
        set that records its lookups (the layers' `apply`, which is what a
        stage runs), then give each stage a factory on its device that
        holds the union of its layers' keys and prepare the stage's layers
        on it."""
        fac = self.encrypt_layer.factory
        full = fac.keys
        # every factory the layers use (the head's, or an earlier
        # pipeline's stages) reads through a recording view
        owners = list({id(f): f for f in [fac] + [l.factory for l in self.layers]}.values())
        saved = [f.keys for f in owners]
        seen: set = set()
        for f in owners:
            f.keys = f.keys.recording(seen)[0]
        self.layer_keys = []
        try:
            m = enc
            for layer in self.layers:
                seen.clear()
                m = layer.apply(m)
                self.layer_keys.append(frozenset(seen))
        finally:
            for f, keys in zip(owners, saved):
                f.keys = keys
        self.factories = []
        i = 0
        for s, (group, dev) in enumerate(zip(self.groups, self.devices)):
            used = frozenset().union(*self.layer_keys[i:i + len(group)])
            i += len(group)
            keys = full.select(
                galois=[g for g in used if isinstance(g, int)],
                relin="relin" in used,
                keep=[n for n in used if isinstance(n, str) and n != "relin"],
                owner=f"pipeline stage {s}")
            f = fac.to(dev, keys=keys)
            for layer in group:
                layer.factory = f      # its prepared state, again on f
                layer.layer_prepared = False
                layer.prepare()
                layer.layer_prepared = True
            self.factories.append(f)

    def stage_key_bytes(self) -> list[int]:
        """Bytes of the keys each stage holds (after the first record)."""
        return [f.keys.nbytes() for f in self.factories]

    @property
    def reader(self):
        return self._fwd.reader

    def _stage(self, s: int, m: HEMatrix, ready) -> tuple:
        """Queue stage s on record matrix m (on the stage's device) once
        `ready` (an event or None) has passed; returns (its output, on the
        next stage's device, and the event that marks it done)."""
        dev, stream = self.devices[s], self.streams[s]
        if stream is None:
            for layer in self.groups[s]:
                m = layer.forward(m)
            return self._to_next(s, m), None
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            if ready is not None:
                stream.wait_event(ready)
            for v in m.vectors:
                v.data.record_stream(stream)
            for layer in self.groups[s]:
                m = layer.forward(m)
            m = self._to_next(s, m)  # a copy to another card runs on this stream
            done = torch.cuda.Event()
            done.record(stream)
        return m, done

    def _to_next(self, s: int, m: HEMatrix) -> HEMatrix:
        """Stage s's output as a matrix of the next stage's factory (the
        head's after the last stage)."""
        if s + 1 < len(self.factories):
            return self._to_factory(self.factories[s + 1], m)
        return self._to_factory(self.encrypt_layer.factory, m)

    @staticmethod
    def _to_factory(fac, m: HEMatrix) -> HEMatrix:
        """m as a matrix of `fac`, its data on fac's device.  A copy between
        cards runs on the current stream of the source card, after the
        work queued there."""
        if m.factory is fac:
            return m
        return HEMatrix(fac, [HEVector(fac, data=v.data.to(fac.device), dim=v.dim,
                                       scale=v.scale, fmt=v.fmt, is_signed=v.is_signed)
                              for v in m.vectors], m.fmt)

    def _submit(self, enc: HEMatrix) -> HEMatrix:
        """Queue one encrypted record through every stage without waiting;
        the output, a matrix of the head's factory, may be read on the
        current stream of that factory's device."""
        m = self._to_factory(self.factories[0], enc)
        ready = None
        src = enc.vectors[0].data.device
        if src.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(src))
        for s in range(len(self.groups)):
            m, ready = self._stage(s, m, ready)
        if ready is not None:
            consumer = torch.cuda.current_stream(self.encrypt_layer.factory.device)
            consumer.wait_event(ready)
            for v in m.vectors:
                v.data.record_stream(consumer)
        return m

    def _synchronize(self) -> None:
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def __call__(self):
        """Encrypt the reader's next record and queue it; None when the
        reader is exhausted.  The first record runs through the layers
        once on the head's factory (`_plan`) and through every stage once,
        synchronised, before it is queued."""
        raw = self.reader.get_next()
        if raw is None:
            return None
        enc = self._fwd.encrypt(raw)
        if not self._warm:
            self._plan(enc)
            self._submit(enc)
            self._synchronize()
            self._warm = True
        return self._submit(enc)

    def run_stream(self, n_records: int) -> list:
        """Queue up to n records back to back, then wait for all of them;
        returns their output matrices."""
        outs = []
        for _ in range(n_records):
            out = self()
            if out is None:
                break
            outs.append(out)
        self._synchronize()
        return outs
