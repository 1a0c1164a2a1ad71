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

A stage on another device than the factory's gets a factory of the same
parameters there, holding the key set moved by `KeySet.to`, and its
layers are prepared again for it.  A stage's output crosses to the next
stage's card on the producing stage's stream, after its work, so the
copy reads finished data and the consumer waits for it by the event.

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
        fac = self.encrypt_layer.factory
        self.factories = []
        for group, dev in zip(self.groups, self.devices):
            f = fac.to(dev)
            for layer in group:
                layer.factory = f
                if f is not fac:       # its prepared state, again on f
                    layer.layer_prepared = False
                    layer.prepare()
                    layer.layer_prepared = True
            self.factories.append(f)
        self.streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
                        for dev in self.devices]
        self._warm = False

    @property
    def reader(self):
        return self._fwd.reader

    def _stage(self, s: int, m: HEMatrix, ready) -> tuple:
        """Queue stage s on record matrix m (on the stage's device) once
        `ready` (an event or None) has passed; returns (its output, on the
        next stage's device, and the event that marks it done)."""
        dev, stream = self.devices[s], self.streams[s]
        last = s + 1 == len(self.groups)
        if stream is None:
            for layer in self.groups[s]:
                m = layer.forward(m)
            return (m if last else self._to_stage(s + 1, m)), None
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            if ready is not None:
                stream.wait_event(ready)
            for v in m.vectors:
                v.data.record_stream(stream)
            for layer in self.groups[s]:
                m = layer.forward(m)
            if not last:         # a copy to another card runs on this stream
                m = self._to_stage(s + 1, m)
            done = torch.cuda.Event()
            done.record(stream)
        return m, done

    def _to_stage(self, s: int, m: HEMatrix) -> HEMatrix:
        """m as a matrix of stage s's factory, its data on that stage's
        device.  A copy between cards runs on the current stream of the
        source card, after the work queued there."""
        fac = self.factories[s]
        if m.factory is fac:
            return m
        dev = self.devices[s]
        return HEMatrix(fac, [HEVector(fac, data=v.data.to(dev), dim=v.dim,
                                       scale=v.scale, fmt=v.fmt, is_signed=v.is_signed)
                              for v in m.vectors], m.fmt)

    def _submit(self, enc: HEMatrix) -> HEMatrix:
        """Queue one encrypted record through every stage without waiting;
        the output may be read on the current stream of the last device."""
        m = self._to_stage(0, enc)
        ready = None
        src = enc.vectors[0].data.device
        if src.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(src))
        for s in range(len(self.groups)):
            m, ready = self._stage(s, m, ready)
        if ready is not None:
            consumer = torch.cuda.current_stream(self.devices[-1])
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
        reader is exhausted.  The first record runs through every stage
        once, synchronised, before it is queued."""
        raw = self.reader.get_next()
        if raw is None:
            return None
        enc = self._fwd.encrypt(raw)
        if not self._warm:
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
