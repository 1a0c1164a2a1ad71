"""Layer-graph contract: singly-linked pull pipeline (ref INetwork/
BaseLayer, `NeuralNetworks/INetwork.cs`, `BaseLayer.cs`); port of
`cryptonets_tpu/nn/network.py`.

Networks are linked lists of layers; data is pulled from the reader at the
tail via get_next().  Verbose mode prints each layer's preparation time,
and for each application its time and width, the noise budget of output
column 0 and the operation counts, as `BaseLayer.cs:31-42` does.  On a
CUDA factory the time is taken after `torch.cuda.synchronize()`, so it
measures the layer's work and not its launches.
"""

from __future__ import annotations

import time

from ..device import synchronize
from ..utils.opcount import OPS


class Layer:
    # the kind of the layer's device range in a record (`utils/trace.py`
    # KINDS); None takes no range
    kind: str | None = None

    def __init__(self, source: "Layer | None" = None, factory=None):
        self.source = source
        self._factory = factory
        self.layer_prepared = False
        self.verbose = False

    @property
    def factory(self):
        if self._factory is not None:
            return self._factory
        return self.source.factory

    @factory.setter
    def factory(self, f):
        self._factory = f

    def get_source(self):
        return self.source

    def output_dimension(self) -> int:
        return self.source.output_dimension()

    def get_output_scale(self) -> float:
        return self.source.get_output_scale()

    def prepare(self):
        pass

    def prepare_network(self):
        if self.source is not None:
            self.source.prepare_network()
        t0 = time.time()
        self.prepare()
        self.layer_prepared = True
        if self.verbose:
            synchronize(self.factory)
            print(f"Prepare {type(self).__name__} computed in "
                  f"{time.time() - t0:.3f} seconds")

    def apply(self, m):
        raise NotImplementedError

    def forward(self, m):
        """apply(m); in verbose mode with the layer's time and width, the
        budget of output column 0 and the operation counts printed."""
        if not self.verbose:
            return self.apply(m)
        from ..api.tracker import test_budget

        OPS.reset()
        synchronize(self.factory)
        t0 = time.time()
        res = self.apply(m)
        synchronize(self.factory)
        dims = getattr(m, "row_count", "?"), getattr(m, "column_count", "?")
        print(f"Layer {type(self).__name__} computed in "
              f"{time.time() - t0:.3f} seconds; layer width {dims}")
        test_budget(res, self.factory)
        OPS.print()
        return res

    def get_next(self):
        if not self.layer_prepared:
            self.prepare()
            self.layer_prepared = True
        m = self.source.get_next()
        if m is None:
            return None
        return self.forward(m)

    def set_verbose(self, flag: bool = True):
        """Set verbose on this layer and all its sources (ref
        `CryptoNets.cs:81-82`)."""
        layer = self
        while layer is not None:
            layer.verbose = flag
            layer = layer.source
        return self


class InputLayer(Layer):
    """Input layers additionally expose per-record labels."""

    labels: list

    def get_source(self):
        return None
