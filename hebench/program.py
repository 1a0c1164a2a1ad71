"""The system under test: the port's network of one configuration, built
through the port's own model builder and served through its evaluation
forward (`cryptonets_tpu_torch.nn.forward.evaluation_forward`: one CUDA
graph replay a request, encrypt to decode).

The benchmark hands the program the weights it loaded and the pixels it
made; it takes back the decoded logits, and reads the port's own
counters (`OPS`, each kernel module's `LAUNCHES`).  Nothing of the port
is imported before `Program` is built.
"""

from __future__ import annotations

import importlib

import numpy as np

KERNEL_MODULES = ("ntt", "modmatmul", "matmul_ntt", "modmac", "bconv")


class Program:
    """`Program(config, weights, key_seed)`: keygen on the card, the layers
    prepared, the forward ready (its graph is captured at the first
    request).  `serve(pixels, idx)` runs one request of the pixel rows
    `pixels[idx]` (784 values each) and returns its logits as exact
    integers [images, classes] (an object array) at the scale `scale`;
    its input, forward and decode are spans of a traced run."""

    def __init__(self, config: dict, weights: dict, key_seed: int):
        from cryptonets_tpu_torch.nn.forward import evaluation_forward

        b = config["builder"]
        build = getattr(importlib.import_module(b["module"]), b["function"])
        head, factory, reader = build(True, seed=key_seed, device="cuda",
                                      weights=weights, **b["kwargs"])
        got = scheme_of(factory)
        want = {k: config["scheme"][k] for k in got}
        if got != want:
            raise SystemExit(f"the factory's scheme {got} is not the "
                             f"configuration's {want}")
        head.prepare_network()
        self.reader = reader
        self.forward = evaluation_forward(head, graph=True)
        self.layout = config["output_layout"]
        self.scale = None

    def serve(self, pixels: np.ndarray, idx) -> np.ndarray:
        from torch.profiler import record_function

        with record_function("hebench.input"):
            self.reader.set_source_records([(0, pixels[i]) for i in idx])
        with record_function("hebench.forward"):
            out = self.forward()
        with record_function("hebench.decode"):
            cols = [v.decrypt_full_precision() for v in out.vectors]
        self.scale = out.vectors[0].scale
        if self.layout == "vector_per_request":       # one vector of classes
            return np.stack(cols)
        return np.stack(cols, axis=1)                 # a vector per class

    @staticmethod
    def counters() -> dict:
        """The port's operation and kernel-launch counters, copied."""
        from cryptonets_tpu_torch.utils.opcount import OPS

        out = {f"op.{k}": v for k, v in OPS.snapshot().items()}
        for name in KERNEL_MODULES:
            mod = importlib.import_module(f"cryptonets_tpu_torch.kernels.{name}")
            out.update({f"launch.{k}": v for k, v in mod.LAUNCHES.items()})
        return out


def scheme_of(factory) -> dict:
    """What the factory was built with, under the configuration's keys."""
    return dict(n=factory.n, limbs=len(factory.coeff_modulus),
                plain_primes=[int(t) for t in factory.plain_primes],
                galois_keys=len(factory.keys.galois), ntt=factory.ntt_impl)
