"""PyTorch/CUDA port of `cryptonets_tpu`: BFV homomorphic neural-network
inference on an NVIDIA H100.

The JAX package `cryptonets_tpu` is the reference and is not imported
here; this package imports `torch`, never `jax`.  Layout mirrors the
reference: `crypto/` (BFV over int32 RNS limb tensors), `kernels/` (the
hand-written Hopper kernels: NTT and exact modular contraction), `api/`
(factory, HE vectors and matrices), `nn/` (layers), `models/` and
`data/`.  Entry points run on CUDA unless
the caller passes `device="cpu"`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
