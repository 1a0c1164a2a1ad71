"""A (batch, limb) mesh over process ranks and the placement of ciphertext
tensors on it, port of `cryptonets_tpu/parallel/mesh.py`.

Ciphertext data is [P, C, size, k, N] (plain primes, blocks or records,
polynomials, RNS limbs, coefficients):
  * the `batch` axis shards C: independent ciphertexts, which need no
    communication until their records are assembled or decrypted;
  * the `limb` axis shards k.  The JAX package leaves its collectives to
    GSPMD; torch has no such partitioner, so each operation that reads
    across limbs (base conversion, key switching, decrypt) takes an
    explicit collective over the limb group: a rank's factory is given
    its `limb_shard` (`parallel/limbs.py`, `CrtBfvFactory(shard=...)`).

Each rank holds its own block of C and of k (`shard_ciphertext_data`); a
sharding is described, as the reference's PartitionSpec, by the mesh axis
name of each tensor axis (`ciphertext_spec`, `batch_sharding`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

AXES = ("batch", "limb")


def mesh_shape(n: int, batch: int | None = None) -> tuple[int, int]:
    """(batch, limb) of an n-rank mesh by the reference's rule: batch =
    max(1, n // 2) for n > 1 unless given, limb = n // batch; raises where
    batch * limb is not n (the reference's device reshape fails there)."""
    if batch is None:
        batch = max(1, n // 2) if n > 1 else 1
    if n % batch:
        raise ValueError(f"batch = {batch} does not divide {n} ranks")
    return batch, n // batch


class Mesh:
    """A (batch, limb) mesh of ranks.  `shape` is {"batch": b, "limb": l};
    `device_mesh` is the `torch.distributed` DeviceMesh over the ranks of
    the default process group, or None for the one rank of a process
    without a group."""

    def __init__(self, batch: int, limb: int, device_mesh=None):
        self.shape = {"batch": batch, "limb": limb}
        self.device_mesh = device_mesh

    def _coordinate(self, axis: int) -> int:
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_coordinate()[axis])

    def batch_index(self) -> int:
        """This rank's coordinate on the batch axis."""
        return self._coordinate(0)

    def limb_index(self) -> int:
        """This rank's coordinate on the limb axis."""
        return self._coordinate(1)

    def _group(self, name: str):
        return None if self.device_mesh is None else self.device_mesh.get_group(name)

    def batch_group(self):
        """The process group of this rank's batch axis (None on one rank)."""
        return self._group("batch")

    def limb_group(self):
        """The process group of this rank's limb axis (None on one rank)."""
        return self._group("limb")

    def limb_block(self, k: int) -> tuple[int, int]:
        """This rank's data limbs [lo, hi) of a k-limb chain: the l-th of
        the limb axis' equal blocks.  A limb count that does not divide k
        raises."""
        parts = self.shape["limb"]
        if k % parts:
            raise ValueError(f"{k} limbs do not split into {parts} equal "
                             f"blocks over the limb axis")
        per = k // parts
        i = self.limb_index()
        return i * per, (i + 1) * per

    def limb_shard(self, k: int):
        """The `LimbShard` of this rank's limbs of a k-limb chain, for the
        factory (`CrtBfvFactory(shard=...)`); None when the limb axis is
        1, where the factory is the one-process one."""
        if self.shape["limb"] == 1:
            return None
        from .limbs import LimbShard

        return LimbShard(*self.limb_block(k), k, self.limb_group())

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(n_devices: int | None = None, batch: int | None = None) -> Mesh:
    """A (batch, limb) mesh over the ranks of the default process group,
    or over one rank when none is initialised.  `n_devices` defaults to
    the world size and must equal it when a group exists.  The default
    factoring is the reference's: n // 2 ranks on batch and 2 on limb
    for n > 1; pass batch=n to put every rank on batch."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    b, lb = mesh_shape(n, batch)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a {n}-rank mesh needs a process group "
                             f"(`distributed.init_multihost`)")
        return Mesh(1, 1)
    if n != world:
        raise ValueError(f"a mesh spans every rank: {n} asked, world size {world}")
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(b, lb, init_device_mesh(kind, (b, lb), mesh_dim_names=AXES))


def ciphertext_spec(batch_axis: int = 1, limb_axis: int = 3) -> tuple:
    """The mesh axis of each axis of [P, C, size, k, N] data: C over batch,
    k over limb, the rest replicated (None)."""
    spec = [None] * 5
    spec[batch_axis] = "batch"
    spec[limb_axis] = "limb"
    return tuple(spec)


class Sharding(NamedTuple):
    """A tensor's placement: the mesh and the mesh axis of each tensor axis."""

    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = 1) -> Sharding:
    """`ndim`-axis data whose axis `batch_axis` lies over the batch axis."""
    spec = [None] * ndim
    spec[batch_axis] = "batch"
    return Sharding(mesh, tuple(spec))


def shard_ciphertext_data(data: torch.Tensor, mesh: Mesh, batch_axis: int = 1,
                          limb_axis: int = 3) -> torch.Tensor:
    """This rank's block of `data` (default: C and k of [P, C, size, k,
    N]): the b-th of the mesh's `batch` equal blocks along `batch_axis`
    and the l-th of its `limb` blocks along `limb_axis`, a view.  An axis
    its mesh axis does not divide raises."""
    b = mesh.batch_index()
    parts = mesh.shape["batch"]
    size = data.shape[batch_axis]
    if size % parts:
        raise ValueError(f"axis {batch_axis} of {size} does not split into "
                         f"{parts} equal blocks over the batch axis")
    per = size // parts
    block = data.narrow(batch_axis, b * per, per)
    if mesh.shape["limb"] == 1:
        return block
    lo, hi = mesh.limb_block(data.shape[limb_axis])
    return block.narrow(limb_axis, lo, hi - lo)
