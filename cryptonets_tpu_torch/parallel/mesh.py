"""A (batch, limb) mesh over process ranks and the placement of ciphertext
tensors on it, port of `cryptonets_tpu/parallel/mesh.py`.

Ciphertext data is [P, C, size, k, N] (plain primes, blocks or records,
polynomials, RNS limbs, coefficients):
  * the `batch` axis shards C: independent ciphertexts, which need no
    communication until their records are assembled or decrypted;
  * the `limb` axis shards k.  The JAX package leaves its collectives to
    GSPMD; torch has no such partitioner, so a limb axis needs explicit
    collectives at every operation that reads across limbs (base
    conversion, key switching, decrypt), which this package does not have
    yet: a mesh with limb > 1 can be built, and raises NotImplementedError
    when used.

Each rank holds its own block of C (`shard_ciphertext_data`); a sharding
is described, as the reference's PartitionSpec, by the mesh axis name of
each tensor axis (`ciphertext_spec`, `batch_sharding`).
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

    def batch_index(self) -> int:
        """This rank's coordinate on the batch axis.  Every use of a mesh
        passes here, so a mesh with limb > 1 raises."""
        if self.shape["limb"] > 1:
            raise NotImplementedError(
                f"a mesh with limb = {self.shape['limb']} > 1 (RNS limbs "
                f"sharded over ranks, with collectives at base conversion, "
                f"key switching and decrypt) is not ported")
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_coordinate()[0])

    def batch_group(self):
        """The process group of this rank's batch axis (None on one rank)."""
        self.batch_index()
        return None if self.device_mesh is None else self.device_mesh.get_group("batch")

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(n_devices: int | None = None, batch: int | None = None) -> Mesh:
    """A (batch, limb) mesh over the ranks of the default process group,
    or over one rank when none is initialised.  `n_devices` defaults to
    the world size and must equal it when a group exists.  The default
    factoring puts half the ranks on `limb` (n // 2 on batch), and a
    limb axis raises when used: for n > 1 pass batch=n to get a usable
    mesh."""
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
    mesh.batch_index()
    spec = [None] * ndim
    spec[batch_axis] = "batch"
    return Sharding(mesh, tuple(spec))


def shard_ciphertext_data(data: torch.Tensor, mesh: Mesh,
                          batch_axis: int = 1) -> torch.Tensor:
    """This rank's block of `data` along `batch_axis` (default: C of
    [P, C, size, k, N]): the b-th of the mesh's `batch` equal blocks, a
    view.  An axis the batch size does not divide raises."""
    b = mesh.batch_index()
    parts = mesh.shape["batch"]
    size = data.shape[batch_axis]
    if size % parts:
        raise ValueError(f"axis {batch_axis} of {size} does not split into "
                         f"{parts} equal blocks over the batch axis")
    per = size // parts
    return data.narrow(batch_axis, b * per, per)
