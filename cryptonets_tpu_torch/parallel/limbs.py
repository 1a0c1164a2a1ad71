"""The `limb` axis of the mesh: one rank's block of the RNS data limbs and
the collectives that the cross-limb operations of BFV take over the ranks
that hold the other blocks.

A rank of a mesh with limb = L > 1 holds data limbs [lo, hi) of the k of
the chain (k / L of them), every special prime, every auxiliary base (Bsk,
gamma, m2) and its limbs of the key set.  `crypto/bfv.py` receives the
shard as an optional argument and calls two methods:

  * `all_gather(x, dim)`: the ranks' limb blocks in rank order,
    concatenated along the limb axis: key switching reads whole source
    limbs (digits, RNS groups), once per switch in the coefficient domain;
    the BEHZ multiply's lift and fast floor read every q limb of their
    operand, once each; the exact host decrypt composes every limb;
  * `all_reduce_sum(x)`: the int64 sum over the ranks: a decrypt's fast
    base conversion out of base q (the gamma and two-plane decrypts) sums
    its terms over every source limb, so each rank adds its own limbs'
    terms and the partial sums, each below 2**32, are summed exactly in
    int64.

Under gloo the tensors cross through host memory (gloo collectives run on
host tensors); under NCCL they stay on the device.  Each call counts
itself by kind (`counts`), so a run can report its collectives per
record.

Both collectives run under `torch.func.vmap` (a record batch on a limb
group): a batched tensor goes to a `torch.library.custom_op` whose vmap
rule moves the record axis to the front and runs one collective on the
stacked records (the gathered axis shifted by one), as the kernels' rules
fold the records into their rows (`kernels/batching.py`).  A batched call
counts once, whatever its records; every rank of the group must hold the
same batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.batching import LIB, handle, is_batched, lookup, unbatched


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` of `group`, in rank order, concatenated along `dim`,
    on `x`'s device (through host memory under gloo).  Every rank's `x`
    must have the same shape."""
    wire = x.contiguous()
    if dist.get_backend(group) == "gloo":
        wire = wire.cpu()
    blocks = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(blocks, wire, group=group)
    return torch.cat(blocks, dim=dim).to(x.device)


class LimbShard:
    """Data limbs [lo, hi) of a chain of k, held by this rank of the limb
    process group `group` (whose ranks hold the blocks in rank order)."""

    def __init__(self, lo: int, hi: int, k: int, group):
        if not 0 <= lo < hi <= k:
            raise ValueError(f"limbs [{lo}, {hi}) do not lie in a chain of {k}")
        self.lo, self.hi, self.k = lo, hi, k
        self.group = group
        self.counts = {"all_gather": 0, "all_reduce_sum": 0}

    def __repr__(self):
        return f"LimbShard([{self.lo}, {self.hi}) of {self.k})"

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' limb blocks of x, concatenated along `dim` (the
        limb axis of x), on x's device."""
        self.counts["all_gather"] += 1
        if is_batched(x):
            return _all_gather_op(x, handle(self), dim)
        return all_gather_cat(x, self.group, dim)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of x as int64, on x's device; x is not
        changed.  Exact while the sum stays below 2**63."""
        self.counts["all_reduce_sum"] += 1
        if is_batched(x):
            return _all_reduce_op(x, handle(self))
        return _all_reduce(x, self.group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    host = dist.get_backend(group) == "gloo"
    wire = x.to("cpu" if host else x.device, torch.int64, copy=True)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    return wire.to(x.device)


@torch.library.custom_op(f"{LIB}::limb_all_gather", mutates_args=())
def _all_gather_op(x: torch.Tensor, shard: int, dim: int) -> torch.Tensor:
    """`LimbShard.all_gather` of a tensor that is not batched (the shard
    by handle)."""
    return all_gather_cat(x, lookup(shard).group, dim)


@torch.library.register_vmap(_all_gather_op)
def _all_gather_vmap(info, in_dims, x, shard, dim):
    """[B, ...]: one all-gather of the stacked records along `dim` + 1."""
    unbatched(in_dims, "limb_all_gather")
    if in_dims[0] is None:
        return _all_gather_op(x, shard, dim), None
    x = x.movedim(in_dims[0], 0)
    return _all_gather_op(x, shard, dim if dim < 0 else dim + 1), 0


@torch.library.custom_op(f"{LIB}::limb_all_reduce_sum", mutates_args=())
def _all_reduce_op(x: torch.Tensor, shard: int) -> torch.Tensor:
    """`LimbShard.all_reduce_sum` of a tensor that is not batched."""
    return _all_reduce(x, lookup(shard).group)


@torch.library.register_vmap(_all_reduce_op)
def _all_reduce_vmap(info, in_dims, x, shard):
    """[B, ...]: one all-reduce of the stacked records."""
    unbatched(in_dims, "limb_all_reduce_sum")
    if in_dims[0] is None:
        return _all_reduce_op(x, shard), None
    return _all_reduce_op(x.movedim(in_dims[0], 0), shard), 0
