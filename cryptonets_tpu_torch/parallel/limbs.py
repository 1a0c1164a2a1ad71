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
    the exact host decrypt composes every limb;
  * `all_reduce_sum(x)`: the int64 sum over the ranks: a fast base
    conversion out of base q (BEHZ lift and scale, the gamma and two-plane
    decrypts) sums its terms over every source limb, so each rank adds its
    own limbs' terms and the partial sums, each below 2**32, are summed
    exactly in int64.

Under gloo the tensors cross through host memory (gloo collectives run on
host tensors); under NCCL they stay on the device.  Each call counts
itself by kind (`counts`), so a run can report its collectives per
record.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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
        return all_gather_cat(x, self.group, dim)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of x as int64, on x's device; x is not
        changed.  Exact while the sum stays below 2**63."""
        self.counts["all_reduce_sum"] += 1
        host = dist.get_backend(self.group) == "gloo"
        wire = x.to("cpu" if host else x.device, torch.int64, copy=True)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.group)
        return wire.to(x.device)
