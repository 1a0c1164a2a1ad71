"""The kernels as operators that `torch.func.vmap` can batch.

A kernel's wrapper launches through ctypes on `x.data_ptr()`, which a
tensor inside `vmap` does not have.  Each kernel module therefore also
registers its entry point as a `torch.library.custom_op` whose vmap rule
folds the record axis into the rows the kernel already loops over, and
its wrapper sends a batched tensor there (`is_batched`).  A plain tensor
goes straight to the existing launch, so the eager path pays no
dispatcher time.  An operator takes tensors and numbers only: the tables
and prepared weights it needs travel as an integer handle (`handle`,
`lookup`), kept while the object lives.

The op body dispatches as the wrapper does (the hand kernel on CUDA, the
plain version on the CPU), so the fold runs on the CPU as on the card.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._pytree import tree_leaves

LIB = "cryptonets_torch"

_OBJECTS: "weakref.WeakValueDictionary[int, object]" = weakref.WeakValueDictionary()


def is_batched(x: torch.Tensor) -> bool:
    """True for a tensor inside `torch.func.vmap` (a batched tensor of
    functorch, which has no storage of its own)."""
    return torch._C._functorch.is_batchedtensor(x)


def handle(obj) -> int:
    """An integer that names `obj` to an operator while `obj` lives."""
    _OBJECTS[id(obj)] = obj
    return id(obj)


def lookup(h: int):
    """The object an operator's handle names."""
    return _OBJECTS[h]


def unbatched(in_dims, op: str) -> None:
    """Raise unless only the first argument (the data) is batched."""
    if any(d is not None for d in tree_leaves(list(in_dims[1:]))):
        raise ValueError(f"{op} batches its data only, not its tables")
