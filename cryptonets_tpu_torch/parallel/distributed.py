"""Multi-process scaling on `torch.distributed`: process-group set-up,
each rank's slice of a record batch, and the assembly of a global
ciphertext batch; port of `cryptonets_tpu/parallel/distributed.py`.

  * One process per card.  `init_multihost` joins the default process
    group against a coordinator's TCP address; every rank then builds the
    same (batch, limb) mesh over the group (`mesh.make_mesh`).
  * The record axis shards over `batch`.  Records are independent, so a
    rank encodes, encrypts and evaluates only its own records
    (`local_record_slice`), and ranks talk only where records are
    assembled (`global_ciphertext_batch`) or verdicts gathered.
  * The RNS limbs shard over `limb`: the ranks of a limb group hold the
    blocks of the same ciphertexts and meet at every cross-limb operation
    (`limbs.py`).
  * Nothing picks a backend behind the caller's back: the default is
    NCCL, the card's.  Two ranks on one card must ask for gloo (NCCL
    refuses a card twice), whose collectives then run on host tensors.

`run_ranks` starts such a group of processes on this host (the spawn
start method, a localhost port): the multi-process dry runs, their tests
and `scripts/torch_multihost_worker.py` use it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile

import torch
import torch.distributed as dist

from .limbs import all_gather_cat
from .mesh import Mesh, make_mesh

# how long a collective waits for the other ranks before it raises
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    single_process: bool = False,
    backend: str | None = None,
    timeout: datetime.timedelta | None = None,
) -> None:
    """Join the default process group (idempotent): `coordinator_address`
    "host:port" (rank 0 listens there), `num_processes` ranks, this one
    `process_id`; `backend` "nccl" (the default) or "gloo"; a collective
    waits `timeout` (COLLECTIVE_TIMEOUT by default) for the others.  Where
    CUDA is available the rank takes card `process_id % device_count`.  A single process
    must opt in with `single_process=True` (it then joins no group): that
    is never inferred from missing arguments, so a rank that forgets its
    coordinator fails instead of running the whole batch alone."""
    if dist.is_initialized() or single_process:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id, or single_process=True")
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend or "nccl", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timeout or COLLECTIVE_TIMEOUT)


def local_record_slice(n_records: int) -> slice:
    """This rank's contiguous slice of a global record batch: rank i of H
    gets records [i R / H, (i + 1) R / H).  R must divide evenly, so the
    ranks' blocks assemble into one batch; pad the batch (repeat the last
    record) to a multiple of the rank count first."""
    h = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    if n_records % h:
        raise ValueError(
            f"record count {n_records} must be a multiple of the host "
            f"count {h} (pad the batch before slicing; uneven local "
            "shards cannot be assembled into one global batch array)"
        )
    per = n_records // h
    return slice(i * per, (i + 1) * per)


def global_ciphertext_batch(local_data: torch.Tensor, mesh: Mesh | None = None,
                            batch_axis: int = 1, limb_axis: int = 3) -> torch.Tensor:
    """The global batch ([P, C, size, k, N] by default, C = the records of
    every rank, k every limb) from each rank's own block: an all-gather
    over the mesh's limb group along `limb_axis` (when the limb axis is
    more than 1), then one over its batch group along `batch_axis`, the
    blocks in rank order, on every rank.  Under gloo the blocks cross
    through host memory; the result lies on `local_data`'s device.  Every
    rank's block must have the same shape."""
    mesh = mesh or make_mesh()
    out = local_data
    if mesh.shape["limb"] > 1:
        out = all_gather_cat(out, mesh.limb_group(), limb_axis)
    group = mesh.batch_group()
    return out if group is None else all_gather_cat(out, group, batch_axis)


# ------------------------------------------------- ranks of one host
def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, n_ranks, port, backend, timeout, out_dir, fn, args):
    """A spawned rank: join the group, run fn(*args), write its result."""
    init_multihost(f"127.0.0.1:{port}", n_ranks, rank, backend=backend,
                   timeout=timeout)
    try:
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n_ranks: int, *args, backend: str | None = None,
              timeout: datetime.timedelta | None = None) -> list:
    """Run fn(*args) on `n_ranks` processes of this host in one process
    group (`init_multihost` on a free localhost port, `backend` and
    `timeout` as there),
    started by `torch.multiprocessing` with the spawn method; `fn` must be
    a module-level function.  Returns each rank's result in rank order.
    A rank that fails ends the others and raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_entry, args=(n_ranks, free_port(), backend, timeout,
                                    out_dir, fn, args),
                 nprocs=n_ranks, join=True, start_method="spawn")
        results = []
        for r in range(n_ranks):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results
