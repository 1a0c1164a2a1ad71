"""Record batches on the `limb` axis of the port's mesh, on the CPU: gloo
ranks at {batch: 1, limb: 2} and {2, 2} run the tiny LoLa network of
`parallel/dryrun.py` on the same input ciphertexts once as a loop over
their records and once as one record batch, the layers under
`torch.func.vmap` with the limb collectives inside it (`parallel/
limbs.py`'s custom operators).  The batch's outputs are bit-equal to the
loop's and to the one-process run's, and a batched cross-limb operation
counts one collective for the batch: the batch's collectives a record are
the loop's divided by the batch size.  Ranks of a limb group that hold
batches of different sizes are refused.

The ranks' functions live in this module, whose top level imports no JAX
(the spawned processes import it).
"""

import datetime

import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu_torch.parallel import distributed, dryrun  # noqa: E402

RECORDS = 4
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


def _raw():
    rh, _, rr = dryrun.build_tiny_lola(encrypt=False)
    return rh, rr


def _unequal_batch_rank():
    """Rank r of a {1, 2} group runs a batch of 2 + r records."""
    import torch.distributed as dist

    from cryptonets_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(batch=1)
    head, fac, _ = dryrun.build_tiny_lola(
        encrypt=True, device="cpu", shard=mesh.limb_shard(dryrun.TINY_LIMBS))
    dryrun.run_sharded_forward(mesh, head, fac,
                               dryrun.records_for(2 + dist.get_rank()), _raw,
                               batched=True)


def _loop_and_batch_rank(path, batch):
    """One rank: the loop, then the batch, on the saved inputs."""
    torch.set_num_threads(1)
    return [dryrun.sharded_rank(RECORDS, path, "cpu", batch, batched)
            for batched in (False, True)]


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The 4 records' input ciphertexts, encrypted once and saved for the
    ranks, and the one-process run's stacked output columns on them."""
    torch.set_num_threads(1)
    head, _, _ = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    forward, batched = dryrun.batched_encrypted_forward(head,
                                                        dryrun.records_for(RECORDS))
    outs = forward(batched)
    path = str(tmp_path_factory.mktemp("inputs") / "inputs.pt")
    torch.save(batched, path)
    return path, torch.stack([o.vectors[0].data for o in outs])


@pytest.mark.parametrize("ranks,batch", [(2, 1), (4, 2)], ids=["1x2", "2x2"])
def test_batched_limb_ranks_bit_equal_to_the_loop(one_process, ranks, batch,
                                                  monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    path, stacked = one_process
    results = distributed.run_ranks(_loop_and_batch_rank, ranks, path, batch,
                                    backend="gloo", timeout=GROUP_TIMEOUT)
    per = RECORDS // batch
    for loop, batched in results:
        assert batched["mesh"] == loop["mesh"] == {"batch": batch,
                                                   "limb": ranks // batch}
        assert batched["limbs"] == loop["limbs"]
        for a, b in zip(loop["outputs"], batched["outputs"]):
            assert torch.equal(a, b)
        assert torch.equal(batched["global_output"], stacked)
        assert torch.equal(loop["global_output"], stacked)
        assert set(batched["collectives"]) == {"all_gather", "all_reduce_sum"}
        # the forward's multiplies and key switches gather; nothing in it
        # sums over the ranks
        assert loop["collectives"]["all_gather"] > 0
        assert loop["collectives"]["all_reduce_sum"] == 0
        for kind, n in loop["collectives"].items():
            assert batched["collectives"][kind] * per == n, kind


def test_limb_group_refuses_batches_of_different_sizes(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(Exception, match="one size for all"):
        distributed.run_ranks(_unequal_batch_rank, 2, backend="gloo",
                              timeout=GROUP_TIMEOUT)
