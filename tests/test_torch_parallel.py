"""The port's `parallel/` package against the JAX package's, on the CPU:

  * `make_mesh`'s factoring against the JAX `make_mesh` on its 8 virtual
    devices, for 1-8 ranks; `local_record_slice` against the reference's
    arithmetic, the ragged-split error too; the placement specs; each
    rank's blocks of a mesh with limb > 1;
  * the tiny LoLa network of `parallel/dryrun.py` (n = 256, hybrid key
    switching): its weights equal the reference's; ranks under gloo
    (spawned processes) on the meshes {2, 1}, {4, 1} and the JAX
    package's defaults {1, 2} and {2, 2} (records over batch, RNS limbs
    over limb): the input ciphertexts encrypted once, each rank's outputs
    for its records and limbs bit-equal to the one-process run on the same
    ciphertexts, the global batch assembled by all-gathers equal to it,
    and the decrypted outputs equal to the JAX package's
    `build_tiny_lola(encrypt=False)` oracle;
  * `PipelineForward` with 1 and 3 stages on the CPU: equal outputs, the
    Raw oracle's values, each stage's factory and keys on its device.

Ciphertexts are compared bit-equal; decrypted values at atol 1e-9, as
the reference's dry run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu.parallel import distributed as jdist  # noqa: E402
from cryptonets_tpu.parallel import dryrun as jdry  # noqa: E402
from cryptonets_tpu.parallel import mesh as jmesh  # noqa: E402
from cryptonets_tpu_torch.parallel import (PipelineForward, batch_sharding,  # noqa: E402
                                           global_ciphertext_batch,
                                           local_record_slice, make_mesh,
                                           shard_ciphertext_data)
from cryptonets_tpu_torch.parallel import distributed, dryrun, mesh  # noqa: E402
from cryptonets_tpu_torch.parallel.pipeline import _groups  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread runs them as fast and
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------- mesh
@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_equals_reference(n):
    """The default factoring, where the reference's reshape fails (5 and 7
    ranks) too, and every rank on batch."""
    try:
        want = jmesh.make_mesh(n).shape
    except ValueError:
        with pytest.raises(ValueError):
            mesh.mesh_shape(n)
    else:
        assert mesh.mesh_shape(n) == (want["batch"], want["limb"])
    assert mesh.mesh_shape(n, batch=n) == (n, 1) == tuple(
        jmesh.make_mesh(n, batch=n).shape.values())


@pytest.mark.parametrize("hosts,index,records", [(1, 0, 5), (2, 1, 8), (4, 3, 8),
                                                 (3, 1, 7)])
def test_local_record_slice_equals_reference(monkeypatch, hosts, index, records):
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed.dist, "get_world_size", lambda: hosts)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda: index)
    monkeypatch.setattr(jdist.jax, "process_count", lambda: hosts)
    monkeypatch.setattr(jdist.jax, "process_index", lambda: index)
    if records % hosts:
        with pytest.raises(ValueError) as want:
            jdist.local_record_slice(records)
        with pytest.raises(ValueError) as got:
            local_record_slice(records)
        assert str(got.value) == str(want.value)
    else:
        assert local_record_slice(records) == jdist.local_record_slice(records)


def test_one_rank_mesh_and_specs():
    m = make_mesh()
    assert m.shape == {"batch": 1, "limb": 1} and m.batch_index() == 0
    assert mesh.ciphertext_spec() == tuple(jmesh.ciphertext_spec())
    assert batch_sharding(m, 6, 0).spec == tuple(
        jmesh.batch_sharding(jmesh.make_mesh(1), 6, 0).spec)
    x = torch.arange(2 * 4 * 3).reshape(2, 4, 3)
    assert torch.equal(shard_ciphertext_data(x, m), x)
    assert torch.equal(global_ciphertext_batch(x, m), x)
    with pytest.raises(ValueError):
        make_mesh(2)               # two ranks need a process group


class _Coordinate:
    """A device mesh that only says this rank's coordinate."""

    def __init__(self, coordinate):
        self.coordinate = coordinate

    def get_coordinate(self):
        return list(self.coordinate)

    def get_group(self, name):
        return None


@pytest.mark.parametrize("coordinate", [(0, 0), (1, 1)])
def test_limb_axis_blocks(coordinate):
    """A {2, 2} mesh's rank at `coordinate`: its batch and limb indices,
    its block of [P, C, size, k, N] data on both axes, its limb shard,
    the batch spec; a limb axis that does not divide k raises."""
    b, lb = coordinate
    m = mesh.Mesh(2, 2, _Coordinate(coordinate))
    assert (m.batch_index(), m.limb_index()) == coordinate
    x = torch.arange(2 * 4 * 2 * 6 * 8).reshape(2, 4, 2, 6, 8)
    assert torch.equal(shard_ciphertext_data(x, m),
                       x[:, 2 * b:2 * b + 2, :, 3 * lb:3 * lb + 3])
    y = x.movedim(1, 0).movedim(4, 3)                    # [C, P, size, N, k]
    assert torch.equal(shard_ciphertext_data(y, m, batch_axis=0, limb_axis=4),
                       y[2 * b:2 * b + 2, ..., 3 * lb:3 * lb + 3])
    shard = m.limb_shard(6)
    assert (shard.lo, shard.hi, shard.k) == (3 * lb, 3 * lb + 3, 6)
    assert mesh.Mesh(2, 1).limb_shard(6) is None
    assert batch_sharding(m, 5).spec == (None, "batch", None, None, None)
    with pytest.raises(ValueError):
        shard_ciphertext_data(x[..., :5, :], m)


def test_uneven_batch_split_raises():
    m = mesh.Mesh(2, 1)
    with pytest.raises(ValueError):
        shard_ciphertext_data(torch.zeros(1, 3, 2, 4, 8), m)


# ----------------------------------------------------------------- dry run
def test_tiny_lola_weights_equal_reference():
    ours, _, _ = dryrun.build_tiny_lola(encrypt=False)
    theirs, _, _ = jdry.build_tiny_lola(encrypt=False)
    while ours is not None:
        assert type(ours).__name__ == type(theirs).__name__
        for name in ("weights", "bias", "weights_scale"):
            a, b = getattr(ours, name, None), getattr(theirs, name, None)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        ours, theirs = ours.source, theirs.source
    assert theirs is None
    np.testing.assert_array_equal(
        np.stack([f for _, f in dryrun.records_for(3)]),
        np.stack([f for _, f in jdry.records_for(3)]))


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The input ciphertexts of 4 records encrypted once, saved for the
    ranks, and the one-process run's output columns on them."""
    head, fac, _ = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    forward, batched = dryrun.batched_encrypted_forward(head, dryrun.records_for(4))
    outs = forward(batched)
    path = str(tmp_path_factory.mktemp("inputs") / "inputs.pt")
    torch.save(batched, path)
    stacked = torch.stack([o.vectors[0].data for o in outs])
    return path, outs, stacked


def test_one_process_outputs_equal_reference_raw_oracle(one_process):
    _, outs, _ = one_process
    raw_head, _, raw_reader = jdry.build_tiny_lola(encrypt=False)
    raw_reader.set_source_records(jdry.records_for(4))
    for out in outs:
        want = np.asarray(raw_head.get_next().get_column(0).decrypt(), float)
        got = np.asarray(out.get_column(0).decrypt(), float)
        np.testing.assert_allclose(got[: len(want)], want, atol=1e-9)


@pytest.mark.parametrize("ranks,batch", [(2, 2), (4, 4), (2, None), (4, None)],
                         ids=["2x1", "4x1", "1x2", "2x2"])
def test_gloo_ranks_bit_equal_to_one_process(one_process, ranks, batch, monkeypatch):
    """`ranks` spawned processes under gloo on the mesh of `batch` (None:
    the default factoring, held to the JAX `make_mesh` default, as
    `dryrun_multichip` runs it), each on its own records and limbs of the
    same ciphertexts (each limb group also holds its records to the Raw
    oracle): every rank's outputs equal the one-process run's for its
    records and limbs, and the global batch all-gathered over both axes
    equals the whole run.  The ranks run one torch thread each (they
    inherit OMP_NUM_THREADS)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    path, _, stacked = one_process
    results = distributed.run_ranks(dryrun.sharded_rank, ranks, 4, path, "cpu",
                                    batch, backend="gloo")
    want = dict(jmesh.make_mesh(ranks, batch=batch).shape)
    per, limb = 4 // want["batch"], dryrun.TINY_LIMBS // want["limb"]
    for r, res in enumerate(results):
        b, lb = divmod(r, want["limb"])
        assert res["mesh"] == want
        assert res["records"] == (b * per, (b + 1) * per)
        assert res["limbs"] == (lb * limb, (lb + 1) * limb)
        assert res["window_s"] >= res["forward_s"] > 0
        assert torch.equal(res["outputs"][0],
                           stacked[b * per:(b + 1) * per, ..., lb * limb:(lb + 1) * limb, :])
        assert torch.equal(res["global_output"], stacked)


# ---------------------------------------------------------------- pipeline
def test_stage_groups_follow_the_reference_rule():
    for L, S, want in ((4, 3, [2, 1, 1]), (6, 3, [2, 2, 2]), (6, 4, [2, 2, 1, 1]),
                       (5, 1, [5])):
        assert [len(g) for g in _groups(list(range(L)), S)] == want


@pytest.fixture(scope="module")
def raw_outputs():
    raw_head, _, raw_reader = jdry.build_tiny_lola(encrypt=False)
    raw_reader.set_source_records(jdry.records_for(3, seed=29))
    return [np.asarray(raw_head.get_next().get_column(0).decrypt(), float)
            for _ in range(3)]


def _stream(stages):
    head, fac, reader = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    reader.set_source_records(dryrun.records_for(3, seed=29))
    pipe = PipelineForward(head, n_stages=stages, devices=["cpu"] * stages)
    assert len(pipe.groups) == stages
    outs = pipe.run_stream(5)
    for f, d in zip(pipe.factories, pipe.devices):
        assert f is not fac and d == torch.device("cpu") and f.device == d
        assert all(sk.k0.device == d for sk in f.keys.galois.values())
    assert all(layer.factory is f for g, f in zip(pipe.groups, pipe.factories)
               for layer in g)
    assert all(out.factory is fac for out in outs)
    return outs


def test_pipeline_one_and_three_stages(raw_outputs):
    one, three = _stream(1), _stream(3)
    assert len(one) == len(three) == 3
    for a, b, want in zip(one, three, raw_outputs):
        assert torch.equal(a.vectors[0].data, b.vectors[0].data)
        got = np.asarray(b.get_column(0).decrypt(), float)
        np.testing.assert_allclose(got[: len(want)], want, atol=1e-9)


def test_pipeline_stages_on_factories_of_their_own(raw_outputs):
    """Every stage gets a factory of its own (as on another card), holding
    its part of the head's keys, and its layers are prepared again for
    it; the records cross to them and back to the head's factory, and
    decrypt to the Raw oracle's values, bit-equal to one stage."""
    one = _stream(1)
    head, fac, reader = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    reader.set_source_records(dryrun.records_for(3, seed=29))
    pipe = PipelineForward(head, n_stages=3, devices=["cpu"] * 3)
    outs = pipe.run_stream(5)
    assert len({id(f) for f in pipe.factories} | {id(fac)}) == 4
    for f in pipe.factories:
        for g, sk in f.keys.galois.items():
            assert torch.equal(sk.k0, fac.keys.galois[g].k0)
    dense = pipe.groups[2][-1]
    assert dense.factory is pipe.factories[2]
    assert dense.weights_matrix.factory is pipe.factories[2]
    for a, b, want in zip(one, outs, raw_outputs):
        assert b.factory is fac
        assert torch.equal(a.vectors[0].data, b.vectors[0].data)
        got = np.asarray(b.get_column(0).decrypt(), float)
        np.testing.assert_allclose(got[: len(want)], want, atol=1e-9)


def test_pipeline_refuses_more_stages_than_devices_or_layers():
    head, _, _ = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    with pytest.raises(ValueError):
        PipelineForward(head, n_stages=3, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        PipelineForward(head, n_stages=5, devices=["cpu"] * 5)
