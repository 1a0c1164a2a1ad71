"""The port's `parallel/` package against the JAX package's, on the CPU:

  * `make_mesh`'s factoring against the JAX `make_mesh` on its 8 virtual
    devices, for 1-8 ranks; `local_record_slice` against the reference's
    arithmetic, the ragged-split error too; the placement specs; a mesh
    with limb > 1 raising NotImplementedError wherever it is used;
  * the tiny LoLa network of `parallel/dryrun.py` (n = 256, hybrid key
    switching): its weights equal the reference's; 2 and 4 ranks under
    gloo (spawned processes), {batch: ranks, limb: 1}: the input
    ciphertexts encrypted once, each rank's outputs for its records
    bit-equal to the one-process run on the same ciphertexts, the global
    batch assembled by all-gather equal to it, and the decrypted outputs
    equal to the JAX package's `build_tiny_lola(encrypt=False)` oracle;
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


def test_limb_axis_is_not_ported():
    m = mesh.Mesh(1, 2)
    x = torch.zeros(1, 2, 2, 4, 8)
    for use in (m.batch_index, lambda: shard_ciphertext_data(x, m),
                lambda: batch_sharding(m, 5), lambda: global_ciphertext_batch(x, m),
                lambda: dryrun.dryrun_production(m, device="cpu")):
        with pytest.raises(NotImplementedError, match="not ported"):
            use()


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


@pytest.mark.parametrize("ranks", [2, 4])
def test_gloo_ranks_bit_equal_to_one_process(one_process, ranks, monkeypatch):
    """`ranks` spawned processes under gloo, each on its own records of the
    same ciphertexts (each rank also holds its records to the Raw oracle):
    every rank's outputs equal the one-process run's for its records, and
    the all-gathered global batch equals the whole run.  The ranks run one
    torch thread each (they inherit OMP_NUM_THREADS)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    path, _, stacked = one_process
    results = distributed.run_ranks(dryrun.sharded_rank, ranks, 4, path, "cpu",
                                    backend="gloo")
    per = 4 // ranks
    for r, res in enumerate(results):
        assert res["records"] == (r * per, (r + 1) * per)
        assert res["window_s"] >= res["forward_s"] > 0
        assert torch.equal(res["outputs"][0], stacked[r * per:(r + 1) * per])
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
    for f, d in zip(pipe.factories, pipe.devices):
        assert f is fac and d == torch.device("cpu") and f.device == d
        assert f.keys.relin.k0.device == d
    assert all(layer.factory is f for g, f in zip(pipe.groups, pipe.factories)
               for layer in g)
    return pipe.run_stream(5)


def test_pipeline_one_and_three_stages(raw_outputs):
    one, three = _stream(1), _stream(3)
    assert len(one) == len(three) == 3
    for a, b, want in zip(one, three, raw_outputs):
        assert torch.equal(a.vectors[0].data, b.vectors[0].data)
        got = np.asarray(b.get_column(0).decrypt(), float)
        np.testing.assert_allclose(got[: len(want)], want, atol=1e-9)


def test_pipeline_stages_on_factories_of_their_own(monkeypatch, raw_outputs):
    """The path of stages on other cards, on the CPU: `CrtBfvFactory.to`
    made to build a factory wherever it is asked (as for another card), so
    stages 1 and 2 get factories of their own, holding the same keys, and
    their layers are prepared again for them; the records cross to them
    and decrypt to the Raw oracle's values, bit-equal to one stage."""
    from cryptonets_tpu_torch.api import factory as factory_mod

    one = _stream(1)
    monkeypatch.setattr(factory_mod, "canonical", lambda device: object())
    head, fac, reader = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    reader.set_source_records(dryrun.records_for(3, seed=29))
    pipe = PipelineForward(head, n_stages=3, devices=["cpu"] * 3)
    assert len({id(f) for f in pipe.factories}) == 3
    for f in pipe.factories:
        assert torch.equal(f.keys.relin.k0, fac.keys.relin.k0)
    dense = pipe.groups[2][-1]
    assert dense.factory is pipe.factories[2]
    assert dense.weights_matrix.factory is pipe.factories[2]
    outs = pipe.run_stream(5)
    for a, b, want in zip(one, outs, raw_outputs):
        assert b.factory is pipe.factories[2]
        assert torch.equal(a.vectors[0].data, b.vectors[0].data)
        got = np.asarray(b.get_column(0).decrypt(), float)
        np.testing.assert_allclose(got[: len(want)], want, atol=1e-9)


def test_pipeline_refuses_more_stages_than_devices_or_layers():
    head, _, _ = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    with pytest.raises(ValueError):
        PipelineForward(head, n_stages=3, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        PipelineForward(head, n_stages=5, devices=["cpu"] * 5)
