"""The compiled record (`nn/forward.py`: `record_fn`, `record_batch_fn`,
`run_batch`, `RecordGraph`) and the kernels as vmappable operators
(`kernels/batching.py`) against the JAX package on the CPU.

On the n = 256 tiny LoLa of `parallel/dryrun.py` (hybrid key switching,
two special primes), with the JAX factory's keys imported into the port:
  (a) `record_fn` on the JAX package's input ciphertexts gives output
      ciphertexts bit-equal to JAX's `EncryptedForward(jit=True)`
      (`nn/jit.py`), and its device-decoded slots equal the Raw oracle;
  (b) the record batch at B = 4, the layers under `torch.func.vmap`, is
      bit-equal to the JAX `batched_encrypted_forward` outputs on the same
      batched inputs, and to the port's eager loop over the records; an
      eager record (`__call__` without a graph) runs the record body, one
      slot map, its encrypted input and decoded outputs bit-equal to
      `record_fn`'s from the same generator state;
  (c) each kernel's operator under `torch.func.vmap` equals its loop over
      the records: K1/K2, K5 on its ring, K4 with the records folded into
      C > 1;
  (d) nothing falls back: `graph=True` on a CPU factory, a `RecordGraph`
      of CPU tensors and `run_batch` on a factory that encodes on the host
      raise;
  (e) the operation counts of B records are B times one record's.
The port runs on one torch thread.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cryptonets_tpu.api as japi  # noqa: E402
from cryptonets_tpu.api.matrix import HEMatrix as JMatrix  # noqa: E402
from cryptonets_tpu.api.vector import HEVector as JVector  # noqa: E402
from cryptonets_tpu.nn.jit import EncryptedForward as JaxForward  # noqa: E402
from cryptonets_tpu.parallel import dryrun as jdry  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory  # noqa: E402
from cryptonets_tpu_torch.convert import keyset_from_numpy  # noqa: E402
from cryptonets_tpu_torch.crypto.ntt import get_ntt_context  # noqa: E402
from cryptonets_tpu_torch.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.kernels import matmul_ntt as M  # noqa: E402
from cryptonets_tpu_torch.kernels import modmatmul as MM  # noqa: E402
from cryptonets_tpu_torch.kernels import ntt as K  # noqa: E402
from cryptonets_tpu_torch.nn.forward import EncryptedForward, RecordGraph, _split  # noqa: E402
from cryptonets_tpu_torch.parallel import dryrun  # noqa: E402
from cryptonets_tpu_torch.utils.opcount import OPS  # noqa: E402

B = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(a) -> torch.Tensor:
    """A JAX uint32 array as the port's int32 tensor, bit for bit."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny LoLa in both packages on the JAX factory's keys, the JAX
    package's input ciphertexts of B records (one [B, P, C, 2, k, N] array
    a column) and its vmapped outputs on them."""
    recs = dryrun.records_for(B)
    jhead, jfac, _ = jdry.build_tiny_lola(encrypt=True)
    vforward, batched, jfwd = jdry.batched_encrypted_forward(jhead, recs)
    jouts = jax.jit(vforward)(batched)         # as `run_sharded_forward` runs it
    path = str(tmp_path_factory.mktemp("keys") / "keys.npz")
    japi.CrtBfvFactory._save_cached_keys(path, jfac.keys)
    head, fac, _ = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    with np.load(path) as z:
        fac.keys = keyset_from_numpy(z, device="cpu")
    fwd = EncryptedForward(head)
    fwd.reader.set_source_records([(lb, f.copy()) for lb, f in recs])
    raws = list(iter(fwd.reader.get_next, None))
    raw_head, _, raw_reader = jdry.build_tiny_lola(encrypt=False)
    raw_reader.set_source_records(jdry.records_for(B))
    oracle = [np.asarray(raw_head.get_next().get_column(0).decrypt(), float)
              for _ in range(B)]
    return dict(jhead=jhead, jfwd=jfwd, batched=[_port(b) for b in batched],
                jouts=[_port(o) for o in jouts], fwd=fwd, fac=fac, raws=raws,
                oracle=oracle)


def _encrypting(fac, data, monkeypatch) -> list:
    """Make the factory's device encrypt of the reader's values return
    `data` (the JAX package's ciphertexts), so a record body runs its
    layers on them; the values it was handed are kept in the list
    returned."""
    handed = []

    def encrypt(x):
        handed.append(x)
        return data

    monkeypatch.setattr(fac, "_encrypt_values_dev", encrypt)
    return handed


def test_record_fn_layers_bit_equal_to_jax_jit(tiny, monkeypatch):
    """(a) One record: JAX's jitted layers and the port's record body on
    the same input ciphertexts; the body's decoded slots against the Raw
    oracle."""
    fwd, fac = tiny["fwd"], tiny["fac"]
    jfwd = JaxForward(tiny["jhead"], jit=True)
    x, (V, C, dim, scale) = fwd.slot_values(tiny["raws"][0])
    cols = [b[0] for b in tiny["batched"]]                 # [P, C, 2, k, N] each
    jf = jfwd.encrypt_layer.factory
    jin = JMatrix(jf, [JVector(jf, data=jnp.asarray(c.numpy().view(np.uint32)),
                               dim=dim, scale=scale, fmt="dense") for c in cols], "col")
    jout = jfwd.run_encrypted(jin)

    data = torch.stack(cols, dim=1).reshape(fac.P, V * C, *cols[0].shape[2:])
    handed = _encrypting(fac, data, monkeypatch)
    datas, slots, enc = fwd.record_fn(V, C, dim, scale)(x)
    assert enc is data
    # the body's slot map of what it was handed: JAX's slot buffers
    jbufs, jsig = jfwd.slot_bufs(tiny["raws"][0])
    assert jsig == (V, C, dim, scale) and len(handed) == 1
    assert torch.equal(fac.slot_map(handed[0]), _port(jbufs))
    assert len(datas) == len(jout.vectors) == 1
    np.testing.assert_array_equal(datas[0].numpy().view(np.uint32),
                                  np.asarray(jout.vectors[0].data))
    out = fwd._output_matrix(("fused", V, C, dim, scale), datas,
                             _split(slots.numpy().astype(np.int64), [d.shape[1] for d in datas]))
    got = np.asarray(out.get_column(0).decrypt(), float)
    want = tiny["oracle"][0]
    np.testing.assert_allclose(got[: len(want)], want, atol=1e-9)
    # the slots decoded in the body equal the eager decrypt of its output
    np.testing.assert_array_equal(out.vectors[0]._dec_slots,
                                  fac.decrypt_slots(datas[0]))


def test_record_batch_bit_equal_to_jax_vmap_and_eager_loop(tiny, monkeypatch):
    """(b) B = 4 records, the layers under vmap: bit-equal to the JAX
    package's vmapped forward and to the port's eager loop, every
    record's decoded logits equal to the Raw oracle; (e) its operation
    counts B times one record's."""
    fwd, fac = tiny["fwd"], tiny["fac"]
    batched = tiny["batched"]                                # [B, P, C, 2, k, N] a column
    V = len(batched)
    C = batched[0].shape[2]
    data = torch.stack(batched, dim=2)                       # [B, P, V, C, 2, k, N]
    flat = data.movedim(0, 1).reshape(fac.P, B * V * C, *data.shape[4:])
    handed = _encrypting(fac, flat, monkeypatch)

    OPS.reset()
    ones = [fwd.run_encrypted(fwd.input_matrix([b[r] for b in batched],
                                               *_dim_scale(fwd, tiny)))
            for r in range(B)]
    per_record = {k: v // B for k, v in OPS.reset().items()}

    outs = fwd.run_batch(tiny["raws"])
    counts = OPS.reset()
    assert counts == {k: B * v for k, v in per_record.items()}
    # one slot map of the B records' values: JAX's slot buffers, in order
    jbufs = torch.cat([_port(tiny["jfwd"].slot_bufs(r)[0]) for r in tiny["raws"]], dim=1)
    assert len(handed) == 1 and torch.equal(fac.slot_map(handed[0]), jbufs)
    jouts = tiny["jouts"]                                     # [B, P, C, s, k, N] a column
    assert len(outs) == B and len(jouts) == 1
    for r, (out, one) in enumerate(zip(outs, ones)):
        np.testing.assert_array_equal(out.vectors[0].data.numpy(), jouts[0][r].numpy())
        assert torch.equal(out.vectors[0].data, one.vectors[0].data)
        got = np.asarray(out.get_column(0).decrypt(), float)
        want = tiny["oracle"][r]
        np.testing.assert_allclose(got[: len(want)], want, atol=1e-9)
        assert out.get_column(0).noise_budget() > 0


def _dim_scale(fwd, tiny):
    _, (_, _, dim, scale) = fwd.slot_values(tiny["raws"][0])
    return dim, scale


def _eager_records_equal_the_body(fwd, fac, raws, monkeypatch) -> list:
    """The reader's records through eager `__call__`s: each runs the slot
    map once, and from the same generator state its encrypted input and
    decoded outputs equal `record_fn`'s body bit for bit.  The outputs."""
    maps, encs, outs = [], [], []
    slot_map, encrypt = fac.slot_map, fac._encrypt_values_dev
    monkeypatch.setattr(fac, "slot_map", lambda v: maps.append(v) or slot_map(v))
    monkeypatch.setattr(fac, "_encrypt_values_dev",
                        lambda v: encs.append(encrypt(v)) or encs[-1])
    for raw in raws:
        state, seen = fac._gen.get_state(), len(maps)
        out = fwd()
        assert len(maps) == seen + 1
        x, sig = fwd.slot_values(raw)
        assert torch.equal(maps[-1], x)              # the values handed over
        enc = encs[-1]
        fac._gen.set_state(state)
        datas, slots, data = fwd.record_fn(*sig)(x)
        assert torch.equal(data, enc)
        cols = _split(slots.numpy().astype(np.int64), [d.shape[1] for d in datas])
        for v, d, c in zip(out.vectors, datas, cols, strict=True):
            assert torch.equal(v.data, d) and np.array_equal(v._dec_slots, c)
        outs.append(out)
    return outs


@pytest.mark.parametrize("path", ["batch", "record"])
def test_run_batch_own_encryption_matches_oracle(path, monkeypatch):
    """The record batch end to end on the port's own keys and encryption:
    the B records' logits equal the Raw oracle's, and the vmapped layers
    equal the eager layers on the batch's own input ciphertexts; `record`:
    the same records one eager `__call__` each, which runs the record body
    (`_eager_records_equal_the_body`), their logits equal the oracle's."""
    head, fac, _ = dryrun.build_tiny_lola(encrypt=True, device="cpu", seed=5)
    fwd = EncryptedForward(head)
    fwd.reader.set_source_records(dryrun.records_for(3, seed=12))
    raws = list(iter(fwd.reader.get_next, None))
    if path == "record":
        fwd.reader.set_source_records(dryrun.records_for(3, seed=12))
        outs = _eager_records_equal_the_body(fwd, fac, raws, monkeypatch)
    else:
        x = torch.cat([fwd.slot_values(r)[0] for r in raws])     # [3, dim, V]
        V, C, dim, scale = fwd.slot_values(raws[0])[1]
        outs, slots, data = fwd.record_batch_fn(3, V, C, dim, scale)(x)
        for r in range(3):
            one = fwd.run_encrypted(fwd.input_matrix([data[r][:, i] for i in range(V)],
                                                     dim, scale))
            assert torch.equal(outs[0][r], one.vectors[0].data)
        outs = fwd.run_batch(raws)
    raw_head, _, raw_reader = dryrun.build_tiny_lola(encrypt=False, seed=5)
    raw_reader.set_source_records(dryrun.records_for(3, seed=12))
    assert len(outs) == 3
    for out in outs:
        want = np.asarray(raw_head.get_next().get_column(0).decrypt(), float)
        got = np.asarray(out.get_column(0).decrypt(), float)
        np.testing.assert_allclose(got[: len(want)], want, atol=1e-9)


# ------------------------------------------------------------- the ops
def _residues(shape, mods, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.tensor(mods, dtype=torch.int64).view(-1, 1)
    return (torch.randint(0, 1 << 31, shape, generator=g) % q).to(torch.int32)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("impl", ["butterfly", "matmul"])
@pytest.mark.parametrize("in_dim", [0, 2])
def test_ntt_ops_under_vmap_equal_loop(impl, inverse, in_dim):
    """(c) K1/K2 and K5 (on its own ring, n = 64) under vmap, the records
    on a leading or an inner axis, against the loop over the records."""
    n, mods = 64, ntt_primes(64, 30, 3)
    x = _residues((B, 2, 3, n), mods, seed=1).movedim(0, in_dim)
    if impl == "butterfly":
        tab = get_ntt_context(n, mods).tables("cpu")
        fn = K.ntt_inverse if inverse else K.ntt_forward
    else:
        tab = M.host_tables(n, mods)
        fn = M.matmul_ntt_inverse if inverse else M.matmul_ntt_forward
    got = torch.func.vmap(lambda a: fn(a.contiguous(), tab), in_dims=in_dim)(x)
    want = torch.stack([fn(a.contiguous(), tab) for a in x.unbind(in_dim)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("prepared", [True, False], ids=["prepared", "raw"])
def test_contract_op_folds_records_into_columns(C, prepared):
    """(c) K4 under vmap folds the B records into the column axis
    ([P, O, B*C, s, k, N]): equal to the loop over the records, from
    prepared and from raw weights, at C = 1 and C = 3."""
    n, mods = 64, ntt_primes(64, 30, 3)
    W = np.random.default_rng(2).integers(-9, 10, (5, 4))
    w = MM.prepare_contract(W, mods, "cpu") if prepared else W
    q_col = torch.tensor(mods, dtype=torch.int64).view(-1, 1)
    x = _residues((B, 2, 4, C, 2, 3, n), mods, seed=3)
    got = torch.func.vmap(lambda a: MM.exact_mod_contract(w, a, mods, q_col))(x)
    want = torch.stack([MM.exact_mod_contract(w, a, mods, q_col) for a in x])
    assert got.shape == (B, 2, 5, C, 2, 3, n)
    assert torch.equal(got, want)


# ---------------------------------------------------------- refusals
def test_graph_on_cpu_factory_raises():
    """(d) A CUDA graph has no CPU counterpart: the constructor and a
    graph of CPU tensors raise, and nothing runs eagerly instead."""
    head, _, _ = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        EncryptedForward(head, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        RecordGraph(lambda x: x + 1, [torch.zeros(4)])
    with pytest.raises(ValueError, match="graph=True"):
        EncryptedForward(head).run_graph(None)


def test_run_batch_on_host_encode_factory_raises():
    """(d) A factory whose plain primes pass 2**31 encodes on the host: a
    record batch refuses it, as `bench.py`'s BENCH_VMAP does."""
    head, _, _ = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    fwd = EncryptedForward(head)
    fwd.encrypt_layer.factory = CrtBfvFactory(
        plain_primes=[p for p in ntt_primes(256, 33, 1)], n=256,
        coeff_modulus=ntt_primes(256, 30, 4), device="cpu")
    assert not fwd.factory.encodes_on_device
    fwd.reader.set_source_records(dryrun.records_for(2))
    with pytest.raises(ValueError, match="encodes on the host"):
        fwd.run_batch(list(iter(fwd.reader.get_next, None)))


def test_sharded_forward_batched_equals_loop():
    """`run_sharded_forward(batched=True)` on one rank (the record batch
    of `scripts/torch_weak_scaling.py --batch`): the block's outputs on
    the same input ciphertexts bit-equal to the loop over the records,
    every record held to the Raw oracle inside (a limb group's batch:
    `tests/test_torch_limb_batch.py`)."""
    from cryptonets_tpu_torch.parallel.mesh import make_mesh

    def build_raw():
        rh, _, rr = dryrun.build_tiny_lola(encrypt=False)
        return rh, rr

    head, fac, _ = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    recs = dryrun.records_for(3)
    loop = dryrun.run_sharded_forward(make_mesh(), head, fac, recs, build_raw)
    batch = dryrun.run_sharded_forward(make_mesh(), head, fac, recs, build_raw,
                                       inputs=loop["inputs"], batched=True)
    assert all(torch.equal(a, b) for a, b in zip(loop["outputs"], batch["outputs"]))
