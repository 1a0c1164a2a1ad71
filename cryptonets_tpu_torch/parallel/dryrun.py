"""Multi-rank validation harness, port of `cryptonets_tpu/parallel/
dryrun.py`: a real LoLa-shaped encrypted network (LLConvReader -> Encrypt
-> LLPoolLayer -> Vectorize -> Square -> LLDenseLayer, the LoLaSmall
topology) run over the records of a (batch, limb) mesh of ranks, each
record's decrypted output held exactly to the Raw oracle.

The JAX package vmaps the forward over the record axis and lets GSPMD
shard it; here each rank loops over its own block of records through
`nn/forward.EncryptedForward` (one launch sequence a record; batching
records into single launches is later work), and ranks talk only where
outputs are assembled or verdicts gathered (and at the two barriers that
bound a timed window).  The record axis shards over
`batch`; a mesh with limb > 1 raises NotImplementedError.

Used by `dryrun_multichip` (the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`), `chip_smoke.py`'s `parallel` phase
and `scripts/torch_weak_scaling.py` / `scripts/torch_multihost_worker.py`.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device, synchronize
from ..nn.forward import EncryptedForward, split_at_encrypt
from .mesh import make_mesh, shard_ciphertext_data


def build_tiny_lola(encrypt: bool = True, n: int = 256, seed: int = 3,
                    device=None):
    """(head, factory, reader): the LoLaSmall topology at ring degree n
    with hybrid key switching (n_special = 2, as the lola_small preset),
    its weights drawn as the reference's from numpy's default_rng(seed);
    the encrypted factory on `device` (the card unless named)."""
    from ..api.factory import CrtBfvFactory, RawFactory
    from ..crypto.primes import ntt_primes
    from ..nn.layers import EncryptLayer, SquareActivation
    from ..nn.lola import LLDenseLayer, LLPoolLayer, LLVectorizeLayer
    from ..nn.readers import LLConvReader

    rng = np.random.default_rng(seed)
    geo = dict(input_shape=[8, 8], kernel_shape=[3, 3], upper_padding=[1, 1],
               stride=[2, 2])
    fac = (
        CrtBfvFactory(plain_primes=ntt_primes(n, 17, 2), n=n,
                      coeff_modulus=ntt_primes(n, 30, 4), dbc=16, seed=seed,
                      n_special=2, device=device)
        if encrypt else RawFactory(n)
    )
    reader = LLConvReader(RawFactory(n), normalization_factor=1.0, scale=2.0, **geo)
    enc = EncryptLayer(reader)
    enc.factory = fac
    maps = 2
    conv = LLPoolLayer(enc, map_count=[maps, 1],
                       weights=rng.integers(-2, 3, maps * 9).astype(float),
                       bias=rng.integers(-2, 3, maps).astype(float),
                       weights_scale=2.0, **geo)
    act = SquareActivation(LLVectorizeLayer(conv))
    feat = maps * len(conv.engine.corners)
    head = LLDenseLayer(act, weights=rng.integers(-2, 3, 4 * feat).astype(float),
                        bias=rng.integers(-2, 3, 4).astype(float),
                        weights_scale=2.0, input_format="dense")
    head.prepare_network()
    return head, fac, reader


def records_for(n_records: int, side: int = 8, seed: int = 11):
    rng = np.random.default_rng(seed)
    return [(0, rng.integers(0, 4, side * side).astype(float))
            for _ in range(n_records)]


def _copies(recs):
    return [(lb, f.copy()) for lb, f in recs]


def _reader_records(head, recs):
    """(fwd, raws): the network's EncryptedForward with `recs` set as its
    reader's source, and the reader's records of them."""
    fwd = EncryptedForward(head)
    fwd.reader.set_source_records(_copies(recs))
    return fwd, list(iter(fwd.reader.get_next, None))


def _input_matrices(fwd, raws, datas):
    """The B records' input matrices from their stacked input columns
    (one [B, P, C, 2, k, N] tensor a column), their dim and scale read
    off the reader's first record."""
    _, (_, _, dim, scale) = fwd.slot_ints(raws[0])
    return [fwd.input_matrix([d[b] for d in datas], dim, scale)
            for b in range(datas[0].shape[0])]


def batched_encrypted_forward(head, recs):
    """(forward, batched): `batched` the records' encrypted input columns
    stacked, one [B, P, C, 2, k, N] tensor a column (a global batch to
    save and cut into ranks' blocks); forward(batched) -> the B output
    matrices, one record at a time through the layers."""
    fwd, raws = _reader_records(head, recs)
    mats = [fwd.encrypt(raw) for raw in raws]
    batched = [torch.stack([m.vectors[i].data for m in mats])
               for i in range(len(mats[0].vectors))]

    def forward(datas):
        return [fwd.run_encrypted(m) for m in _input_matrices(fwd, raws, datas)]

    return forward, batched


def _barrier(mesh):
    """Wait for every rank of the mesh's batch group (none on one rank)."""
    group = mesh.batch_group()
    if group is None:
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def run_sharded_forward(mesh, head, fac, recs, build_raw, inputs=None) -> dict:
    """Run this rank's block of `recs` (the b-th of the mesh's batch
    blocks) through the encrypted network and hold each record's
    decrypted output to the Raw oracle (`build_raw()` -> (head, reader)),
    atol 1e-9 as the reference.  `inputs`: the global batch's encrypted
    input columns ([B, P, C, 2, k, N] each), encrypted once elsewhere; by
    default the rank encrypts only its own records, each into its own
    input matrix.  Returns the mesh shape, the limb count, this rank's
    records (start, stop), its output columns ([B_local, P, C, size, k, N]
    each) and two host-clock times after one warm-up record: `forward_s`
    this rank's own forward, the device synchronised, and `window_s` the
    group's window, from a barrier of every rank of the batch axis before
    the forward to one after every rank's forward has synchronised (on one
    rank the two are the same)."""
    b = mesh.batch_index()
    parts = mesh.shape["batch"]
    if len(recs) % parts:
        raise ValueError(f"{len(recs)} records do not split into {parts} "
                         f"equal blocks over the batch axis")
    per = len(recs) // parts
    local_recs = recs[b * per:(b + 1) * per]
    fwd, raws = _reader_records(head, local_recs)
    if inputs is None:
        mats = [fwd.encrypt(raw) for raw in raws]
    else:
        mats = _input_matrices(fwd, raws, [
            shard_ciphertext_data(d, mesh, batch_axis=0).to(fac.device)
            for d in inputs])
    fwd.run_encrypted(mats[0])           # one warm-up record, not timed
    synchronize(fac)
    _barrier(mesh)
    t0 = time.perf_counter()
    outs = [fwd.run_encrypted(m) for m in mats]
    synchronize(fac)
    seconds = time.perf_counter() - t0
    _barrier(mesh)
    window = time.perf_counter() - t0

    raw_head, raw_reader = build_raw()
    raw_reader.set_source_records(_copies(local_recs))
    for out in outs:
        want = np.asarray(raw_head.get_next().get_column(0).decrypt(), float)
        got = np.asarray(out.get_column(0).decrypt(), float)
        np.testing.assert_allclose(got[: len(want)], want, atol=1e-9)
    return dict(mesh=dict(mesh.shape), n_limbs=len(fac.coeff_modulus),
                records=(b * per, (b + 1) * per), forward_s=seconds,
                window_s=window,
                outputs=[torch.stack([o.vectors[i].data for o in outs])
                         for i in range(len(outs[0].vectors))])


def dryrun_production(mesh, n_records: int | None = None, seed: int = 13,
                      device=None) -> dict:
    """The production LoLaSmall network at n = 8192 over the mesh's
    records, each rank encrypting and evaluating its own, every record
    exact against the Raw oracle.  The chain is 6 data limbs and 1 special
    prime (186 data bits, at least the preset's 130-bit SEAL requirement;
    7 x 31 = 217 of the 218 bits 128-bit security allows at n = 8192), the
    reference's dry-run chain, passed to `make_factory` as overrides of
    the lola_small preset; the factory is set on the network's
    EncryptLayer before `prepare_network`.  Records: synthetic MNIST of
    `seed`, max(2, batch) by default."""
    from ..data.preprocess import synthetic_mnist_records
    from ..models.lola_mnist import build_lola_small
    from ..models.presets import make_factory

    mesh.batch_index()
    if n_records is None:
        n_records = max(2, int(mesh.shape["batch"]))
    recs = synthetic_mnist_records(n_records, seed=seed)
    fac = make_factory("lola_small", True, device=resolve_device(device),
                       coeff_count=6, n_special=1)
    head, _, _ = build_lola_small(False)
    split_at_encrypt(head)[0].factory = fac
    head.prepare_network()

    def build_raw():
        rh, _, rr = build_lola_small(False)
        rh.prepare_network()
        return rh, rr

    return run_sharded_forward(mesh, head, fac, recs, build_raw)


def sharded_rank(n_records: int, inputs_path: str | None = None, device=None) -> dict:
    """One rank of the tiny LoLa dry run over {batch: world size, limb: 1}:
    its block of `records_for(n_records)`, encrypted by the rank or read
    from `inputs_path` (`torch.save` of the global batch's input columns,
    encrypted once), through `run_sharded_forward`; then the global
    output batch assembled from every rank's block
    (`global_ciphertext_batch`).  Returns its records (start, stop), its
    output columns and the global first column, on the CPU."""
    from .distributed import global_ciphertext_batch

    mesh = make_mesh(batch=dist.get_world_size() if dist.is_initialized() else 1)
    head, fac, _ = build_tiny_lola(encrypt=True, device=device)
    inputs = None if inputs_path is None else torch.load(inputs_path)

    def build_raw():
        rh, _, rr = build_tiny_lola(encrypt=False)
        return rh, rr

    res = run_sharded_forward(mesh, head, fac, records_for(n_records), build_raw,
                              inputs=inputs)
    whole = global_ciphertext_batch(res["outputs"][0], mesh, batch_axis=0)
    return dict(res, outputs=[o.cpu() for o in res["outputs"]],
                global_output=whole.cpu())


SUMMARY = ("mesh", "n_limbs", "records", "forward_s", "window_s")


def production_rank(per_rank: int, device=None) -> dict:
    """One rank of `dryrun_production` over {batch: world size, limb: 1},
    `per_rank` records of its own; returns its verdict (the SUMMARY keys:
    a mismatch against the Raw oracle raises)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    res = dryrun_production(make_mesh(batch=n), n_records=n * per_rank,
                            device=device)
    return {k: res[k] for k in SUMMARY}


def multichip_rank(device=None) -> list:
    """One rank of `dryrun_multichip`: the tiny LoLa network
    (`sharded_rank`) and the production LoLaSmall over a mesh with every
    rank on `batch`, each rank's records exact against the Raw oracle (a
    mismatch raises); returns every rank's verdicts, gathered on each."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    tiny = sharded_rank(max(2, n), None, device)
    summary = dict(tiny={k: tiny[k] for k in SUMMARY},
                   production=production_rank(max(2, n) // n, device))
    if not dist.is_initialized():
        return [summary]
    out = [None] * n
    dist.all_gather_object(out, summary)
    return out


def dryrun_multichip(n_ranks: int, backend: str | None = None, device=None) -> list:
    """Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`:
    `n_ranks` processes on this host (`distributed.run_ranks`), a mesh of
    {batch: n_ranks, limb: 1}, the tiny LoLa network and the production
    LoLaSmall at n = 8192, every record exact against the Raw oracle.
    Prints what ran and returns the ranks' verdicts."""
    from .distributed import run_ranks

    verdicts = run_ranks(multichip_rank, n_ranks, device, backend=backend)[0]
    for name, what in (("tiny", "LoLa-topology network at n = 256 (conv/"
                                "vectorize/square/dense + hybrid key switching)"),
                       ("production", "LoLaSmall at n = 8192 (6 data + 1 "
                                      "special limbs)")):
        first = verdicts[0][name]
        print(f"dryrun_multichip {name} ok: mesh={first['mesh']}, {what}, "
              f"records {[v[name]['records'] for v in verdicts]} over batch, "
              f"{first['n_limbs']} limbs on every rank; decrypted outputs "
              f"match the Raw oracle exactly", flush=True)
    return verdicts
