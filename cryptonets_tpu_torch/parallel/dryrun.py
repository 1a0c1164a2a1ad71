"""Multi-rank validation harness, port of `cryptonets_tpu/parallel/
dryrun.py`: a real LoLa-shaped encrypted network (LLConvReader -> Encrypt
-> LLPoolLayer -> Vectorize -> Square -> LLDenseLayer, the LoLaSmall
topology) run over the records of a (batch, limb) mesh of ranks, each
record's decrypted output held exactly to the Raw oracle.

The JAX package vmaps the forward over the record axis and lets GSPMD
shard it; here each rank runs its own block of records through
`nn/forward.EncryptedForward`: one record at a time, or with `batched`
as one record batch, the layers under `torch.func.vmap` (one launch a
kernel for the block, and on a limb group one collective a cross-limb
operation for the block: `limbs.py`).  The record axis shards over
`batch`: the ranks of a batch group talk only where outputs are assembled
or verdicts gathered (and at the two barriers that bound a timed window).
The RNS limbs shard over `limb`: the ranks of a limb group run the same
records, each on its own block of the data limbs with its own limbs of
the key set (`CrtBfvFactory(shard=mesh.limb_shard(k))`), and meet at every
cross-limb operation (`limbs.py`).  A rank encrypts whole ciphertexts and
keeps its limb block, as the reference encrypts unsharded and then places
the blocks: its encrypt draws the same randomness as the unsharded one on
every limb, so its block is the whole ciphertext's.

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
from .limbs import all_gather_cat
from .mesh import make_mesh, mesh_shape, shard_ciphertext_data


TINY_LIMBS = 4       # the tiny network's data limbs


def build_tiny_lola(encrypt: bool = True, n: int = 256, seed: int = 3,
                    device=None, shard=None):
    """(head, factory, reader): the LoLaSmall topology at ring degree n
    with hybrid key switching (n_special = 2, as the lola_small preset),
    its weights drawn as the reference's from numpy's default_rng(seed);
    the encrypted factory on `device` (the card unless named), over the
    limbs of `shard` (a `limbs.LimbShard`; None: every limb)."""
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
                      coeff_modulus=ntt_primes(n, 30, TINY_LIMBS), dbc=16,
                      seed=seed, n_special=2, device=device, shard=shard)
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
    dim, scale = _dim_scale(raws[0])
    return [fwd.input_matrix([d[b] for d in datas], dim, scale)
            for b in range(datas[0].shape[0])]


def batched_encrypted_forward(head, recs):
    """(forward, batched): `batched` the records' encrypted input columns
    stacked, one [B, P, C, 2, k, N] tensor a column (a global batch to
    save and cut into ranks' blocks); forward(batched) -> the B output
    matrices, the layers under `torch.func.vmap` over the records (the
    reference's `jax.vmap` of its record program)."""
    fwd, raws = _reader_records(head, recs)
    batched = _stacked([fwd.encrypt(raw) for raw in raws])
    dim, scale = _dim_scale(raws[0])

    def forward(datas):
        return fwd.run_encrypted_batch(datas, dim, scale)

    return forward, batched


def _barrier():
    """Wait for every rank of the group (none without one)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _dim_scale(raw) -> tuple:
    """A reader record's (dim, scale): its matrix is [dim, V]."""
    return raw.m.shape[0], float(raw.scale)


def _stacked(mats) -> list:
    """B records' matrices -> one [B, P, C, size, k, N] tensor a column."""
    return [torch.stack([m.vectors[i].data for m in mats])
            for i in range(len(mats[0].vectors))]


def run_sharded_forward(mesh, head, fac, recs, build_raw, inputs=None,
                        batched: bool = False) -> dict:
    """Run this rank's block of `recs` (the b-th of the mesh's batch
    blocks) through the encrypted network on its block of the limbs (the
    l-th of the mesh's limb blocks: `fac` must be the factory of this
    rank's `mesh.limb_shard`), and hold each record's decrypted output
    to the Raw oracle (`build_raw()` -> (head, reader)), atol 1e-9 as the
    reference; the decrypt composes every rank's limbs of the output.
    `inputs`: the global batch's encrypted input columns ([B, P, C, 2, k,
    N] each, every limb), encrypted once elsewhere; by default the rank
    encrypts only its own records, each into its own input matrix.
    Returns the mesh shape, the limb count, this rank's records (start,
    stop) and limbs [lo, hi), its input and output columns ([B_local, P,
    C, size, hi - lo, N] each), the bytes of its key set, the collectives
    of its timed forward per record by kind (none without a limb axis),
    and two host-clock times after one warm-up record: `forward_s` this
    rank's own forward, the device synchronised, and `window_s` the
    group's window, from a barrier of every rank before the forward to one
    after every rank's forward has synchronised (on one rank the two are
    the same).  `batched`: the block runs as one record batch, the layers
    under `torch.func.vmap` (the warm-up too); on a limb group each
    cross-limb operation is one collective for the batch, and every rank
    of the group must hold the same batch size."""
    b = mesh.batch_index()
    parts = mesh.shape["batch"]
    if len(recs) % parts:
        raise ValueError(f"{len(recs)} records do not split into {parts} "
                         f"equal blocks over the batch axis")
    k = len(fac.coeff_modulus)
    lo, hi = mesh.limb_block(k)
    if (fac.params[0].lo, fac.params[0].hi) != (lo, hi):
        raise ValueError(f"the factory holds limbs {fac.limb_moduli}, this "
                         f"rank of {mesh} limbs [{lo}, {hi}) of {k}")
    per = len(recs) // parts
    local_recs = recs[b * per:(b + 1) * per]
    fwd, raws = _reader_records(head, local_recs)
    if inputs is None:
        mats = [fwd.encrypt(raw) for raw in raws]
    else:
        mats = _input_matrices(fwd, raws, [
            shard_ciphertext_data(d, mesh, batch_axis=0, limb_axis=4)
            .to(fac.device).contiguous() for d in inputs])
    shard = fac.shard
    if batched and shard is not None:
        sizes = all_gather_cat(torch.tensor([len(mats)]), shard.group, 0)
        if len(set(sizes.tolist())) != 1:
            raise ValueError(f"the ranks of a limb group hold batches of "
                             f"{sizes.tolist()} records: one size for all")
    if batched:
        cols = _stacked(mats)
        dim, scale = _dim_scale(raws[0])
        forward = lambda: fwd.run_encrypted_batch(cols, dim, scale)  # noqa: E731
        forward()                        # one warm-up batch, not timed
    else:
        forward = lambda: [fwd.run_encrypted(m) for m in mats]  # noqa: E731
        fwd.run_encrypted(mats[0])       # one warm-up record, not timed
    synchronize(fac)
    _barrier()
    before = dict(shard.counts) if shard else {}
    t0 = time.perf_counter()
    outs = forward()
    synchronize(fac)
    seconds = time.perf_counter() - t0
    _barrier()
    window = time.perf_counter() - t0
    collectives = {kind: (n - before[kind]) / len(mats)
                   for kind, n in shard.counts.items()} if shard else {}

    raw_head, raw_reader = build_raw()
    raw_reader.set_source_records(_copies(local_recs))
    for out in outs:
        want = np.asarray(raw_head.get_next().get_column(0).decrypt(), float)
        got = np.asarray(out.get_column(0).decrypt(), float)
        np.testing.assert_allclose(got[: len(want)], want, atol=1e-9)
    return dict(mesh=dict(mesh.shape), n_limbs=k, limbs=(lo, hi),
                records=(b * per, (b + 1) * per), forward_s=seconds,
                window_s=window, key_bytes=fac.keys.nbytes(),
                collectives=collectives, inputs=_stacked(mats),
                outputs=_stacked(outs))


K_DATA = 6     # the production dry run's data limbs


def dryrun_production(mesh, n_records: int | None = None, seed: int = 13,
                      device=None, inputs=None, batched: bool = False) -> dict:
    """The production LoLaSmall network at n = 8192 over the mesh: records
    over `batch`, each batch group encrypting and evaluating its own, the
    6 data limbs over `limb`, every record exact against the Raw oracle.
    The chain is 6 data limbs and 1 special prime (186 data bits, at
    least the preset's 130-bit SEAL requirement; 7 x 31 = 217 of the 218
    bits 128-bit security allows at n = 8192), the reference's dry-run
    chain, passed to `make_factory` as overrides of the lola_small preset
    with this rank's limb shard; the factory is set on the network's
    EncryptLayer before `prepare_network`.  A limb axis that does not
    divide 6 raises the reference's ValueError.  Records: synthetic MNIST
    of `seed`, max(2, batch) by default; `inputs` and `batched` as
    `run_sharded_forward` takes them."""
    from ..data.preprocess import synthetic_mnist_records
    from ..models.lola_mnist import build_lola_small
    from ..models.presets import make_factory

    limb = int(mesh.shape["limb"])
    if limb > 1 and K_DATA % limb != 0:
        raise ValueError(
            f"mesh limb axis {limb} must divide the {K_DATA}-limb data "
            "chain evenly (uneven shard dims are rejected by "
            "device_put/jit) — use a mesh with limb in (1, 2, 3, 6)"
        )
    if n_records is None:
        n_records = max(2, int(mesh.shape["batch"]))
    recs = synthetic_mnist_records(n_records, seed=seed)
    fac = make_factory("lola_small", True, device=resolve_device(device),
                       coeff_count=K_DATA, n_special=1,
                       shard=mesh.limb_shard(K_DATA))
    head, _, _ = build_lola_small(False)
    split_at_encrypt(head)[0].factory = fac
    head.prepare_network()

    def build_raw():
        rh, _, rr = build_lola_small(False)
        rh.prepare_network()
        return rh, rr

    return run_sharded_forward(mesh, head, fac, recs, build_raw, inputs=inputs,
                               batched=batched)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def sharded_rank(n_records: int, inputs_path: str | None = None, device=None,
                 batch: int | None = None, batched: bool = False) -> dict:
    """One rank of the tiny LoLa dry run over the mesh of `batch` (None:
    the reference's factoring of the world size, `make_mesh`): its block
    of `records_for(n_records)` on its block of the limbs, encrypted by
    the rank or read from `inputs_path` (`torch.save` of the global
    batch's input columns, encrypted once), through
    `run_sharded_forward` (`batched`: as one record batch); then the
    global output batch assembled from every rank's block
    (`global_ciphertext_batch`, both axes).  Returns
    its records (start, stop), limbs [lo, hi), output columns and the
    global first column, on the CPU."""
    from .distributed import global_ciphertext_batch

    mesh = make_mesh(batch=batch)
    head, fac, _ = build_tiny_lola(encrypt=True, device=device,
                                   shard=mesh.limb_shard(TINY_LIMBS))
    inputs = None if inputs_path is None else torch.load(inputs_path)

    def build_raw():
        rh, _, rr = build_tiny_lola(encrypt=False)
        return rh, rr

    res = run_sharded_forward(mesh, head, fac, records_for(n_records), build_raw,
                              inputs=inputs, batched=batched)
    whole = global_ciphertext_batch(res["outputs"][0], mesh, batch_axis=0,
                                    limb_axis=4)
    return dict(res, inputs=None, outputs=[o.cpu() for o in res["outputs"]],
                global_output=whole.cpu())


SUMMARY = ("mesh", "n_limbs", "limbs", "records", "forward_s", "window_s",
           "key_bytes", "collectives")


def production_rank(per_rank: int, device=None, batch: int | None = None) -> dict:
    """One rank of `dryrun_production` over the mesh of `batch` (None:
    the reference's factoring of the world size), `per_rank` records a
    batch group; returns its verdict (the SUMMARY keys: a mismatch
    against the Raw oracle raises)."""
    mesh = make_mesh(batch=batch)
    res = dryrun_production(mesh, n_records=mesh.shape["batch"] * per_rank,
                            device=device)
    return {k: res[k] for k in SUMMARY}


def multichip_rank(device=None, batch: int | None = None,
                   per_group: int | None = None) -> list:
    """One rank of `dryrun_multichip`: the tiny LoLa network
    (`sharded_rank`, max(2, batch) records) and the production LoLaSmall
    (`per_group` records a batch group, the reference's max(2, batch) in
    all by default) over the mesh of `batch` (None: the reference's
    factoring), every record exact against the Raw oracle (a mismatch
    raises); returns every rank's verdicts, gathered on each."""
    b = mesh_shape(_world(), batch)[0]
    tiny = sharded_rank(max(2, b), None, device, batch)
    summary = dict(tiny={k: tiny[k] for k in SUMMARY},
                   production=production_rank(per_group or max(2, b) // b,
                                              device, batch))
    if not dist.is_initialized():
        return [summary]
    out = [None] * _world()
    dist.all_gather_object(out, summary)
    return out


def dryrun_multichip(n_ranks: int, backend: str | None = None, device=None,
                     batch: int | None = None, per_group: int | None = None) -> list:
    """Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`:
    `n_ranks` processes on this host (`distributed.run_ranks`), the
    reference's default mesh ({1, 2} at 2 ranks, {2, 2} at 4; `batch`
    to ask for another), the tiny LoLa network and the production
    LoLaSmall at n = 8192 (`per_group` records a batch group), records
    over batch and RNS limbs over limb, every record exact against the
    Raw oracle.  Prints what ran, and for the production network its
    records per second over the group's window, each rank's key-set
    bytes and collectives per record; returns the ranks' verdicts."""
    from .distributed import run_ranks

    verdicts = run_ranks(multichip_rank, n_ranks, device, batch, per_group,
                         backend=backend)[0]
    for name, what in (("tiny", "LoLa-topology network at n = 256 (conv/"
                                "vectorize/square/dense + hybrid key switching)"),
                       ("production", "LoLaSmall at n = 8192 (6 data + 1 "
                                      "special limbs)")):
        first = verdicts[0][name]
        print(f"dryrun_multichip {name} ok: mesh={first['mesh']}, {what}, "
              f"records {[v[name]['records'] for v in verdicts]} over batch, "
              f"limbs {[v[name]['limbs'] for v in verdicts]} of "
              f"{first['n_limbs']} over limb; decrypted outputs match the "
              f"Raw oracle exactly", flush=True)
    prod = [v["production"] for v in verdicts]
    records = prod[-1]["records"][1]
    window = max(v["window_s"] for v in prod)
    print(f"dryrun_multichip production: {records} records over the "
          f"group's window of {window:.4f} s, {records / window:.2f} records/s; "
          f"key-set bytes a rank {[v['key_bytes'] for v in prod]}; collectives "
          f"a record on rank 0 {prod[0]['collectives']}", flush=True)
    return verdicts


def main(argv=None) -> None:
    """`python -m cryptonets_tpu_torch.parallel.dryrun --ranks 4`:
    `dryrun_multichip` on this host's cards (NCCL unless `--backend
    gloo`), on the reference's default mesh unless `--batch` is given."""
    import argparse

    ap = argparse.ArgumentParser(description="dryrun_multichip: the tiny LoLa "
                                 "network and LoLaSmall over a mesh of ranks")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--per-group", type=int, default=None,
                    help="production records a batch group")
    ap.add_argument("--backend", default=None, help="nccl (default) or gloo")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    # through the package's module, so the spawned ranks import it by name
    from cryptonets_tpu_torch.parallel.dryrun import dryrun_multichip as run

    run(args.ranks, args.backend, args.device, args.batch, args.per_group)


if __name__ == "__main__":
    main()
