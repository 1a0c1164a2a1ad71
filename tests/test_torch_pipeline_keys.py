"""`PipelineForward`'s per-stage keys (`parallel/pipeline.py`,
`KeySet.select`, `KeySet.recording`) on the CPU, over the tiny LoLa of
`parallel/dryrun.py` (n = 256, hybrid key switching).

Each layer's keys are found here independently of the pipeline's own
recording: the layers run one by one on a factory whose Galois key dict
counts its lookups and whose `BFV.relinearize` counts the products it
relinearizes.  A stage's factory must hold exactly the union of its
layers' keys (no secret or public key), every stage count must give the
outputs of one stage bit for bit (and those of `EncryptedForward`), and a
lookup of a key a stage does not hold raises, naming the stage and the
Galois element.
"""

import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu_torch.crypto.bfv import BFV  # noqa: E402
from cryptonets_tpu_torch.nn.forward import EncryptedForward  # noqa: E402
from cryptonets_tpu_torch.parallel import PipelineForward, dryrun  # noqa: E402


class _CountingGalois(dict):
    def __init__(self, keys, hits):
        super().__init__(keys)
        self.hits = hits

    def __getitem__(self, g):
        self.hits.add(g)
        return dict.__getitem__(self, g)


def _head():
    torch.set_num_threads(1)
    head, fac, reader = dryrun.build_tiny_lola(encrypt=True, device="cpu")
    reader.set_source_records(dryrun.records_for(3, seed=29))
    return head, fac


@pytest.fixture(scope="module")
def layer_keys():
    """Each layer's Galois elements looked up and whether it relinearized
    a product, from one record run layer by layer."""
    head, fac = _head()
    fwd = EncryptedForward(head)
    m = fwd.encrypt(fwd.reader.get_next())
    hits, relins = set(), []
    original = BFV.relinearize

    def counting(self, ct, keys):
        if ct.shape[-3] == 3:
            relins.append(1)
        return original(self, ct, keys)

    fac.keys = fac.keys._replace(galois=_CountingGalois(fac.keys.galois, hits))
    BFV.relinearize = counting
    out = []
    try:
        for layer in fwd.layers:
            hits.clear()
            relins.clear()
            m = layer.apply(m)
            out.append((frozenset(hits), bool(relins)))
    finally:
        BFV.relinearize = original
    return out


@pytest.fixture(scope="module")
def eager_outputs():
    head, _ = _head()
    fwd = EncryptedForward(head)
    return [fwd().vectors[0].data for _ in range(3)]


def _pipeline(stages):
    head, fac = _head()
    pipe = PipelineForward(head, n_stages=stages, devices=["cpu"] * stages)
    return pipe, fac, pipe.run_stream(5)


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_stage_keys_are_the_union_of_their_layers_keys(stages, layer_keys,
                                                       eager_outputs):
    pipe, fac, outs = _pipeline(stages)
    assert any(galois for galois, _ in layer_keys)
    assert any(relin for _, relin in layer_keys)
    i = 0
    for s, (group, f) in enumerate(zip(pipe.groups, pipe.factories)):
        want = layer_keys[i:i + len(group)]
        i += len(group)
        galois = frozenset().union(*(g for g, _ in want))
        assert set(dict.keys(f.keys.galois)) == galois, s
        assert (f.keys.relin is not None) == any(r for _, r in want), s
        assert f.keys.s_hat_mont is None and f.keys.p0_hat_mont is None
        assert not f.has_secret_key
        assert [lk for lk in pipe.layer_keys[i - len(group):i]] == [
            g | ({"relin"} if r else set()) for g, r in want]
        assert f.keys.nbytes() < fac.keys.nbytes()
        assert pipe.stage_key_bytes()[s] == f.keys.nbytes()
    assert len(outs) == 3
    for out, want in zip(outs, eager_outputs):
        assert out.factory is fac
        assert torch.equal(out.vectors[0].data, want)


def test_a_stage_refuses_a_key_it_does_not_hold():
    pipe, fac, _ = _pipeline(3)
    for s, f in enumerate(pipe.factories):
        missing = sorted(set(fac.keys.galois) - set(dict.keys(f.keys.galois)))
        assert missing
        with pytest.raises(KeyError, match=f"pipeline stage {s} holds no Galois "
                                           f"key for element {missing[0]}"):
            f.keys.galois[missing[0]]
        # the branches that ask whether a single-hop key exists see the
        # whole set, so a stage takes the head's paths
        assert missing[0] in f.keys.galois
        if f.keys.relin is None:
            ct = torch.zeros((3, f.bfv[0].p.k, f.n), dtype=torch.int32)
            with pytest.raises(KeyError, match=f"pipeline stage {s} holds no "
                                               "relinearization key"):
                f.bfv[0].relinearize(ct, f.keys)
    with pytest.raises(KeyError, match="no Galois key"):
        fac.keys.select(galois=[12345])


def test_a_second_pipeline_on_the_same_head():
    """A head whose layers an earlier pipeline moved to its one stage plans
    again from the head's whole key set: three stages after one hold the
    same keys as three stages on a fresh head, and give its outputs."""
    head, fac = _head()
    first = PipelineForward(head, n_stages=1, devices=["cpu"])
    before = first.run_stream(5)
    first.reader.set_source_records(dryrun.records_for(3, seed=29))
    pipe = PipelineForward(head, n_stages=3, devices=["cpu"] * 3)
    outs = pipe.run_stream(5)
    fresh, _, _ = _pipeline(3)
    assert pipe.layer_keys == fresh.layer_keys
    assert pipe.stage_key_bytes() == fresh.stage_key_bytes()
    # other encryptions of the same records: the same decryptions
    assert len(outs) == len(before) == 3
    for out, want in zip(outs, before):
        assert (out.get_column(0).decrypt() == want.get_column(0).decrypt()).all()
