"""LoLa-CIFAR against the benchmark's plain reference
(`hebench/reference/lola_cifar_net.py`, plain torch, which imports
nothing of the port) on the CPU.

(a) The port's encrypted reduced CIFAR chain of `test_torch_lola_cifar`
at n = 256 (hybrid key switching with one special prime, the
conv-as-dense through BSGS at F = 2 with chained babies) decodes exactly
the reference's logits, the reference built for that chain's geometry.
(b) The full-width Raw path of `lola_cifar.build(False, weights=...)` on
the benchmark's weights file and two of its cell's images agrees with
the reference within the float64 rounding bound of the Raw oracle's
last layer.  (c) On the reduced chain, the BSGS counts: diagonal forms
P x g x F a chunk encoded, chained babies F x (g - 1), no hoisted ones,
and `rotation` as before them.  (d) The reference's guards: an
`OverflowError` past each bound and where a logit reaches t/2, and the
float64 control differing from the exact logits on the cell's own
images at full width.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lola_cifar import (  # noqa: E402
    CHAIN, MAPS, N, PLAIN, STRIDE, _chain_weights, _cifar_chain, _Port, _records)

from cryptonets_tpu_torch.api import bsgs  # noqa: E402
from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory  # noqa: E402
from cryptonets_tpu_torch.nn.forward import EncryptedForward  # noqa: E402
from cryptonets_tpu_torch.utils.opcount import OPS  # noqa: E402
from hebench import generate, spec  # noqa: E402
from hebench.reference import lola_cifar_net as ref  # noqa: E402
from hebench.run import load_weights  # noqa: E402

CELL = "lola-cifar10-3p.single"

# the reduced chain of `test_torch_lola_cifar` as a `network` block
SMALL = {
    "input": [3, 5, 5],
    "conv1": {"maps": MAPS, "kernel": [3, 3], "stride": [2, 2], "padding": [1, 1]},
    "conv2": {"maps": 4, "kernel": [2, 2], "stride": [1, 1], "padding": [1, 1]},
    "dense": {"inputs": 64, "outputs": 10},
    "quantization": {"normalization": 1.0, "input_scale": 2, "conv1_weight_scale": 2,
                     "conv2_weight_scale": 2, "dense_weight_scale": 2},
    "arrays": {"conv1": "w0", "conv1_bias": "b0", "conv2": "w1", "conv2_bias": "b1",
               "dense": "w2", "dense_bias": "b2"},
    "plain_modulus": math.prod(PLAIN),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chain():
    """The port's reduced chain on an encrypted factory of its own keys
    (the `cifar` preset's shape: one special prime), eager."""
    records = _records(3)
    fac = CrtBfvFactory(plain_primes=PLAIN, n=N, coeff_modulus=CHAIN, device="cpu",
                        rot_steps=(-STRIDE,), seed=8, n_special=1)
    head = _cifar_chain(_Port, fac, RawFactory(N), records)
    return records, fac, head, EncryptedForward(head)


@pytest.fixture(scope="module")
def cell():
    config = spec.config(spec.workload(spec.benchmark(), CELL)["config"])
    weights = load_weights(config)
    mix = spec.traffic(spec.workload(spec.benchmark(), CELL)["traffic"])
    return config, weights, generate.images(mix["images"], 4, 2**31 + 77)


def test_encrypted_reduced_chain_equals_the_reference(chain):
    records, fac, head, fwd = chain
    form = head.source.source.bsgs_form
    assert form.F == 2 and not bsgs.hoist_eligible(fac, form.g)
    qn = ref.quantize(SMALL, _chain_weights())
    want = ref.exact_logits(np.stack([f for _, f in records[:2]]), qn, SMALL)
    for row in want:
        out = fwd().get_column(0)
        assert out.scale == qn["out_scale"]
        assert list(out.decrypt_full_precision()) == list(row)
        assert out.noise_budget() > 0


def test_bsgs_counts_on_the_reduced_chain(chain, monkeypatch):
    _, fac, head, fwd = chain
    form = head.source.source.bsgs_form
    F, g = form.F, form.g
    encoded = []
    found = bsgs._encode_diag_chunk

    def counting(*args):
        encoded.append(1)
        return found(*args)

    monkeypatch.setattr(bsgs, "_encode_diag_chunk", counting)
    m = fwd.encrypt(fwd.reader.get_next())
    for layer in fwd.layers[:3]:
        m = layer.apply(m)
    OPS.reset()
    head.source.source.apply(m)                  # the conv-as-dense alone
    counts = OPS.reset()
    assert len(encoded) in (form.G, len(form.active))
    assert counts["bsgs_diagonal_form"] == fac.P * g * F * len(encoded)
    assert counts["baby_rotation_chained"] == F * (g - 1)
    assert "baby_rotation_hoisted" not in counts
    # the column swap, the baby chain, a giant step a chunk encoded
    assert counts["rotation"] == 1 + F * (g - 1) + len(encoded)


def test_full_width_raw_path_agrees_with_the_reference(cell):
    """The Raw oracle is float64: its conv sums are exact (below 2**53),
    but conv2's squares (up to about 2**64) and the Dense(10) sums are
    rounded to 53 bits.  Each of a logit's K = 5488 products, its K
    additions, the square under each and the bias addition rounds once,
    so it lies within (K + 3) 2**-53 sum_j |w_ij| s_j**2 + 2**-53 |b_i|
    of the exact logit, and within 1 more once rounded to an integer."""
    from cryptonets_tpu_torch.models import lola_cifar

    config, weights, images = cell
    net = config["network"]
    images = images[:2]
    head, _, _ = lola_cifar.build(
        False, records=[(0, im.ravel().astype(np.float64)) for im in images],
        weights=weights)
    head.prepare_network()
    qn = ref.quantize(net, weights)
    want = ref.exact_logits(images, qn, net)
    s = ref.conv2_outputs(images, qn, net).double()
    mass = (s * s) @ qn["w2"].double().abs().T               # sum_j |w_ij| s_j**2
    bias = torch.tensor([abs(float(b)) for b in qn["b2"]], dtype=torch.float64)
    K = net["dense"]["inputs"]
    tol = ((K + 3) * mass + bias) * 2.0 ** -53 + 1
    for r in range(len(images)):
        out = head.get_next().get_column(0)
        assert out.scale == qn["out_scale"] and out.dim == 10
        got = out.decrypt_full_precision()
        diff = np.array([abs(int(a) - int(b)) for a, b in zip(got, want[r])], dtype=float)
        assert (diff <= tol[r].numpy()).all(), (diff, tol[r])
        # the bound is tight: under a billionth of the logits' size
        assert tol[r].max() < 1e-9 * max(abs(int(v)) for v in want[r])


@pytest.mark.parametrize("guard", ["conv", "square", "dense", "t_half"])
def test_reference_guards(guard):
    net = dict(SMALL)
    w = _chain_weights()
    x = np.stack([f for _, f in _records(2)])
    q = dict(net["quantization"])
    if guard == "conv":          # a conv1 sum past 2**53
        q["input_scale"] = 2 ** 48
    elif guard == "square":      # conv1's outputs past 2**31.5
        q["input_scale"] = 2 ** 30
    elif guard == "dense":       # a digit sum of Dense(10) past 2**63
        q["dense_weight_scale"] = 2 ** 30
    else:                        # a logit past t/2
        net["plain_modulus"] = 3
    net["quantization"] = q
    with pytest.raises(OverflowError):
        ref.exact_logits(x, ref.quantize(net, w), net)
    # within every bound the same network passes
    ref.exact_logits(x, ref.quantize(SMALL, w), SMALL)


def test_control_differs_at_full_width(cell):
    config, weights, images = cell
    net = config["network"]
    qn = ref.quantize(net, weights)
    exact = ref.exact_logits(images, qn, net)
    assert exact.shape == (len(images), 10) and qn["out_scale"] == 2.0 ** 71
    assert np.count_nonzero(ref.float64_logits(images, qn, net) != exact) > 0
    # the cell's logits sit inside t/2 with bits to spare
    t = int(np.prod([int(p) for p in config["scheme"]["plain_primes"]], dtype=object))
    assert t == net["plain_modulus"]
    assert max(abs(int(v)) for v in exact.ravel()).bit_length() + 8 < (t // 2).bit_length()
