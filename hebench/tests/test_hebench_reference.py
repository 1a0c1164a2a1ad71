"""The plain reference: against a network worked by hand, against plain
Python integers past 2**64, against the port's own float64 Raw oracle
(both networks, at their full widths), and its float64 control."""

import numpy as np
import pytest

from hebench import generate, spec
from hebench.check import reference_logits
from hebench.reference import mnist_net

TINY = {
    "input": [4, 4],
    "conv": {"maps": 1, "kernel": [2, 2], "stride": [2, 2], "upper_padding": [0, 0]},
    "dense1": {"inputs": 4, "outputs": 2},
    "dense2": {"inputs": 2, "outputs": 1},
    "quantization": {"normalization": 1.0, "input_scale": 1, "conv_weight_scale": 1,
                     "dense1_weight_scale": 1, "dense2_weight_scale": 1},
    "arrays": {"conv": "c", "dense1": "d1", "dense1_bias": "b1", "dense2": "d2",
               "dense2_bias": "b2"},
}


def test_tiny_network_by_hand():
    x = np.array([[[1, 2, 0, 1], [0, 1, 1, 0], [2, 0, 1, 1], [1, 1, 0, 2]]])
    w = dict(c=[1, -1, 2, 0, 1],                 # taps row-major, then the bias
             d1=[1, 0, 0, 1, 1, 1, 2, -1], b1=[1, -2],   # [inputs, outputs]
             d2=[1, -1], b2=[3])
    qn = mnist_net.quantize(TINY, w)
    # conv at the four corners 0, 2, 5, 1; squares 0, 4, 25, 1; hidden
    # 28 and 26; squares 784 and 676; 784 - 676 + 3
    assert mnist_net.hidden(x, qn, TINY).tolist() == [[28, 26]]
    assert mnist_net.exact_logits(x, qn, TINY).tolist() == [[111]]
    assert mnist_net.float64_logits(x, qn, TINY).tolist() == [[111]]


def test_quantization_rounds_half_to_even():
    net = dict(TINY, quantization=dict(TINY["quantization"], input_scale=0.5))
    qn = mnist_net.quantize(net, dict(c=[0.5, 1.5, 2.5, -0.5, 0.0], d1=[0] * 8,
                                      b1=[0, 0], d2=[0, 0], b2=[0.5]))
    assert qn["w0"].tolist() == [[0, 2, 2, 0]] and qn["b2"].tolist() == [0]
    # the top-left tap alone: pixels 1, 5 at scale 0.5 are 0.5 and 2.5
    qn["w0"] = np.array([[1, 0, 0, 0]])
    x = np.array([[[1, 3, 5, 7]] * 4])
    x = np.round(x * 0.5).astype(np.int64)
    assert mnist_net.conv(x, qn, net)[0, 0].tolist() == [[0, 2], [0, 2]]


def test_exact_past_int64_against_python_integers(weights):
    net = spec.config("lola-mnist")["network"]
    qn = mnist_net.quantize(net, weights)
    imgs = generate.images(spec.traffic("single")["images"], 8, 3)
    # larger hidden values than the images give: bright squares
    imgs[:4] = 255
    d = mnist_net.hidden(imgs, qn, net)
    want = [[sum(int(w) * int(v) ** 2 for w, v in zip(row, dv)) + int(b)
             for row, b in zip(qn["w2"], qn["b2"])] for dv in d]
    got = mnist_net.exact_logits(imgs, qn, net)
    assert got.tolist() == want
    assert max(abs(v) for r in want for v in r) > 2 ** 64
    assert np.count_nonzero(mnist_net.float64_logits(imgs, qn, net) != got) > 0


@pytest.mark.parametrize("cell", ["lola-mnist", "cryptonets-mnist-3p"])
def test_reference_matches_the_ports_raw_oracle(cell, weights):
    """The port's Raw oracle (float64, the port's own layers) on the same
    images and weights: agreement to float64 rounding."""
    from cryptonets_tpu_torch.models import cryptonets_mnist, lola_mnist

    config = spec.config(cell)
    imgs = generate.images(spec.traffic("single")["images"], 5, 11)
    want, scale = reference_logits(imgs, config, weights)
    recs = [(0, im.ravel().astype(np.float64)) for im in imgs]
    if cell == "lola-mnist":
        head, _, _ = lola_mnist.build_lola_bsgs(False, records=recs, weights=weights)
        head.prepare_network()
        raw = np.stack([head.get_next().get_column(0).decrypt() for _ in imgs])
    else:
        head, _, _ = cryptonets_mnist.build(False, len(imgs), records=recs, weights=weights)
        head.prepare_network()
        raw = head.get_next().decrypt()
    exact = np.array([[float(v) for v in r] for r in want]) / scale
    assert raw.shape == exact.shape
    np.testing.assert_allclose(raw, exact, rtol=1e-12, atol=0)


def test_logits_fit_the_plain_modulus(weights):
    """Every logit of the traffic's images lies inside t / 2 of both
    configurations, with bits to spare."""
    imgs = generate.images(spec.traffic("batch8192")["images"], 512, 5)
    for cell in ("lola-mnist", "cryptonets-mnist-3p"):
        config = spec.config(cell)
        t = int(np.prod([int(p) for p in config["scheme"]["plain_primes"]], dtype=object))
        logits, _ = reference_logits(imgs, config, weights)
        assert max(abs(int(v)) for v in logits.ravel()).bit_length() + 4 < (t // 2).bit_length()
