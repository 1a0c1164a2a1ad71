"""The plain reference of the MNIST networks of CryptoNets and LoLa.

Conv (5 maps of 5 x 5 at stride 2, the bias as each map's 26th weight) ->
Square -> Dense(100) -> Square -> Dense(10), on fixed-point integers: the
pixels scaled by the configuration's normalisation and input scale and
rounded, each weight scaled by its layer's scale and rounded (half to
even), each bias scaled by the scale of the sum it joins.  The scheme
computes this network exactly over the integers (BFV's plaintexts are
integers modulo t, and the logits lie far inside t / 2), so the
reference does too: `exact_logits` gives every logit as a Python integer
at the output scale.  Products and sums run in float64 or int64 only
where a bound shows that they are exact; past 2**53 the squares are
split into base-2**18 digits.  `float64_logits` is the same network in
float64, the precision below the configuration's: the control.

Everything here comes from the configuration file and the arrays handed
in; nothing is taken from the program under test.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

EXACT = 2.0 ** 53
DIGIT_BITS = 18


def _round(x) -> np.ndarray:
    """Round half to even, as the program's quantisation does."""
    return np.round(np.asarray(x, dtype=np.float64))


def _big_round(values, scale: float) -> np.ndarray:
    """round(v * scale) as exact Python integers (an object array), for
    biases whose scaled value passes int64."""
    return np.array([int(round(float(v) * scale)) for v in values], dtype=object)


def quantize(net: dict, weights: dict) -> dict:
    """The integer network: weights, biases and scales from the
    configuration's `network` block and the weight arrays by the names it
    gives."""
    q = net["quantization"]
    names = net["arrays"]
    maps = net["conv"]["maps"]
    kh, kw = net["conv"]["kernel"]
    taps = kh * kw
    w0 = np.asarray(weights[names["conv"]], dtype=np.float64).reshape(maps, taps + 1)
    s_in = q["input_scale"]
    s_conv = s_in * q["conv_weight_scale"]
    s_d1 = s_conv * s_conv * q["dense1_weight_scale"]
    s_out = s_d1 * s_d1 * q["dense2_weight_scale"]
    d_in, d_hidden = net["dense1"]["inputs"], net["dense1"]["outputs"]
    d_classes = net["dense2"]["outputs"]
    # dense1's weights are stored [inputs, outputs] row-major, dense2's
    # [outputs, inputs]
    w1 = np.asarray(weights[names["dense1"]], dtype=np.float64).reshape(d_in, d_hidden).T
    w2 = np.asarray(weights[names["dense2"]], dtype=np.float64).reshape(d_classes, d_hidden)
    return dict(
        norm=q["normalization"], s_in=s_in,
        w0=_round(w0[:, :taps] * q["conv_weight_scale"]).astype(np.int64),
        b0=_round(w0[:, taps] * s_conv).astype(np.int64),
        w1=_round(w1 * q["dense1_weight_scale"]).astype(np.int64),
        b1=_round(np.asarray(weights[names["dense1_bias"]]) * s_d1).astype(np.int64),
        w2=_round(w2 * q["dense2_weight_scale"]).astype(np.int64),
        b2=_big_round(weights[names["dense2_bias"]], s_out),
        out_scale=s_out,
    )


def conv(x: np.ndarray, qn: dict, net: dict) -> np.ndarray:
    """Images [B, H, W] of integers -> the conv's output [B, maps, oh, ow]
    with its bias, int64: windows from the top left at the stride, the
    image padded with zeros on its high sides by `upper_padding`, taps
    row-major.  Exact: each sum is checked below 2**53 in float64."""
    c = net["conv"]
    (kh, kw), (sh, sw), (ph, pw) = c["kernel"], c["stride"], c["upper_padding"]
    B, H, W = x.shape
    xp = np.zeros((B, H + ph, W + pw))
    xp[:, :H, :W] = x
    w = qn["w0"].reshape(-1, kh, kw).astype(np.float64)
    if float(np.abs(xp).max(initial=0)) * float(np.abs(w).sum(axis=(1, 2)).max()) >= EXACT:
        raise OverflowError("a conv sum of the reference passes 2**53")
    win = sliding_window_view(xp, (kh, kw), axis=(1, 2))[:, ::sh, ::sw]
    out = np.einsum("byxij,mij->bmyx", win, w, optimize=True).astype(np.int64)
    return out + qn["b0"][None, :, None, None]


def _exact_matmul(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """a [B, K] @ w.T ([M, K]) for integer arrays, in float64 once a bound
    shows every partial sum below 2**53; int64 result."""
    bound = float(np.abs(a).sum(axis=1).max(initial=0)) * float(np.abs(w).max(initial=0))
    if bound >= EXACT:
        raise OverflowError("a product of the reference passes 2**53")
    return (a.astype(np.float64) @ w.astype(np.float64).T).astype(np.int64)


def hidden(images: np.ndarray, qn: dict, net: dict) -> np.ndarray:
    """The Dense(100) output (before its Square) of images [B, H, W] of
    pixel values, exact, int64 [B, 100]."""
    x = _round(np.asarray(images, dtype=np.float64) * qn["norm"] * qn["s_in"])
    # features map-major: map m's corners (row-major), then map m + 1's
    f1 = conv(x.astype(np.int64), qn, net).reshape(len(x), -1)
    return _exact_matmul(f1 * f1, qn["w1"]) + qn["b1"]


def exact_logits(images: np.ndarray, qn: dict, net: dict) -> np.ndarray:
    """Logits [B, 10] of images [B, H, W] as exact Python integers at the
    output scale: the squares of the hidden layer split into base-2**18
    digits, each digit product's dense sum exact in float64, the parts
    joined as Python integers."""
    d = hidden(images, qn, net)
    if np.abs(d).max(initial=0) >= 2 ** (3 * DIGIT_BITS):
        raise OverflowError("a hidden value passes three digits")
    mask = (1 << DIGIT_BITS) - 1
    a = np.abs(d)
    digits = [(a >> (DIGIT_BITS * i)) & mask for i in range(3)]
    out = np.zeros((d.shape[0], qn["w2"].shape[0]), dtype=object)
    for k in range(5):
        ck = sum(digits[i] * digits[k - i] for i in range(3) if 0 <= k - i < 3)
        part = _exact_matmul(ck, qn["w2"]).astype(object)
        out = out + part * (1 << (DIGIT_BITS * k))
    return out + qn["b2"][None, :]


def float64_logits(images: np.ndarray, qn: dict, net: dict) -> np.ndarray:
    """The control: the same network in float64 (the hidden layer's
    square and the last dense sum rounded to 53 bits), its logits rounded
    to the nearest integers (Python integers)."""
    d = hidden(images, qn, net).astype(np.float64)
    z = (d * d) @ qn["w2"].astype(np.float64).T + qn["b2"].astype(np.float64)[None, :]
    return np.vectorize(lambda v: int(round(v)), otypes=[object])(z)
