"""The plain reference of LoLa's CIFAR-10 network, in PyTorch on the CPU.

Conv (`conv1`: maps of C x kh x kw at a stride, zero padding on both
sides of each spatial axis, a bias a map) -> Square -> Conv (`conv2`, the
same form over conv1's maps) -> Square -> Dense over conv2's outputs, on
fixed-point integers: the pixels scaled by the configuration's
normalisation and input scale and rounded, each weight scaled by its
layer's scale and rounded (half to even, as `torch.round` and
`np.round` do), each bias scaled by the scale of the sum it joins.  The
scheme computes this network exactly over the integers modulo t
(`plain_modulus`), so the reference computes it exactly too:
`exact_logits` gives every logit as a Python integer at the output
scale, and raises `OverflowError` where a logit reaches t/2 (the scheme
would return it reduced) or where a bound fails to show a sum exact.
Sums run in float64 only where a bound shows every partial sum below
2**53, and in int64 only where one shows it below 2**63; conv2's
squares pass both, so they are split into base-2**20 digits for the
dense layer and the digit sums joined as Python integers.
`float64_logits` is the same network in float64, the precision below
the configuration's: the control.

Layouts (those of the program's `ConvolutionEngine`, `LLPoolLayer` and
`LLDenseLayer`, written out here from their definitions, not called):

- images arrive as [B, ...] with C * H * W values each, channel-major
  (CHW): value (c, y, x) at c * H * W + y * W + x; the benchmark's pool
  holds them as [B, C * H, W].
- conv1's weights are [maps, C, kh, kw] row-major (its `arrays.conv1`),
  its bias one value a map; output (m, oy, ox) is the window whose top
  left corner is (oy * sh - ph, ox * sw - pw) in the image, taps in the
  padding dropped; the windows run over every corner from -p to
  H + p - kh at the stride, so oh = (H + 2 ph - kh) // sh + 1.
- the dense layers see a conv's outputs map-major, then row, then
  column (the Vectorize of the maps' columns, each column its windows
  row-major): feature m * oh * ow + oy * ow + ox.
- conv2's weights are [maps2, maps1, kh, kw] row-major over that input,
  as the conv-as-dense's rows are laid out; its output joins the dense
  layer in the same feature order.
- the dense layer's weights are [outputs, inputs] row-major.

Everything here comes from the configuration's `network` block and the
arrays handed in; nothing is taken from the program under test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EXACT_F64 = 2 ** 53
EXACT_I64 = 2 ** 63
DIGIT_BITS = 20


def _tensor(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, as the program's quantisation does."""
    return torch.round(x)


def quantize(net: dict, weights: dict) -> dict:
    """The integer network: weights, biases and scales from the
    configuration's `network` block and the weight arrays by the names it
    gives."""
    q, names = net["quantization"], net["arrays"]
    c1, c2, d = net["conv1"], net["conv2"], net["dense"]
    channels = net["input"][0]
    w0 = _tensor(weights[names["conv1"]]).reshape(c1["maps"], channels, *c1["kernel"])
    w1 = _tensor(weights[names["conv2"]]).reshape(c2["maps"], c1["maps"], *c2["kernel"])
    w2 = _tensor(weights[names["dense"]]).reshape(d["outputs"], d["inputs"])
    s_in = q["input_scale"]
    s1 = s_in * q["conv1_weight_scale"]
    s2 = s1 * s1 * q["conv2_weight_scale"]
    s_out = s2 * s2 * q["dense_weight_scale"]
    b2 = _tensor(weights[names["dense_bias"]])
    return dict(
        norm=q["normalization"], s_in=s_in, t=int(net["plain_modulus"]),
        w0=_round(w0 * q["conv1_weight_scale"]).long(),
        b0=_round(_tensor(weights[names["conv1_bias"]]) * s1).long(),
        w1=_round(w1 * q["conv2_weight_scale"]).long(),
        b1=_round(_tensor(weights[names["conv2_bias"]]) * s2).long(),
        w2=_round(w2 * q["dense_weight_scale"]).long(),
        # past 2**53 float64 holds b * scale exactly (a power of two
        # scale), so int() of the rounded product is the integer
        b2=[int(round(float(v) * s_out)) for v in b2],
        out_scale=s_out,
    )


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, layer: dict) -> torch.Tensor:
    """x [B, C, H, W] int64 -> [B, maps, oh, ow] int64 with the bias:
    windows at `layer`'s stride over the input padded with zeros by
    `layer["padding"]` on both sides of each spatial axis.  Exact: every
    sum is shown below 2**53 in float64 first."""
    kernel, stride, pad = layer["kernel"], layer["stride"], layer["padding"]
    wf = w.reshape(w.shape[0], -1).double()
    bound = float(x.abs().max()) * float(wf.abs().sum(dim=1).max()) if x.numel() else 0.0
    if bound >= EXACT_F64:
        raise OverflowError("a conv sum of the reference passes 2**53")
    cols = F.unfold(x.double(), kernel, padding=pad, stride=stride)   # [B, C kh kw, L]
    B, _, H, W = x.shape
    oh = (H + 2 * pad[0] - kernel[0]) // stride[0] + 1
    ow = (W + 2 * pad[1] - kernel[1]) // stride[1] + 1
    out = torch.matmul(wf, cols).round().long().reshape(B, w.shape[0], oh, ow)
    return out + b[None, :, None, None]


def _square(x: torch.Tensor) -> torch.Tensor:
    if x.numel() and float(x.abs().max()) ** 2 >= EXACT_I64:
        raise OverflowError("a square of the reference passes 2**63")
    return x * x


def pixels(images, qn: dict, net: dict) -> torch.Tensor:
    """Images [B, ...] of C * H * W pixel values (channel-major) -> the
    scaled, rounded integers [B, C, H, W] int64."""
    x = torch.as_tensor(np.asarray(images, dtype=np.float64))
    x = x.reshape(x.shape[0], *net["input"])
    return _round(x * qn["norm"] * qn["s_in"]).long()


def conv2_outputs(images, qn: dict, net: dict) -> torch.Tensor:
    """conv2's outputs (before their square) of images [B, ...], exact,
    int64 [B, maps2 * oh * ow] in the dense layer's feature order."""
    a1 = conv(pixels(images, qn, net), qn["w0"], qn["b0"], net["conv1"])
    a2 = conv(_square(a1), qn["w1"], qn["b1"], net["conv2"])
    return a2.reshape(a2.shape[0], -1)


def _exact_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [B, K] @ w.T ([M, K]) for int64 tensors, in int64 once a bound
    shows every partial sum below 2**63."""
    bound = int(a.abs().max()) * int(w.abs().sum(dim=1).max()) if a.numel() else 0
    if bound >= EXACT_I64:
        raise OverflowError("a dense sum of the reference passes 2**63")
    return a @ w.T


def exact_logits(images, qn: dict, net: dict) -> np.ndarray:
    """Logits [B, outputs] of images [B, ...] as exact Python integers (an
    object array) at the output scale: conv2's outputs split into
    base-2**20 digits, the square's digit products summed by weight
    (c_k = sum over i + j = k of d_i d_j), each c_k's dense sum exact in
    int64, the parts joined as Python integers."""
    a2 = conv2_outputs(images, qn, net)
    mag = a2.abs()
    top = int(mag.max()) if mag.numel() else 0
    ndig = max(1, -(-top.bit_length() // DIGIT_BITS))
    mask = (1 << DIGIT_BITS) - 1
    digits = [(mag >> (DIGIT_BITS * i)) & mask for i in range(ndig)]
    out = np.zeros((a2.shape[0], qn["w2"].shape[0]), dtype=object)
    for k in range(2 * ndig - 1):
        ck = sum(digits[i] * digits[k - i] for i in range(ndig) if 0 <= k - i < ndig)
        part = _exact_matmul(ck, qn["w2"]).numpy().astype(object)
        out = out + part * (1 << (DIGIT_BITS * k))
    out = out + np.array(qn["b2"], dtype=object)[None, :]
    if any(2 * abs(v) >= qn["t"] for v in out.ravel()):
        raise OverflowError("a logit of the reference reaches t/2: the scheme "
                            "would return it reduced mod t")
    return out


def float64_logits(images, qn: dict, net: dict) -> np.ndarray:
    """The control: the same network in float64 (conv2's square and the
    dense sums rounded to 53 bits), its logits rounded to the nearest
    integers (Python integers)."""
    a2 = conv2_outputs(images, qn, net).double()
    z = (a2 * a2) @ qn["w2"].double().T + torch.tensor(
        [float(b) for b in qn["b2"]], dtype=torch.float64)[None, :]
    return np.vectorize(lambda v: int(round(v)), otypes=[object])(z.numpy())
