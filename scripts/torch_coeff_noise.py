"""LoLaDense's invariant noise coefficient by coefficient, after every layer
of a sequence of encryptions on one factory, on one GPU.

    python3 scripts/torch_coeff_noise.py [--order 0,1,2,0,1,2,0] [--sample 2]

Builds LoLaDense (`build_lola_dense`, n = 16384, plain primes near 2**35,
factory seed 0) on the card and its Raw oracle, and encrypts the records
of `synthetic_mnist_records(3, seed=11)` in the order given, one after
another on one factory (the order `chip_smoke.py`'s `graph` phase runs
them in: its fourth encryption, record 0 again, decrypts wrong).  After
each layer of each encryption, for each plain prime t, over the first
`--sample` output vectors, it prints in bits (log2):

  * coef0: the invariant noise of coefficient 0, |d| with d = t w - q
    round(t w / q) for the centered phase w = [c(s)]_q
    (`crypto/noise.coefficient_noise`; q |v| in SEAL's terms, so |d| < q/2
    is the decryption's condition, Delta / 2 on the scale of the phase);
  * other: the largest |d| over the other coefficients, and which
    coefficient holds the largest |d| of all;
  * the threshold log2(q / 2),

and whether the layer's decryption agrees with the Raw oracle (the
packed dense layer's unselected slots never do: its window sums wrap
within the ciphertext's rows, the Raw dot product's within the vector;
the interleave after it keeps the selected slots).  Against the
decrypted coefficient, |d| <= q / 2 always, so a crossing shows only
against the true message.  The last layer (`LLInterleavedDenseLayer`,
one ciphertext a logit, the logit in every slot: the constant
polynomial) is linear in its input, whose decryption is exact (its noise
lies far below the threshold): the script computes each logit exactly,
sum_s W[r, s] x[s] + b[r] mod T over every slot s of the decrypted input
and the layer's own integer weights and bias, and from it the true
constant coefficient mod each plain prime, the noise of coefficient 0
against it (`true_coef0`, above the threshold where it crossed Delta / 2)
and the exact error of the decrypted logit (a CRT unit where one prime's
constant coefficient is one off).  The exact host decrypt (`BFV.decrypt`)
is held against the card's two-plane decrypt on the last layer's output.
Writes chiprun_out/torch_lola_dense_coeff_noise.json.  Fails without
CUDA.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bits(x: int) -> float:
    """log2 of a non-negative int (0 for 0), exact enough for big ints."""
    x = abs(int(x))
    if x == 0:
        return 0.0
    shift = max(0, x.bit_length() - 60)
    return math.log2(x >> shift) + shift


def crt_units(primes) -> list[int]:
    """e_p = 1 mod t_p, 0 mod every other plain prime, centered mod T."""
    T = math.prod(primes)
    out = []
    for t in primes:
        rest = T // t
        e = rest * pow(rest % t, -1, t) % T
        out.append(e - T if e > T // 2 else e)
    return out


def exact_logits(fac, layer, x) -> list[int]:
    """The last layer's logits exactly (module docstring), centered mod T:
    `layer` an LLInterleavedDenseLayer, `x` its encrypted input vector."""
    T = math.prod(fac.plain_primes)
    C = x.data.shape[1]
    xs = fac.join_decoded_blocks(fac.decrypt_slots(x.data), C * fac.n)
    out = []
    for row, b in zip(layer.weights_matrix.vectors, layer.bias_vector.values):
        acc = (int(np.dot(row._slot_values().reshape(-1)[: len(xs)], xs)) + int(b)) % T
        out.append(acc - T if acc > T // 2 else acc)
    return out


def last_layer_rows(fac, out, want) -> list[dict]:
    """Per logit (one ciphertext each) and plain prime: the noise of
    coefficient 0 against the decrypted and against the true constant
    coefficient, whether it crossed q / 2, and the exact error of the
    decrypted logit."""
    from cryptonets_tpu_torch.crypto.noise import coefficient_noise

    v = out.vectors[0]
    slots = fac.decrypt_slots(v.data)                       # [P, R, N]
    rows = []
    for r, x_true in enumerate(want):
        got = int(fac.join_split_numbers([slots[pi, r, :1] for pi in range(fac.P)])[0])
        cells = []
        for pi, bfv in enumerate(fac.bfv):
            p = bfv.p
            limbs = bfv.raw_decrypt_residues(fac.keys, v.data[pi, r]).cpu().numpy()
            d, m = coefficient_noise(p, limbs)
            off = (int(m[0]) - x_true) % p.t
            off = off - p.t if off > p.t // 2 else off
            d_true = int(d[0]) + p.q_big * off
            cells.append(dict(t=p.t, d0=str(int(d[0])), off=off,
                              coef0_bits=bits(d[0]), true_coef0_bits=bits(d_true),
                              crossed=abs(d_true) > p.q_big // 2))
        rows.append(dict(logit=r, error=str(got - x_true), primes=cells))
    return rows


def layer_rows(fac, m, sample: int) -> list[dict]:
    """Per plain prime: coefficient 0's noise, the other coefficients'
    largest, the noisiest coefficient, over the first `sample` vectors
    (every block)."""
    from cryptonets_tpu_torch.crypto.noise import coefficient_noise

    out = []
    for pi in range(fac.P):
        bfv = fac.bfv[pi]
        p = bfv.p
        c0 = other = 0
        where = None
        worst = -1
        d0s = []
        for v in m.vectors[:sample]:
            for c in range(v.data.shape[1]):
                limbs = bfv.raw_decrypt_residues(fac.keys, v.data[pi, c]).cpu().numpy()
                d, _ = coefficient_noise(p, limbs)
                a = np.abs(d)
                d0s.append(int(d[0]))
                c0 = max(c0, int(a[0]))
                other = max(other, int(a[1:].max()))
                i = int(np.argmax(a))
                if int(a[i]) > worst:
                    worst, where = int(a[i]), i
        out.append(dict(t=p.t, coef0_bits=bits(c0), other_bits=bits(other),
                        noisiest_coef=where, threshold_bits=bits(p.q_big // 2),
                        coef0_is_noisiest=c0 >= other, d0=d0s))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", default="0,1,2,0,1,2,0",
                    help="records of synthetic_mnist_records(3, seed=11), "
                         "encrypted in this order on one factory")
    ap.add_argument("--sample", type=int, default=2,
                    help="output vectors of a layer whose noise is taken")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_coeff_noise: CUDA is not available", file=sys.stderr)
        return 1
    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.models.lola_mnist import build_lola_dense
    from cryptonets_tpu_torch.nn.forward import EncryptedForward, raw_layer_outputs

    order = [int(x) for x in args.order.split(",")]
    records = synthetic_mnist_records(3, seed=11)
    copy = lambda rs: [(lb, f.copy()) for lb, f in rs]  # noqa: E731
    head_r, _, _ = build_lola_dense(False, records=copy(records))
    head_r.prepare_network()
    raws = [raw_layer_outputs(head_r) for _ in records]
    dev = torch.device("cuda", 0)
    head, fac, _ = build_lola_dense(True, records=copy(records[:1]), device=dev)
    head.prepare_network()
    fwd = EncryptedForward(head)
    units = crt_units(fac.plain_primes)
    names = ["input"] + [type(layer).__name__ for layer in fwd.layers]
    log = []
    for i, r in enumerate(order):
        fwd.reader.set_source_records(copy([records[r]]))
        m = fwd.encrypt(fwd.reader.get_next())
        outs = [m]
        for layer in fwd.layers:
            m = layer.apply(m)
            outs.append(m)
        for li, (name, m, raw) in enumerate(zip(names, outs, raws[r])):
            enc = m.decrypt()
            want = np.asarray(raw.decrypt(), dtype=float)
            equal = enc.shape == want.shape and bool(
                np.allclose(enc, want, rtol=1e-9, atol=0))
            rows = layer_rows(fac, m, args.sample)
            entry = dict(encryption=i, record=r, layer=li, name=name, equal=equal,
                         primes=[dict(row, d0=[str(x) for x in row["d0"]])
                                 for row in rows])
            if li == len(outs) - 1:
                entry["logits"] = last_layer_rows(
                    fac, m, exact_logits(fac, fwd.layers[-1], outs[-2].vectors[0]))
                # the card's two-plane decrypt against the exact host one
                v = m.vectors[0]
                lo, m2 = fac._decrypt_big_all(v.data)
                entry["two_plane_equals_exact"] = all(
                    np.array_equal(
                        fac.bfv[pi].join_big_t_planes(lo[pi].cpu().numpy(),
                                                      m2[pi].cpu().numpy()).astype(object),
                        fac.bfv[pi].decrypt(fac.keys, v.data[pi]))
                    for pi in range(fac.P))
            log.append(entry)
            cells = "  ".join(
                f"t={row['t']}: coef0 {row['coef0_bits']:.3f} other "
                f"{row['other_bits']:.3f} (noisiest {row['noisiest_coef']})"
                for row in entry["primes"])
            print(f"enc {i} (record {r}) {name:24s} {'equal' if equal else 'WRONG'}"
                  f"  threshold {entry['primes'][0]['threshold_bits']:.3f}  {cells}"
                  + (f"  two-plane = exact: {entry['two_plane_equals_exact']}"
                     if "two_plane_equals_exact" in entry else ""), flush=True)
            for row in entry.get("logits", ()):
                worst = max(row["primes"], key=lambda c: c["true_coef0_bits"])
                crossed = [c["t"] for c in row["primes"] if c["crossed"]]
                print(f"    logit {row['logit']}: error {row['error']}; true coef0 "
                      + ", ".join(f"t={c['t']} {c['true_coef0_bits']:.3f} (off "
                                  f"{c['off']})" for c in row["primes"])
                      + (f"  CROSSED at t={crossed}" if crossed else
                         f"  largest {worst['true_coef0_bits']:.3f}"), flush=True)
    result = dict(card=torch.cuda.get_device_name(0), network="LoLaDense",
                  plain_primes=list(fac.plain_primes), limbs=len(fac.coeff_modulus),
                  order=order, sample=args.sample,
                  crt_units=[str(e) for e in units], rows=log)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "torch_lola_dense_coeff_noise.json"),
              "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
