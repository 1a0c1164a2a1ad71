"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,ntt,mmntt,contract,bigt,lola,
                           cryptonets,cryptonets_matmul,cryptonets_bigt,
                           lola_small,caltech,lola_packed,lola_large,cifar,
                           lola_dense,cifar_bigt,lola_large_bigt,serve,
                           basic,op_budgets,parallel,pipeline,bigt62,
                           featurize]

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build of the hand-written CUDA kernels from the checkout, one nvcc
     per source, all started together;
  3. kernel phases: each kernel held bit-equal against its plain PyTorch
     version on the card, at the main paths' shapes and a few more, with
     its time (`ntt`: the two butterfly NTT kernels at every launch shape
     and chain of the four single-record paths, each shape also on a row
     of q - 1 and a row of zeros, timed beside its bound, and what the
     compiler made of each kernel instance; `mmntt`: the two
     four-step NTT kernels at the shapes of the LoLaSmall and Caltech-101
     runs and a few more, each with a row of q - 1, timed beside the
     bound and the kernel's own plan, with each instance's registers,
     spills and blocks per SM, and a negacyclic product through them
     against the butterfly kernels; `contract`: the exact modular contraction at
     LoLa's and LoLaSmall's conv, Dense(10) and Dense(100) of CryptoNets,
     from raw and from prepared weights, the convs of LoLaLarge, CIFAR and
     LoLaDense at n = 16384, each with an input row of q - 1, the preparation timed apart, and
     what the compiler made of each kernel instance); `bigt`: the C++
     host NTT of the plain primes of 2**31 and above (built from the
     checkout with `c++`) bit-equal to its exact object-int twin at
     n = 16384 on LoLaDense's primes, and the two-plane decrypt on the
     card bit-equal to the same decrypt on the CPU;
  4. `lola`: the LoLa-MNIST network (`build_lola_bsgs`, n = 8192, k = 7,
     four plain primes, key switching without special primes) at full
     width on the real weights: keygen on the card, one warm-up and two
     timed records,
     every record's decoded logits held against the Raw oracle, the
     kernels' launch counts over the run, and the final noise budget;
  5. `cryptonets`: the CryptoNets-MNIST network (n = 8192, k = 7, three
     ~30-bit plain primes, digit key switching, batch 8192, 784 input and
     845 hidden columns) at full width on the real weights: keygen on the
     card, one warm-up batch held against the Raw oracle's logits, one
     timed batch whose 8192 predictions must equal the oracle's, launch
     counts, peak memory and the final noise budget; `cryptonets_matmul`
     the same under the four-step NTT (K5 on the ciphertext chain, K1/K2
     on the plain primes only) and `cryptonets_bigt` under the
     reference's two ~39-bit plain primes (the 784 columns encoded on the
     host, the two-plane decrypt), each with the butterfly run's warm-up
     logits;
  6. `lola_small`: the LoLaSmall network (n = 8192, five data limbs and
     two special primes, hybrid key switching, two plain primes, real
     weights) and `caltech`: the Caltech-101 linear head (n = 4096, three
     limbs, 4096 features, 102 classes, seeded synthetic parameters), each
     at full width and run twice, under the butterfly NTT and under the
     four-step NTT: keygen on the card, one warm-up and two timed records,
     every record against the Raw oracle, the launch counts held to the
     kernels each run must and must not use, a positive final budget, and
     the two runs' decoded logits equal;
  7. `lola_packed`: LoLaPacked, the reference packing of LoLa (n = 8192,
     digit key switching at dbc = 8, real weights), one warm-up and two
     timed records, and `lola_large`: LoLaLarge (n = 16384, eleven data
     limbs and three special primes, seeded synthetic weights), one
     warm-up and one timed record; each record against the Raw oracle,
     the launches held to K1, K2 and K4 without K5, a positive final
     budget, keygen and prepare seconds, Galois keys, peak memory;
  8. `cifar`: LoLa-CIFAR (n = 16384, thirteen data limbs and one special
     prime, seeded stand-in weights; K4 at [83, 192], the 5488 x 16268
     conv-as-dense through BSGS with F = 2), one warm-up and one timed
     record, and `lola_dense`: LoLaDense (n = 16384, plain primes near
     2**35: host encode, two-plane decrypt; real weights), one warm-up
     and two timed records; the same checks as the paths of 7;
  9. `cifar_bigt` and `lola_large_bigt`: CIFAR and LoLaLarge under the
     reference's own plain primes (two near 2**40; three just above
     2**31), whose factories encode on the host, so the conv-as-dense
     runs as per-row dot products with the forced dense output (5488 and
     2608 SumAllSlots ladders at n = 16384): one record each, the same
     checks as the paths of 7, every layer's output against the Raw
     oracle's, the budget beside the reference's;
 10. `serve`: LoLa at full width and depth through the client/server
     split and files (`api/serial.py`): the client writes a public-only
     and a full key file and the encrypted input of one record, the server
     evaluates on a factory loaded from the public-only file and writes
     the output, the client decrypts it; the logits against the Raw
     oracle, the output ciphertexts bit-equal to the client's own run, the
     server's decrypt refused, K1, K2 and K4 launched; file sizes, save
     and load seconds, the server's record seconds, the final budget;
 11. `basic`: the Basic Example under the `default` preset (n = 4096,
     three limbs, five plain primes), its results exact;
 12. `op_budgets`: `utils/budget.py` on every preset, each entry above 0
     bits and within 3 bits of the reference's row (`REFERENCE_OP_BUDGETS`,
     printed by the JAX package's `utils/budget.py` on today's presets);
 13. `parallel`: the `parallel/` package at full width, LoLaSmall at
     n = 8192 on the 6-data + 1-special chain: `dryrun_production` on a
     one-rank NCCL group (mesh {batch: 1, limb: 1}), then over two ranks
     started with the spawn method on this one card under gloo, asked for
     by name (NCCL refuses one card twice), each rank encrypting and
     evaluating only its own records; every record exact against the Raw
     oracle, the verdicts gathered on rank 0, records per second of each
     over its group's window (a barrier before the timed forward, one
     after every rank's has synchronised);
 14. `pipeline`: `PipelineForward` over LoLa at full width, one stage and
     three stages on a CUDA stream each; every streamed record against the
     Raw oracle, the three-stage outputs equal to the one-stage ones,
     records per second of each;
 15. `bigt62`: a plain prime between 2**62 and 2**63 at n = 8192: host
     encode, encrypt and evaluate on the card, exact host decrypt of
     add_plain, a plaintext product and a ciphertext product with
     relinearisation, each exact with budget left, the budgets beside the
     reference's;
 16. `featurize`: the seeded AlexNet featurizer on the card for four
     synthetic images against the CPU run of the same parameters;
 17. launch shapes: every path records the shape of every kernel launch
     of its first record (batch), and after the paths a fresh process
     (`--launch-shapes`, fed the shapes on stdin) holds K1/K2, K5 and K4
     (on the path's own weights) bit-equal to their plain versions at
     each, with edge rows, and times each beside its bound (the two-rank
     `parallel` run's rank 0 sends its shapes back to this process).
With no argument every phase runs, and only then are the result lines
printed: a JSON object with one entry per kernel, the card line, and the
last line {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# 32-bit integer multiplies (IMAD, IMAD.HI): 64 per SM per clock at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at the H100 SXM's 1.98 GHz boost clock; one multiply
# counts as one operation
INT32_MUL_PER_S = 132 * 64 * 1.98e9
INT8_TENSOR_OPS_PER_S = 1.979e15   # dense int8, H100 SXM data sheet
TIMED_RECORDS = 2
PHASES = ("build", "ntt", "mmntt", "contract", "bigt", "lola", "cryptonets",
          "cryptonets_matmul", "cryptonets_bigt", "lola_small", "caltech",
          "lola_packed", "lola_large", "cifar", "lola_dense", "cifar_bigt",
          "lola_large_bigt", "serve", "basic", "op_budgets", "parallel",
          "pipeline", "bigt62", "featurize")
# final budgets the reference records (docs/PARITY.md:175; :155 gives no
# budget for `cryptonets_bigt`, only its plain moduli's 78.6-bit capacity)
REFERENCE_BUDGETS = {"cifar_bigt": "none recorded: the JAX package never ran "
                                   "it at full width; the `cifar` preset's "
                                   "117 bits",
                     "cryptonets_bigt": "no budget recorded (78.6-bit "
                                        "plain capacity)"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, launches: int = 50, repeats: int = 5, warmup: int = 3) -> float:
    """Time of one call: CUDA events around `launches` back-to-back calls,
    divided by the count; the median of `repeats` such runs.  Where the
    host cannot issue the calls as fast as the card runs them, this is the
    host's rate, hence `device_ms` beside it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def device_ms(fn, kernel: str, launches: int = 50, attempts: int = 3) -> float:
    """Device time of one launch of `kernel` (a substring of its name):
    torch.profiler's self device time over `launches` calls, divided by
    the count of launches it saw.  The profiler now and then returns a
    window without the kernel's device records: such a window is taken
    again, up to `attempts` times, then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        hits = [e for e in events if kernel in e.key]
        count = sum(e.count for e in hits)
        if count:
            return sum(e.self_device_time_total for e in hits) / count / 1e3
        seen = [e.key[:60] for e in events]
    raise SystemExit(f"the profiler recorded no device time for {kernel} "
                     f"in {attempts} windows; device events seen: {seen}")


# --------------------------------------------------------------- kernels
BOUND_KEYS = ("bound_ms", "bound_by", "bytes_bound_ms", "int32_ops_ms",
              "int8_ops_ms", "design_ops_ms")


def modmat_bound(terms: int, nbytes: int) -> dict:
    """The least time the card could take for an exact matrix product
    modulo 31-bit primes with `terms` multiply-adds that moves `nbytes`.
    The operations are the function's, not a kernel's: one 32 x 32 -> 64
    bit product a term (two 32-bit multiplies) on the integer pipe, or 16
    plane pairs of 8-bit digits a term (a multiply and an add each) on the
    int8 tensor cores, whichever unit is the faster.  A kernel's own plan
    is apart: K4's `contract_design_ms`, K5's `mmntt_design_ms`."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_int32 = 2 * terms / INT32_MUL_PER_S
    t_int8 = 16 * 2 * terms / INT8_TENSOR_OPS_PER_S
    t_ops = min(t_int32, t_int8)
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=1e3 * t_bytes, int32_ops_ms=1e3 * t_int32,
                int8_ops_ms=1e3 * t_int8)


# K5's integer instructions a coefficient, counted from matmul_ntt.cu: per
# product and output 7 wide multiply-adds (the shift groups), the fold of
# hi (two Shoup products and a 64-bit add: 8) and the final `reduce64` (two
# Shoup products, three conditional subtractions: 11), so 26 for each of
# the two products; the twiddle (4); the split of the row (1.5: six byte
# permutes a word of four) and the split between the products (6: byte
# permutes or shifts, and stores)
MMNTT_INT_PER_COEFF = 2 * 26 + 4 + 1.5 + 6


def mmntt_design_ms(rows: int, n: int) -> dict:
    """The K5 kernel's own operation count, as its plan does the work: 16
    plane pairs (an int8 multiply and add each) for every term of its
    padded tiles on the tensor cores (rows a padded to 64 a warpgroup,
    output columns to 8, sums to 32 terms), and `MMNTT_INT_PER_COEFF`
    instructions a coefficient on the integer pipe (at the rate of its
    multiplies, 64 an SM a clock).  The two units work side by side: the
    larger time is `design_ops_ms`."""
    from cryptonets_tpu_torch.kernels.matmul_ntt import geometry

    g = geometry(n)
    terms = rows * g.mp * g.np_ * (max(32, g.n2) + max(32, g.n1))
    t_mma = 16 * 2 * terms / INT8_TENSOR_OPS_PER_S
    t_int = MMNTT_INT_PER_COEFF * rows * n / INT32_MUL_PER_S
    return dict(design_ops_ms=1e3 * max(t_mma, t_int),
                design_mma_ms=1e3 * t_mma, design_int_ms=1e3 * t_int)


def slice_c_chains(dev) -> list[tuple]:
    """(where, shape, chain, is_plain) of the NTT launches of one LoLaSmall
    and one Caltech-101 record, as those records make them: the q, Bsk
    and Q*P chains (under either NTT) and the plain primes (the slot
    encode and decode, always the butterfly NTT)."""
    from cryptonets_tpu_torch.crypto.bfv import BFVParams
    from cryptonets_tpu_torch.crypto.primes import default_coeff_modulus_128
    from cryptonets_tpu_torch.models.presets import CONFIGS

    def params(name):
        cfg = CONFIGS[name]
        chain = default_coeff_modulus_128(cfg["n"])[: cfg["coeff_count"]]
        return cfg, BFVParams(cfg["n"], cfg["plain_primes"][0],
                              coeff_modulus=chain, dbc=cfg.get("dbc", 16),
                              n_special=cfg.get("n_special", 0), device=dev)

    cfg, p = params("lola_small")
    out = [
        ("LoLaSmall conv, q", (25, 5, 8192), p.q_list, False),
        ("LoLaSmall dense rows, q", (2, 10, 1, 2, 5, 8192), p.q_list, False),
        ("LoLaSmall ladder, three groups over Q*P", (3, 2, 10, 1, 7, 8192),
         p.qp_list, False),
        ("LoLaSmall rotation, Q*P", (3, 2, 1, 7, 8192), p.qp_list, False),
        ("LoLaSmall square, Bsk", (1, 3, len(p.bsk_list), 8192), p.bsk_list,
         False),
        ("LoLaSmall slot encode, Z_t", (25, 2, 8192), cfg["plain_primes"], True),
        ("LoLaSmall slot decode, Z_t", (10, 2, 8192), cfg["plain_primes"], True),
    ]
    cfg, p = params("caltech")
    out += [
        ("Caltech ladder, six digits, q", (6, 1, 102, 1, 3, 4096), p.q_list,
         False),
        ("Caltech ladder, q", (1, 102, 1, 2, 3, 4096), p.q_list, False),
        ("Caltech encrypt, q", (1, 3, 4096), p.q_list, False),
        # the linear head never multiplies ciphertexts, so no record
        # launches this chain; the factory builds it all the same
        ("Caltech, Bsk", (1, 3, len(p.bsk_list), 4096), p.bsk_list, False),
        ("Caltech slot decode, Z_t", (102, 1, 4096), cfg["plain_primes"], True),
        ("Caltech slot encode, Z_t", (1, 1, 4096), cfg["plain_primes"], True),
    ]
    return out


def _residues(shape, mods, gen, dev):
    """Uniform residues [..., L, N] of the chain `mods`, int32 storage."""
    q = torch.tensor(mods, dtype=torch.int64, device=dev).view(-1, 1)
    return (torch.randint(0, 2**31, shape, generator=gen, device=dev,
                          dtype=torch.int64) % q).to(torch.int32)


def ntt_bound(rows: int, n: int, L: int, inverse: bool) -> dict:
    """The least time the card could take for `rows` butterfly NTTs of
    length n over L limbs.  Bytes: the data read and written once, the
    limb tables a row uses (twiddles and Shoup companions; n^-1 and its
    companion for the inverse) and the moduli once.  Operations, the
    function's need: one 32 x 32 -> 64 bit product (two 32-bit multiplies)
    a butterfly, and a row's n products by n^-1 for the inverse.
    `design_ops_ms` is apart: the three multiplies of each product as the
    kernel does it (umulhi and two mullo)."""
    logn = n.bit_length() - 1
    nbytes = 2 * rows * n * 4 + 2 * L * n * 4 + L * 4 + (8 * L if inverse else 0)
    products = rows * (n // 2) * logn + (rows * n if inverse else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * products / INT32_MUL_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=1e3 * t_bytes, int32_ops_ms=1e3 * t_ops,
                design_ops_ms=1e3 * 3 * products / INT32_MUL_PER_S)


def ntt_shape_case(shape, tab, gen, err: dict, names=("ntt_forward",
                                                      "ntt_inverse"),
                   launches: int = 50) -> tuple:
    """K1/K2 at one launch shape: random residues and two edge rows (every
    residue q - 1, every residue 0) bit-equal to the twins, round trip
    exact; then each of `names` timed (events and profiler device time)
    beside its bound.  Raises the largest errors into `err`; returns (x,
    NTT(x), {name: entry})."""
    from cryptonets_tpu_torch.kernels import ntt as K

    n, L = shape[-1], shape[-2]
    mods = [int(v) for v in tab.q.view(-1).tolist()]
    x = _residues(shape, mods, gen, tab.q.device)
    q = tab.q.view(1, L, 1)
    edge = torch.cat([(q - 1).expand(1, L, n), torch.zeros_like(q).expand(1, L, n)])
    for xs in (x, edge.contiguous()):
        y = K.ntt_forward(xs, tab)
        y_ref = K.ntt_forward_plain(xs, tab)
        z = K.ntt_inverse(y, tab)
        z_ref = K.ntt_inverse_plain(y, tab)
        torch.cuda.synchronize()
        e_f = int((y.long() - y_ref.long()).abs().max())
        e_i = int((z.long() - z_ref.long()).abs().max())
        if e_f or e_i or not torch.equal(z, xs):
            raise SystemExit(
                f"NTT kernel disagrees with its twin at {list(xs.shape)} "
                f"(case {list(shape)}): forward {e_f}, inverse {e_i}, "
                f"round trip {torch.equal(z, xs)}")
        err["ntt_forward"] = max(err["ntt_forward"], e_f)
        err["ntt_inverse"] = max(err["ntt_inverse"], e_i)
        del y_ref, z, z_ref
    y = K.ntt_forward(x, tab)
    calls = {"ntt_forward": lambda: K.ntt_forward(x, tab),
             "ntt_inverse": lambda: K.ntt_inverse(y, tab)}
    rows = x.numel() // n
    entries = {
        name: dict(shape=list(shape),
                   ms=event_ms(calls[name], launches=launches),
                   device_ms=device_ms(calls[name], f"{name}_kernel",
                                       launches=launches),
                   **ntt_bound(rows, n, L, name == "ntt_inverse"))
        for name in names}
    line = ", ".join(
        f"{name[4:]} {e['ms']:.4f} / {e['device_ms']:.4f} / "
        f"{e['bound_ms']:.4f} ms by {e['bound_by']}"
        for name, e in entries.items())
    log(f"kernel shape {list(shape)}: bit-equal to twin, edge rows too; per "
        f"launch, events over back-to-back calls / profiler device time / "
        f"bound: {line}")
    return x, y, entries


def kernel_phase(dev) -> list[dict]:
    """K1/K2 bit-equal to their twins on the card, round trip exact, at
    the shapes and chains the four single-record paths launch them, each
    shape also on two edge rows (every residue q - 1, every residue 0);
    every shape timed beside its bound."""
    from cryptonets_tpu_torch.crypto.bfv import BFVParams
    from cryptonets_tpu_torch.crypto.ntt import get_ntt_context
    from cryptonets_tpu_torch.crypto.primes import default_coeff_modulus_128
    from cryptonets_tpu_torch.kernels import ntt as K
    from cryptonets_tpu_torch.models.presets import CONFIGS

    lola = CONFIGS["lola"]
    q_chain = default_coeff_modulus_128(8192)
    bsk = BFVParams(8192, lola["plain_primes"][0], device=dev).bsk_list
    cases = [((64, 7, 8192), q_chain)]
    cases += [((100, 1, 8192), (t,)) for t in lola["plain_primes"]]
    cases += [((4, 14, 16384), default_coeff_modulus_128(16384))]
    # shapes the LoLa record itself launches: the Dense(100) diagonal
    # encode (NTT_q of [P, g, k, N]), the record's slot encode over the
    # P plain primes, the BEHZ product over the Bsk base
    cases += [((4, 64, 7, 8192), q_chain),
              ((25, 4, 8192), lola["plain_primes"]),
              ((1, 3, len(bsk), 8192), bsk)]
    # every launch shape of a LoLaSmall and a Caltech-101 record
    cases += [(shape, mods) for _, shape, mods, _ in slice_c_chains(dev)]
    names = ("ntt_forward", "ntt_inverse")
    instances = {}
    for n in sorted({shape[-1] for shape, _ in cases}):
        logn = n.bit_length() - 1
        for name in names:
            info = K.kernel_info(logn, name == "ntt_inverse")
            instances[f"{name}<{logn}>"] = info
            log(f"{name}_kernel<{logn}>: {info}")
    gen = torch.Generator(device=dev).manual_seed(5)
    err = dict.fromkeys(names, 0)
    timing, shapes = {}, {name: [] for name in names}
    for shape, mods in cases:
        tab = get_ntt_context(shape[-1], mods).tables(dev)
        x, y, entries = ntt_shape_case(shape, tab, gen, err)
        for name in names:
            shapes[name].append(entries[name])
        if shape == cases[0][0]:
            plain = {
                "ntt_forward": event_ms(lambda: K.ntt_forward_plain(x, tab),
                                        launches=3, repeats=3, warmup=1),
                "ntt_inverse": event_ms(lambda: K.ntt_inverse_plain(y, tab),
                                        launches=3, repeats=3, warmup=1),
            }
            timing = {name: dict(shapes[name][-1], plain_ms=plain[name])
                      for name in names}
    keep = ("shape", "ms", "device_ms", "bound_ms", "bound_by")
    host_ms = launcher_host_ms(dev)
    log(f"K3, the launcher of K1/K2 (kernels/ntt.py _launch): {1e3 * host_ms:.1f} "
        f"us of host time a call (no device work of its own)")
    return [
        dict(
            name=name, route="cuda",
            source="cryptonets_tpu_torch/kernels/ntt.cu",
            replaces=replaces, max_abs_err=err[name], library_ms=None,
            launcher_host_ms=host_ms, **timing[name],
            shapes=[{k: c[k] for k in keep} for c in shapes[name]],
            instances={k: v for k, v in instances.items() if k.startswith(name)},
        )
        for name, replaces in (
            ("ntt_forward", "cryptonets_tpu/kernels/pallas_ntt.py:158"),
            ("ntt_inverse", "cryptonets_tpu/kernels/pallas_ntt.py:172"),
        )
    ]


def contract_design_ms(P: int, positions: int, wc) -> dict:
    """The K4 kernel's own operation count, as its plan does the work:
    16 plane pairs (an int8 multiply and add each) for every padded output
    and padded o on the tensor cores, and one Shoup fold (three 32-bit
    multiplies) for each padded output, shift group and chunk on the
    integer pipe.  The two units work side by side: the larger time is
    `design_ops_ms`."""
    outs = P * positions * wc.nw * wc.mt
    t_mma = 16 * 2 * outs * wc.kc * wc.chunks / INT8_TENSOR_OPS_PER_S
    t_fold = 3 * 7 * outs * wc.chunks / INT32_MUL_PER_S
    return dict(design_ops_ms=1e3 * max(t_mma, t_fold),
                design_mma_ms=1e3 * t_mma, design_fold_ms=1e3 * t_fold)


def contract_case(where: str, W, qs, shape, gen, instances: dict) -> dict:
    """K4 at one launch: weights W [M, O] (integers of any size) on
    residues of `shape` [P, O, C, s, k, n] over the moduli `qs`, with an
    input row of q - 1, bit-equal to the plain version from raw and from
    prepared weights (the preparation timed apart); timed (events,
    profiler device time, the plain version) beside the bound and the
    kernel's own plan.  `instances` gathers what the compiler made of each
    kernel instance."""
    from cryptonets_tpu_torch.kernels import modmatmul as MM

    dev = gen.device
    M, O = len(W), len(W[0])
    q_col = torch.tensor(qs, dtype=torch.int64, device=dev).view(-1, 1)
    x = _residues(shape, qs, gen, dev)
    x[:, 0] = (q_col - 1).to(torch.int32)   # an input row of q - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wc = MM.prepare_contract(W, qs, dev)
    torch.cuda.synchronize()
    prepare_ms = 1e3 * (time.perf_counter() - t0)
    y = MM.exact_mod_contract(wc, x, qs, q_col)
    y_raw = MM.exact_mod_contract(W, x, qs, q_col)
    torch.cuda.synchronize()
    y_ref = MM.exact_mod_contract_plain(W, x, qs, q_col)
    torch.cuda.synchronize()
    err = int((y.long() - y_ref.long()).abs().max())
    if (err or not torch.equal(y, y_raw) or y.shape != y_ref.shape
            or y.dtype != y_ref.dtype):
        raise SystemExit(f"mod_contract disagrees with its plain version "
                         f"at [{M}, {O}] on {list(shape)} ({where}): {err}")
    big = M * O > 10000
    call = lambda: MM.exact_mod_contract(wc, x, qs, q_col)  # noqa: E731
    ms = event_ms(call, launches=10 if big else 50, repeats=5)
    dev_ms = device_ms(call, "mod_contract_kernel", launches=10 if big else 50)
    plain = event_ms(lambda: MM.exact_mod_contract_plain(W, x, qs, q_col),
                     launches=1, repeats=1 if big else 3, warmup=0)
    # one read of x, one write of the result, the weights once
    nbytes = 4 * (x.numel() + y.numel()) + 4 * M * O * len(qs)
    bound = modmat_bound(y.numel() * O, nbytes)
    bound.update(contract_design_ms(shape[0], x[0, 0].numel(), wc))
    name = f"mod_contract_kernel<{wc.nw}, {MM.row_bytes(wc.kc)}>"
    if name not in instances:
        instances[name] = MM.kernel_info(wc.nw, wc.kc)
        log(f"{name}: {instances[name]}")
    log(f"mod_contract [{M}, {O}] on {list(shape)} ({where}): bit-equal "
        f"to its plain version, raw and prepared weights; weights "
        f"prepared once in {prepare_ms:.3f} ms; per launch, events over "
        f"back-to-back calls {ms:.4f} ms, profiler device time "
        f"{dev_ms:.4f} ms, plain version {plain:.2f} ms, bound "
        f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} (bytes "
        f"{bound['bytes_bound_ms']:.4f} ms; the function's operations on "
        f"the integer pipe {bound['int32_ops_ms']:.4f} ms, on the int8 "
        f"tensor cores {bound['int8_ops_ms']:.4f} ms; the kernel's plan: "
        f"plane pairs on the tensor cores {bound['design_mma_ms']:.4f} "
        f"ms, folds on the integer pipe {bound['design_fold_ms']:.4f} ms)")
    return dict(where=where, weights=[M, O], shape=list(shape), ms=ms,
                device_ms=dev_ms, plain_ms=plain, prepare_ms=prepare_ms,
                max_abs_err=err, instance=name,
                tiling=dict(nw=wc.nw, mt=wc.mt, kc=wc.kc, chunks=wc.chunks),
                **bound)


def contract_phase(dev) -> dict:
    """K4 bit-equal to its plain version on the card at the shapes the
    networks give it, with weights that include negatives and magnitudes
    above 2**31 (and, at LoLa's shape, above 2**63) and an input row of
    q - 1; the weights prepared once (timed apart), the kernel timed on
    them.  Every shape a path launches it at is checked after the paths
    (`launch_shape_phase`)."""
    from cryptonets_tpu_torch.crypto.primes import default_coeff_modulus_128

    gen = torch.Generator(device=dev).manual_seed(7)
    rng = np.random.default_rng(7)
    # (where, M, O, plain primes, limbs, n); the last is the largest call
    cases = [("LoLa conv", 5, 25, 4, 7, 8192),
             ("LoLaSmall conv", 5, 25, 2, 5, 8192),
             ("CryptoNets Dense(10)", 10, 100, 3, 7, 8192),
             ("LoLaLarge conv", 83, 64, 3, 11, 16384),
             ("LoLaDense conv", 5, 25, 2, 12, 16384),
             ("CIFAR conv", 83, 192, 3, 13, 16384),
             ("CryptoNets Dense(100)", 100, 845, 3, 7, 8192)]
    by_shape, instances = [], {}
    for where, M, O, P, k, n in cases:
        W = rng.integers(-(1 << 62), 1 << 62, size=(M, O))
        W[0, 0], W[-1, -1] = -1, (1 << 31) + 1
        if M * O <= 1000:   # Python-int weights: magnitudes past 2**63
            W = W.astype(object)
            W[0, 1], W[1, 0] = (1 << 80) + 12345, -(1 << 70) - 7
        by_shape.append(contract_case(where, W, default_coeff_modulus_128(n)[:k],
                                      (P, O, 1, 2, k, n), gen, instances))
    main = by_shape[-1]   # Dense(100): the largest call of the main paths
    return dict(
        name="mod_contract", route="cuda",
        source="cryptonets_tpu_torch/kernels/modmatmul.cu",
        replaces="cryptonets_tpu/kernels/modmatmul.py:71",
        max_abs_err=max(c["max_abs_err"] for c in by_shape),
        ms=main["ms"], device_ms=main["device_ms"], plain_ms=main["plain_ms"],
        prepare_ms=main["prepare_ms"],
        **{k: main[k] for k in BOUND_KEYS},
        # no PyTorch call computes an integer matrix product mod q on CUDA
        library_ms=None, shape=main["shape"], weights=main["weights"],
        by_shape=by_shape, instances=instances)


def mmntt_shape_case(shape, mods, gen, err: dict, where: str | None = None,
                     launches: int = 20) -> tuple:
    """K5 forward and inverse at one shape over the moduli `mods`: random
    residues with a row of q - 1 bit-equal to the plain versions, round
    trip exact; with `where`, both timed (profiler device time, events)
    beside the kernel's own plan.  Raises the largest errors into `err`;
    returns (x, NTT(x), the tables, the timed entry or None)."""
    from cryptonets_tpu_torch.crypto.ntt import ntt_context_for
    from cryptonets_tpu_torch.kernels import matmul_ntt as M

    names = MATMUL_KERNELS
    n = shape[-1]
    tab = ntt_context_for("matmul", n, mods).tables(gen.device)
    x = _residues(shape, mods, gen, gen.device)
    x.view(-1, shape[-2], n)[0] = tab.q.view(-1, 1) - 1   # every residue q - 1
    y = M.matmul_ntt_forward(x, tab)
    y_ref = M.matmul_ntt_forward_plain(x, tab)
    z = M.matmul_ntt_inverse(y, tab)
    z_ref = M.matmul_ntt_inverse_plain(y, tab)
    torch.cuda.synchronize()
    e_f = int((y.long() - y_ref.long()).abs().max())
    e_i = int((z.long() - z_ref.long()).abs().max())
    if e_f or e_i or not torch.equal(z, x):
        raise SystemExit(
            f"four-step NTT kernel disagrees with its plain version at "
            f"{shape}: forward {e_f}, inverse {e_i}, round trip "
            f"{torch.equal(z, x)}")
    err[names[0]] = max(err[names[0]], e_f)
    err[names[1]] = max(err[names[1]], e_i)
    if where is None:
        log(f"four-step NTT {list(shape)}: forward and inverse bit-equal "
            f"to their plain versions, round trip exact")
        return x, y, tab, None
    calls = {names[0]: lambda: M.matmul_ntt_forward(x, tab),
             names[1]: lambda: M.matmul_ntt_inverse(y, tab)}
    dev_ms = [device_ms(calls[name], "matmul_ntt_kernel", launches=launches)
              for name in names]
    ev_ms = [event_ms(calls[name], launches=launches, repeats=3)
             for name in names]
    design = mmntt_design_ms(x.numel() // n, n)
    log(f"four-step NTT {list(shape)} ({where}): bit-equal to its plain "
        f"version, round trip exact; forward / inverse: profiler device "
        f"time {dev_ms[0]:.4f} / {dev_ms[1]:.4f} ms, events {ev_ms[0]:.4f} "
        f"/ {ev_ms[1]:.4f} ms; the kernel's plan {design['design_ops_ms']:.4f} "
        f"ms (plane pairs {design['design_mma_ms']:.4f}, integer work "
        f"{design['design_int_ms']:.4f})")
    return x, y, tab, dict(where=where, shape=list(shape), device_ms=dev_ms,
                           ms=ev_ms, **design)


def mmntt_phase(dev) -> list[dict]:
    """K5 forward and inverse bit-equal to their plain versions on the
    card, round trip exact, at every ciphertext NTT shape of a LoLaSmall
    and a Caltech-101 record and a few more (each also on a row of q - 1),
    timed at the record shapes and at [64, 7, 8192] beside the bound and
    the kernel's own plan, with what the compiler made of each kernel
    instance; and a negacyclic product through K5 equal to the same
    product through K1/K2."""
    from cryptonets_tpu_torch.crypto.ntt import ntt_context_for
    from cryptonets_tpu_torch.crypto.primes import (default_coeff_modulus_128,
                                                    ntt_primes)
    from cryptonets_tpu_torch.kernels import matmul_ntt as M
    from cryptonets_tpu_torch.models.presets import CONFIGS

    cal = CONFIGS["caltech"]
    cases = [
        ((64, 7, 8192), default_coeff_modulus_128(8192)),
        ((8, 3, 4096), default_coeff_modulus_128(4096)[: cal["coeff_count"]]),
        ((4, 14, 16384), default_coeff_modulus_128(16384)),
        ((3, 2, 256), ntt_primes(256, 31, 2)),
    ]
    # every ciphertext NTT shape of a LoLaSmall and a Caltech-101 record:
    # the q, Bsk and Q*P chains at n = 8192 and n = 4096
    chains = [c for c in slice_c_chains(dev) if not c[3]]
    record_shapes = {shape: where for where, shape, _, _ in chains}
    cases += [(shape, mods) for _, shape, mods, _ in chains]
    gen = torch.Generator(device=dev).manual_seed(9)
    names = ("matmul_ntt_forward", "matmul_ntt_inverse")
    instances = {}
    for n in sorted({shape[-1] for shape, _ in cases}):
        for name in names:
            info = M.kernel_info(n, name == names[1])
            instances[f"{name}<{n.bit_length() - 1}>"] = info
            log(f"matmul_ntt_kernel<{n.bit_length() - 1}, "
                f"{str(name == names[1]).lower()}>: {info}")
    err = dict.fromkeys(names, 0)
    timing, by_shape = {}, []
    for shape, mods in cases:
        n = shape[-1]
        x, y, tab, entry = mmntt_shape_case(shape, mods, gen, err,
                                            record_shapes.get(shape))
        if entry is not None:
            by_shape.append(entry)
        calls = {names[0]: lambda: M.matmul_ntt_forward(x, tab),
                 names[1]: lambda: M.matmul_ntt_inverse(y, tab)}
        if shape != cases[0][0]:
            continue
        plains = {names[0]: lambda: M.matmul_ntt_forward_plain(x, tab),
                  names[1]: lambda: M.matmul_ntt_inverse_plain(y, tab)}
        N1, N2 = M.split4(n)
        rows, L = x.numel() // n, shape[-2]
        # the data read and written once, each limb's tables once
        nbytes = 2 * x.numel() * 4 + L * 8 * (2 * n + N1 * N1 + N2 * N2) + L * 4
        # N * (N1 + N2) terms a row
        bound = modmat_bound(rows * n * (N1 + N2), nbytes)
        bound.update(mmntt_design_ms(rows, n))
        for name in names:
            timing[name] = dict(
                ms=event_ms(calls[name], launches=20),
                device_ms=device_ms(calls[name], "matmul_ntt_kernel",
                                    launches=20),
                plain_ms=event_ms(plains[name], launches=3, repeats=3,
                                  warmup=1),
                shape=list(shape), **bound)
            t = timing[name]
            log(f"{name} {list(shape)}: events {t['ms']:.4f} ms, profiler "
                f"device time {t['device_ms']:.4f} ms, plain version "
                f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.4f} ms by "
                f"{t['bound_by']} (bytes {t['bytes_bound_ms']:.4f} ms; the "
                f"function's operations on the integer pipe "
                f"{t['int32_ops_ms']:.4f} ms, on the int8 tensor cores "
                f"{t['int8_ops_ms']:.4f} ms; the kernel's plan: plane pairs "
                f"on the tensor cores {t['design_mma_ms']:.4f} ms, integer "
                f"work {t['design_int_ms']:.4f} ms)")
    # a negacyclic product of two random polynomials through either NTT
    mods = default_coeff_modulus_128(8192)
    mm = ntt_context_for("matmul", 8192, mods)
    bf = ntt_context_for("butterfly", 8192, mods)
    q = torch.tensor(mods, dtype=torch.int64, device=dev).view(-1, 1)
    a = _residues((2, 7, 8192), mods, gen, dev)
    b = _residues((2, 7, 8192), mods, gen, dev)
    prod = [c.inverse((c.forward(a).long() * c.forward(b).long() % q).int())
            for c in (mm, bf)]
    torch.cuda.synchronize()
    if not torch.equal(*prod):
        raise SystemExit("a negacyclic product through the four-step NTT "
                         "differs from the same product through K1/K2")
    log("negacyclic product [2, 7, 8192]: four-step NTT equals butterfly NTT")
    return [
        dict(name=name, route="cuda",
             source="cryptonets_tpu_torch/kernels/matmul_ntt.cu",
             replaces=replaces, max_abs_err=err[name],
             # no single PyTorch call is a modular matrix product
             library_ms=None, **timing[name],
             by_shape=[dict(where=c["where"], shape=c["shape"],
                            device_ms=c["device_ms"][i], ms=c["ms"][i],
                            design_ops_ms=c["design_ops_ms"])
                       for c in by_shape],
             instances={k: v for k, v in instances.items()
                        if k.startswith(name + "<")})
        for i, (name, replaces) in enumerate((
            (names[0], "cryptonets_tpu/kernels/matmul_ntt.py:211"),
            (names[1], "cryptonets_tpu/kernels/matmul_ntt.py:222"),
        ))
    ]


def bigt_phase(dev) -> dict:
    """The pieces of the plain moduli of 2**31 and above that are not CUDA
    kernels: the C++ host NTT (`runtime/hostcrypto.cpp`) bit-equal to its
    exact object-int twin at n = 16384 on LoLaDense's two primes, forward
    and inverse, each timed; and `decrypt_big_t_planes` on the card
    bit-equal to the same decrypt on the CPU, on one ciphertext of the
    `lola_dense` parameters (12 limbs) and on its square, with the joined
    plaintext equal to the message."""
    from cryptonets_tpu_torch.crypto.bfv import BFV, BFVParams
    from cryptonets_tpu_torch.crypto.encoder import (BatchEncoder, _host_tables,
                                                     _intt_host, _ntt_host)
    from cryptonets_tpu_torch.crypto.primes import default_coeff_modulus_128
    from cryptonets_tpu_torch.models.presets import CONFIGS
    from cryptonets_tpu_torch.runtime import hostcrypto

    cfg = CONFIGS["lola_dense"]
    n = cfg["n"]
    rng = np.random.default_rng(17)
    out = {}
    for t in cfg["plain_primes"]:
        enc = BatchEncoder(n, t)
        x = rng.integers(0, t, size=n, dtype=np.int64)
        x[:2] = (t - 1, 0)
        t0 = time.perf_counter()
        fwd = hostcrypto.ntt_forward(x, enc.pf, t)
        fwd_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        inv = hostcrypto.ntt_inverse(x, enc.pi, enc.n_inv, t)
        inv_ms = 1e3 * (time.perf_counter() - t0)
        xo = x.astype(object)
        pf, pi = _host_tables(n, t)[:2]      # exact object-int tables
        if (list(fwd.astype(object)) != list(_ntt_host(xo, pf, t))
                or list(inv.astype(object))
                != list(_intt_host(xo, pi, enc.n_inv, t))):
            raise SystemExit(f"the C++ host NTT differs from its object-int "
                             f"twin at n = {n}, t = {t}")
        out[str(t)] = dict(forward_ms=fwd_ms, inverse_ms=inv_ms)
        log(f"C++ host NTT n = {n}, t = {t}: forward and inverse bit-equal to "
            f"the object-int twin (edge values t - 1 and 0 included); "
            f"{fwd_ms:.3f} / {inv_ms:.3f} ms a row")

    chain = default_coeff_modulus_128(n)[: cfg["coeff_count"]]
    t = cfg["plain_primes"][0]
    kw = dict(coeff_modulus=chain, n_special=cfg["n_special"])
    bfv = BFV(BFVParams(n, t, device=dev, **kw))
    keys = bfv.keygen(seed=3)
    gen = torch.Generator(device=dev).manual_seed(3)
    m = rng.integers(0, 1 << 16, size=n, dtype=np.int64)
    res = torch.from_numpy(bfv.p.plain_to_residues(m).view(np.int32)).to(dev)
    ct = bfv.encrypt(keys, res, gen)
    sq = bfv.relinearize(bfv.multiply(ct, ct), keys)
    cpu = BFV(BFVParams(n, t, device="cpu", **kw))
    ckeys = keys.to("cpu")
    for name, c in (("fresh", ct), ("square", sq)):
        lo, m2 = bfv.decrypt_big_t_planes(keys, c)
        torch.cuda.synchronize()
        clo, cm2 = cpu.decrypt_big_t_planes(ckeys, c.cpu())
        if not (torch.equal(lo.cpu(), clo) and torch.equal(m2.cpu(), cm2)):
            raise SystemExit(f"the two-plane decrypt on the card differs from "
                             f"the CPU's ({name} ciphertext)")
        got = bfv.join_big_t_planes(lo.cpu(), m2.cpu()).astype(np.int64)
        want = m if name == "fresh" else None
        if want is not None and not np.array_equal(got, want):
            raise SystemExit("the two-plane decrypt does not return the message")
        out[f"planes_{name}_ms"] = event_ms(
            lambda c=c: bfv.decrypt_big_t_planes(keys, c), launches=5, repeats=3)
    log(f"two-plane decrypt at n = {n}, {len(chain)} limbs, t = {t}: the card "
        f"bit-equal to the CPU on a fresh ciphertext and on its square, the "
        f"message recovered; {out['planes_fresh_ms']:.3f} ms a ciphertext "
        f"on the card")
    return out


# ---------------------------------------------------------------- slices
BUTTERFLY_KERNELS = ("ntt_forward", "ntt_inverse")
MATMUL_KERNELS = ("matmul_ntt_forward", "matmul_ntt_inverse")


def _count_tables() -> tuple:
    from cryptonets_tpu_torch.kernels import matmul_ntt as M
    from cryptonets_tpu_torch.kernels import modmatmul as MM
    from cryptonets_tpu_torch.kernels import ntt as K

    return K.LAUNCHES, MM.LAUNCHES, M.LAUNCHES


def kernel_counts() -> dict:
    return {k: v for counts in _count_tables() for k, v in counts.items()}


def reset_kernel_counts() -> None:
    for counts in _count_tables():
        for name in counts:
            counts[name] = 0


def check_launches(where: str, launched: dict, expect, absent=()) -> None:
    """A path names the kernels it runs and the ones it must not run."""
    missing = [k for k in expect if launched[k] == 0]
    stray = [k for k in absent if launched[k] != 0]
    if missing or stray:
        raise SystemExit(
            f"{where}: kernels that never ran {missing}, kernels that ran "
            f"and should not {stray}: {launched}")


class LaunchShapes:
    """Within `with`, records every kernel launch by shape: K1/K2 and K5
    with their tables, K4 with its weights and moduli.  A path's own
    launch shapes, read off its run for the kernel check that follows the
    paths (`launch_shape_phase`)."""

    def __init__(self):
        self.ntt = {}        # (shape, id(tables)) -> (tables, {kernel names})
        self.mmntt = {}      # the same for K5
        self.contract = {}   # (M, O, shape, moduli) -> weights

    def __enter__(self):
        from cryptonets_tpu_torch.kernels import matmul_ntt as M
        from cryptonets_tpu_torch.kernels import modmatmul as MM
        from cryptonets_tpu_torch.kernels import ntt as K

        self._orig = orig = (K._launch, M._launch, MM._launch)

        def tables_launch(seen, launch):
            def wrapped(name, x, tab, *tables):
                entry = seen.setdefault((tuple(x.shape), id(tab)), (tab, set()))
                entry[1].add(name)
                return launch(name, x, tab, *tables)
            return wrapped

        def contract_launch(w, x, q_list):
            key = MM._check(w, x, q_list) + (tuple(x.shape),
                                             tuple(int(q) for q in q_list))
            self.contract.setdefault(key, w)
            return orig[2](w, x, q_list)

        K._launch = tables_launch(self.ntt, orig[0])
        M._launch = tables_launch(self.mmntt, orig[1])
        MM._launch = contract_launch
        return self

    def __exit__(self, *exc):
        from cryptonets_tpu_torch.kernels import matmul_ntt as M
        from cryptonets_tpu_torch.kernels import modmatmul as MM
        from cryptonets_tpu_torch.kernels import ntt as K

        K._launch, M._launch, MM._launch = self._orig


# the single-image paths: (title, builder, timed records after one
# warm-up (0: one record, timed), the records: MNIST-like images of seed
# 11, CIFAR-like ones of seed 4, the path whose Raw oracle it shares)
def _lola_builders() -> dict:
    from functools import partial

    from cryptonets_tpu_torch.data.preprocess import (synthetic_cifar_records,
                                                      synthetic_mnist_records)
    from cryptonets_tpu_torch.models import lola_cifar
    from cryptonets_tpu_torch.models import lola_mnist as LM

    mnist = lambda k: synthetic_mnist_records(k, seed=11)  # noqa: E731
    cifar = lambda k: synthetic_cifar_records(k, seed=4)  # noqa: E731
    return {"lola": ("LoLa", LM.build_lola_bsgs, TIMED_RECORDS, mnist, "lola"),
            "lola_packed": ("LoLaPacked", LM.build_lola, TIMED_RECORDS, mnist,
                            "lola_packed"),
            "lola_large": ("LoLaLarge", LM.build_lola_large, 1, mnist,
                           "lola_large"),
            "cifar": ("CIFAR", lola_cifar.build, 1, cifar, "cifar"),
            "lola_dense": ("LoLaDense", LM.build_lola_dense, TIMED_RECORDS,
                           mnist, "lola_dense"),
            # the verbatim big-t presets: the same networks, so the same
            # Raw oracle; the conv-as-dense as per-row dots, forced dense
            "cifar_bigt": ("CIFAR (cifar_bigt)",
                           partial(lola_cifar.build, preset="cifar_bigt"), 0,
                           cifar, "cifar"),
            "lola_large_bigt": ("LoLaLarge (lola_large_bigt)",
                                partial(LM.build_lola_large,
                                        preset="lola_large_bigt"), 0,
                                mnist, "lola_large")}


# Raw oracle outputs by path, for the paths that share them
_RAWS: dict = {}


# the paths whose every layer is held against the Raw oracle's layer
# outputs, and the one of them whose budget may end at 0 in its last
# layer: `cifar_bigt` under the reference's evaluation (per-row dots with
# a forced dense output at t ~ 2**40) keeps 103 bits after its
# conv-as-dense, 50 after the square and none after Dense(10) (PERF.md
# §7); the port is bit-equal to the reference on a reduced chain
# (tests/test_torch_forced_dense.py), so that is the configuration's limit
BY_LAYER = ("cifar_bigt", "lola_large_bigt")
EXHAUSTS_IN_LAST_LAYER = ("cifar_bigt",)


def raw_layer_outputs(build, record) -> list:
    """The Raw oracle's output of every layer above the EncryptLayer for
    one record."""
    from cryptonets_tpu_torch.nn.forward import raw_layer_outputs as outputs

    head_r, _, _ = build(False, records=[(record[0], record[1].copy())])
    head_r.prepare_network()
    return outputs(head_r)[1:]


def layer_gate(title: str, which: str, names, outs, raws) -> list:
    """Every layer's decrypted output against the Raw oracle's at rtol
    1e-9, with its budget (least over its first two vectors).  A layer
    with budget left must agree; only a path of EXHAUSTS_IN_LAST_LAYER may
    end at 0 bits, and only in its last layer."""
    from cryptonets_tpu_torch.nn.forward import layer_agreement

    rows = []
    for li, (name, m, r) in enumerate(zip(names, outs, raws)):
        row = dict(layer=name, **layer_agreement(m, r))
        rows.append(row)
        last = li == len(outs) - 1
        if not row["equal"] and (row["budget"] > 0 or not (
                last and which in EXHAUSTS_IN_LAST_LAYER)):
            raise SystemExit(f"{title}: layer {li} ({name}) disagrees with the "
                             f"Raw oracle with {row['budget']} bits of budget")
    log(f"{title} by layer (budget bits, equal to the Raw oracle): "
        + ", ".join(f"{r['layer']} {r['budget']} {r['equal']}" for r in rows))
    return rows


def lola_phase(dev, which: str = "lola", shapes: LaunchShapes | None = None) -> dict:
    """A full-width single-image network on the card (LoLa, LoLaPacked,
    LoLaLarge, CIFAR, LoLaDense, or CIFAR and LoLaLarge under their
    verbatim big-t presets), every record's logits gated on the Raw
    oracle (the big-t paths: every layer's output, `layer_gate`), the
    launch counts held to the butterfly NTT and the contraction, a
    positive final budget; `shapes` records the first record's NTT
    launch shapes."""
    from cryptonets_tpu_torch.nn.forward import EncryptedForward

    title, build, timed, make_records, raw_key = _lola_builders()[which]
    records = make_records(1 + timed if timed else 1)
    raws = _RAWS.get(raw_key, [])[: len(records)]
    if len(raws) < len(records):
        head_r, _, _ = build(False, records=[(lb, f.copy()) for lb, f in records])
        head_r.prepare_network()
        raws = [head_r.get_next().get_column(0) for _ in records]
        _RAWS[raw_key] = raws
    raw_layers = raw_layer_outputs(build, records[0]) if which in BY_LAYER else None

    reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head, fac, _ = build(True, records=records, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    head.prepare_network()
    prepare_s = time.perf_counter() - t0
    galois = len(fac.keys.galois)
    log(f"{title} factory + keygen on the card: {keygen_s:.3f} s; "
        f"prepare: {prepare_s:.3f} s; {galois} Galois keys")

    fwd = EncryptedForward(head)
    kept = []
    if raw_layers is not None:
        # keep every layer's output of the record for `layer_gate`
        for layer in fwd.layers:
            layer.apply = (lambda m, f=layer.apply: kept.append(f(m)) or kept[-1])
    lats, per_record, peaks = [], None, []
    out = by_layer = None
    for i, raw in enumerate(raws):
        before = kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0 and shapes is not None:
            with shapes:
                out = fwd().get_column(0)
        else:
            out = fwd().get_column(0)
        enc = out.decrypt()
        lat = time.perf_counter() - t0
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        launched = {k: v - before[k] for k, v in kernel_counts().items()}
        check_launches(f"{title} record {i}", launched,
                       BUTTERFLY_KERNELS + ("mod_contract",), MATMUL_KERNELS)
        if raw_layers is not None:
            by_layer = layer_gate(title, which, [type(l).__name__ for l in fwd.layers],
                                  kept, raw_layers)
            kept.clear()
        # bench.py's gate: the Raw oracle is float64 and the logits reach
        # 2**67 in fixed point, so it carries its own rounding (~1e-16)
        raw_logits = raw.decrypt()
        same = enc.shape == raw_logits.shape and np.allclose(
            enc, raw_logits, rtol=1e-9, atol=0)
        if not same and not (by_layer and not by_layer[-1]["equal"]):
            raise SystemExit(
                f"{title} record {i}: encrypted logits {enc[:10]} disagree "
                f"with the Raw oracle {raw_logits[:10]}")
        rel = float(np.max(np.abs(enc - raw_logits) / np.abs(raw_logits)))
        kind = "timed" if i or not timed else "warm-up"
        log(f"{title} record {i} ({kind}): {lat:.4f} s, logits "
            f"{'match' if same else 'do not match'} the Raw oracle (max "
            f"relative difference {rel:.3e}), peak memory {peaks[-1]:.2f} "
            f"GiB, kernel launches {launched}")
        if kind == "timed":
            lats.append(lat)
            per_record = launched
    if raw_layers is not None:
        for layer in fwd.layers:
            del layer.apply      # the wrappers' cycle would keep the weights
    launches = kernel_counts()
    budget = out.noise_budget()
    if budget <= 0 and which not in EXHAUSTS_IN_LAST_LAYER:
        raise SystemExit(f"{title}: the noise budget is exhausted")
    beside = REFERENCE_BUDGETS.get(which)
    log(f"{title} record latency: median {statistics.median(lats):.4f} s over "
        f"{len(lats)} records {lats}; prepare {prepare_s:.3f} s; peak memory "
        f"{max(peaks):.2f} GiB; final noise budget {budget} bits"
        + (f" (the reference: {beside})" if beside else "")
        + ("; every layer with budget left equals the Raw oracle, the last "
           "layer's budget is exhausted: the configuration's limit"
           if budget <= 0 else ""))
    return dict(launches=launches, per_record=per_record, latency=lats,
                keygen_s=keygen_s, prepare_s=prepare_s, budget=budget,
                galois_keys=galois, peak_gib=max(peaks), by_layer=by_layer)


def shape_cases(where: str, rec: LaunchShapes) -> list[dict]:
    """The launch shapes a path recorded as picklable cases of the fresh
    process's check: K1/K2 and K5 by shape and moduli, K4 with the
    path's weights reduced mod each modulus."""
    from cryptonets_tpu_torch.kernels import modmatmul as MM

    cases = []
    for kind, seen in (("ntt", rec.ntt), ("mmntt", rec.mmntt)):
        for (shape, _), (tab, names) in seen.items():
            cases.append(dict(kind=kind, where=where, shape=shape,
                              mods=tuple(int(q) for q in tab.q.view(-1).tolist()),
                              names=sorted(names)))
    for (M, O, shape, mods), w in rec.contract.items():
        reduced = (w.reduced.cpu().numpy() if isinstance(w, MM.ContractWeights)
                   else MM.reduce_weights(w, mods))
        cases.append(dict(kind="contract", where=where, shape=shape, mods=mods,
                          reduced=reduced))
    return cases


def launch_shape_phase(recorded: dict) -> tuple[dict, dict]:
    """Every kernel held to its plain version and timed beside its bound
    at every launch shape recorded on the paths (each (shape, moduli)
    once, in the first path that launched it; K4 on the path's own
    weights), in a fresh process (`--launch-shapes`): after the paths'
    hundreds of thousands of launches the profiler's windows came back
    empty in this one.  `recorded` maps a path to its LaunchShapes, or to
    the cases (`shape_cases`) a rank process sent back.  Returns ({kernel
    name: [entries with `where`]}, {kernel name: max error})."""
    cases, done = [], set()
    for where, rec in recorded.items():
        for c in (rec if isinstance(rec, list) else shape_cases(where, rec)):
            key = (c["kind"], c["shape"], c["mods"]) + (
                (c["reduced"].shape[0],) if c["kind"] == "contract" else ())
            if key not in done:
                done.add(key)
                cases.append(c)
    paths = ", ".join(recorded)
    recorded.clear()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--launch-shapes"], input=pickle.dumps(cases),
                          stdout=subprocess.PIPE, timeout=900, check=False)
    lines = proc.stdout.decode().splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0:
        raise SystemExit(f"the launch-shape check failed ({proc.returncode}): "
                         + (lines[-1] if lines else ""))
    out = json.loads(lines[-1])
    counts = {kind: sum(c["kind"] == kind for c in cases)
              for kind in ("ntt", "mmntt", "contract")}
    log(f"launch shapes of {paths}: {counts} (K1/K2, K5, K4) bit-equal "
        f"to the plain versions, edge rows too, each timed with the "
        f"profiler's device time")
    return out["shapes"], out["err"]


def _crt_weights(reduced: np.ndarray, mods) -> np.ndarray:
    """Integers [M, O] whose residues mod each of `mods` are `reduced`
    [M, O, k]: the weights a path's prepared contraction was made from,
    up to a multiple of the moduli's product."""
    Q = 1
    for q in mods:
        Q *= q
    W = np.zeros(reduced.shape[:2], dtype=object)
    for l, q in enumerate(mods):
        c = (Q // q) * pow(Q // q, -1, q)
        W = W + reduced[..., l].astype(object) * c
    return W % Q


def launch_shapes_main() -> int:
    """`--launch-shapes`: the cases `launch_shape_phase` pickles to stdin,
    each checked and timed; the last line of stdout is the JSON result."""
    from cryptonets_tpu_torch.crypto.ntt import get_ntt_context

    cases = pickle.loads(sys.stdin.buffer.read())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    names = BUTTERFLY_KERNELS + MATMUL_KERNELS + ("mod_contract",)
    err = dict.fromkeys(names, 0)
    shapes = {name: [] for name in names}
    instances = {}
    keep = ("ms", "device_ms", "bound_ms", "bound_by")  # the rest is in the log
    for c in sorted(cases, key=lambda c: (c["kind"], c["shape"][-1], c["shape"])):
        shape, mods, where = c["shape"], c["mods"], c["where"]
        if c["kind"] == "ntt":
            tab = get_ntt_context(shape[-1], mods).tables(dev)
            _, _, entries = ntt_shape_case(shape, tab, gen, err,
                                           names=c["names"], launches=20)
            for name, e in entries.items():
                shapes[name].append(dict(where=where, shape=e["shape"],
                                         limbs=len(mods),
                                         **{k: e[k] for k in keep}))
        elif c["kind"] == "mmntt":
            _, _, _, e = mmntt_shape_case(shape, mods, gen, err, where)
            for i, name in enumerate(MATMUL_KERNELS):
                shapes[name].append(dict(where=where, shape=e["shape"],
                                         device_ms=e["device_ms"][i],
                                         ms=e["ms"][i],
                                         design_ops_ms=e["design_ops_ms"]))
        else:
            e = contract_case(where, _crt_weights(c["reduced"], mods), mods,
                              shape, gen, instances)
            err["mod_contract"] = max(err["mod_contract"], e["max_abs_err"])
            shapes["mod_contract"].append(dict(
                where=where, weights=e["weights"], shape=e["shape"],
                plain_ms=e["plain_ms"], instance=e["instance"],
                **{k: e[k] for k in keep}))
    print(json.dumps({"shapes": shapes, "err": err}), flush=True)
    return 0


_CRYPTONETS_DATA: dict = {}


def cryptonets_data(batch: int) -> tuple:
    """Two batches of synthetic records (seed 11) and the Raw oracle's
    logits of each, made once for the CryptoNets paths."""
    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.models import cryptonets_mnist

    if batch not in _CRYPTONETS_DATA:
        t0 = time.perf_counter()
        records = synthetic_mnist_records(2 * batch, seed=11)
        records_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        head_r, _, _ = cryptonets_mnist.build(
            False, batch, records=[(lb, f.copy()) for lb, f in records])
        head_r.prepare_network()
        raws = [np.asarray(head_r.get_next().decrypt(), dtype=float)
                for _ in range(2)]
        log(f"CryptoNets host set-up: {2 * batch} synthetic records "
            f"{records_s:.2f} s, Raw oracle of two batches "
            f"{time.perf_counter() - t0:.2f} s")
        _CRYPTONETS_DATA[batch] = records, raws
    return _CRYPTONETS_DATA[batch]


def cryptonets_phase(dev, batch: int = 8192, preset: str = "cryptonets",
                     ntt_impl: str = "butterfly", same_as=None,
                     shapes: LaunchShapes | None = None) -> dict:
    """Full-width CryptoNets on the card under `preset` and `ntt_impl`: one
    warm-up batch whose logits are held against the Raw oracle, one timed
    batch whose predictions must all equal the oracle's.  Under the
    four-step NTT K1/K2 may run on the plain primes (the slot encode and
    decode over Z_t) and on no ciphertext chain; `same_as`, another run's
    result, must have the same warm-up logits; `shapes` records the
    warm-up batch's launch shapes."""
    from cryptonets_tpu_torch.models import cryptonets_mnist
    from cryptonets_tpu_torch.nn.forward import EncryptedForward

    title = "CryptoNets" + {("cryptonets", "butterfly"): "",
                            ("cryptonets", "matmul"): " (matmul NTT)"}.get(
                                (preset, ntt_impl), f" ({preset}, {ntt_impl} NTT)")
    records, raws = cryptonets_data(batch)
    if ntt_impl == "matmul":
        expect = (MATMUL_KERNELS + ("mod_contract",), ())
    else:
        expect = (BUTTERFLY_KERNELS + ("mod_contract",), MATMUL_KERNELS)

    reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head, fac, _ = cryptonets_mnist.build(True, batch, records=records,
                                          device=dev, preset=preset,
                                          ntt_impl=ntt_impl)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    head.prepare_network()
    prepare_s = time.perf_counter() - t0
    log(f"{title} factory + keygen on the card: {keygen_s:.3f} s; "
        f"prepare: {prepare_s:.3f} s")

    fwd = EncryptedForward(head)
    lat = per_batch = out = logits = None
    for i, raw in enumerate(raws):
        before = kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        rec = shapes if i == 0 else None
        if rec is None and ntt_impl == "matmul":
            rec = LaunchShapes()
        t0 = time.perf_counter()
        with rec or contextlib.nullcontext():
            out = fwd()
        enc = np.asarray(out.decrypt(), dtype=float)
        lat = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        per_batch = {k: v - before[k] for k, v in kernel_counts().items()}
        check_launches(f"{title} batch {i}", per_batch, *expect)
        if ntt_impl == "matmul":
            chains = {tuple(tab.q.view(-1).tolist())
                      for tab, _ in rec.ntt.values()}
            if any(not set(c) <= set(fac.plain_primes) for c in chains):
                raise SystemExit(f"{title} batch {i}: the butterfly NTT ran "
                                 f"on a ciphertext chain: {chains}")
        if enc.shape != (batch, 10) or not np.all(np.isfinite(enc)):
            raise SystemExit(f"batch {i}: output {enc.shape} is malformed")
        wrong = int((np.argmax(enc, axis=1) != np.argmax(raw, axis=1)).sum())
        # the same gate on the logits as for LoLa (see lola_phase)
        close = bool(np.allclose(enc, raw, rtol=1e-9, atol=0))
        if wrong or (i == 0 and not close):
            raise SystemExit(
                f"{title} batch {i}: {wrong}/{batch} predictions differ from "
                f"the Raw oracle's, logits within rtol 1e-9: {close}; "
                f"enc[0]={enc[0]}, raw[0]={raw[0]}")
        if i == 0:
            logits = enc
            if same_as is not None and not np.array_equal(enc, same_as["logits"]):
                raise SystemExit(f"{title}: the warm-up batch's logits differ "
                                 f"from the butterfly run's")
        kind = "warm-up" if i == 0 else "timed"
        log(f"{title} batch {i} ({kind}): {lat:.4f} s "
            f"({1e3 * lat / batch:.4f} ms per image), {batch}/{batch} "
            f"predictions equal the Raw oracle's, logits within rtol 1e-9: "
            f"{close}, kernel launches {per_batch}, peak memory "
            f"{peak_gib:.2f} GiB")
    launches = kernel_counts()
    budget = min(v.noise_budget() for v in out.vectors)
    if budget <= 0:
        raise SystemExit(f"{title}: the noise budget is exhausted")
    beside = REFERENCE_BUDGETS.get(preset)
    log(f"{title} batch latency {lat:.4f} s, {1e3 * lat / batch:.4f} ms per "
        f"image; final noise budget {budget} bits (minimum over the 10 output "
        f"columns and the plain primes)"
        + (f"; the reference: {beside}" if beside else "")
        + ("; the warm-up logits equal the butterfly run's"
           if same_as is not None else ""))
    return dict(launches=launches, per_batch=per_batch, latency=lat,
                keygen_s=keygen_s, prepare_s=prepare_s, budget=budget,
                logits=logits, peak_gib=peak_gib)


def slice_c_phase(dev, which: str, shapes: LaunchShapes | None = None) -> dict:
    """Full-width LoLaSmall or Caltech-101 on the card, once under the
    butterfly NTT and once under the four-step NTT: every record's logits
    held against the Raw oracle, the launch counts held to the kernels
    each run must and must not use, the two runs' decoded logits equal;
    `shapes` records each run's first record's launch shapes."""
    from cryptonets_tpu_torch.data.preprocess import (
        synthetic_feature_records, synthetic_mnist_records)
    from cryptonets_tpu_torch.models import caltech101
    from cryptonets_tpu_torch.models.lola_mnist import build_lola_small
    from cryptonets_tpu_torch.nn.forward import EncryptedForward

    if which == "lola_small":
        title, n_out, build = "LoLaSmall", 10, build_lola_small
        records = synthetic_mnist_records(1 + TIMED_RECORDS, seed=11)
        conv = ("mod_contract",)
    else:
        title, n_out, build = "Caltech-101", caltech101.N_CLASSES, caltech101.build
        records = synthetic_feature_records(
            1 + TIMED_RECORDS, caltech101.N_FEATURES, seed=6)
        conv = ()                      # a linear head: no contraction
    copy = lambda: [(lb, f.copy()) for lb, f in records]  # noqa: E731
    head_r, _, _ = build(False, records=copy())
    head_r.prepare_network()
    raws = [head_r.get_next().get_column(0).decrypt() for _ in records]
    expect = {
        "butterfly": (BUTTERFLY_KERNELS + conv,
                      MATMUL_KERNELS + (() if conv else ("mod_contract",))),
        # the slot encode and decode over Z_t stay on the butterfly NTT
        "matmul": (MATMUL_KERNELS + BUTTERFLY_KERNELS + conv,
                   () if conv else ("mod_contract",)),
    }
    runs, exact = {}, {}
    for impl in ("butterfly", "matmul"):
        reset_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        head, fac, _ = build(True, records=copy(), device=dev, ntt_impl=impl)
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        head.prepare_network()
        prepare_s = time.perf_counter() - t0
        fwd = EncryptedForward(head)
        lats, per_record, out, exact[impl] = [], None, None, []
        for i, raw in enumerate(raws):
            before = kernel_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (shapes if i == 0 and shapes else contextlib.nullcontext()):
                out = fwd().get_column(0)
            enc = out.decrypt()
            lat = time.perf_counter() - t0
            if enc.shape != (n_out,) or not np.allclose(
                    enc, raw, rtol=1e-9, atol=0):
                raise SystemExit(
                    f"{title} ({impl}) record {i}: encrypted logits "
                    f"{enc[:10]} disagree with the Raw oracle {raw[:10]}")
            if int(np.argmax(enc)) != int(np.argmax(raw)):
                raise SystemExit(f"{title} ({impl}) record {i}: the "
                                 f"prediction differs from the oracle's")
            exact[impl].append(list(out.decrypt_full_precision()))
            launched = {k: v - before[k] for k, v in kernel_counts().items()}
            check_launches(f"{title} ({impl}) record {i}", launched,
                           *expect[impl])
            if i > 0:
                lats.append(lat)
                per_record = launched
        budget = out.noise_budget()
        if budget <= 0:
            raise SystemExit(f"{title} ({impl}): the noise budget is exhausted")
        log(f"{title} under the {impl} NTT: keygen {keygen_s:.3f} s, prepare "
            f"{prepare_s:.3f} s, {len(fac.keys.galois)} Galois keys; every "
            f"record's logits match the Raw oracle; timed records {lats}, "
            f"median {statistics.median(lats):.4f} s; launches per record "
            f"{per_record}; final noise budget {budget} bits")
        runs[impl] = dict(launches=kernel_counts(), per_record=per_record,
                          latency=lats, keygen_s=keygen_s,
                          prepare_s=prepare_s, budget=budget)
        del head, fac, fwd, out
        torch.cuda.empty_cache()
    if exact["butterfly"] != exact["matmul"]:
        raise SystemExit(f"{title}: the decoded logits under the two NTTs differ")
    log(f"{title}: the decoded logits under the two NTTs are equal")
    return runs


def _sync_s() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def serve_phase(dev, shapes: LaunchShapes | None = None) -> dict:
    """LoLa (`build_lola_bsgs`, full width and depth) through the
    client/server split, through files.  The client builds the network on
    the card, writes a public-only and a full key file and the encrypted
    input matrix of one record.  The server loads a factory from the
    public-only file, sets it on its network's EncryptLayer before
    `prepare_network`, loads the matrix, runs the layers and writes the
    output matrix, which the client loads and decrypts.  Gates: the logits
    equal the Raw oracle's at rtol 1e-9; the output ciphertexts equal, bit
    for bit, the client's own run of the layers on the same loaded input;
    the server's decrypt raises; K1, K2 and K4 launch.  `launches` counts
    the whole phase, `per_record` the server's steady record."""
    import tempfile

    from cryptonets_tpu_torch.api import serial
    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.models.lola_mnist import build_lola_bsgs
    from cryptonets_tpu_torch.nn.forward import EncryptedForward

    records = synthetic_mnist_records(1, seed=11)
    copy = lambda: [(lb, f.copy()) for lb, f in records]  # noqa: E731
    head_r, _, _ = build_lola_bsgs(False, records=copy())
    head_r.prepare_network()
    raw_logits = head_r.get_next().get_column(0).decrypt()
    reset_kernel_counts()
    out, tmp = {}, tempfile.TemporaryDirectory()
    files = {k: os.path.join(tmp.name, f"{k}.npz") for k in
             ("public", "full", "input", "output")}

    # the client: keygen, the key files, the encrypted input
    t0 = _sync_s()
    head_c, fac_c, _ = build_lola_bsgs(True, records=copy(), device=dev)
    out["client_keygen_s"] = _sync_s() - t0
    head_c.prepare_network()
    for name, secret in (("public", False), ("full", True)):
        t0 = _sync_s()
        serial.save_keys(fac_c, files[name], include_secret=secret)
        out[f"save_{name}_s"] = time.perf_counter() - t0
        out[f"{name}_mb"] = os.path.getsize(files[name]) / 1e6
    fwd_c = EncryptedForward(head_c)
    m_in = fwd_c.encrypt_layer.apply(fwd_c.reader.get_next())
    t0 = _sync_s()
    with open(files["input"], "wb") as fh:
        serial.save_matrix(m_in, fh)
    out["save_input_s"] = time.perf_counter() - t0
    out["input_mb"] = os.path.getsize(files["input"]) / 1e6

    # the server: the public-only factory, the network, the record
    t0 = time.perf_counter()
    fac_s = serial.load_factory(files["public"], device=dev)
    out["load_public_s"] = _sync_s() - t0
    head_s, _, _ = build_lola_bsgs(False)
    fwd_s = EncryptedForward(head_s)
    fwd_s.encrypt_layer.factory = fac_s
    t0 = time.perf_counter()
    head_s.prepare_network()
    out["server_prepare_s"] = _sync_s() - t0
    t0 = time.perf_counter()
    with open(files["input"], "rb") as fh:
        m_s = serial.load_matrix(fac_s, fh)
    out["load_input_s"] = _sync_s() - t0
    # the first record builds what the layers keep (stacked keys, the
    # contraction's weights); the second is the steady one
    for key in ("server_first_record_s", "server_record_s"):
        before = kernel_counts()
        t0 = time.perf_counter()
        with shapes or contextlib.nullcontext():
            res_s = fwd_s.run_encrypted(m_s)
        out[key] = _sync_s() - t0
    per_record = {k: v - before[k] for k, v in kernel_counts().items()}
    t0 = time.perf_counter()
    with open(files["output"], "wb") as fh:
        serial.save_matrix(res_s, fh)
    out["save_output_s"] = time.perf_counter() - t0
    out["output_mb"] = os.path.getsize(files["output"]) / 1e6
    try:
        res_s.decrypt()
    except RuntimeError as e:
        log(f"serve: the server's decrypt raises: {e}")
    else:
        raise SystemExit("serve: the server factory decrypted without a secret key")
    launched = kernel_counts()

    # the client: the output, and its own run of the layers on the input
    t0 = time.perf_counter()
    with open(files["output"], "rb") as fh:
        res_c = serial.load_matrix(fac_c, fh)
    out["load_output_s"] = _sync_s() - t0
    enc = res_c.get_column(0).decrypt()
    if enc.shape != raw_logits.shape or not np.allclose(enc, raw_logits,
                                                        rtol=1e-9, atol=0):
        raise SystemExit(f"serve: the client's logits {enc[:10]} disagree "
                         f"with the Raw oracle {raw_logits[:10]}")
    with open(files["input"], "rb") as fh:
        same = fwd_c.run_encrypted(serial.load_matrix(fac_c, fh))
    if not all(torch.equal(a.data, b.data)
               for a, b in zip(same.vectors, res_c.vectors)):
        raise SystemExit("serve: the server's output ciphertexts differ from "
                         "the client's own run on the same input")
    check_launches("serve", launched, BUTTERFLY_KERNELS + ("mod_contract",),
                   MATMUL_KERNELS)
    out.update(budget=res_c.get_column(0).noise_budget(), launches=launched,
               per_record=per_record, galois_keys=len(fac_s.keys.galois))
    tmp.cleanup()
    log(f"serve (LoLa through files, the server public-only): logits equal "
        f"the Raw oracle, the output ciphertexts equal the client's own run "
        f"bit for bit; key files public {out['public_mb']:.1f} MB, full "
        f"{out['full_mb']:.1f} MB, {out['galois_keys']} Galois keys; save "
        f"public {out['save_public_s']:.3f} s, full {out['save_full_s']:.3f} s; "
        f"load public {out['load_public_s']:.3f} s; input {out['input_mb']:.1f} MB "
        f"saved {out['save_input_s']:.3f} s, loaded {out['load_input_s']:.3f} s; "
        f"output {out['output_mb']:.2f} MB saved {out['save_output_s']:.3f} s, "
        f"loaded {out['load_output_s']:.3f} s; server prepare "
        f"{out['server_prepare_s']:.3f} s, first record "
        f"{out['server_first_record_s']:.4f} s, second {out['server_record_s']:.4f} s; "
        f"client keygen {out['client_keygen_s']:.3f} s; final noise budget "
        f"{out['budget']} bits; kernel launches {launched}, on the steady "
        f"record {per_record}")
    return out


def basic_phase(dev, shapes: LaunchShapes | None = None) -> dict:
    """The Basic Example under the `default` preset (n = 4096, three
    limbs, five plain primes): norm^2 = 385, sum = 55 and the elementwise
    product v * v[::-1], exactly; keygen and compute seconds."""
    from cryptonets_tpu_torch.models import basic_example

    reset_kernel_counts()
    with shapes or contextlib.nullcontext():
        res = basic_example.run(verbose=False, device=dev)
    v = np.arange(1.0, 11.0)
    if (res["norm_squared"] != 385 or res["sum"] != 55
            or not np.array_equal(res["elementwise"], v * v[::-1])):
        raise SystemExit(f"basic: wrong results {res}")
    launched = kernel_counts()
    check_launches("basic", launched, BUTTERFLY_KERNELS,
                   MATMUL_KERNELS + ("mod_contract",))
    log(f"basic example (default preset): norm^2 385, sum 55, elementwise "
        f"{res['elementwise'].tolist()} exactly; keygen "
        f"{res['keygen_seconds']:.3f} s, compute {res['compute_seconds']:.3f} "
        f"s; kernel launches {launched}")
    return dict(launches=launched, keygen_s=res["keygen_seconds"],
                compute_s=res["compute_seconds"])


# the reference's per-operation budgets on today's presets: fresh, enc x
# enc dot, plain dot, slot sum, plain mult, enc mult, rotate, as
# `python -m cryptonets_tpu.utils.budget <preset> --cpu` prints them (the
# JAX package on the CPU, seed 0; encryption randomness differs between
# the packages, so rows agree in bits, not ciphertexts).  The table in
# `docs/PARITY.md:137-146` predates later preset changes (LoLa's 8-bit
# digits, the small-t CIFAR and LoLaLarge) and is not used here.
REFERENCE_OP_BUDGETS = {
    "default": (56, 17, 17, 39, 29, 28, 48),
    "lola": (176, 134, 133, 166, 146, 145, 175),
    "cryptonets": (156, 102, 102, 148, 115, 114, 155),
    "lola_small": (113, 68, 67, 109, 80, 80, 113),
    "caltech": (49, 5, 5, 35, 17, 16, 43),
    "lola_large": (280, 226, 224, 275, 238, 237, 280),
    "cifar": (342, 287, 286, 338, 300, 300, 342),
    "lola_dense": (301, 243, 239, 296, 253, 253, 301),
    "cryptonets_bigt": (138, 77, 75, 134, 88, 87, 138),
    "lola_large_bigt": (278, 224, 221, 274, 235, 234, 278),
    "cifar_bigt": (323, 258, 257, 319, 271, 270, 323),
}


def op_budgets_phase(dev, shapes: LaunchShapes | None = None) -> dict:
    """`utils.budget.op_budgets` on the card for every preset of the
    port, each row beside the reference's (`REFERENCE_OP_BUDGETS`): every
    entry above 0 bits and within 3 bits of the reference's."""
    from cryptonets_tpu_torch.models.presets import CONFIGS, make_factory
    from cryptonets_tpu_torch.utils.budget import op_budgets

    if set(REFERENCE_OP_BUDGETS) != set(CONFIGS):
        raise SystemExit("op_budgets: the reference's rows and the port's "
                         "presets differ")
    reset_kernel_counts()
    rows, bad = {}, []
    for name in CONFIGS:
        t0 = time.perf_counter()
        with shapes or contextlib.nullcontext():
            fac = make_factory(name, True, seed=0, device=dev)
            row = op_budgets(fac)
        del fac
        torch.cuda.empty_cache()
        ref = REFERENCE_OP_BUDGETS[name]
        rows[name] = dict(row, reference=ref, seconds=time.perf_counter() - t0)
        if min(row.values()) <= 0 or any(abs(b - r) > 3 for b, r in
                                         zip(row.values(), ref)):
            bad.append(name)
        log(f"op budgets {name}: " + ", ".join(f"{k} {v}" for k, v in row.items())
            + f"; the reference {ref} ({rows[name]['seconds']:.2f} s)")
    launched = kernel_counts()
    check_launches("op_budgets", launched, BUTTERFLY_KERNELS, MATMUL_KERNELS)
    log(f"op budgets: {len(rows)} presets, kernel launches {launched}")
    if bad:
        raise SystemExit(f"op_budgets: {bad} at 0 bits or more than 3 bits "
                         f"from the reference's row")
    return dict(launches=launched, rows=rows)


# ------------------------------------------------------- slice G1 and F2
PARALLEL_RECORDS = 16    # records of each rank, timed after one warm-up record


def parallel_rank(per_rank: int) -> dict:
    """One rank of the `parallel` phase's two-rank run (started by
    `distributed.run_ranks` under gloo, both ranks on card 0):
    `dryrun.production_rank`, LoLaSmall at n = 8192 over {batch: 2,
    limb: 1}, this rank encrypting and evaluating only its own records,
    each exact against the Raw oracle; its launch counts from zero, rank
    0's launch shapes, and every rank's verdict gathered on rank 0."""
    import torch.distributed as dist

    from cryptonets_tpu_torch.parallel import dryrun

    rank = dist.get_rank()
    reset_kernel_counts()
    shapes = LaunchShapes() if rank == 0 else None
    with shapes or contextlib.nullcontext():
        verdict = dryrun.production_rank(per_rank, device="cuda")
    launched = kernel_counts()
    check_launches(f"parallel rank {rank}", launched,
                   BUTTERFLY_KERNELS + ("mod_contract",), MATMUL_KERNELS)
    verdict.update(rank=rank, exact=True, launches=launched,
                   device=torch.cuda.get_device_name(torch.cuda.current_device()))
    gathered = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(verdict, gathered, dst=0)
    return dict(verdicts=gathered,
                cases=shape_cases("parallel", shapes) if shapes else [])


def parallel_phase(dev, shapes: LaunchShapes | None = None) -> dict:
    """`parallel/` at full width: (a) `dryrun_production` (LoLaSmall at
    n = 8192 on the 6-data + 1-special chain) on a one-rank NCCL group in
    this process, mesh {batch: 1, limb: 1}; (b) the same over two ranks
    started with the spawn method, both on this card, under gloo, asked
    for by name (NCCL refuses one card twice; gloo's collectives run on
    host tensors), each rank encrypting and evaluating only its own
    records.  Every record's decoded logits exact against the Raw oracle
    (each rank checks its own; a failing rank fails the run), the
    verdicts gathered on rank 0, the launches held to K1, K2 and K4;
    records per second of each run: all its timed records over the
    group's window (host clock, from a barrier of every rank before the
    forward to one after every rank's forward has synchronised, after one
    warm-up record a rank)."""
    import torch.distributed as dist

    from cryptonets_tpu_torch.parallel import dryrun, make_mesh
    from cryptonets_tpu_torch.parallel.distributed import (free_port,
                                                           init_multihost,
                                                           run_ranks)

    out = {}
    reset_kernel_counts()
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh()
        with shapes or contextlib.nullcontext():
            res = dryrun.dryrun_production(mesh, n_records=PARALLEL_RECORDS,
                                           device=dev)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    launched = kernel_counts()
    check_launches("parallel (one rank)", launched,
                   BUTTERFLY_KERNELS + ("mod_contract",), MATMUL_KERNELS)
    out["one_rank"] = dict(mesh=res["mesh"], backend=backend,
                           records=PARALLEL_RECORDS, window_s=res["window_s"],
                           records_per_s=PARALLEL_RECORDS / res["window_s"])
    log(f"parallel (a): dryrun_production on one rank ({backend}), mesh "
        f"{res['mesh']}, LoLaSmall n = 8192, {res['n_limbs']} data limbs + 1 "
        f"special: {PARALLEL_RECORDS} records exact against the Raw oracle, "
        f"{out['one_rank']['records_per_s']:.2f} records/s "
        f"(window {res['window_s']:.4f} s); kernel launches {launched}")

    n_ranks = 2
    log(f"parallel (b): {n_ranks} ranks on one card, backend gloo asked for "
        f"by name (NCCL refuses one card twice; gloo's collectives run on "
        f"host tensors)")
    t0 = time.perf_counter()
    ranks = run_ranks(parallel_rank, n_ranks, PARALLEL_RECORDS, backend="gloo")
    wall = time.perf_counter() - t0
    verdicts = ranks[0]["verdicts"]
    if len(verdicts) != n_ranks or not all(v["exact"] for v in verdicts):
        raise SystemExit(f"parallel (b): verdicts {verdicts}")
    window = max(v["window_s"] for v in verdicts)
    total = n_ranks * PARALLEL_RECORDS
    for name in launched:
        launched[name] += sum(v["launches"][name] for v in verdicts)
    out["ranks"] = dict(n_ranks=n_ranks, backend="gloo", records=total,
                        mesh=verdicts[0]["mesh"], wall_s=wall, window_s=window,
                        forward_s=[v["forward_s"] for v in verdicts],
                        records_per_s=total / window)
    log(f"parallel (b): mesh {verdicts[0]['mesh']}, ranks' records "
        f"{[v['records'] for v in verdicts]} on {verdicts[0]['device']}, every "
        f"record exact against the Raw oracle (gathered on rank 0); "
        f"{out['ranks']['records_per_s']:.2f} records/s over {n_ranks} ranks "
        f"(window {window:.4f} s; the ranks' own forwards "
        f"{[round(v['forward_s'], 4) for v in verdicts]} s; the ranks' "
        f"processes {wall:.1f} s with start-up, keygen and prepare); "
        f"launches per rank {[v['launches'] for v in verdicts]}")
    out.update(launches=launched, cases=ranks[0]["cases"])
    return out


PIPELINE_STAGES = 3
PIPELINE_RECORDS = 4     # streamed after one record that fills the stages


def pipeline_phase(dev, shapes: LaunchShapes | None = None) -> dict:
    """`PipelineForward` over LoLa (`build_lola_bsgs`, full width and
    depth) on this card: one stage, then PIPELINE_STAGES stages on a CUDA
    stream each; one record streamed to fill the stages, then
    PIPELINE_RECORDS records back to back.  Every record's decoded logits
    against the Raw oracle (rtol 1e-9), the S-stage run's decoded outputs
    equal to the one-stage run's, the launches held to K1, K2 and K4;
    records per second of the streamed records (host clock, all stages
    synchronised)."""
    from cryptonets_tpu_torch.data.preprocess import synthetic_mnist_records
    from cryptonets_tpu_torch.models.lola_mnist import build_lola_bsgs
    from cryptonets_tpu_torch.parallel import PipelineForward

    records = synthetic_mnist_records(1 + PIPELINE_RECORDS, seed=11)
    copy = lambda: [(lb, f.copy()) for lb, f in records]  # noqa: E731
    head_r, _, _ = build_lola_bsgs(False, records=copy())
    head_r.prepare_network()
    raws = [head_r.get_next().get_column(0).decrypt() for _ in records]
    reset_kernel_counts()
    head, fac, reader = build_lola_bsgs(True, device=dev)
    head.prepare_network()
    out, decoded = {}, {}
    for S in (1, PIPELINE_STAGES):
        reader.set_source_records(copy())
        pipe = PipelineForward(head, n_stages=S, devices=[dev] * S)
        before = kernel_counts()
        with shapes or contextlib.nullcontext():
            first = pipe.run_stream(1)
        t0 = time.perf_counter()
        outs = first + pipe.run_stream(PIPELINE_RECORDS)
        dt = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in kernel_counts().items()}
        check_launches(f"pipeline {S} stages", launched,
                       BUTTERFLY_KERNELS + ("mod_contract",), MATMUL_KERNELS)
        decoded[S] = [o.get_column(0).decrypt() for o in outs]
        for i, (enc, raw) in enumerate(zip(decoded[S], raws)):
            if enc.shape != raw.shape or not np.allclose(enc, raw, rtol=1e-9, atol=0):
                raise SystemExit(f"pipeline {S} stages record {i}: {enc[:10]} "
                                 f"disagree with the Raw oracle {raw[:10]}")
        out[f"stages_{S}"] = dict(
            layers=[len(g) for g in pipe.groups], records=PIPELINE_RECORDS,
            seconds=dt, records_per_s=PIPELINE_RECORDS / dt, launches=launched,
            budget=outs[-1].get_column(0).noise_budget())
        log(f"pipeline, LoLa in {S} stage(s) of {out[f'stages_{S}']['layers']} "
            f"layers on {S} stream(s) of one card: {1 + PIPELINE_RECORDS} "
            f"records match the Raw oracle; {PIPELINE_RECORDS} streamed in "
            f"{dt:.3f} s = {PIPELINE_RECORDS / dt:.2f} records/s; final budget "
            f"{out[f'stages_{S}']['budget']} bits; kernel launches {launched}")
    if not all(np.array_equal(a, b) for a, b in
               zip(decoded[1], decoded[PIPELINE_STAGES])):
        raise SystemExit("pipeline: the staged run's decoded outputs differ "
                         "from the one-stage run's")
    log(f"pipeline: the {PIPELINE_STAGES}-stage run's decoded outputs equal the "
        f"one-stage run's")
    out["launches"] = kernel_counts()
    return out


# the reference's per-operation budgets on `bigt62`'s ring (n = 8192, the
# default 7-limb chain, digit switching at dbc = 16, t = ntt_primes(8192,
# 63, 1)[0]), as the JAX package's `utils/budget.py` `op_budgets` returns
# them on JAX's CPU platform for its `CrtBfvFactory(plain_primes=
# ntt_primes(8192, 63, 1), n=8192, seed=0)`:
# (fresh, enc x enc dot, plain dot, slot sum, plain mult, enc mult, rotate)
REFERENCE_BIGT62_BUDGETS = (91, 5, 4, 87, 17, 16, 91)


def bigt62_phase(dev, shapes: LaunchShapes | None = None) -> dict:
    """A plain prime between 2**62 and 2**63 (t = 1 mod 2n, from the
    port's `crypto/primes.py`) at n = 8192 over the default 7-limb chain:
    the factory encodes on the host, encrypts and evaluates on the card
    and decrypts exactly on the host.  Encrypt, add_plain, a plaintext
    product, a ciphertext product with relinearisation and decrypt, each
    result exact and with budget left; the per-operation budgets beside
    the reference's row on the same ring."""
    from cryptonets_tpu_torch.api.factory import CrtBfvFactory
    from cryptonets_tpu_torch.crypto.primes import ntt_primes
    from cryptonets_tpu_torch.utils.budget import op_budgets

    n = 8192
    t = ntt_primes(n, 63, 1)[0]
    if not (1 << 62) < t < (1 << 63):
        raise SystemExit(f"bigt62: t = {t} is not between 2**62 and 2**63")
    reset_kernel_counts()
    with shapes or contextlib.nullcontext():
        t0 = _sync_s()
        fac = CrtBfvFactory(plain_primes=(t,), n=n, seed=0, device=dev)
        keygen_s = _sync_s() - t0
        if fac._device_encode or fac._device_decode or fac._device_decode_big:
            raise SystemExit("bigt62: the factory takes a device encode or decode")
        rng = np.random.default_rng(62)
        a = rng.integers(-(1 << 30), 1 << 30, 64)
        b = rng.integers(-(1 << 30), 1 << 30, 64)
        ai, bi = a.astype(object), b.astype(object)
        t0 = _sync_s()
        va = fac.get_encrypted_vector(a.astype(float), "dense", 1.0)
        vb = fac.get_encrypted_vector(b.astype(float), "dense", 1.0)
        encrypt_s = _sync_s() - t0
        if va.data.device.type != "cuda":
            raise SystemExit("bigt62: the ciphertexts left the card")
        pb = fac.get_plain_vector(b.astype(float), "dense", 1.0)
        results = {
            "encrypt": (va, ai),
            "add_plain": (va.add(pb), ai + bi),
            "mul_plain": (va.pointwise_multiply(pb), ai * bi),
            "multiply_relinearize": (va.pointwise_multiply(vb), ai * bi),
        }
        row = op_budgets(fac)
    launched = kernel_counts()
    check_launches("bigt62", launched, BUTTERFLY_KERNELS,
                   MATMUL_KERNELS + ("mod_contract",))
    budgets = {}
    for name, (vec, want) in results.items():
        t0 = time.perf_counter()
        got = vec.decrypt_full_precision()
        dec_s = time.perf_counter() - t0
        budgets[name] = vec.noise_budget()
        if not np.array_equal(got, want) or budgets[name] <= 0:
            raise SystemExit(f"bigt62 {name}: {got[:4]} against {want[:4]}, "
                             f"{budgets[name]} bits")
        log(f"bigt62 {name}: exact, budget {budgets[name]} bits "
            f"(host decrypt {dec_s:.3f} s)")
    log(f"bigt62 (n = {n}, {len(fac.coeff_modulus)} limbs, t = {t}, "
        f"{t.bit_length()} bits): keygen {keygen_s:.3f} s, two encryptions "
        f"{encrypt_s:.3f} s; op budgets "
        + ", ".join(f"{k} {v}" for k, v in row.items())
        + f"; the reference {REFERENCE_BIGT62_BUDGETS}; kernel launches {launched}")
    return dict(launches=launched, t=t, budgets=budgets, op_budgets=row,
                reference=REFERENCE_BIGT62_BUDGETS, keygen_s=keygen_s)


def featurize_phase(dev) -> dict:
    """The seeded AlexNet featurizer (`data/alexnet.py`) on the card for
    four synthetic 227x227 images, against the CPU run of the same
    parameters: rtol 1e-4, and 1e-4 of the largest feature for the values
    near 0 that the ReLUs leave (the card runs float32 without TF32).
    No PIL on this path."""
    from cryptonets_tpu_torch.data.alexnet import AlexNetFeaturizer

    images = np.random.default_rng(227).integers(0, 256, (4, 227, 227, 3),
                                                 dtype=np.uint8)
    cpu = AlexNetFeaturizer(seed=0, device="cpu")(images)
    card = AlexNetFeaturizer(seed=0, device=dev)
    card(images)
    t0 = _sync_s()
    got = card(images)
    ms = 1e3 * (_sync_s() - t0)
    scale = float(np.abs(cpu).max())
    err = float(np.abs(got - cpu).max())
    if got.shape != (4, 4096) or not np.allclose(got, cpu, rtol=1e-4,
                                                 atol=1e-4 * scale):
        raise SystemExit(f"featurize: the card's features differ from the CPU's "
                         f"by up to {err:.3e} (largest feature {scale:.3e})")
    log(f"featurize: AlexNet fc7 features of 4 images on the card equal the "
        f"CPU's (max abs difference {err:.3e}, largest feature {scale:.3e}); "
        f"{ms:.2f} ms for the batch on the card")
    return dict(ms=ms, max_abs_err=err, largest=scale)


def launcher_host_ms(dev, calls: int = 400) -> float:
    """K3, the launcher of K1/K2 (`kernels/ntt.py` `_launch`): host
    seconds a call, from the host clock over `calls` back-to-back
    forward NTTs of one row at n = 4096 (device work far shorter than the
    host's, so the queue never fills and the host sets the rate)."""
    from cryptonets_tpu_torch.crypto.ntt import get_ntt_context
    from cryptonets_tpu_torch.kernels import ntt as K

    mods = (40961,)
    tab = get_ntt_context(4096, mods).tables(dev)
    x = torch.zeros((1, 1, 4096), dtype=torch.int32, device=dev)
    for _ in range(10):
        K.ntt_forward(x, tab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        K.ntt_forward(x, tab)
    host = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return 1e3 * host


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + "; the result lines need all of them")
    ap.add_argument("--launch-shapes", action="store_true",
                    help="check and time the kernels at the launch shapes "
                         "a run of the paths pickles to stdin (the run "
                         "starts this itself)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phase in {phases}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.launch_shapes:
        return launch_shapes_main()
    import cryptonets_tpu_torch  # noqa: F401  (fails outside the checkout)
    from cryptonets_tpu_torch.kernels import build as B
    from cryptonets_tpu_torch.kernels import matmul_ntt as M
    from cryptonets_tpu_torch.kernels import modmatmul as MM
    from cryptonets_tpu_torch.kernels import ntt as K
    from cryptonets_tpu_torch.runtime import hostcrypto

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    # the host runtime (c++) builds beside the three nvcc runs
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: (hostcrypto.build(), time.perf_counter() - t0))
        B.build_sources([B.source("ntt.cu"), B.source("modmatmul.cu"),
                         B.source("matmul_ntt.cu")])
        host_lib, host_s = host.result()
    hostcrypto.get_lib()
    K.build()
    MM.build()
    M.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s, the three sources "
        f"in parallel (nvcc {B.BUILD_SECONDS}); host runtime {host_lib.name} "
        f"({host_s:.2f} s)")
    kernels = []
    for phase, run in (("ntt", kernel_phase), ("mmntt", mmntt_phase),
                       ("contract", lambda d: [contract_phase(d)])):
        if phase in phases:
            t0 = time.perf_counter()
            kernels += run(dev)
            log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    if "bigt" in phases:
        t0 = time.perf_counter()
        bigt_phase(dev)
        log(f"phase bigt: {time.perf_counter() - t0:.1f} s")
    # every path records its first record's (batch's) kernel launch shapes
    paths, recorded = {}, {}
    runs = (
        ("lola", lambda d, r: lola_phase(d, "lola", r)),
        ("cryptonets", lambda d, r: cryptonets_phase(d, shapes=r)),
        ("cryptonets_matmul", lambda d, r: cryptonets_phase(
            d, ntt_impl="matmul", same_as=paths.get("cryptonets"), shapes=r)),
        ("cryptonets_bigt", lambda d, r: cryptonets_phase(
            d, preset="cryptonets_bigt", same_as=paths.get("cryptonets"),
            shapes=r)),
        ("lola_small", lambda d, r: slice_c_phase(d, "lola_small", r)),
        ("caltech", lambda d, r: slice_c_phase(d, "caltech", r)))
    runs += tuple((phase, lambda d, r, p=phase: lola_phase(d, p, r))
                  for phase in ("lola_packed", "lola_large", "cifar",
                                "lola_dense", "cifar_bigt", "lola_large_bigt"))
    runs += (("serve", serve_phase), ("basic", basic_phase),
             ("op_budgets", op_budgets_phase), ("parallel", parallel_phase),
             ("pipeline", pipeline_phase), ("bigt62", bigt62_phase))
    for phase, run in runs:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        recorded[phase] = LaunchShapes()
        result = run(dev, recorded[phase])
        if phase in ("lola_small", "caltech"):
            for impl, r in result.items():
                paths[f"{phase}_{impl}"] = r
        else:
            paths[phase] = result
        if "cases" in result:      # the launch shapes a rank process sent back
            recorded[f"{phase} (rank 0)"] = result.pop("cases")
        torch.cuda.empty_cache()
        if phase == "cifar_bigt" and "cifar" in paths:
            log(f"final noise budget: cifar_bigt {paths[phase]['budget']} "
                f"bits, cifar {paths['cifar']['budget']} bits (this run)")
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    if "featurize" in phases:
        t0 = time.perf_counter()
        featurize_phase(dev)
        log(f"phase featurize: {time.perf_counter() - t0:.1f} s")
    if recorded:
        t0 = time.perf_counter()
        by_name, err = launch_shape_phase(recorded)
        for k in kernels:
            k["launch_shapes"] = by_name[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], err[k["name"]])
        log(f"phase launch shapes: {time.perf_counter() - t0:.1f} s")
    log(f"all phases: {time.perf_counter() - t_start:.1f} s, build included")
    if set(phases) != set(PHASES):
        log(f"phases {phases} passed; run every phase for the result lines")
        return 0
    for k in kernels:
        name = k["name"]
        # launches on each main path, counted from zero at its start, and
        # per record (per batch of 8192 for CryptoNets) on its timed part,
        # for the paths that serve records (not `basic` or `op_budgets`)
        k["launches_by_path"] = {p: r["launches"][name] for p, r in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        k["launches_per_record"] = {
            p: (r.get("per_record") or r["per_batch"])[name]
            for p, r in paths.items() if "per_record" in r or "per_batch" in r}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
