"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,ntt,mmntt,contract,fused,behz,
                           slotmap,bigt,lola,
                           cryptonets,cryptonets_matmul,cryptonets_bigt,
                           lola_small,caltech,lola_packed,lola_large,cifar,
                           lola_dense,cifar_bigt,lola_large_bigt,serve,
                           basic,op_budgets,parallel,pipeline,bigt62,
                           graph,record_batch,featurize]

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
     what the compiler made of each kernel instance); `fused`: K6, the
     modular multiply-accumulate (`kernels/modmac.cu`), in every form of
     its call sites (LoLa's hoisted babies, one and a chunk of 16, with
     the gather by their NTT-domain automorphisms and the accumulator; a
     stacked key switch; CIFAR's giant chunk read through strides;
     LoLaLarge's stacked and looped group switch), and K7, the fast base
     conversion (`kernels/bconv.cu`: q -> Bsk, Shenoy-Kumaresan's B ->
     (q, m_sk) in one launch, a group extension, two mod-downs) on the
     tables `BFVParams.bconv` prepares, each with edge residues, bit-equal
     to its twin, timed beside its byte bound and the twin's time, with
     its launch plan and what the compiler made of the kernel instance
     (registers, spilled bytes, blocks an SM), and the host ms of one
     launch of each; `behz`: the BEHZ multiply's kernels, K7's lift, floor
     and Shenoy-Kumaresan modes (`kernels/bconv.py` `behz`) and the
     NTT-domain tensor product (`kernels/modmac.py` `ct_tensor`, two
     operands and the square), at CryptoNets', LoLa's and CIFAR's shapes
     and on a limb-sharded rank's tables, with edge residues, bit-equal to
     their twins, timed beside their byte bounds with their plans and
     instances, and a square on the card equal to the CPU's; `slotmap`:
     the slot map (`kernels/slotmap.cu`, the fused record's slot
     buffers) bit-equal to its twin at LoLa's,
     CryptoNets' and LoLaSmall's batch shapes with int64's edges and
     halves, timed beside its byte bound and the twin's time; `bigt`: the C++
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
     oracle's, the budget beside the reference's; then the layers as one
     CUDA graph as the command lines run them (`evaluation_forward`,
     `bigt_graph_case`; `cryptonets_bigt` too, after its batches): on the
     eager record's input ciphertexts, the warm-up eager, the capture
     decided from the card's free memory against the reckoned pool and
     printed, one replay, its outputs bit-equal to the warm-up's and the
     eager record's; capture, eager and replay seconds, pool and peak GiB;
     `cryptonets_bigt` also with the pool made not to fit: the decision
     eager, two records eager and bit-equal;
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
     n = 8192 on the 6-data + 1-special chain: (a) `dryrun_production` on
     a one-rank NCCL group (mesh {batch: 1, limb: 1}), then over two ranks
     started with the spawn method on this one card under gloo, asked for
     by name (NCCL refuses one card twice): (b) at {batch: 2, limb: 1},
     each rank encrypting and evaluating only its own records, and (c) at
     {batch: 1, limb: 2}, rank 0 holding data limbs [0, 3) and rank 1
     [3, 6), both the special prime, each its limbs of the key set, on
     (a)'s first input ciphertexts (encrypted once and saved for the
     ranks), with collectives at every cross-limb operation, the outputs
     gathered over the ranks bit-equal to (a)'s, once as a loop over the
     records and once as one record batch under `torch.func.vmap` (one
     collective a cross-limb operation for the batch); every record exact
     against the Raw oracle, the verdicts gathered on rank 0, records per
     second of each over its group's window (a barrier before the timed
     forward, one after every rank's has synchronised), each rank's key
     bytes and collectives per record in (c);
 14. `pipeline`: `PipelineForward` over LoLa at full width, one stage and
     three stages on a CUDA stream each, each stage holding only the keys
     its layers look up; every streamed record against the Raw oracle,
     the three-stage outputs equal to the one-stage ones, records per
     second of each, each stage's key bytes beside the whole set's (fewer
     where its layers use fewer keys, no secret key);
 15. `bigt62`: a plain prime between 2**62 and 2**63 at n = 8192: host
     encode, encrypt and evaluate on the card, exact host decrypt of
     add_plain, a plaintext product and a ciphertext product with
     relinearisation, each exact with budget left, the budgets beside the
     reference's;
 16. `graph`: the compiled record (`nn/forward.py`), the counterpart of
     the reference's one XLA program a record: LoLa, LoLaSmall,
     Caltech-101, CryptoNets (8192 images), LoLaDense, LoLaPacked,
     LoLaLarge and CIFAR each eager and under `graph=True` on one head
     and key set (the whole record in one CUDA graph; the layers only for
     LoLaDense, whose plain primes encode on the host): a warm-up and
     five timed records of each form, every record against the Raw
     oracle (LoLaDense's wrong records counted, ROADMAP.md §3) and the two
     forms' decryptions equal, the graph's launches a record (replayed)
     equal to the eager record's, one slot map each where the factory
     encodes on the card, its outputs bit-equal to the
     eager layers on its own input ciphertexts read from its static
     buffer, two replays of one record with different input ciphertexts
     and equal decoded slots, capture seconds, graph pool and peak GiB,
     device busy ms and idle share of one profiled graph record, one
     record's parts with the device synchronised between them;
     `record_batch`: LoLaSmall at B = 16 and Caltech-101 at B = 32
     (`bench.py`'s BENCH_VMAP rows), the layers under `torch.func.vmap`,
     one graph replay a batch: every record against the Raw oracle and
     bit-equal to the eager layers on its input ciphertexts, ms a record,
     launches a batch (one slot map), peak and graph pool GiB;
 17. `featurize`: the seeded AlexNet featurizer on the card for four
     synthetic images against the CPU run of the same parameters;
 18. launch shapes: every path records the shape of every kernel launch
     of its first record (batch), and after the paths a fresh process
     (`--launch-shapes`, fed the shapes on stdin) holds K1/K2, K5, K4
     (on the path's own weights), K6 and K7 (their operands' layouts,
     strides included; K6 on the path's own gathers, K7 on its own table)
     and the slot map (on the path's own index map and plain primes)
     bit-equal to their plain versions at each, with edge rows, and times
     each beside its bound, K6's and K7's device over bound ms summed up
     as the median and maximum over the launches of a million outputs or
     more and over the rest, K6's gathered ones apart (the two-rank
     `parallel` runs' rank 0 sends its shapes back to this process).
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
PHASES = ("build", "ntt", "lift", "mmntt", "contract", "fused", "behz", "slotmap", "bigt",
          "lola",
          "cryptonets",
          "cryptonets_matmul", "cryptonets_bigt", "lola_small", "caltech",
          "lola_packed", "lola_large", "cifar", "lola_dense", "cifar_bigt",
          "lola_large_bigt", "serve", "basic", "op_budgets", "parallel",
          "pipeline", "bigt62", "graph", "record_batch", "featurize")
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
    raise SystemExit(f"{PROFILER_EMPTY} for {kernel} "
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


def lift_bound(src_rows: int, L: int, n: int, inverse: bool) -> dict:
    """The least time for one lift launch of `src_rows` source rows of n
    over L limbs (`kernels/ntt.cu`, the lift load): bytes, each source
    coefficient read once and each of the L outputs written once, the limb
    tables (twiddles, companions, the scale pair) and moduli; operations,
    `ntt_bound`'s of the L src_rows output rows, the scale by R mod q (or
    n^-1) a product."""
    rows = src_rows * L
    logn = n.bit_length() - 1
    nbytes = 4 * src_rows * n + 4 * rows * n + 2 * L * n * 4 + L * 4 + 8 * L
    products = rows * (n // 2) * logn + rows * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * products / INT32_MUL_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=1e3 * t_bytes, int32_ops_ms=1e3 * t_ops,
                design_ops_ms=1e3 * 3 * products / INT32_MUL_PER_S, bytes=nbytes)


def ntt_lift_case(name: str, src_rows: int, tab, gen, launches: int = 50,
                  where: str = "") -> dict:
    """One lift load at one launch shape: source rows [src_rows, n] as the
    BSGS encode gives them (the forward: values in [0, 2**31) with a row of
    2**31 - 1 and one of zeros; the inverse: values in (-t, t), t the
    smallest modulus, with rows of t - 1, -(t - 1) and 0) bit-equal to the
    plain twin, then timed (events and profiler device time) beside
    `lift_bound`.  Returns its entry."""
    from cryptonets_tpu_torch.kernels import ntt as K

    L, n = tab.psi.shape
    inverse = name == "ntt_inverse_lift"
    dev = tab.q.device
    if inverse:
        t = int(tab.q.min())
        x = torch.randint(-t + 1, t, (src_rows, n), generator=gen, device=dev,
                          dtype=torch.int32)
        edges = (t - 1, -(t - 1), 0)
    else:
        x = torch.randint(0, 1 << 31, (src_rows, n), generator=gen, device=dev,
                          dtype=torch.int32)
        edges = ((1 << 31) - 1, 0)
    for i, v in enumerate(edges[:src_rows]):
        x[i] = v
    launch = K.ntt_inverse_lift if inverse else K.ntt_forward_lift
    twin = K.ntt_inverse_lift_plain if inverse else K.ntt_forward_lift_plain
    y, ref = launch(x, tab), twin(x, tab)
    torch.cuda.synchronize()
    err = int((y.long() - ref.long()).abs().max())
    del y, ref
    if err:
        raise SystemExit(f"{name} disagrees with its twin at {where} [{src_rows}, "
                         f"{n}] over {L} limbs: max error {err}")
    kernel = "ntt_inverse_kernel" if inverse else "ntt_forward_kernel"
    e = dict(where=where, shape=[src_rows, n], limbs=L, max_abs_err=err,
             ms=event_ms(lambda: launch(x, tab), launches=launches),
             device_ms=device_ms(lambda: launch(x, tab), kernel, launches=launches),
             **lift_bound(src_rows, L, n, inverse))
    e["ratio"] = e["device_ms"] / e["bound_ms"]
    log(f"{name} {where} [{src_rows}, {n}] over {L} limbs: bit-equal to twin, "
        f"edge rows too; events {e['ms']:.4f} / device {e['device_ms']:.4f} / "
        f"bound {e['bound_ms']:.4f} ms by {e['bound_by']} ({e['bytes'] / 1e6:.1f} "
        f"MB; {e['ratio']:.2f}x)")
    return e


# the BSGS diagonal encode's lift launches: (where, n, limbs, plain primes,
# source rows of the inverse = g F; the forward's are P g F)
LIFT_SHAPES = (("CIFAR giant chunk", 16384, 13, 3, 128),
               ("LoLa Dense(100) chunk", 8192, 7, 4, 64),
               ("LoLa Dense(10) chunk", 8192, 7, 4, 32))


def lift_phase(dev) -> list[dict]:
    """Both lift loads bit-equal to their twins and timed beside their
    bounds at the BSGS encode's shapes (`LIFT_SHAPES`), on the chains of
    the presets `cifar` and `lola`; each instance's registers, spills and
    blocks an SM."""
    from cryptonets_tpu_torch.crypto.ntt import get_ntt_context
    from cryptonets_tpu_torch.crypto.primes import default_coeff_modulus_128
    from cryptonets_tpu_torch.kernels import ntt as K
    from cryptonets_tpu_torch.models.presets import CONFIGS

    gen = torch.Generator(device=dev).manual_seed(29)
    entries = {name: [] for name in LIFT_KERNELS}
    instances = {}
    for where, n, L, P, gF in LIFT_SHAPES:
        logn = n.bit_length() - 1
        preset = CONFIGS["cifar" if n == 16384 else "lola"]
        plain = preset["plain_primes"]
        assert len(plain) == P, (where, plain)
        tab = get_ntt_context(n, default_coeff_modulus_128(n)[:L]).tables(dev)
        ptab = get_ntt_context(n, plain).tables(dev)
        for name in LIFT_KERNELS:
            inverse = name == "ntt_inverse_lift"
            key = f"{name}<{logn}>"
            if key not in instances:
                instances[key] = K.kernel_info(logn, inverse, lift=True)
                log(f"{key}: {instances[key]}")
            entries[name].append(ntt_lift_case(
                name, gF if inverse else P * gF, ptab if inverse else tab, gen,
                where=where))
    keep = ("where", "shape", "limbs", "ms", "device_ms", "bound_ms", "bound_by",
            "ratio")
    return [dict(name=name, route="cuda",
                 source="cryptonets_tpu_torch/kernels/ntt.cu",
                 # none: it replaces the XLA glue of the BSGS encode
                 replaces=None,
                 max_abs_err=max(e["max_abs_err"] for e in entries[name]),
                 library_ms=None,
                 **{k: entries[name][0][k] for k in keep if k != "where"},
                 shapes=[{k: e[k] for k in keep} for e in entries[name]],
                 instances={k: v for k, v in instances.items() if k.startswith(name)})
            for name in LIFT_KERNELS]


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


# ------------------------------------------------- fused kernels (K6, K7)
FUSED_KERNELS = ("mod_mac", "fast_bconv")
# the BEHZ multiply's kernels: K7's modes and the tensor product
BEHZ_KERNELS = ("fast_bconv_lift", "fast_bconv_floor", "fast_bconv_sk", "ct_tensor")
# the kernels whose launches are cases of their operands' layouts
SPEC_KERNELS = FUSED_KERNELS + ("slot_map",) + BEHZ_KERNELS
FUSED_LAUNCHES = 10   # timed launches a shape (a big-t record has 10**5)


def _layout(x) -> tuple | None:
    """(shape, strides) of a view, or None."""
    return None if x is None else (tuple(x.shape), tuple(x.stride()))


def _distinct(layout) -> int:
    """Elements a view reads once each: its sizes over the dims whose
    stride is not 0 (a broadcast dim reads the same elements again)."""
    if layout is None:
        return 0
    return int(np.prod([s for s, st in zip(*layout) if st != 0], dtype=np.int64))


def _strided(layout, mods, gen, dev, values=None) -> torch.Tensor:
    """A tensor laid out as `layout` records (the strides reproduced, the
    dims of stride 0 broadcast) holding `values`, or residues of the chain
    `mods` (limbs at dim -2) with the edges: every row's coefficients 0
    and 1 at 0 and q - 1, the first index of dim 0 at q - 1 throughout."""
    shape, stride = layout
    compact = tuple(1 if st == 0 else s for s, st in zip(shape, stride))
    if values is None:
        q = torch.tensor(mods, dtype=torch.int64, device=dev).view(-1, 1)
        values = _residues(compact, mods, gen, dev)
        values[..., 0] = 0
        values[..., 1] = (q - 1).view(-1).to(torch.int32)
        values[0] = (q - 1).to(torch.int32)
    x = torch.empty_strided(compact, tuple(st or 1 for st in stride),
                            dtype=values.dtype, device=dev)
    x.copy_(values)
    return x.expand(shape)


def fused_bound(nbytes: int, products: int, outputs: int) -> dict:
    """The least time the card could take for a sum of `products` modular
    products into `outputs` residues moving `nbytes`: each input read once
    (a broadcast or gathered operand's distinct elements), each output
    written once, at 3.35 TB/s; one 32 x 32 -> 64 bit product (two 32-bit
    multiplies) a term and one reduction (two) an output on the integer
    pipe."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * (products + outputs) / INT32_MUL_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=1e3 * t_bytes, int32_ops_ms=1e3 * t_ops,
                bytes=nbytes)


def mac_spec(a, b, acc, perm, chain) -> dict:
    """A K6 launch as a case: the layouts of its operands in the kernel's
    form, the gather itself (read to the host by `shape_cases`, after the
    run, as K7's table is: the path's own NTT-domain automorphisms), the
    chain's moduli."""
    return dict(kind="mod_mac", a=_layout(a), b=[_layout(x) for x in b],
                acc=[_layout(x) for x in acc], perm=perm,
                mods=tuple(chain.moduli))


def bconv_spec(y, c, chain) -> dict:
    """A K7 launch as a case: y's layout, the layout of the prepared table
    the kernel reads (its Montgomery form), the table's values (read to
    the host by `shape_cases`, after the run), the targets' moduli."""
    from cryptonets_tpu_torch.kernels.bconv import BconvTable

    t = c if isinstance(c, BconvTable) else BconvTable.prepare(c, chain.moduli)
    return dict(kind="fast_bconv", y=_layout(y), c=_layout(t.mont), table=t.c,
                mods=tuple(chain.moduli))


LARGE_OUTPUTS = 1 << 20   # a launch of a million outputs or more


def ratio_summary(entries) -> dict:
    """Device ms over bound ms of K6 or K7 launch cases: the median and the
    maximum over the large ones (LARGE_OUTPUTS or more) and over the rest,
    K6's gathered cases apart."""
    groups = {}
    for e in entries:
        key = ("large" if e["outputs"] >= LARGE_OUTPUTS else "small") + (
            ", gathered" if e.get("gather") else "")
        groups.setdefault(key, []).append(e["device_ms"] / e["bound_ms"])
    return {k: dict(cases=len(v), median=statistics.median(v), max=max(v))
            for k, v in sorted(groups.items())}


def _spec_key(spec) -> tuple:
    """What tells two K6, K7, slot-map or BEHZ launches apart for the
    check: the layouts and moduli (not a table's or an index map's
    values), a BEHZ mode's targets and the rows its lift writes through."""
    if spec["kind"] in BEHZ_KERNELS:
        return (spec["kind"], spec["x"], spec["mods"], spec.get("targets"),
                spec.get("through"), spec.get("square"))
    if spec["kind"] == "slot_map":
        return ("slot_map", spec["x"], len(spec["pos"]), spec["mods"])
    if spec["kind"] == "mod_mac":
        return ("mod_mac", spec["a"], tuple(spec["b"]), tuple(spec["acc"]),
                None if spec["perm"] is None else len(spec["perm"]), spec["mods"])
    return ("fast_bconv", spec["y"], spec["c"], spec["mods"])


def fused_case(spec, gen, dev, where: str, plain: bool = False,
               timed: bool = True) -> dict:
    """K6 or K7 at one launch `spec` (`mac_spec`, `bconv_spec`): operands
    laid out as recorded, with edge residues (K7's y over [0, 2**31 - 1),
    any residue of a 31-bit source; K6's gather the recorded one), the
    kernel bit-equal to its twin on the card, with its launch plan and
    kernel instance; then timed (events and profiler device time) beside
    its bound, and the twin timed when `plain`."""
    from cryptonets_tpu_torch.crypto.bfv import get_mod_chain
    from cryptonets_tpu_torch.kernels import bconv as K7
    from cryptonets_tpu_torch.kernels import modmac as K6

    mods = spec["mods"]
    chain = get_mod_chain(mods, dev)
    if spec["kind"] == "mod_mac":
        a = _strided(spec["a"], mods, gen, dev)
        b = tuple(_strided(x, mods, gen, dev) for x in spec["b"])
        acc = tuple(None if x is None else _strided(x, mods, gen, dev)
                    for x in spec["acc"])
        perm = None if spec["perm"] is None else torch.as_tensor(spec["perm"]).to(dev)
        args = (a, b, chain, acc, perm)
        kernel, twin = K6._launch, K6.mod_mac_plain
        Z, C = b[0].shape[0], len(b)
        J, R1, RA, RB, L, N = a.shape
        outputs = Z * R1 * RA * RB * C * L * N
        nbytes = 4 * (_distinct(spec["a"]) + sum(map(_distinct, spec["b"]))
                      + sum(map(_distinct, spec["acc"])) + outputs + 4 * L)
        nbytes += 0 if perm is None else 4 * perm.numel()   # an int32 index
        bound = fused_bound(nbytes, outputs * J, outputs)
        pl = K6.plan_of(a, b, acc, None if perm is None else perm.to(torch.int32))
        instance = K6.kernel_info(C, pl["RT"], pl["V"])
    else:
        Lf = spec["y"][0][-2]
        y = _strided(spec["y"], [2**31 - 1] * Lf, gen, dev)
        vals = torch.as_tensor(spec["table"]).to(dev)
        mont = K7.BconvTable.prepare(vals, mods).mont
        c = K7.BconvTable(vals, _strided(spec["c"], None, gen, dev, values=mont))
        args = (y, c, chain)
        kernel, twin = K7._launch, K7.fast_bconv_plain
        RA, RB, _, N = y.shape
        outputs = RA * RB * len(mods) * N
        nbytes = 4 * (_distinct(spec["y"]) + outputs + 4 * len(mods) + mont.numel())
        bound = fused_bound(nbytes, outputs * Lf, outputs)
        pl = K7.plan_of(y, c)
        instance = K7.kernel_info(Lf, pl["V"])
    out, ref = kernel(*args), twin(*args)
    torch.cuda.synchronize()
    err = int((out.long() - ref.long()).abs().max())
    del out, ref
    if err:
        raise SystemExit(f"{spec['kind']} disagrees with its twin at {where}: "
                         f"{spec}: max error {err}")
    e = dict(where=where, shape=[list(x) for x in (
        [spec["a"][0]] + [x[0] for x in spec["b"]] if spec["kind"] == "mod_mac"
        else [spec["y"][0], spec["c"][0]])], max_abs_err=err, outputs=outputs,
        plan={k: pl[k] for k in ("V", "RT", "chunk", "grid") if k in pl},
        instance={k: instance[k] for k in ("registers", "local_bytes", "blocks_per_sm")},
        **bound)
    if spec["kind"] == "mod_mac":
        e.update(gather=spec["perm"] is not None,
                 acc=sum(x is not None for x in spec["acc"]))
    if timed:
        e["ms"] = event_ms(lambda: kernel(*args), launches=FUSED_LAUNCHES, repeats=3)
        e["device_ms"] = device_ms(lambda: kernel(*args), f"{spec['kind']}_kernel",
                                   launches=FUSED_LAUNCHES)
        e["ratio"] = e["device_ms"] / e["bound_ms"]
    if plain:
        e["plain_ms"] = event_ms(lambda: twin(*args), launches=2, repeats=3, warmup=1)
    return e


def fused_host_ms(dev, lola, table, calls: int = 400) -> dict:
    """Host ms of one K6 and one K7 launch (the wrapper's checks, launch
    plan and ctypes call), from the host clock over `calls` back-to-back
    calls at n = 4096, as `launcher_host_ms` times K3: K6 a key switch's
    two keys on one limb, K7 LoLa's q -> Bsk on its own table `table`
    (device work far shorter than the host's)."""
    from cryptonets_tpu_torch.crypto.bfv import get_mod_chain
    from cryptonets_tpu_torch.kernels import bconv as K7
    from cryptonets_tpu_torch.kernels import modmac as K6

    n = 4096
    chain = get_mod_chain(lola.q_list[:1], dev)
    a = torch.zeros((1, 1, 1, 1, n), dtype=torch.int32, device=dev)
    keys = (a.clone(), a.clone())
    y = torch.zeros((1, len(lola.q_list), n), dtype=torch.int32, device=dev)
    out = {}
    for name, call in (("mod_mac", lambda: K6.mod_mac(a, keys, chain)),
                       ("fast_bconv", lambda: K7.fast_bconv(y, table, lola.chain_bsk))):
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        out[name] = 1e3 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
    return out


def fused_phase(dev) -> list[dict]:
    """K6 and K7 bit-equal to their twins on the card in every form their
    call sites take, at the main paths' shapes, with edge residues, each
    timed beside its bound and the twin's time (every shape a path
    launches them at is checked after the paths, `launch_shape_phase`)."""
    from cryptonets_tpu_torch.crypto.bfv import BFV, BFVParams, get_mod_chain
    from cryptonets_tpu_torch.crypto.ntt import ntt_automorphism_perm
    from cryptonets_tpu_torch.crypto.primes import default_coeff_modulus_128
    from cryptonets_tpu_torch.models.presets import CONFIGS

    gen = torch.Generator(device=dev).manual_seed(17)
    q16 = default_coeff_modulus_128(16384)
    lola = BFVParams(8192, CONFIGS["lola"]["plain_primes"][0], ks_alpha=1, device=dev)
    large = BFVParams(16384, CONFIGS["lola_large"]["plain_primes"][0],
                      coeff_modulus=q16[:11], n_special=3, device=dev)

    def z(*shape):          # a layout only: the cases make their own data
        return torch.empty(shape, dtype=torch.int32, device="meta")

    mac = []
    # LoLa's hoisted babies: dhat [J = 7 groups, P = 4, F = 1, k = 7, N],
    # the keys of 63 babies, c0_hat's gathered accumulator, the gathers of
    # babies 1..16 as `stacked_baby_rotations` builds them
    J, P, k, N = 7, 4, 7, 8192
    perms = torch.from_numpy(np.stack([
        ntt_automorphism_perm(N, BFV(lola).galois_elt_rows(b))
        for b in range(1, 17)])).to(dev)
    a = z(J, P, 1, k, N).reshape(J, 1, P, k, N).unsqueeze(2)
    keys = z(63, J, k, N)
    c0 = z(P, 1, k, N).reshape(1, 1, P, k, N)
    for B, where in ((1, "LoLa hoisted baby (one)"),
                     (16, "LoLa hoisted babies (a chunk of 16)")):
        mac.append((where, mac_spec(
            a, [keys[:B, :, None]] * 2,
            [c0.expand(B, -1, -1, -1, -1).unsqueeze(2), None], perms[:B],
            lola.chain_q)))
    # LoLa's relinearisation: the stacked groups, both keys, no gather
    mac.append(("LoLa key switch (stacked, J = 7)", mac_spec(
        a, [keys[0].reshape(1, J, 1, k, N)] * 2, [None, None], None, lola.chain_q)))
    # CIFAR's giant chunk: bab_hat [P = 3, g = 64, F = 2, 2, 13, N] chained,
    # one flip a launch, the second onto the first
    P3, g, L13, N16 = 3, 64, 13, 16384
    bab = z(P3, g, 2, 2, L13, N16)
    forms = z(P3, g, 2, L13, N16)
    x = bab[:, :, 1].transpose(0, 1).unsqueeze(2)
    mac.append(("CIFAR giant chunk (g = 64, second flip)", mac_spec(
        x, [forms[:, :, 1].transpose(0, 1)[None]], [z(1, P3, 2, L13, N16).unsqueeze(2)],
        None, get_mod_chain(q16[:13], dev))))
    # LoLaLarge's ladders: the groups stacked (J = 4 over Q*P, 14 limbs)
    # and looped (J = 1 onto the accumulator), 16 rows of the P = 3 primes
    R = 48
    aq = z(4, R, 14, N16).reshape(4, 1, R, 14, N16).unsqueeze(2)
    kq = z(4, 14, N16).reshape(1, 4, 1, 14, N16)
    mac.append(("LoLaLarge key switch (stacked groups, J = 4)", mac_spec(
        aq, [kq] * 2, [None, None], None, large.chain_qp)))
    acc = z(R, 2, 14, N16)[:, 0].reshape(1, 1, R, 14, N16).unsqueeze(2)
    mac.append(("LoLaLarge key switch (looped, J = 1)", mac_spec(
        aq[:1], [kq[:, :1]] * 2, [acc, acc], None, large.chain_qp)))
    bconv = [
        ("LoLa square: q -> Bsk", bconv_spec(
            z(1, 2, 7, N), lola.bconv["q_to_bsk"], lola.chain_bsk)),
        ("LoLa square: B -> (q, m_sk), Shenoy-Kumaresan in one launch", bconv_spec(
            z(1, 2, len(lola.B_list), N), lola.bconv["B_to_q_msk"], lola.chain_q_msk)),
        ("LoLaLarge ladder: group extension (alpha = 3 -> Q*P)", bconv_spec(
            z(1, R, 11, N16)[:, :, 3:6], large.bconv["groups"][1], large.chain_qp)),
        ("LoLaLarge mod-down: sp -> q", bconv_spec(
            z(1, R * 2, 3, N16), large.bconv["sp_to_q"], large.chain_q)),
        ("lola_large_bigt mod-down: sp -> q (246 rows)", bconv_spec(
            z(1, 246, 3, N16), large.bconv["sp_to_q"], large.chain_q)),
    ]
    entries = {}
    for name, cases in (("mod_mac", mac), ("fast_bconv", bconv)):
        entries[name] = [fused_case(spec, gen, dev, where, plain=True)
                         for where, spec in cases]
        for e in entries[name]:
            log(f"{name} {e['where']} {e['shape']}: bit-equal to twin, edges "
                f"too; events {e['ms']:.4f} / device {e['device_ms']:.4f} / "
                f"bound {e['bound_ms']:.4f} ms by {e['bound_by']} "
                f"({e['bytes'] / 1e6:.2f} MB; {e['ratio']:.2f}x) / plain "
                f"{e['plain_ms']:.3f} ms; plan {e['plan']}, instance {e['instance']}")
    # the kernels line's shape: the main path's (LoLa's chunk of babies,
    # LoLa's square)
    main = {"mod_mac": entries["mod_mac"][1], "fast_bconv": entries["fast_bconv"][0]}
    host = fused_host_ms(dev, lola, lola.bconv["q_to_bsk"])
    log(f"host ms a launch: K6 {host['mod_mac']:.4f}, K7 {host['fast_bconv']:.4f}")
    keep = ("where", "shape", "ms", "device_ms", "bound_ms", "bound_by", "plain_ms",
            "plan", "instance")
    return [
        dict(name=name, route="cuda",
             source=f"cryptonets_tpu_torch/kernels/{src}", replaces=replaces,
             max_abs_err=max(e["max_abs_err"] for e in entries[name]),
             ms=main[name]["ms"], device_ms=main[name]["device_ms"],
             plain_ms=main[name]["plain_ms"],
             **{k: main[name][k] for k in ("bound_ms", "bound_by", "bytes_bound_ms",
                                           "int32_ops_ms")},
             # no PyTorch call computes a modular sum of products
             library_ms=None, shape=main[name]["shape"], launcher_host_ms=host[name],
             by_shape=[{k: e[k] for k in keep} for e in entries[name]])
        for name, src, replaces in (
            ("mod_mac", "modmac.cu", "cryptonets_tpu/crypto/bfv.py:1118"),
            ("fast_bconv", "bconv.cu", "cryptonets_tpu/crypto/bfv.py:952"))]


def behz_spec(x, tab=None, chain=None, square=None) -> dict:
    """A launch of one of the BEHZ kernels as a case: the input's layout
    and its rows' moduli; a K7 mode's tables (`tab`, a `BehzMode`: moved
    to the host by `shape_cases`, after the run), their targets' moduli
    and the source rows [lo, hi) the lift writes through; the tensor
    product's square flag."""
    if tab is None:
        return dict(kind="ct_tensor", x=_layout(x), mods=tuple(chain.moduli),
                    square=square)
    return dict(kind=f"fast_bconv_{tab.mode}", x=_layout(x), mods=tab.row_moduli,
                targets=tab.moduli[1], through=(tab.lo, tab.lo + tab.out0), tab=tab)


def behz_case(spec, gen, dev, where: str, plain: bool = False,
              timed: bool = True) -> dict:
    """A BEHZ kernel at one launch `spec` (`behz_spec`): its input laid
    out as recorded with edge residues of its chain, bit-equal to its twin
    on the card, with its plan and instance; then timed (events and the
    profiler's device time) beside its bound (each input read once, each
    output written once; the products and reductions of the mode), the
    twin too when `plain`."""
    from cryptonets_tpu_torch.crypto.bfv import get_mod_chain
    from cryptonets_tpu_torch.kernels import bconv as K7
    from cryptonets_tpu_torch.kernels import modmac as K6

    kind, mods = spec["kind"], spec["mods"]
    x = _strided(spec["x"], mods, gen, dev)
    N = x.shape[-1]
    if kind == "ct_tensor":
        chain = get_mod_chain(mods, dev)
        square = spec["square"]
        y = None if square else _strided(spec["x"], mods, gen, dev)
        args, kernel, twin = (x, y, chain), K6._launch_tensor, K6.ct_tensor_plain
        cells = x.numel() // 2                     # (row, limb, coefficient)
        outputs = 3 * cells
        nbytes = 4 * (x.numel() * (1 if square else 2) + outputs + 4 * len(mods))
        bound = fused_bound(nbytes, cells * (6 if square else 7), 6 * cells)
        pl = K6.tensor_plan(cells // (N * len(mods)), len(mods), N, True)
        instance = K6.tensor_kernel_info(square, pl["V"])
        name = "ct_tensor_kernel"
    else:
        mode = kind[len("fast_bconv_"):]
        tab = spec["tab"].to(dev)
        args, kernel, twin = (x, tab), K7._launch_behz, K7.behz_plain
        R = x.numel() // (tab.Lin * N)
        Lf, Lt = tab.Lf, tab.Lt
        outputs = R * tab.Lout * N
        nbytes = 4 * (x.numel() + outputs + tab.src.numel() + tab.tab.numel()
                      + tab.tgt.numel())
        # a Shoup scale a source, the correction's products (the lift's
        # sum, SK's extra target), Lf + 1 products and a REDC a target
        extra = {"lift": Lf, "floor": 0, "sk": Lf + 1}[mode]
        bound = fused_bound(nbytes, R * N * (2 * Lf + extra + Lt * (Lf + 1)),
                            R * N * (Lt + (mode == "sk")))
        pl = K7.mode_plan(R, Lf, Lt, N, 16)
        instance = K7.kernel_info(Lf, pl["V"], mode)
        name = "fast_bconv_kernel_behz"
    out, ref = kernel(*args), twin(*args)
    torch.cuda.synchronize()
    err = int((out.long() - ref.long()).abs().max())
    del out, ref
    if err:
        raise SystemExit(f"{kind} disagrees with its twin at {where}: "
                         f"{ {k: v for k, v in spec.items() if k != 'tab'} }: "
                         f"max error {err}")
    e = dict(where=where, shape=[list(spec["x"][0])], max_abs_err=err, outputs=outputs,
             plan={k: pl[k] for k in ("V", "chunk", "grid") if k in pl},
             instance={k: instance[k] for k in ("registers", "local_bytes", "blocks_per_sm")},
             **bound)
    if timed:
        e["ms"] = event_ms(lambda: kernel(*args), launches=FUSED_LAUNCHES, repeats=3)
        e["device_ms"] = device_ms(lambda: kernel(*args), name, launches=FUSED_LAUNCHES)
        e["ratio"] = e["device_ms"] / e["bound_ms"]
    if plain:
        e["plain_ms"] = event_ms(lambda: twin(*args), launches=2, repeats=3, warmup=1)
    return e


class _Limbs:
    """A limb shard's block [lo, hi) of k, for `BFVParams.narrow`'s tables
    only (no collective)."""

    def __init__(self, lo, hi, k):
        self.lo, self.hi, self.k = lo, hi, k


def behz_phase(dev) -> list[dict]:
    """The BEHZ multiply's kernels bit-equal to their twins on the card at
    CryptoNets' chunk (64 ciphertexts), LoLa's one ciphertext and CIFAR's
    at n = 16384, each timed beside its bound and the twin; the lift and
    Shenoy-Kumaresan on a limb-sharded rank's tables (limbs [2, 5) of
    CryptoNets' chain) too; a square on the card equal to the CPU's
    twins' (every shape a path launches them at is checked after the
    paths, `launch_shape_phase`)."""
    from cryptonets_tpu_torch.crypto.bfv import BFV, BFVParams
    from cryptonets_tpu_torch.crypto.primes import default_coeff_modulus_128
    from cryptonets_tpu_torch.models.presets import CONFIGS

    gen = torch.Generator(device=dev).manual_seed(19)
    rings = {
        "CryptoNets": (8192, CONFIGS["cryptonets"]["plain_primes"][0],
                       tuple(default_coeff_modulus_128(8192)), 64),
        "LoLa": (8192, CONFIGS["lola"]["plain_primes"][0],
                 tuple(default_coeff_modulus_128(8192)), 1),
        "CIFAR": (16384, CONFIGS["cifar"]["plain_primes"][0],
                  tuple(default_coeff_modulus_128(16384)[:13]), 1)}

    def z(*shape):          # a layout only: the cases make their own data
        return torch.empty(shape, dtype=torch.int32, device="meta")

    params = {title: BFVParams(n, t, qs, device=dev)
              for title, (n, t, qs, rows) in rings.items()}
    cases = []
    for title, (n, t, qs, rows) in rings.items():
        p = params[title]
        k, nb = len(qs), len(p.bsk_list)
        cases += [
            (f"{title} square: lift", behz_spec(z(rows, 2, k, n), p.bconv["lift"])),
            (f"{title} square: tensor", behz_spec(
                z(rows, 2, k + nb, n), chain=p.chain_qbsk, square=True)),
            (f"{title} multiply: tensor", behz_spec(
                z(rows, 2, k + nb, n), chain=p.chain_qbsk, square=False)),
            (f"{title} square: floor", behz_spec(z(rows, 3, k + nb, n), p.bconv["floor"])),
            (f"{title} square: Shenoy-Kumaresan", behz_spec(
                z(rows, 3, nb, n), p.bconv["sk"]))]
    n, t, qs, rows = rings["CryptoNets"]
    rank = params["CryptoNets"].narrow(_Limbs(2, 5, len(qs))).bconv
    cases += [
        ("CryptoNets square, limbs [2, 5): lift", behz_spec(
            z(rows, 2, len(qs), n), rank["lift"])),
        ("CryptoNets square, limbs [2, 5): Shenoy-Kumaresan", behz_spec(
            z(rows, 3, rank["sk"].Lin, n), rank["sk"]))]
    entries = {name: [] for name in BEHZ_KERNELS}
    for where, spec in cases:
        e = behz_case(spec, gen, dev, where, plain=True)
        entries[spec["kind"]].append(e)
        log(f"{spec['kind']} {where} {e['shape']}: bit-equal to twin, edges too; "
            f"events {e['ms']:.4f} / device {e['device_ms']:.4f} / bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']} ({e['bytes'] / 1e6:.2f} MB; "
            f"{e['ratio']:.2f}x) / plain {e['plain_ms']:.3f} ms; plan {e['plan']}, "
            f"instance {e['instance']}")
    # a square of CryptoNets' chunk on the card against the CPU's twins
    p = params["CryptoNets"]
    a = _residues((rows, 2, len(qs), n), qs, gen, dev)
    sq = BFV(p).square(a)
    if not torch.equal(sq, BFV(p).multiply(a, a.clone())):
        raise SystemExit("the square on the card differs from multiply(a, a)")
    cpu = BFV(BFVParams(n, t, qs, device="cpu"))
    if not torch.equal(sq.cpu(), cpu.square(a.cpu())):
        raise SystemExit("the square on the card differs from the CPU's twins'")
    sq_ms = event_ms(lambda: BFV(p).square(a), launches=5, repeats=3)
    log(f"CryptoNets square of 64 ciphertexts on the card: bit-equal to "
        f"multiply(a, a) and to the CPU's twins; {sq_ms:.3f} ms (events)")
    keep = ("where", "shape", "ms", "device_ms", "bound_ms", "bound_by", "plain_ms",
            "plan", "instance")
    # the JAX package's lift, tensor products, fast floor, Shenoy-Kumaresan
    sources = {"fast_bconv_lift": ("bconv.cu", 961), "ct_tensor": ("modmac.cu", 1000),
               "fast_bconv_floor": ("bconv.cu", 1016), "fast_bconv_sk": ("bconv.cu", 1025)}
    out = []
    for name in BEHZ_KERNELS:
        main = entries[name][0]            # CryptoNets' chunk
        src, line = sources[name]
        replaces = f"cryptonets_tpu/crypto/bfv.py:{line}"
        out.append(dict(
            name=name, route="cuda", source=f"cryptonets_tpu_torch/kernels/{src}",
            replaces=replaces, max_abs_err=max(e["max_abs_err"] for e in entries[name]),
            ms=main["ms"], device_ms=main["device_ms"], plain_ms=main["plain_ms"],
            **{k: main[k] for k in ("bound_ms", "bound_by", "bytes_bound_ms",
                                    "int32_ops_ms")},
            library_ms=None, shape=main["shape"],
            by_shape=[{k: e[k] for k in keep} for e in entries[name]]))
    return out


class SquareLaunches:
    """Within `with`, the kernel launches of every `BFV.square` and
    `BFV.multiply` call, and whether it was made inside a Square layer
    (`SquareActivation.apply`); `check` holds them to the BEHZ path."""

    def __enter__(self):
        from cryptonets_tpu_torch.crypto.bfv import BFV
        from cryptonets_tpu_torch.nn.layers import SquareActivation

        self.calls = []        # (name, inside a Square layer, launches)
        self._orig = orig = (BFV.square, BFV.multiply, SquareActivation.apply)
        depth = [0]

        def counted(name, fn):
            def wrapped(bfv, *args):
                before = kernel_counts()
                out = fn(bfv, *args)
                after = kernel_counts()
                self.calls.append((name, depth[0] > 0, {
                    k: v - before[k] for k, v in after.items() if v != before[k]}))
                return out
            return wrapped

        def apply(layer, m):
            depth[0] += 1
            try:
                return orig[2](layer, m)
            finally:
                depth[0] -= 1

        BFV.square = counted("square", orig[0])
        BFV.multiply = counted("multiply", orig[1])
        SquareActivation.apply = apply
        return self

    def __exit__(self, *exc):
        from cryptonets_tpu_torch.crypto.bfv import BFV
        from cryptonets_tpu_torch.nn.layers import SquareActivation

        BFV.square, BFV.multiply, SquareActivation.apply = self._orig

    def check(self, where: str, ntt_impl: str = "butterfly") -> int:
        """The Square layers call `square` only, at least once, and each
        square launches one lift, one forward NTT over q + Bsk, one tensor
        product, one inverse NTT, one floor and one Shenoy-Kumaresan mode:
        no plain `fast_bconv`.  Returns the squares seen."""
        fwd, inv = ((MATMUL_KERNELS if ntt_impl == "matmul" else BUTTERFLY_KERNELS))
        want = {"fast_bconv_lift": 1, fwd: 1, "ct_tensor": 1, inv: 1,
                "fast_bconv_floor": 1, "fast_bconv_sk": 1}
        inside = [(name, d) for name, at, d in self.calls if at]
        bad = [(name, d) for name, d in inside if name != "square" or d != want]
        if not inside or bad:
            raise SystemExit(f"{where}: the Square layers made {len(inside)} "
                             f"products; not one square of {want} each: {bad[:3]}")
        return len(inside)


def slotmap_spec(x, pos, primes) -> dict:
    """A slot-map launch as a case: the values' layout, the index map (read
    to the host by `shape_cases`, after the run), the plain primes."""
    return dict(kind="slot_map", x=_layout(x), pos=pos,
                mods=tuple(int(t) for t in primes))


# int32 multiplies of one floor modulus in the slot map: the 64 x 64 high
# product of the Barrett quotient (four) and the quotient times t (two)
SLOTMAP_MULS = 6
SLOTMAP_EDGES = (2.0**62, -2.0**62, 2.0**62 - 1024, -2.0**62 + 1024, 0.0, 1.0, -1.0)


def slotmap_case(spec, gen, dev, where: str, plain: bool = False,
                 timed: bool = True) -> dict:
    """The slot map at one launch `spec` (`slotmap_spec`): values laid out
    as recorded, integers of both signs below 2**40 with int64's edges
    (+-2**62) in the first record's first column and halves in the last
    one's last column, on the path's index map and primes; the kernel
    bit-equal to its twin on the card, then timed (events and profiler
    device time) beside its bound (each value read once, each buffer
    position written once, the index map once; the floor moduli on the
    integer pipe), and the twin timed when `plain`."""
    from cryptonets_tpu_torch.kernels import slotmap as SM

    shape, stride = spec["x"]
    R, dim, V = shape
    primes = spec["mods"]
    vals = torch.randint(-2**40, 2**40, shape, generator=gen, device=dev).double()
    edges = torch.tensor(SLOTMAP_EDGES, dtype=torch.float64, device=dev)[:dim]
    vals[0, :len(edges), 0] = edges
    halves = torch.arange(-20, 20, dtype=torch.float64, device=dev)[:dim] + 0.5
    vals[-1, :len(halves), -1] = halves
    x = torch.empty_strided(shape, stride, dtype=torch.float64, device=dev)
    x.copy_(vals)
    pos = torch.as_tensor(spec["pos"]).to(dev)
    n = pos.shape[0]
    out, ref = SM._launch(x, pos, primes), SM.slot_map_plain(x, pos, primes)
    torch.cuda.synchronize()
    err = int((out.long() - ref.long()).abs().max())
    del out, ref
    if err:
        raise SystemExit(f"slot_map disagrees with its twin at {where}: "
                         f"{shape}, n {n}, primes {primes}: max error {err}")
    pl = SM.plan(R, dim, V, n)
    outputs = len(primes) * R * V * pl["C"] * n
    nbytes = 8 * R * dim * V + 4 * outputs + 4 * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = SLOTMAP_MULS * outputs / INT32_MUL_PER_S
    e = dict(where=where, shape=[R, dim, V], n=n, primes=len(primes),
             max_abs_err=err, outputs=outputs, plan=dict(pl),
             instance={k: v for k, v in SM.kernel_info().items()
                       if k in ("registers", "local_bytes", "blocks_per_sm")},
             bound_ms=1e3 * max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             bytes_bound_ms=1e3 * t_bytes, int32_ops_ms=1e3 * t_ops, bytes=nbytes)
    if timed:
        e["ms"] = event_ms(lambda: SM._launch(x, pos, primes),
                           launches=FUSED_LAUNCHES, repeats=3)
        e["device_ms"] = device_ms(lambda: SM._launch(x, pos, primes),
                                   "slot_map_kernel", launches=FUSED_LAUNCHES)
        e["ratio"] = e["device_ms"] / e["bound_ms"]
    if plain:
        e["plain_ms"] = event_ms(lambda: SM.slot_map_plain(x, pos, primes),
                                 launches=2, repeats=3, warmup=1)
    return e


def slotmap_phase(dev) -> list[dict]:
    """The slot map bit-equal to its twin on the card at the benchmark
    cells' shapes (LoLa's one image: [1, 169, 25] into 4 x 25 buffers;
    CryptoNets' 8192 images: [1, 8192, 784] into 3 x 784) and LoLaSmall's
    batch of 16, with edge values, each timed beside its bound and the
    twin's time (every shape a path launches it at is checked after the
    paths, `launch_shape_phase`)."""
    from cryptonets_tpu_torch.crypto.encoder import BatchEncoder
    from cryptonets_tpu_torch.models.presets import CONFIGS

    gen = torch.Generator(device=dev).manual_seed(23)
    entries = []
    for where, R, dim, V, preset in (
            ("LoLa, one image", 1, 169, 25, "lola"),
            ("CryptoNets, 8192 images", 1, 8192, 784, "cryptonets"),
            ("LoLaSmall, a batch of 16", 16, 169, 25, "lola_small")):
        n, primes = CONFIGS[preset]["n"], CONFIGS[preset]["plain_primes"]
        pos = torch.from_numpy(np.argsort(BatchEncoder(n, primes[0]).index_map)
                               .astype(np.int32))
        x = torch.empty((R, dim, V), dtype=torch.float64, device="meta")
        e = slotmap_case(slotmap_spec(x, pos, primes), gen, dev, where, plain=True)
        rows = e["outputs"] // (e["primes"] * e["n"])
        log(f"slot_map {where} {e['shape']} -> [{e['primes']}, {rows}, {e['n']}]: "
            f"bit-equal to twin, edges too; events {e['ms']:.4f} / device "
            f"{e['device_ms']:.4f} / bound {e['bound_ms']:.4f} ms by {e['bound_by']} "
            f"({e['bytes'] / 1e6:.2f} MB; {e['ratio']:.2f}x) / plain "
            f"{e['plain_ms']:.3f} ms; plan {e['plan']}, instance {e['instance']}")
        entries.append(e)
    main = entries[1]             # CryptoNets': the one far above launch latency
    keep = ("where", "shape", "ms", "device_ms", "bound_ms", "bound_by", "plain_ms",
            "plan", "instance")
    return [dict(name="slot_map", route="cuda",
                 source="cryptonets_tpu_torch/kernels/slotmap.cu",
                 # none: the JAX package builds the buffers on the host
                 replaces=None,
                 max_abs_err=max(e["max_abs_err"] for e in entries),
                 ms=main["ms"], device_ms=main["device_ms"], plain_ms=main["plain_ms"],
                 **{k: main[k] for k in ("bound_ms", "bound_by", "bytes_bound_ms",
                                         "int32_ops_ms")},
                 library_ms=None, shape=main["shape"],
                 by_shape=[{k: e[k] for k in keep} for e in entries])]


# ---------------------------------------------------------------- slices
BUTTERFLY_KERNELS = ("ntt_forward", "ntt_inverse")
LIFT_KERNELS = ("ntt_forward_lift", "ntt_inverse_lift")   # their lift loads
MATMUL_KERNELS = ("matmul_ntt_forward", "matmul_ntt_inverse")


def kernel_counts() -> dict:
    from cryptonets_tpu_torch.kernels import LAUNCH_TABLES

    return {k: v for counts in LAUNCH_TABLES for k, v in counts.items()}


def reset_kernel_counts() -> None:
    from cryptonets_tpu_torch.kernels import LAUNCH_TABLES

    for counts in LAUNCH_TABLES:
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
    """Within `with`, records every kernel launch by shape: K1/K2 (and
    their lift loads, by source rows) and K5 with their tables, K4 with
    its weights and moduli, K6, K7 and the slot map by the layouts of
    their operands (`mac_spec`, `bconv_spec`, `slotmap_spec`).  A path's own
    launch shapes, read off its run for the kernel check that follows the
    paths (`launch_shape_phase`)."""

    def __init__(self):
        self.ntt = {}        # (shape, id(tables)) -> (tables, {kernel names})
        self.lift = {}       # (name, source shape, id(tables)) -> tables
        self.mmntt = {}      # the same for K5
        self.contract = {}   # (M, O, shape, moduli) -> weights
        self.fused = {}      # `_spec_key` -> K6, K7 or slot-map spec

    def __enter__(self):
        from cryptonets_tpu_torch.kernels import bconv as K7
        from cryptonets_tpu_torch.kernels import matmul_ntt as M
        from cryptonets_tpu_torch.kernels import modmac as K6
        from cryptonets_tpu_torch.kernels import modmatmul as MM
        from cryptonets_tpu_torch.kernels import ntt as K
        from cryptonets_tpu_torch.kernels import slotmap as SM

        self._orig = orig = (K._launch, M._launch, MM._launch, K6._launch,
                             K7._launch, SM._launch, K._launch_lift,
                             K7._launch_behz, K6._launch_tensor)

        def tables_launch(seen, launch):
            def wrapped(name, x, tab, *tables):
                entry = seen.setdefault((tuple(x.shape), id(tab)), (tab, set()))
                entry[1].add(name)
                return launch(name, x, tab, *tables)
            return wrapped

        def lift_launch(name, x, tab, *rest):
            self.lift.setdefault((name, tuple(x.shape), id(tab)), tab)
            return orig[6](name, x, tab, *rest)

        def contract_launch(w, x, q_list):
            key = MM._check(w, x, q_list) + (tuple(x.shape),
                                             tuple(int(q) for q in q_list))
            self.contract.setdefault(key, w)
            return orig[2](w, x, q_list)

        def mac_launch(a, b, chain, acc, perm):
            spec = mac_spec(a, b, acc, perm, chain)
            self.fused.setdefault(_spec_key(spec), spec)
            return orig[3](a, b, chain, acc, perm)

        def bconv_launch(y, c, chain):
            spec = bconv_spec(y, c, chain)
            self.fused.setdefault(_spec_key(spec), spec)
            return orig[4](y, c, chain)

        def slotmap_launch(x, pos, primes):
            spec = slotmap_spec(x, pos, primes)
            self.fused.setdefault(_spec_key(spec), spec)
            return orig[5](x, pos, primes)

        def behz_launch(x, tab):
            spec = behz_spec(x, tab)
            self.fused.setdefault(_spec_key(spec), spec)
            return orig[7](x, tab)

        def tensor_launch(x, y, chain):
            spec = behz_spec(x, chain=chain, square=y is None)
            self.fused.setdefault(_spec_key(spec), spec)
            return orig[8](x, y, chain)

        K._launch = tables_launch(self.ntt, orig[0])
        K._launch_lift = lift_launch
        M._launch = tables_launch(self.mmntt, orig[1])
        MM._launch = contract_launch
        K6._launch, K7._launch, SM._launch = mac_launch, bconv_launch, slotmap_launch
        K7._launch_behz, K6._launch_tensor = behz_launch, tensor_launch
        return self

    def __exit__(self, *exc):
        from cryptonets_tpu_torch.kernels import bconv as K7
        from cryptonets_tpu_torch.kernels import matmul_ntt as M
        from cryptonets_tpu_torch.kernels import modmac as K6
        from cryptonets_tpu_torch.kernels import modmatmul as MM
        from cryptonets_tpu_torch.kernels import ntt as K
        from cryptonets_tpu_torch.kernels import slotmap as SM

        (K._launch, M._launch, MM._launch, K6._launch, K7._launch,
         SM._launch, K._launch_lift, K7._launch_behz, K6._launch_tensor) = self._orig


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


def bigt_graph_case(title: str, head, m, eager_out, refuse: bool = False) -> dict:
    """A big-t preset's layers as one CUDA graph, as its command line runs
    it (`evaluation_forward`: the factory encodes on the host, so the
    graph holds the layers), on the input matrix `m` of the path's eager
    record, whose outputs were `eager_out`: `run_graph`'s warm-up runs
    the layers eagerly on the graph's static inputs (a copy of m), the
    capture is decided from the card's free memory against the reckoned
    pool (printed), the graph is captured and replayed once, and its
    outputs decrypted.  The replay's outputs must be bit-equal to the
    eager record's (so its decryption is the eager record's, gated on the
    Raw oracle there).  `refuse`: then once more with the pool made not to
    fit (`GRAPH_FREE_SHARE` 0): the decision eager, printed, no graph, the
    record's outputs and those of a second record on m (the eager path)
    bit-equal to the eager record's.  Returns the decision, the warm-up
    (eager), capture and replay (with the decrypt) seconds, the reckoned,
    free and pool GiB, the peak GiB and the kernel launches of the replay
    and decrypt."""
    from cryptonets_tpu_torch.nn import forward
    from cryptonets_tpu_torch.nn.forward import evaluation_forward

    def same(out):
        return all(torch.equal(a.data, b.data) for a, b in zip(out.vectors, eager_out.vectors))

    fwd = evaluation_forward(head)
    if not fwd.graph or fwd.factory.encodes_on_device:
        raise SystemExit(f"{title}: expected a layers-only graph, got graph="
                         f"{fwd.graph} on a factory that encodes on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kernel_counts()
    t0 = time.perf_counter()
    out = fwd.run_graph(m)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in kernel_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launched["slot_map"]:
        raise SystemExit(f"{title}: the layers-only graph launched the slot map")
    if fwd.eager:
        raise SystemExit(f"{title}: the graph was refused on this card: "
                         f"{list(fwd.eager.values())}")
    (g,) = fwd.graphs().values()
    if not same(out):
        raise SystemExit(f"{title}: the graph's outputs differ from the eager "
                         f"layers' on the graph's own input ciphertexts")
    res = dict(decision=g.decision, eager_s=g.warm_s,
               capture_s=g.capture_s - g.warm_s, replay_s=first_s - g.capture_s,
               need_gib=g.need_bytes / 2**30, free_gib=g.free_bytes / 2**30,
               pool_gib=g.pool_bytes / 2**30, peak_gib=peak, replay_launches=launched)
    log(f"{title} under a graph (the layers): {g.decision}; eager (the "
        f"warm-up) {res['eager_s']:.3f} s, capture {res['capture_s']:.3f} s, "
        f"replay {res['replay_s']:.3f} s; pool {res['pool_gib']:.3f} GiB, peak "
        f"{peak:.2f} GiB; the replay's outputs bit-equal to the eager "
        f"record's on the same input ciphertexts; kernel launches of the "
        f"replay and decrypt {launched}")
    fwd.release()
    del g, out
    torch.cuda.empty_cache()
    if refuse:
        share = forward.GRAPH_FREE_SHARE
        forward.GRAPH_FREE_SHARE = 0.0
        try:
            fwd = evaluation_forward(head)
            outs = [fwd.run_graph(m), fwd.run_graph(m)]
        finally:
            forward.GRAPH_FREE_SHARE = share
        if fwd.graphs() or len(fwd.eager) != 1 or not all(same(o) for o in outs):
            raise SystemExit(f"{title}: a graph whose pool does not fit: "
                             f"graphs {list(fwd.graphs())}, eager {fwd.eager}")
        (res["refused"],) = fwd.eager.values()
        log(f"{title} with the pool made not to fit: {res['refused']}; two "
            f"records ran eagerly, bit-equal to the eager record")
    return res


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
    # a BSGS dense layer encodes its diagonals through the lift loads
    bsgs = any(getattr(layer, "bsgs_form", None) is not None for layer in fwd.layers)
    lift = (LIFT_KERNELS, ()) if bsgs else ((), LIFT_KERNELS)
    # the first record's products, counted from before the layer wrappers
    # below so that they call the counting Square layer (a failure ends
    # the run, so only the normal exit restores the class)
    squares = SquareLaunches().__enter__()
    kept = []
    if raw_layers is not None:
        # keep every layer's output of the record for `layer_gate`, and
        # its input for the graph's (`bigt_graph_case`)
        for layer in fwd.layers:
            layer.apply = (lambda m, f=layer.apply: kept.append(f(m)) or kept[-1])
        fwd.encrypt = (lambda raw, f=fwd.encrypt: kept.append(f(raw)) or kept[-1])
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
                       BUTTERFLY_KERNELS + ("mod_contract",) + FUSED_KERNELS
                       + BEHZ_KERNELS + lift[0], MATMUL_KERNELS + lift[1])
        if i == 0:
            squares.check(f"{title} record {i}")
            squares.__exit__(None, None, None)
        if raw_layers is not None:
            by_layer = layer_gate(title, which, [type(l).__name__ for l in fwd.layers],
                                  kept[1:], raw_layers)
            first_record = (kept[0], kept[-1])
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
        del fwd.encrypt
    budget = out.noise_budget()
    if budget <= 0 and which not in EXHAUSTS_IN_LAST_LAYER:
        raise SystemExit(f"{title}: the noise budget is exhausted")
    graph = None
    if which in BY_LAYER:
        graph = bigt_graph_case(title, head, *first_record)
    launches = kernel_counts()
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
                galois_keys=galois, peak_gib=max(peaks), by_layer=by_layer,
                graph=graph)


def shape_cases(where: str, rec: LaunchShapes) -> list[dict]:
    """The launch shapes a path recorded as picklable cases of the fresh
    process's check: K1/K2, their lift loads and K5 by shape and
    moduli, K4 with the path's weights reduced mod each modulus, K6, K7
    and the slot map by their operands' layouts (K7 with the path's
    table, the slot map with its index map)."""
    from cryptonets_tpu_torch.kernels import modmatmul as MM

    cases = []
    for kind, seen in (("ntt", rec.ntt), ("mmntt", rec.mmntt)):
        for (shape, _), (tab, names) in seen.items():
            cases.append(dict(kind=kind, where=where, shape=shape,
                              mods=tuple(int(q) for q in tab.q.view(-1).tolist()),
                              names=sorted(names)))
    for (name, shape, _), tab in rec.lift.items():
        cases.append(dict(kind="ntt_lift", where=where, name=name, shape=shape,
                          mods=tuple(int(q) for q in tab.q.view(-1).tolist())))
    for (M, O, shape, mods), w in rec.contract.items():
        reduced = (w.reduced.cpu().numpy() if isinstance(w, MM.ContractWeights)
                   else MM.reduce_weights(w, mods))
        cases.append(dict(kind="contract", where=where, shape=shape, mods=mods,
                          reduced=reduced))
    for spec in rec.fused.values():
        cases.append(dict(spec, where=where, **{
            k: spec[k].cpu().numpy() for k in ("table", "perm", "pos")
            if spec.get(k) is not None}, **(
            {"tab": spec["tab"].to("cpu")} if "tab" in spec else {})))
    return cases


def launch_shape_phase(recorded: dict) -> tuple[dict, dict]:
    """Every kernel held to its plain version and timed beside its bound
    at every launch shape recorded on the paths (each (shape, moduli)
    once, in the first path that launched it; K4 on the path's own
    weights), in fresh processes of SHAPE_CHUNK cases each
    (`_shape_process`): after the paths' hundreds of thousands of launches
    the profiler's windows came back empty in this one.  `recorded` maps a path to its LaunchShapes, or to
    the cases (`shape_cases`) a rank process sent back.  Returns ({kernel
    name: [entries with `where`]}, {kernel name: max error})."""
    cases, done = [], set()
    for where, rec in recorded.items():
        for c in (rec if isinstance(rec, list) else shape_cases(where, rec)):
            key = _spec_key(c) if c["kind"] in SPEC_KERNELS else (
                c["kind"], c["shape"], c["mods"], c.get("name")) + (
                (c["reduced"].shape[0],) if c["kind"] == "contract" else ())
            if key not in done:
                done.add(key)
                cases.append(c)
    paths = ", ".join(recorded)
    recorded.clear()
    torch.cuda.empty_cache()
    names = (BUTTERFLY_KERNELS + LIFT_KERNELS + MATMUL_KERNELS + ("mod_contract",)
             + SPEC_KERNELS)
    shapes, err = {name: [] for name in names}, dict.fromkeys(names, 0)
    for c0 in range(0, len(cases), SHAPE_CHUNK):
        out = _shape_process(cases[c0:c0 + SHAPE_CHUNK])
        for name in names:
            shapes[name] += out["shapes"][name]
            err[name] = max(err[name], out["err"][name])
    counts = {kind: sum(c["kind"] == kind for c in cases)
              for kind in ("ntt", "ntt_lift", "mmntt", "contract") + SPEC_KERNELS}
    log(f"launch shapes of {paths}: {counts} (K1/K2, their lift loads, K5, K4, "
        f"K6, K7, the slot map, K7's BEHZ modes, the tensor product) bit-equal "
        f"to the plain versions, edge rows too, each timed with the "
        f"profiler's device time")
    return shapes, err


# cases a fresh process checks and times: a process's profiler has come
# back empty after some hundreds of windows (PERF.md §7), so the cases
# are cut into pieces, and a piece whose process saw no device time at
# all runs once more in another fresh process
SHAPE_CHUNK = 120
PROFILER_EMPTY = "the profiler recorded no device time"


def _shape_process(cases) -> dict:
    """`cases` checked and timed in a fresh process (`--launch-shapes`);
    its JSON result.  A kernel that disagrees with its plain version, or
    any other failure, fails the run; an empty profiler twice does too."""
    for attempt in range(2):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--launch-shapes"], input=pickle.dumps(cases),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              timeout=900, check=False)
        lines = proc.stdout.decode().splitlines()
        errors = proc.stderr.decode()
        for line in lines[:-1] if proc.returncode == 0 else lines:
            log(line)
        sys.stderr.write(errors)
        if proc.returncode == 0:
            return json.loads(lines[-1])
        if attempt or PROFILER_EMPTY not in errors:
            raise SystemExit(f"the launch-shape check failed ({proc.returncode}): "
                             + (errors.strip().splitlines() or [""])[-1])
        log(f"launch shapes: the profiler of that process saw no device time; "
            f"its {len(cases)} cases once more in a fresh process")


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
    names = (BUTTERFLY_KERNELS + LIFT_KERNELS + MATMUL_KERNELS + ("mod_contract",)
             + SPEC_KERNELS)
    err = dict.fromkeys(names, 0)
    shapes = {name: [] for name in names}
    instances = {}
    keep = ("ms", "device_ms", "bound_ms", "bound_by")  # the rest is in the log
    for c in sorted(cases, key=lambda c: (c["kind"], c["shape"][-1], c["shape"])
                    if "shape" in c else (c["kind"], 0, ())):
        mods, where = c["mods"], c["where"]
        if c["kind"] == "slot_map":
            e = slotmap_case(c, gen, dev, where)
            err["slot_map"] = max(err["slot_map"], e["max_abs_err"])
            shapes["slot_map"].append({k: e[k] for k in ("where", "shape", "outputs")
                                       + keep + ("plan", "instance")})
            continue
        if c["kind"] in BEHZ_KERNELS:
            e = behz_case(c, gen, dev, where)
            err[c["kind"]] = max(err[c["kind"]], e["max_abs_err"])
            shapes[c["kind"]].append({k: e[k] for k in ("where", "shape", "outputs")
                                      + keep + ("plan", "instance")})
            continue
        if c["kind"] in FUSED_KERNELS:
            e = fused_case(c, gen, dev, where)
            err[c["kind"]] = max(err[c["kind"]], e["max_abs_err"])
            shapes[c["kind"]].append({k: e[k] for k in ("where", "shape", "outputs")
                                      + keep + ("gather", "plan", "instance") if k in e})
            continue
        shape = c["shape"]
        if c["kind"] == "ntt_lift":
            tab = get_ntt_context(shape[-1], mods).tables(dev)
            e = ntt_lift_case(c["name"], shape[0], tab, gen, launches=20, where=where)
            err[c["name"]] = max(err[c["name"]], e["max_abs_err"])
            shapes[c["name"]].append({k: e[k] for k in ("where", "shape", "limbs")
                                      + keep})
        elif c["kind"] == "ntt":
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
        expect = (MATMUL_KERNELS + ("mod_contract",) + FUSED_KERNELS + BEHZ_KERNELS,
                  LIFT_KERNELS)
    else:
        expect = (BUTTERFLY_KERNELS + ("mod_contract",) + FUSED_KERNELS + BEHZ_KERNELS,
                  MATMUL_KERNELS + LIFT_KERNELS)

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
    inputs = []
    if preset == "cryptonets_bigt":
        # the warm-up batch's input, for its graph (`bigt_graph_case`)
        fwd.encrypt = (lambda raw, f=fwd.encrypt: inputs.append(f(raw)) or inputs[-1])
    lat = per_batch = out = logits = first = None
    for i, raw in enumerate(raws):
        before = kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        rec = shapes if i == 0 else None
        if rec is None and ntt_impl == "matmul":
            rec = LaunchShapes()
        t0 = time.perf_counter()
        with rec or contextlib.nullcontext(), SquareLaunches() as squares:
            out = fwd()
        enc = np.asarray(out.decrypt(), dtype=float)
        lat = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        per_batch = {k: v - before[k] for k, v in kernel_counts().items()}
        check_launches(f"{title} batch {i}", per_batch, *expect)
        if i == 0:
            n_sq = squares.check(f"{title} batch {i}", ntt_impl)
            log(f"{title} batch {i}: {n_sq} squares, each one lift, one forward "
                f"and one inverse NTT over q + Bsk, one tensor product, one floor, "
                f"one Shenoy-Kumaresan, no plain fast_bconv")
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
            logits, first = enc, out
            if same_as is not None and not np.array_equal(enc, same_as["logits"]):
                raise SystemExit(f"{title}: the warm-up batch's logits differ "
                                 f"from the butterfly run's")
        kind = "warm-up" if i == 0 else "timed"
        log(f"{title} batch {i} ({kind}): {lat:.4f} s "
            f"({1e3 * lat / batch:.4f} ms per image), {batch}/{batch} "
            f"predictions equal the Raw oracle's, logits within rtol 1e-9: "
            f"{close}, kernel launches {per_batch}, peak memory "
            f"{peak_gib:.2f} GiB")
    budget = min(v.noise_budget() for v in out.vectors)
    if budget <= 0:
        raise SystemExit(f"{title}: the noise budget is exhausted")
    graph = None
    if inputs:
        del fwd.encrypt
        graph = bigt_graph_case(title, head, inputs[0], first, refuse=True)
    launches = kernel_counts()
    beside = REFERENCE_BUDGETS.get(preset)
    log(f"{title} batch latency {lat:.4f} s, {1e3 * lat / batch:.4f} ms per "
        f"image; final noise budget {budget} bits (minimum over the 10 output "
        f"columns and the plain primes)"
        + (f"; the reference: {beside}" if beside else "")
        + ("; the warm-up logits equal the butterfly run's"
           if same_as is not None else ""))
    return dict(launches=launches, per_batch=per_batch, latency=lat,
                keygen_s=keygen_s, prepare_s=prepare_s, budget=budget,
                logits=logits, peak_gib=peak_gib, graph=graph)


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
        "butterfly": (BUTTERFLY_KERNELS + conv + FUSED_KERNELS,
                      MATMUL_KERNELS + (() if conv else ("mod_contract",))),
        # the slot encode and decode over Z_t stay on the butterfly NTT
        "matmul": (MATMUL_KERNELS + BUTTERFLY_KERNELS + conv + FUSED_KERNELS,
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
    the server's decrypt raises; K1, K2, K4 and the BEHZ kernels launch.
    `launches` counts the whole phase, `per_record` the server's steady
    record."""
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
    check_launches("serve", launched,
                   BUTTERFLY_KERNELS + ("mod_contract",) + FUSED_KERNELS + BEHZ_KERNELS,
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
    check_launches("basic", launched, BUTTERFLY_KERNELS + FUSED_KERNELS,
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
    check_launches("op_budgets", launched,
                   BUTTERFLY_KERNELS + FUSED_KERNELS + BEHZ_KERNELS, MATMUL_KERNELS)
    log(f"op budgets: {len(rows)} presets, kernel launches {launched}")
    if bad:
        raise SystemExit(f"op_budgets: {bad} at 0 bits or more than 3 bits "
                         f"from the reference's row")
    return dict(launches=launched, rows=rows)


# ------------------------------------------------------- slice G1, G2 and F2
PARALLEL_RECORDS = 16    # records of each rank, timed after one warm-up record
LIMB_RECORDS = 4         # (c)'s records, on both ranks, after one warm-up


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
        verdict = dryrun.production_rank(per_rank, device="cuda",
                                         batch=dist.get_world_size())
    launched = kernel_counts()
    check_launches(f"parallel rank {rank}", launched,
                   BUTTERFLY_KERNELS + ("mod_contract",) + FUSED_KERNELS + BEHZ_KERNELS,
                   MATMUL_KERNELS)
    verdict.update(rank=rank, exact=True, launches=launched,
                   device=torch.cuda.get_device_name(torch.cuda.current_device()))
    gathered = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(verdict, gathered, dst=0)
    return dict(verdicts=gathered,
                cases=shape_cases("parallel (b)", shapes) if shapes else [])


def parallel_limb_rank(inputs_path: str, batched: bool) -> dict:
    """One rank of the `parallel` phase's part (c) (started by
    `distributed.run_ranks` under gloo, both ranks on card 0):
    `dryrun_production` over the reference's default mesh of two ranks,
    {batch: 1, limb: 2}, on the input ciphertexts saved at `inputs_path`,
    this rank on its block of the 6 data limbs with its limbs of the key
    set, a loop over the records or (`batched`) one record batch under
    `torch.func.vmap` with one collective a cross-limb operation for the
    batch, every record exact against the Raw oracle, each Square layer's
    products squares through the BEHZ kernels on the rank's tables
    (`SquareLaunches`); its launch counts from zero, rank 0's launch
    shapes, the output columns gathered over the ranks (on the CPU), and
    every rank's verdict gathered on rank 0."""
    import torch.distributed as dist

    from cryptonets_tpu_torch.parallel import dryrun, make_mesh
    from cryptonets_tpu_torch.parallel.distributed import global_ciphertext_batch

    rank = dist.get_rank()
    mesh = make_mesh()
    inputs = torch.load(inputs_path)
    reset_kernel_counts()
    shapes = LaunchShapes() if rank == 0 else None
    with shapes or contextlib.nullcontext(), SquareLaunches() as squares:
        res = dryrun.dryrun_production(mesh, n_records=LIMB_RECORDS,
                                       device="cuda", inputs=inputs,
                                       batched=batched)
    launched = kernel_counts()
    check_launches(f"parallel (c) rank {rank}", launched,
                   BUTTERFLY_KERNELS + ("mod_contract",) + FUSED_KERNELS + BEHZ_KERNELS,
                   MATMUL_KERNELS)
    squares.check(f"parallel (c) rank {rank}")
    outputs = [global_ciphertext_batch(o, mesh, batch_axis=0, limb_axis=4).cpu()
               for o in res["outputs"]]
    verdict = {k: res[k] for k in dryrun.SUMMARY}
    verdict.update(rank=rank, exact=True, launches=launched,
                   device=torch.cuda.get_device_name(torch.cuda.current_device()))
    gathered = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(verdict, gathered, dst=0)
    if rank:
        return {}
    where = "parallel (c, batched)" if batched else "parallel (c)"
    return dict(verdicts=gathered, outputs=outputs, cases=shape_cases(where, shapes))


def parallel_phase(dev, shapes: LaunchShapes | None = None) -> dict:
    """`parallel/` at full width: (a) `dryrun_production` (LoLaSmall at
    n = 8192 on the 6-data + 1-special chain) on a one-rank NCCL group in
    this process, mesh {batch: 1, limb: 1}; (b) the same over two ranks
    started with the spawn method, both on this card, under gloo, asked
    for by name (NCCL refuses one card twice; gloo's collectives run on
    host tensors), at {batch: 2, limb: 1}, each rank encrypting and
    evaluating only its own records; (c) two such ranks at {batch: 1,
    limb: 2}, each on its 3 of the 6 data limbs and the special prime,
    on (a)'s first LIMB_RECORDS input ciphertexts, their outputs gathered
    over the ranks and held bit-equal to (a)'s.  Every record's decoded
    logits exact against the Raw oracle (each rank checks its own; a
    failing rank fails the run), the verdicts gathered on rank 0, the
    launches held to K1, K2, K4 and the BEHZ kernels (each of (c)'s
    squares to the six launches of one device's); records per second of each run: all
    its timed records over the group's window (host clock, from a barrier
    of every rank before the forward to one after every rank's forward
    has synchronised, after one warm-up record a rank)."""
    import tempfile

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
                   BUTTERFLY_KERNELS + ("mod_contract",) + FUSED_KERNELS + BEHZ_KERNELS,
                   MATMUL_KERNELS)
    out["one_rank"] = dict(mesh=res["mesh"], backend=backend,
                           records=PARALLEL_RECORDS, window_s=res["window_s"],
                           records_per_s=PARALLEL_RECORDS / res["window_s"],
                           key_bytes=res["key_bytes"])
    log(f"parallel (a): dryrun_production on one rank ({backend}), mesh "
        f"{res['mesh']}, LoLaSmall n = 8192, {res['n_limbs']} data limbs + 1 "
        f"special: {PARALLEL_RECORDS} records exact against the Raw oracle, "
        f"{out['one_rank']['records_per_s']:.2f} records/s "
        f"(window {res['window_s']:.4f} s); kernel launches {launched}")
    # (c)'s inputs and what (a) made of them
    limb_inputs = [d[:LIMB_RECORDS].cpu() for d in res["inputs"]]
    one_rank_outputs = [o[:LIMB_RECORDS].cpu() for o in res["outputs"]]
    del res

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
    cases = ranks[0]["cases"]

    one_key = out["one_rank"]["key_bytes"]
    for batched in (False, True):
        name = "limb_batch" if batched else "limb_ranks"
        what = "(c, batched)" if batched else "(c)"
        log(f"parallel {what}: {n_ranks} ranks on one card, gloo, the "
            f"reference's default mesh of two ranks: {LIMB_RECORDS} of (a)'s "
            f"input ciphertexts, RNS limbs over the ranks"
            + (", the records as one batch under vmap" if batched else ""))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "inputs.pt")
            torch.save(limb_inputs, path)
            t0 = time.perf_counter()
            ranks = run_ranks(parallel_limb_rank, n_ranks, path, batched,
                              backend="gloo")
            wall = time.perf_counter() - t0
        verdicts = ranks[0]["verdicts"]
        if len(verdicts) != n_ranks or not all(v["exact"] for v in verdicts):
            raise SystemExit(f"parallel {what}: verdicts {verdicts}")
        if verdicts[0]["mesh"] != {"batch": 1, "limb": 2} or [
                v["limbs"] for v in verdicts] != [(0, 3), (3, 6)]:
            raise SystemExit(f"parallel {what}: mesh {verdicts[0]['mesh']}, "
                             f"limbs {[v['limbs'] for v in verdicts]}")
        same = [torch.equal(g, w) for g, w in zip(ranks[0]["outputs"], one_rank_outputs)]
        if len(same) != len(one_rank_outputs) or not all(same):
            raise SystemExit(f"parallel {what}: gathered outputs equal to "
                             f"(a)'s: {same}")
        window = max(v["window_s"] for v in verdicts)
        for k in launched:
            launched[k] += sum(v["launches"][k] for v in verdicts)
        out[name] = lr = dict(
            n_ranks=n_ranks, backend="gloo", records=LIMB_RECORDS,
            batched=batched, mesh=verdicts[0]["mesh"],
            limbs=[v["limbs"] for v in verdicts], wall_s=wall, window_s=window,
            forward_s=[v["forward_s"] for v in verdicts],
            records_per_s=LIMB_RECORDS / window,
            key_bytes=[v["key_bytes"] for v in verdicts], one_rank_key_bytes=one_key,
            collectives_per_record=verdicts[0]["collectives"],
            launches=[v["launches"] for v in verdicts])
        cases += ranks[0]["cases"]
        log(f"parallel {what}: mesh {lr['mesh']}, ranks' limbs {lr['limbs']} of "
            f"6 (+ the special prime on both) on {verdicts[0]['device']}, every "
            f"record exact against the Raw oracle, the {len(same)} output "
            f"column(s) gathered over the ranks bit-equal to (a)'s on the same "
            f"inputs; {lr['records_per_s']:.2f} records/s (window "
            f"{window:.4f} s; the ranks' own forwards "
            f"{[round(f, 4) for f in lr['forward_s']]} s; the ranks' processes "
            f"{wall:.1f} s with start-up, keygen and prepare); key set bytes a "
            f"rank {lr['key_bytes']} against {one_key} on one rank "
            f"({[round(b / one_key, 4) for b in lr['key_bytes']]}; (3 + 1) / "
            f"(6 + 1) = {4 / 7:.4f}); collectives per record of the timed "
            f"forward {lr['collectives_per_record']}"
            + (f" (one a cross-limb operation for the batch of {LIMB_RECORDS})"
               if batched else "")
            + f"; launches per rank {lr['launches']} (K6 / K7 "
            f"{[(v['mod_mac'], v['fast_bconv']) for v in lr['launches']]}); "
            f"card {card_line()}")
    loop, batch = out["limb_ranks"], out["limb_batch"]
    for k, n in loop["collectives_per_record"].items():
        if batch["collectives_per_record"][k] * LIMB_RECORDS != n:
            raise SystemExit(f"parallel (c, batched): {k} a record "
                             f"{batch['collectives_per_record'][k]}, the loop's {n}")
    log(f"parallel (c): the batch {batch['records_per_s']:.2f} records/s against "
        f"the loop's {loop['records_per_s']:.2f} "
        f"({batch['records_per_s'] / loop['records_per_s']:.2f}x)")
    out.update(launches=launched, cases=cases)
    return out


PIPELINE_STAGES = 3
PIPELINE_RECORDS = 4     # streamed after one record that fills the stages


def pipeline_phase(dev, shapes: LaunchShapes | None = None) -> dict:
    """`PipelineForward` over LoLa (`build_lola_bsgs`, full width and
    depth) on this card: one stage, then PIPELINE_STAGES stages on a CUDA
    stream each; one record streamed to fill the stages, then
    PIPELINE_RECORDS records back to back.  Every record's decoded logits
    against the Raw oracle (rtol 1e-9), the S-stage run's decoded outputs
    equal to the one-stage run's, the launches held to K1, K2, K4 and the
    BEHZ kernels; records per second of the streamed records (host clock, all stages
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
        stage_bytes, whole = pipe.stage_key_bytes(), fac.keys.nbytes()
        for f, b in zip(pipe.factories, stage_bytes):
            fewer = (len(dict.keys(f.keys.galois)) < len(fac.keys.galois)
                     or f.keys.relin is None)
            if b > whole or (fewer and b >= whole) or f.has_secret_key:
                raise SystemExit(f"pipeline {S} stages: a stage holds {b} key "
                                 f"bytes of the whole set's {whole}")
        t0 = time.perf_counter()
        outs = first + pipe.run_stream(PIPELINE_RECORDS)
        dt = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in kernel_counts().items()}
        check_launches(f"pipeline {S} stages", launched,
                       BUTTERFLY_KERNELS + ("mod_contract",) + FUSED_KERNELS
                       + BEHZ_KERNELS,
                       MATMUL_KERNELS)
        decoded[S] = [o.get_column(0).decrypt() for o in outs]
        for i, (enc, raw) in enumerate(zip(decoded[S], raws)):
            if enc.shape != raw.shape or not np.allclose(enc, raw, rtol=1e-9, atol=0):
                raise SystemExit(f"pipeline {S} stages record {i}: {enc[:10]} "
                                 f"disagree with the Raw oracle {raw[:10]}")
        out[f"stages_{S}"] = dict(
            layers=[len(g) for g in pipe.groups], records=PIPELINE_RECORDS,
            seconds=dt, records_per_s=PIPELINE_RECORDS / dt, launches=launched,
            budget=outs[-1].get_column(0).noise_budget(),
            stage_key_bytes=stage_bytes, whole_key_bytes=whole,
            stage_galois_keys=[len(dict.keys(f.keys.galois)) for f in pipe.factories],
            whole_galois_keys=len(fac.keys.galois))
        log(f"pipeline, LoLa in {S} stage(s) of {out[f'stages_{S}']['layers']} "
            f"layers on {S} stream(s) of one card: {1 + PIPELINE_RECORDS} "
            f"records match the Raw oracle; {PIPELINE_RECORDS} streamed in "
            f"{dt:.3f} s = {PIPELINE_RECORDS / dt:.2f} records/s; final budget "
            f"{out[f'stages_{S}']['budget']} bits; key bytes a stage "
            f"{stage_bytes} ({out[f'stages_{S}']['stage_galois_keys']} Galois "
            f"keys) against the whole set's {whole} "
            f"({len(fac.keys.galois)}); kernel launches {launched}")
        log(f"pipeline {S} stage(s): K6 / K7 launches {launched['mod_mac']} / "
            f"{launched['fast_bconv']} over {1 + PIPELINE_RECORDS} records")
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
    # the host decrypts and the digit key switch converts no base: the
    # product's conversions are the BEHZ modes, and no plain K7 runs
    check_launches("bigt62", launched, BUTTERFLY_KERNELS + ("mod_mac",) + BEHZ_KERNELS,
                   MATMUL_KERNELS + ("mod_contract", "fast_bconv"))
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


# ------------------------------------------------------------- slice H
GRAPH_TIMED = 5   # timed records (CryptoNets: batches) of each form, after one
# the paths under a graph, the main path first: the whole record in the
# graph (fused) where the factory encodes and decodes on the card, the
# layers only for LoLaDense (plain primes near 2**35)
GRAPH_PATHS = ("lola", "lola_small", "caltech", "cryptonets", "lola_dense",
               "lola_packed", "lola_large", "cifar")
BATCHES = (("lola_small", 16), ("caltech", 32))   # README.md:32's batches


def _graph_spec(which: str, count: int):
    """(title, build(encrypt, records, device), pools of records (a pool:
    the records of one reader pull), the kernels the path must launch)
    for `count` pools of one path."""
    from functools import partial

    from cryptonets_tpu_torch.data.preprocess import (synthetic_cifar_records,
                                                      synthetic_feature_records,
                                                      synthetic_mnist_records)
    from cryptonets_tpu_torch.models import caltech101, cryptonets_mnist, lola_cifar
    from cryptonets_tpu_torch.models import lola_mnist as LM

    conv = BUTTERFLY_KERNELS + ("mod_contract",) + FUSED_KERNELS
    if which == "cryptonets":
        records, _ = cryptonets_data(8192)
        pools = [records[:8192], records[8192:]]
        return ("CryptoNets", partial(cryptonets_mnist.build, batch_size=8192),
                pools, conv)
    if which == "caltech":
        recs = synthetic_feature_records(count, caltech101.N_FEATURES, seed=6)
        return ("Caltech-101", caltech101.build, [[r] for r in recs],
                BUTTERFLY_KERNELS + FUSED_KERNELS)
    if which == "cifar":
        return ("CIFAR", lola_cifar.build,
                [[r] for r in synthetic_cifar_records(count, seed=4)], conv)
    title, build = {"lola": ("LoLa", LM.build_lola_bsgs),
                    "lola_small": ("LoLaSmall", LM.build_lola_small),
                    "lola_dense": ("LoLaDense", LM.build_lola_dense),
                    "lola_packed": ("LoLaPacked", LM.build_lola),
                    "lola_large": ("LoLaLarge", LM.build_lola_large)}[which]
    return title, build, [[r] for r in synthetic_mnist_records(count, seed=11)], conv


def _copies(records) -> list:
    return [(lb, f.copy()) for lb, f in records]


def _oracle(which: str, build, pools) -> list:
    """The Raw oracle's output matrix ([dim, columns]) of every pool."""
    if which == "cryptonets":
        return cryptonets_data(8192)[1]
    head_r, _, reader_r = build(False, records=_copies(sum(pools, [])))
    head_r.prepare_network()
    return [np.asarray(head_r.get_next().decrypt(), dtype=float) for _ in pools]


# LoLaDense decrypts some records wrong, eagerly as under a graph: its
# plain primes near 2**35 leave 0-6 bits at the end (PERF.md's sweep), and
# the fourth record this phase runs (record 0 encrypted a second time)
# decrypts one unit off in the first plain prime's constant coefficient,
# whose noise crosses Delta / 2 in the last layer's complete slot sum: a
# finding about the configuration (ROADMAP.md §3,
# `scripts/torch_coeff_noise.py`).  On this path a record that disagrees
# with the Raw oracle is counted and reported; the graph is held bit-equal
# to the eager layers on its own input ciphertexts all the same
WRONG_AT_TIMES = ("lola_dense",)


def _gate(title: str, which: str, i: int, enc, raw) -> bool:
    """A record's decrypted outputs against the Raw oracle's at rtol 1e-9
    (CryptoNets, as its own phase: the first batch's logits, every
    batch's 8192 predictions): True when they agree.  On a path of
    WRONG_AT_TIMES a record that disagrees is logged and False; on any
    other path it fails the run."""
    if enc.shape != raw.shape or not np.all(np.isfinite(enc)):
        raise SystemExit(f"{title} record {i}: output {enc.shape} is malformed")
    close = bool(np.allclose(enc, raw, rtol=1e-9, atol=0))
    if not close and which in WRONG_AT_TIMES:
        log(f"{title} record {i}: decrypts to {enc.ravel()[:4]} against the "
            f"Raw oracle's {raw.ravel()[:4]} (ROADMAP.md §3)")
        return False
    if which == "cryptonets":
        wrong = int((np.argmax(enc, axis=1) != np.argmax(raw, axis=1)).sum())
        if wrong or (i % 2 == 0 and not close):
            raise SystemExit(f"{title} batch {i}: {wrong} predictions differ "
                             f"from the Raw oracle's, logits close: {close}")
    elif not close:
        raise SystemExit(f"{title} record {i}: encrypted outputs "
                         f"{enc.ravel()[:6]} disagree with the Raw oracle "
                         f"{raw.ravel()[:6]}")
    return True


def _profiled_ms(step) -> float | None:
    """Device busy ms of one `step()` (the sum of its kernels' device
    times, torch.profiler); None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 if busy > 0 else None


def graph_case(dev, which: str, shapes: LaunchShapes | None = None) -> dict:
    """One path eager and under `graph=True` (the whole record in one
    graph where the factory encodes and decodes on the card, else the
    layers), one head and key set: a warm-up and GRAPH_TIMED timed records
    of each form, every record against the Raw oracle and the two forms'
    decryptions equal; the graph's launches a record (replayed) equal to
    the eager record's; its outputs bit-equal to the eager layers on its
    own input ciphertexts (read from its static buffer after a replay);
    two replays of one record with different input ciphertexts and equal
    decoded slots; capture seconds, graph memory, device busy time and
    idle share of one profiled graph record, a record's parts; budget >
    0.  A whole-record graph's slot-map launch (on its static input) goes
    into `shapes` beside the eager record's, which the path's own phase
    records."""
    from cryptonets_tpu_torch.nn.forward import EncryptedForward

    title, build, pools, kernels = _graph_spec(which, 3)
    raws = _oracle(which, build, pools)
    head, fac, _ = build(True, records=_copies(pools[0]), device=dev)
    head.prepare_network()
    eager = EncryptedForward(head)
    graph = EncryptedForward(head, graph=True)
    fused = fac.encodes_on_device
    form = "the whole record" if fused else "the layers"

    def record(fwd, i):
        fwd.reader.set_source_records(_copies(pools[i % len(pools)]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fwd()
        enc = np.asarray(out.decrypt(), dtype=float)
        return out, enc, time.perf_counter() - t0

    lats, per, decs, limit = {}, {}, {}, {}
    for kind, fwd in (("eager", eager), ("graph", graph)):
        lats[kind], decs[kind], limit[kind] = [], [], 0
        torch.cuda.reset_peak_memory_stats()
        for i in range(1 + GRAPH_TIMED):
            before = kernel_counts()
            out, enc, s = record(fwd, i)
            launched = {k: v - before[k] for k, v in kernel_counts().items()}
            check_launches(f"{title} ({kind}) record {i}", launched, kernels,
                           MATMUL_KERNELS + (() if "mod_contract" in kernels
                                             else ("mod_contract",)))
            # a factory that encodes on the card makes a record's slot
            # buffers there, in the graph and eagerly alike
            want = int(fused)
            if launched["slot_map"] != want:
                raise SystemExit(f"{title} ({kind}) record {i}: {launched['slot_map']} "
                                 f"slot-map launches, {want} expected")
            exact = _gate(f"{title} ({kind})", which, i, enc, raws[i % len(raws)])
            limit[kind] += not exact
            decs[kind].append(enc if exact else None)
            if i:
                lats[kind].append(s)
                per[kind] = launched
            else:
                first = s
        peak = torch.cuda.max_memory_allocated() / 2**30
        if kind == "graph":
            peak_graph, first_graph = peak, first
        else:
            peak_eager = peak
    if per["graph"] != per["eager"]:
        raise SystemExit(f"{title}: launches a graph record {per['graph']} "
                         f"differ from an eager record's {per['eager']}")
    if any(a is not None and b is not None and not np.array_equal(a, b)
           for a, b in zip(decs["graph"], decs["eager"])):
        raise SystemExit(f"{title}: graph and eager decryptions differ")
    budget = min(v.noise_budget() for v in out.vectors)
    if budget <= 0:
        raise SystemExit(f"{title} (graph): the noise budget is exhausted")
    log(f"{title}: {1 + GRAPH_TIMED} eager and {1 + GRAPH_TIMED} graph records "
        f"exact, launches a record equal, slot maps {per['graph']['slot_map']}")

    (key, g), = graph.graphs().items()
    graph.reader.set_source_records(_copies(pools[0]))
    raw0 = graph.reader.get_next()
    if shapes is not None and fused:
        spec = slotmap_spec(g.inputs[0], fac._slot_positions, fac.plain_primes)
        shapes.fused.setdefault(_spec_key(spec), spec)
    if fused:
        datas, _, data = g.outputs
        outs, ins = [d.clone() for d in datas], data.clone()
        _, V, C, dim, scale = key
        cols = ins.reshape(fac.P, V, C, *ins.shape[2:]).unbind(1)
        ref = eager.run_encrypted(eager.input_matrix(list(cols), dim, scale))
        x0, _ = graph.slot_values(raw0)
        g.replay(x0)
        in1, s1 = g.outputs[2].clone(), g.outputs[1].clone()
        g.replay(x0)
        fresh = not torch.equal(in1, g.outputs[2])
        same = torch.equal(s1, g.outputs[1])
    else:
        m = eager.encrypt(raw0)
        outs = [v.data for v in graph.run_graph(m).vectors]
        ref = eager.run_encrypted(m)
        # encrypt runs outside the graph, a fresh draw a call: two records'
        # inputs differ; the graph holds no randomness to replay
        m2 = eager.encrypt(raw0)
        fresh, same = not torch.equal(m.vectors[0].data, m2.vectors[0].data), True
    if not all(torch.equal(a, v.data) for a, v in zip(outs, ref.vectors)):
        raise SystemExit(f"{title}: the graph's outputs differ from the eager "
                         f"layers' on the graph's own input ciphertexts")
    if not (fresh and same):
        raise SystemExit(f"{title}: two replays of one record drew the same "
                         f"randomness ({not fresh}) or decoded differently "
                         f"({not same})")
    busy = _profiled_ms(lambda: record(graph, 0))
    parts = _record_parts(eager, graph, raw0)
    med = {k: statistics.median(v) for k, v in lats.items()}
    idle = None if busy is None else max(0.0, 1 - busy / (1e3 * med["graph"]))
    res = dict(form=form, eager_s=lats["eager"], graph_s=lats["graph"],
               eager_median_s=med["eager"], graph_median_s=med["graph"],
               capture_s=g.capture_s, first_graph_record_s=first_graph,
               graph_pool_gib=g.pool_bytes / 2**30, peak_eager_gib=peak_eager,
               peak_graph_gib=peak_graph, busy_ms=busy, idle_share=idle,
               per_record=per["graph"], budget=budget, parts=parts,
               wrong_records=limit)
    log(f"{title} under a graph ({form}): capture {g.capture_s:.3f} s "
        f"(warm-up included; first record {first_graph:.4f} s), graph pool "
        f"{res['graph_pool_gib']:.3f} GiB, peak {peak_graph:.2f} GiB (eager "
        f"{peak_eager:.2f}); record latency median eager {med['eager']:.4f} s "
        f"{lats['eager']}, graph {med['graph']:.4f} s {lats['graph']} "
        f"({med['eager'] / med['graph']:.2f}x); device busy ms of one profiled "
        f"graph record {busy}, idle share against the unprofiled median "
        f"{idle}; launches a record {per['graph']} (equal to "
        f"eager's); every record equal to the Raw oracle and to eager; the "
        f"outputs bit-equal to the eager layers on the graph's own input "
        f"ciphertexts; two replays of one record: fresh input ciphertexts, "
        f"equal decoded slots; final budget {budget} bits; one record's parts "
        f"in ms, device synchronised between them: {parts}"
        + (f"; records that decrypted wrong (ROADMAP.md §3): {limit}"
           if any(limit.values()) else ""))
    graph.release()
    return res


def _record_parts(eager, graph, raw) -> dict:
    """Host-clock ms of one record's parts, the device synchronised
    between them: eager (encrypt with the slot encode, the layers, the
    decrypt with the decode and join) and under the graph (the values
    handed over, the copy in and the replay with the slot map, the
    decoded slots out and the join; a layers-only graph: encrypt, replay
    and decrypt, join)."""
    from cryptonets_tpu_torch.nn.forward import _split

    def ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, 1e3 * (time.perf_counter() - t0)

    out = {}
    m, out["eager encrypt"] = ms(lambda: eager.encrypt(raw))
    o, out["eager layers"] = ms(lambda: eager.run_encrypted(m))
    _, out["eager decrypt + join"] = ms(lambda: o.decrypt())
    if graph.factory.encodes_on_device:
        (key, g), = graph.graphs().items()
        b, out["graph slot buffers"] = ms(lambda: graph.slot_values(raw)[0])
        r, out["graph copy + replay"] = ms(lambda: g.replay(b))
        _, out["graph slots out + join"] = ms(lambda: graph._output_matrix(
            key, [d.clone() for d in r[0]],
            _split(r[1].cpu().numpy().astype(np.int64), [d.shape[1] for d in r[0]])).decrypt())
    else:
        m, out["graph encrypt"] = ms(lambda: graph.encrypt(raw))
        o, out["graph layers replay + decrypt"] = ms(lambda: graph.run_graph(m))
        _, out["graph join"] = ms(lambda: o.decrypt())
    return {k: round(v, 3) for k, v in out.items()}


def graph_phase(dev, shapes: LaunchShapes | None = None) -> dict:
    """Every path of GRAPH_PATHS eager and under a graph (`graph_case`),
    each path's graph and head freed before the next.  A graph launches
    the kernels at its eager record's shapes, which that path's own phase
    records, and the slot map, whose launches go into `shapes`."""
    reset_kernel_counts()
    out = {}
    for which in GRAPH_PATHS:
        t0 = time.perf_counter()
        out[which] = graph_case(dev, which, shapes)
        torch.cuda.empty_cache()
        log(f"graph {which}: {time.perf_counter() - t0:.1f} s")
    return dict(launches=kernel_counts(), per_record=out["lola"]["per_record"],
                paths=out)


def record_batch_phase(dev, shapes: LaunchShapes | None = None) -> dict:
    """LoLaSmall at B = 16 and Caltech-101 at B = 32 (`bench.py`'s
    BENCH_VMAP rows, README.md:32) as record batches under one graph: one
    capture, then a warm-up and GRAPH_TIMED timed batches of one replay
    each; every record against the Raw oracle, every record's outputs
    bit-equal to the eager layers on its input ciphertexts from the
    batch's static buffer; ms a record, launches a batch, peak and graph
    pool GiB."""
    from cryptonets_tpu_torch.nn.forward import EncryptedForward

    reset_kernel_counts()
    out = {}
    for which, B in BATCHES:
        t0 = time.perf_counter()
        title, build, pools, kernels = _graph_spec(which, B)
        raws = _oracle(which, build, pools)
        recs = sum(pools, [])
        head, fac, _ = build(True, records=_copies(recs), device=dev)
        head.prepare_network()
        graph, eager = EncryptedForward(head, graph=True), EncryptedForward(head)
        batch = list(iter(graph.reader.get_next, None))
        torch.cuda.reset_peak_memory_stats()
        lats, per = [], None
        for i in range(2 + GRAPH_TIMED):     # capture, warm-up, timed
            before = kernel_counts()
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            with (shapes if i == 0 and shapes else contextlib.nullcontext()):
                res = graph.run_batch(batch)
            encs = [np.asarray(r.decrypt(), dtype=float) for r in res]
            s = time.perf_counter() - s0
            launched = {k: v - before[k] for k, v in kernel_counts().items()}
            check_launches(f"{title} batch {i}", launched, kernels, MATMUL_KERNELS)
            if launched["slot_map"] != 1:
                raise SystemExit(f"{title} batch {i}: {launched['slot_map']} "
                                 f"slot-map launches, one a batch expected")
            for r, (enc, raw) in enumerate(zip(encs, raws)):
                _gate(f"{title} batch {i}", which, r, enc, raw)
            if i > 1:
                lats.append(s)
                per = launched
        peak = torch.cuda.max_memory_allocated() / 2**30
        (key, g), = graph.graphs().items()
        _, _, V, C, dim, scale = key
        outs, _, data = g.outputs
        for b in range(B):
            ref = eager.run_encrypted(eager.input_matrix(
                [data[b][:, i] for i in range(V)], dim, scale))
            if not all(torch.equal(o[b], v.data) for o, v in zip(outs, ref.vectors)):
                raise SystemExit(f"{title} batch: record {b}'s outputs differ "
                                 f"from the eager layers' on its inputs")
        budget = min(v.noise_budget() for r in res for v in r.vectors)
        if budget <= 0:
            raise SystemExit(f"{title} batch: the noise budget is exhausted")
        med = statistics.median(lats)
        out[which] = dict(B=B, batch_s=lats, median_s=med,
                          ms_per_record=1e3 * med / B, capture_s=g.capture_s,
                          per_batch=per, peak_gib=peak,
                          graph_pool_gib=g.pool_bytes / 2**30, budget=budget)
        log(f"{title} record batch B = {B} under one graph: capture "
            f"{g.capture_s:.3f} s, batch latency median {med:.4f} s {lats}, "
            f"{1e3 * med / B:.3f} ms a record; launches a batch {per}; peak "
            f"{peak:.2f} GiB, graph pool {g.pool_bytes / 2**30:.3f} GiB; every "
            f"record equal to the Raw oracle and bit-equal to the eager layers "
            f"on its inputs; least budget {budget} bits "
            f"({time.perf_counter() - t0:.1f} s)")
        graph.release()
        del head, fac, graph, eager, res, outs, data, g
        torch.cuda.empty_cache()
    return dict(launches=kernel_counts(), per_batch=out["lola_small"]["per_batch"],
                paths=out)


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
    from cryptonets_tpu_torch.kernels import bconv as K7
    from cryptonets_tpu_torch.kernels import build as B
    from cryptonets_tpu_torch.kernels import matmul_ntt as M
    from cryptonets_tpu_torch.kernels import modmac as K6
    from cryptonets_tpu_torch.kernels import modmatmul as MM
    from cryptonets_tpu_torch.kernels import ntt as K
    from cryptonets_tpu_torch.kernels import slotmap as SM
    from cryptonets_tpu_torch.runtime import hostcrypto

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    # the host runtime (c++) builds beside the six nvcc runs
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: (hostcrypto.build(), time.perf_counter() - t0))
        B.build_sources([B.source(name) for name in (
            "ntt.cu", "modmatmul.cu", "matmul_ntt.cu", "modmac.cu", "bconv.cu",
            "slotmap.cu")])
        host_lib, host_s = host.result()
    hostcrypto.get_lib()
    for kernel_module in (K, MM, M, K6, K7, SM):
        kernel_module.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s, the six sources "
        f"in parallel (nvcc {B.BUILD_SECONDS}); host runtime {host_lib.name} "
        f"({host_s:.2f} s)")
    kernels = []
    for phase, run in (("ntt", kernel_phase), ("lift", lift_phase),
                       ("mmntt", mmntt_phase),
                       ("contract", lambda d: [contract_phase(d)]),
                       ("fused", fused_phase), ("behz", behz_phase),
                       ("slotmap", slotmap_phase)):
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
             ("pipeline", pipeline_phase), ("bigt62", bigt62_phase),
             ("graph", graph_phase), ("record_batch", record_batch_phase))
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
            if k["name"] in SPEC_KERNELS:
                k["ratios"] = ratio_summary(k["launch_shapes"])
                log(f"{k['name']} device / bound over the launch shapes: "
                    + "; ".join(f"{g}: {r['cases']} cases, median {r['median']:.2f}x, "
                                f"max {r['max']:.2f}x" for g, r in k["ratios"].items()))
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
