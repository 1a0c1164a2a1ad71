"""Where a record's time goes in the PyTorch/CUDA port, on one GPU.

    python3 scripts/torch_lola_breakdown.py
        [--network LoLa|LoLaPacked|LoLaLarge|LoLaDense|CIFAR|CryptoNets|
                   LoLaSmall|Caltech]
        [--ntt butterfly|matmul] [--preset NAME]
        [--records 5] [--seed 11] [--batch 8192]

Builds the full-width network on the card (LoLa: `build_lola_bsgs`, one
image per record; LoLaPacked: `build_lola`, the reference packing;
CryptoNets: `cryptonets_mnist.build`, `--batch` images per record;
LoLaSmall: `build_lola_small`; all four n = 8192 on real weights;
LoLaLarge: `build_lola_large`, n = 16384, seeded synthetic weights;
LoLaDense: `build_lola_dense`, n = 16384, real weights, plain primes near
2**35, so the slot encode runs on the host (C++ NTT) and the decrypt is
the two-plane device decrypt, then the host join and C++ decode, each
timed as its own stage; CIFAR: `lola_cifar.build`, n = 16384, seeded
stand-in weights and synthetic CIFAR records of seed 4; Caltech: `caltech101.build`, n = 4096, one feature vector per
record, seeded synthetic parameters and records of seed 6) under the
NTT `--ntt` names and, for LoLaLarge, CIFAR and CryptoNets, the preset
`--preset` names (`lola_large_bigt`, `cifar_bigt`, `cryptonets_bigt`:
the reference's plain primes of 2**31 and above) and serves records as
the model command lines do (`evaluation_forward`: one CUDA graph replay a
record) with the port's tracing on (`utils/trace.py`, no profiler): the
stages' host ms from the spans (reader, slot buffers or the host's slot
encode, upload, replay, output, the host's slot decode, join; `record`
around them) and the layers' device ms from the device ranges inside the
graph (encrypt, each layer, decrypt + decode; inside each BSGS dense
layer its `babies` and `giants` ranges, summed over the BSGS layers),
each the median over the records, and what `trace.per_request` reads of
the table over them (graph replays and nodes a record, and the graphs
captured among them, which must be 0: one is a rebuild), and the BSGS
counts a record (`OPS`: diagonal forms encoded, chained and hoisted
baby steps).  A network whose graph holds the
layers only (the host encodes)
has encrypt and decrypt outside it, so they read no device ms; one whose
pool does not fit runs eagerly and reads none.  Prints them and the peak
device memory the records held (`max_memory_reserved`, the graph's pool
whole), then profiles one more record with torch.profiler:
device busy time (sum of kernel times), the device's idle share of the
record's wall time (profiled and unprofiled), the kernel launch count,
the launches of the hand-written kernels, the device time of the
butterfly NTT kernels, of the four-step NTT kernels, of the
contraction, of the multiply-accumulate (K6), of the base conversion
(K7) and of the slot map, and the kernels that take the most device
time.  A profiled window with no device records is reported as empty
and the record profiled again (up to `ATTEMPTS` windows; then the script
fails): an empty window is never read as 0 busy ms.  Writes the same JSON to
chiprun_out/torch_<network>[_<preset>][_matmul]_breakdown.json.  Fails
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROFILER_EMPTY = "the profiler recorded no device time"
ATTEMPTS = 3    # profiled windows of one record before the script fails


def traced_record(fwd, trace):
    """One record served with tracing on, decrypted: ({span: host ms},
    {range: device ms}, {kind: device ms}) of it."""
    before = trace.snapshot()
    for v in fwd().vectors:
        v.decrypt_full_precision()
    d = {k: v - before.get(k, 0) for k, v in trace.snapshot().items()
         if v != before.get(k, 0)}

    def part(prefix):
        return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}

    return part("span_ms."), part("range_ms."), part("device_ms.")


def profiled_record(fwd, sync, counts):
    """One record under torch.profiler: (wall seconds, [(kernel, device
    ms, launches)] by device time, the hand kernels' launches, the window
    it took), or None when every one of `ATTEMPTS` windows held no device
    record.  An empty window is reported and taken again."""
    from torch.profiler import ProfilerActivity, profile

    for window in range(1, ATTEMPTS + 1):
        sync()
        before = counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for v in fwd().vectors:
                v.decrypt_full_precision()
            sync()
            wall = time.perf_counter() - t0
        hand = {k: v - before[k] for k, v in counts().items()}
        kernels = sorted(
            ((e.key, e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0),
            key=lambda x: -x[1])
        if kernels:
            return wall, kernels, hand, window
        print(f"torch_lola_breakdown: {PROFILER_EMPTY} in window {window} of "
              f"{ATTEMPTS}: the window is empty, not 0 busy ms; profiling "
              f"another record", file=sys.stderr)
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="LoLa",
                    choices=("LoLa", "LoLaPacked", "LoLaLarge", "LoLaDense",
                             "CIFAR", "CryptoNets", "LoLaSmall", "Caltech"))
    ap.add_argument("--ntt", choices=("butterfly", "matmul"), default="butterfly",
                    help="NTT of the ciphertext chain")
    ap.add_argument("--records", type=int, default=5,
                    help="timed records (CryptoNets: batches) after one warm-up")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--batch", type=int, default=8192,
                    help="images per CryptoNets batch")
    ap.add_argument("--preset", default=None,
                    help="the preset of LoLaLarge, CIFAR or CryptoNets "
                         "(default: the builder's own)")
    args = ap.parse_args()
    if args.preset is not None and args.network not in (
            "LoLaLarge", "CIFAR", "CryptoNets"):
        ap.error("--preset goes with LoLaLarge, CIFAR or CryptoNets")
    if not torch.cuda.is_available():
        print("torch_lola_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    from cryptonets_tpu_torch.data.preprocess import (
        synthetic_cifar_records, synthetic_feature_records,
        synthetic_mnist_records)
    from cryptonets_tpu_torch.kernels import bconv as K7
    from cryptonets_tpu_torch.kernels import matmul_ntt as M
    from cryptonets_tpu_torch.kernels import modmac as K6
    from cryptonets_tpu_torch.kernels import modmatmul as MM
    from cryptonets_tpu_torch.kernels import ntt as K
    from cryptonets_tpu_torch.kernels import slotmap as SM
    from cryptonets_tpu_torch.models import caltech101, cryptonets_mnist, lola_cifar
    from cryptonets_tpu_torch.models.lola_mnist import BUILDERS
    from cryptonets_tpu_torch.nn.forward import evaluation_forward
    from cryptonets_tpu_torch.utils import trace
    from cryptonets_tpu_torch.utils.opcount import OPS

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    preset = {} if args.preset is None else {"preset": args.preset}
    per_record = args.batch if args.network == "CryptoNets" else 1
    count = (args.records + 2) * per_record
    if args.network == "Caltech":
        records = synthetic_feature_records(count, caltech101.N_FEATURES, seed=6)
        head, fac, _ = caltech101.build(True, records=records, device=dev,
                                        ntt_impl=args.ntt)
    elif args.network == "CIFAR":
        records = synthetic_cifar_records(count, seed=4)
        head, fac, _ = lola_cifar.build(True, records=records, device=dev,
                                        ntt_impl=args.ntt, **preset)
    else:
        records = synthetic_mnist_records(count, seed=args.seed)
    if args.network == "CryptoNets":
        head, fac, _ = cryptonets_mnist.build(True, args.batch, records=records,
                                              device=dev, ntt_impl=args.ntt,
                                              **preset)
    elif args.network not in ("Caltech", "CIFAR"):
        head, fac, _ = BUILDERS[args.network](True, records=records, device=dev,
                                              ntt_impl=args.ntt, **preset)
    head.prepare_network()
    fwd = evaluation_forward(head, graph=True)
    for v in fwd().vectors:   # warm-up: lazy forms and tables, the capture
        v.decrypt_full_precision()
    sync()
    torch.cuda.reset_peak_memory_stats()
    trace.enable()
    try:
        before, ops = trace.snapshot(), OPS.snapshot()
        runs = [traced_record(fwd, trace) for _ in range(args.records)]
        read = trace.per_request(
            {k: v - before.get(k, 0) for k, v in trace.snapshot().items()},
            args.records, args.records * per_record)
        bsgs = {k: (v - ops.get(k, 0)) / args.records
                for k, v in OPS.snapshot().items()
                if k in ("bsgs_diagonal_form", "baby_rotation_chained",
                         "baby_rotation_hoisted")}
    finally:
        trace.enable(False)
    if read["graph_captures"]:
        print(f"torch_lola_breakdown: {read['graph_captures']} graph captures "
              f"in the timed records: a rebuild", file=sys.stderr)
    peak = torch.cuda.max_memory_reserved() / 2**30

    def median(i):
        return {k: statistics.median(r[i].get(k, 0.0) for r in runs)
                for k in runs[0][i]}

    stages, layers, kinds = median(0), median(1), median(2)
    total = [r[0]["record"] / 1e3 + r[0].get("join", 0.0) / 1e3 for r in runs]

    tables = (K.LAUNCHES, MM.LAUNCHES, M.LAUNCHES, K6.LAUNCHES, K7.LAUNCHES,
              SM.LAUNCHES)
    profiled = profiled_record(
        fwd, sync, lambda: {k: v for t in tables for k, v in t.items()})
    if profiled is None:
        print(f"torch_lola_breakdown: {PROFILER_EMPTY} in {ATTEMPTS} windows",
              file=sys.stderr)
        return 1
    wall, kernels, hand, window = profiled
    g = next(iter(fwd.graphs().values()), None)
    busy_ms = sum(k[1] for k in kernels)
    result = {
        "card": torch.cuda.get_device_name(0),
        "network": args.network,
        "preset": args.preset,
        "ntt_impl": fac.ntt_impl,
        "images_per_record": per_record,
        "records": args.records,
        "record_s_median": statistics.median(total),
        "graph_nodes": dict(g.nodes) if g is not None else None,
        "stage_host_ms_median": stages,
        "layer_device_ms_median": layers,
        "kind_device_ms_median": kinds,
        "read": read,
        "bsgs_ops_per_record": bsgs,
        "profiled_record_wall_ms": 1e3 * wall,
        "profiled_window": window,
        "device_busy_ms": busy_ms,
        # the profiler slows the host, so the idle share is given against
        # both the profiled wall time and the unprofiled median record
        "device_idle_share_profiled": max(0.0, 1 - busy_ms / (1e3 * wall)),
        "device_idle_share_unprofiled": max(
            0.0, 1 - busy_ms / (1e3 * statistics.median(total))),
        "kernel_launches": sum(k[2] for k in kernels),
        "hand_kernel_launches": hand,
        # device ms of the butterfly NTT kernels (K1, K2) in the record
        "butterfly_ntt_device_ms": {
            name: sum(k[1] for k in kernels if f"{name}_kernel" in k[0])
            for name in ("ntt_forward", "ntt_inverse")},
        # device ms of the exact modular contraction (K4) in the record
        "mod_contract_device_ms": sum(
            k[1] for k in kernels if "mod_contract_kernel" in k[0]),
        # device ms of the four-step NTT kernels (K5) in the record
        "matmul_ntt_device_ms": sum(
            k[1] for k in kernels if "matmul_ntt_kernel" in k[0]),
        # device ms of the multiply-accumulate (K6) and the base
        # conversion (K7) in the record
        "mod_mac_device_ms": sum(k[1] for k in kernels if "mod_mac_kernel" in k[0]),
        "fast_bconv_device_ms": sum(
            k[1] for k in kernels if "fast_bconv_kernel" in k[0]),
        # device ms of the slot map (the fused record's slot buffers)
        "slot_map_device_ms": sum(
            k[1] for k in kernels if "slot_map_kernel" in k[0]),
        "top_kernels_ms": [
            {"name": k[0][:80], "ms": k[1], "count": k[2]} for k in kernels[:12]
        ],
        "peak_mem_gib": peak,
    }
    for k, v in stages.items():
        print(f"host   {k:32s} {v:10.3f} ms")
    for k, v in layers.items():
        print(f"device {k:32s} {v:10.3f} ms")
    print(f"BSGS a record: babies {kinds.get('babies', 0.0):.3f} ms, giants "
          f"{kinds.get('giants', 0.0):.3f} ms (device), "
          + ", ".join(f"{k} {v:.0f}" for k, v in sorted(bsgs.items())))
    print(f"slots encoded an image: host {read['host_encoded_slots_per_image']:.0f}, "
          f"device {read['device_encoded_slots_per_image']:.0f}")
    print(f"peak {peak:.2f} GiB reserved")
    print(json.dumps(result))
    os.makedirs("chiprun_out", exist_ok=True)
    suffix = (f"_{args.preset}" if args.preset else "") + (
        "_matmul" if fac.ntt_impl == "matmul" else "")
    name = f"torch_{args.network.lower()}{suffix}_breakdown.json"
    with open(os.path.join("chiprun_out", name), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
