"""One run of one benchmark cell on the card.

    python3 -m hebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`cryptonets_tpu_torch`).
Set-up (timed as `setup_s`, from this module's start): torch, the
images of the cell's traffic from the seed, the weights file, the port's
builder (keygen on the card, the layers prepared, the kernels loaded or
built into the port's build directory inside the checkout) and one
warm-up request, which captures the CUDA graph and replays it.  Then one
client in a closed loop for `--seconds`: each request hands the program
its images and waits for the decoded logits on the host.  With `--trace
1`, a few more requests run under `torch.profiler` after the window (the
mix's `trace_requests`) and the cell's per-layer metrics are read from
them; without, its end-to-end metrics.  Once the window has closed the
served logits are held against the plain reference.  The last line of
standard output is the result as one JSON object; the compared numbers
and their limits are also the last lines of standard error.

No CUDA device, too few devices, a missing port, JAX (or the JAX
package) loaded in this process once the comparison and the metric
readers have run, or a traced run that could not read a per-layer metric
its cell lists: an exit code other than 0 and no result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import check, spec  # noqa: E402
from .generate import Plan  # noqa: E402
from .work.record import FAMILIES  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cryptonets_tpu")


def fail(msg: str, code: int = 2):
    print(f"hebench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names (`cryptonets_tpu_torch` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_weights(config: dict) -> dict:
    path = spec.ROOT / config["weights"]["file"]
    if not path.exists():
        fail(f"the weights file {config['weights']['file']} is missing")
    with np.load(path) as z:
        return {k: np.asarray(z[k], dtype=np.float64) for k in z.files}


def window(program, plan, seconds: float, served: list) -> list:
    """The closed loop: requests until `seconds` have passed; returns
    [(start, end, images)] on the window's clock, and appends (request
    index, logits) to `served`."""
    times = []
    t0 = time.perf_counter()
    r = len(served)
    while time.perf_counter() - t0 < seconds:
        idx = plan.indices(r)
        a = time.perf_counter()
        logits = program.serve(plan.pixels, idx)
        b = time.perf_counter()
        times.append((a - t0, b - t0, len(idx)))
        served.append((r, logits))
        r += 1
    return times


def traced(program, plan, count: int, served: list) -> dict:
    """`count` requests under the profiler after the window: the trace's
    reduction (`trace.reduce`) and the port's counters over them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace

    before = program.counters()
    r = len(served)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.SPAN):
            for i in range(count):
                served.append((r + i, program.serve(plan.pixels, plan.indices(r + i))))
            torch.cuda.synchronize()
    after = program.counters()
    red = trace.reduce(trace.events(prof), {f: v[1] for f, v in FAMILIES.items()})
    red["counters"] = {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}
    red["requests"] = count
    red["images"] = count * plan.per_request
    return red


class Card:
    """The card's side of a run: synchronise, peak memory, what it is."""

    def __init__(self, chips: int):
        import torch

        self.torch, self.chips = torch, chips

    def sync(self) -> None:
        self.torch.cuda.synchronize()

    def peak(self) -> int:
        """Peak device memory the process held from the card since the
        last reset: the caching allocator's reserved bytes, which count a
        CUDA graph's private pool whole (its allocated bytes count only
        the tensors alive outside replays)."""
        return int(self.torch.cuda.max_memory_reserved())

    def trim(self) -> None:
        """Return the cached blocks that set-up freed (keygen's
        temporaries) to the card; a graph's pool stays."""
        self.torch.cuda.empty_cache()

    def reset_peak(self) -> None:
        self.torch.cuda.reset_peak_memory_stats()

    def describe(self) -> dict:
        return dict(platform="gpu", kind=self.torch.cuda.get_device_name(0),
                    count=self.chips)


def measure(args, bench: dict, cell: dict, config: dict, mix: dict, weights: dict,
            plan, program, card) -> dict:
    """Set-up's warm-up, the window, the traced sub-window (`args.trace`),
    the comparison, the metrics and the import check; prints the compared
    numbers and the result line, and returns the result."""
    served = []
    # set-up's freed blocks (keygen's temporaries) go back to the card before
    # the warm-up, so that the window's first request finds the blocks it
    # reuses already cached
    card.trim()
    program.serve(plan.pixels, plan.indices(-1))    # captures the graph, replays it
    card.sync()
    setup_peak = card.peak()
    setup_s = time.perf_counter() - START
    card.reset_peak()

    times = window(program, plan, args.seconds, served)
    window_peak = card.peak()
    sub = traced(program, plan, mix["trace_requests"], served) if args.trace else None
    scale = program.scale
    device = dict(card.describe(), memory_peak_bytes=max(setup_peak, window_peak, card.peak()))
    if sub is not None:
        device.update(busy_s=sub["busy_s"], window_s=sub["span_s"])
    del program
    gc.collect()
    card.trim()

    verdict = check.compare(served, scale, plan, mix, config, weights)
    rec = dict(cell=cell["name"], setup_s=setup_s, times=times,
               window_s=times[-1][1], images=sum(t[2] for t in times),
               window_peak_bytes=window_peak, trace=sub,
               frozen=spec.frozen(cell["name"]))
    metrics, missing = {}, []
    for m in spec.metrics_of(bench, cell["name"], bool(args.trace)):
        value = spec.reader(m["name"])(rec)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    # last, once the comparison and every reader (files found by name)
    # have loaded what they load
    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or of the JAX package are loaded: {bad}", 3)
    if missing:
        fail(f"{cell['name']} lists metrics that this run could not read: {missing}"
             + ("" if rec["frozen"] else f" (no frozen work in work/{cell['name']}.json)"), 4)
    checks = verdict["checks"]
    out = dict(correct=all(c["value"] <= c["limit"] for c in checks.values()),
               attempted=len(served), failed=0, metrics=metrics, device=device)
    if sub is not None:
        out["breakdown"] = sub["breakdown"]
    out["checks"] = checks
    lat = np.array([b - a for a, b, _ in times]) * 1e3
    print(f"hebench: {cell['name']} seed {args.seed}: {len(times)} requests in "
          f"{rec['window_s']:.3f} s, latency ms p50 {np.median(lat):.3f} p95 "
          f"{np.percentile(lat, 95):.3f} max {lat.max():.3f}, the first three "
          f"{np.round(lat[:3], 3).tolist()}; set-up {setup_s:.3f} s", file=sys.stderr)
    print(f"hebench: {cell['name']} seed {args.seed}: {verdict['compared']} "
          f"logits of {len(served)} requests compared", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark measures the port on the card "
             "and never falls back to the CPU")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} CUDA devices, "
             f"{torch.cuda.device_count()} found")
    try:
        from .program import Program
        import cryptonets_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        fail(f"the port is not in this checkout: {e}")

    weights = load_weights(config)
    plan = Plan(mix, args.seed)
    # no reference kept here: `measure` frees the program before the check
    measure(args, bench, cell, config, mix, weights, plan,
            Program(config, weights, plan.key_seed), Card(cell["chips"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
