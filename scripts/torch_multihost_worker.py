"""One rank ("host") of the port's multi-process dry run, the counterpart
of `scripts/multihost_worker.py`: it joins a process group against a
localhost coordinator (`parallel.init_multihost`), builds the
{batch: ranks, limb: 1} mesh, encrypts ONLY its own slice of the record
batch, runs the tiny LoLa network (`parallel/dryrun.py`) on it, checks
its records' decrypted outputs exactly against the Raw oracle, and
assembles the global output batch by an all-gather.

    python scripts/torch_multihost_worker.py <process_id> <num_processes> <port>
        [--backend nccl|gloo] [--device cuda|cpu]

Start one per rank with the same port (rank 0 listens on it), or all of
them on this host with `--spawn N` in place of the three numbers.  The
defaults are the card and NCCL, one card a rank; ranks that share a card,
or run on the CPU, pass `--backend gloo`.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rank_main(device) -> str:
    """This rank's part: its records through the network, exact against
    the Raw oracle (a mismatch raises), the global outputs assembled."""
    import torch.distributed as dist

    from cryptonets_tpu_torch.parallel.dryrun import sharded_rank

    n = dist.get_world_size()
    res = sharded_rank(2 * n, None, device, n)
    start, stop = res["records"]
    if tuple(res["global_output"].shape[:1]) != (2 * n,):
        raise SystemExit(f"global batch {tuple(res['global_output'].shape)}")
    line = (f"MULTIHOST-OK p{dist.get_rank()}/{n}: mesh={{'batch': {n}, 'limb': 1}}, "
            f"records [{start}, {stop}) exact vs raw, global batch of {2 * n} "
            f"assembled")
    print(line, flush=True)
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ids", nargs="*", type=int,
                    help="process_id num_processes port")
    ap.add_argument("--spawn", type=int, help="start this many ranks here")
    ap.add_argument("--backend", default=None, help="nccl (default) or gloo")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    from cryptonets_tpu_torch.parallel.distributed import init_multihost, run_ranks

    if args.spawn:
        run_ranks(rank_main, args.spawn, args.device, backend=args.backend)
        return
    if len(args.ids) != 3:
        ap.error("give process_id num_processes port, or --spawn N")
    pid, n, port = args.ids
    init_multihost(f"127.0.0.1:{port}", n, pid, backend=args.backend)
    rank_main(args.device)


if __name__ == "__main__":
    main()
