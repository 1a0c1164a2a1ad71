"""Global HE operation counters (ref OperationsCount,
`AtomicSealBfvVector.cs:211-294`), port of `cryptonets_tpu/utils/
opcount.py`.

`OPS.count(name, n)` is called where an operation runs, with the
reference's names and counts.  An eager run counts every executed
operation; a CUDA graph's counts are taken at capture and added at each
replay (`nn/forward.py` `RecordGraph`), as the reference replays its
trace-time counts."""

from __future__ import annotations

from collections import Counter


class OperationsCount:
    def __init__(self):
        self.counters = Counter()

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def snapshot(self) -> dict:
        """The counts as they are, copied."""
        return dict(self.counters)

    def reset(self) -> dict:
        """Clear the counts; returns them as they were."""
        snap = dict(self.counters)
        self.counters.clear()
        return snap

    def print(self, header: str = ""):
        if header:
            print(header)
        for k in sorted(self.counters):
            print(f"  {k:24s} {self.counters[k]}")


OPS = OperationsCount()
