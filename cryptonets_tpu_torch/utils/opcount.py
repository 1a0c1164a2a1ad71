"""Global HE operation counters (ref OperationsCount,
`AtomicSealBfvVector.cs:211-294`), port of `cryptonets_tpu/utils/
opcount.py`.

`OPS.count(name, n)` is called where an operation runs, with the
reference's names and counts.  The port runs eagerly, so every call
counts an executed operation; there is no trace to replay."""

from __future__ import annotations

from collections import Counter


class OperationsCount:
    def __init__(self):
        self.counters = Counter()

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

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
