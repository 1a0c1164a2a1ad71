"""CryptoTracker: the noise-budget watchdog (ref `HE Wrapper/
CryptoTracker.cs`), port of `cryptonets_tpu/api/tracker.py`.

Probes the invariant noise budget of live ciphertexts, records the least
seen, warns on a new least, and raises when the budget reaches zero (the
reference's DEBUG-mode behaviour, `CryptoTracker.cs:42-52`).  A factory
without the secret key cannot probe: the budget is then None."""

from __future__ import annotations


class BudgetExhausted(RuntimeError):
    pass


class CryptoTracker:
    min_budget_so_far: int | None = None
    enabled = True

    @classmethod
    def reset(cls):
        cls.min_budget_so_far = None

    @classmethod
    def test_vector_budget(cls, vec, warn: bool = True) -> int | None:
        """The least budget over the plain primes and blocks of an
        encrypted HEVector."""
        if not cls.enabled or not getattr(vec, "is_encrypted", False):
            return None
        if not vec.factory.has_secret_key:
            return None
        worst = vec.noise_budget()
        if cls.min_budget_so_far is None or worst < cls.min_budget_so_far:
            cls.min_budget_so_far = worst
            if warn:
                print(f"Warning: noise budget decreased to {worst} bits")
        if worst <= 0:
            raise BudgetExhausted("noise budget exhausted (0 bits)")
        return worst


def test_budget(matrix, factory) -> int | None:
    """Budget of column 0 of a layer output (ref `BaseLayer.cs:38`)."""
    col = None
    if hasattr(matrix, "vectors"):
        col = matrix.vectors[0]
    elif hasattr(matrix, "is_encrypted"):
        col = matrix
    if col is None or not getattr(col, "is_encrypted", False):
        return None
    return CryptoTracker.test_vector_budget(col)
