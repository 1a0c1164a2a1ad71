"""Cross-cutting utilities: operation counters, debug printing, the
per-operation noise-budget harness."""
