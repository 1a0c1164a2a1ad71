"""The benchmark of the PyTorch and CUDA port (`cryptonets_tpu_torch`):
`python3 -m hebench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`.  The cells and metrics are listed in `BENCHMARK.json`;
each configuration, traffic mix, metric reader and frozen work is a file
of its own here (`spec.py`)."""
