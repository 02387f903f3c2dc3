"""The benchmark of resselt_tpu_torch on an NVIDIA H100: one cell a run,
driven by BENCHMARK.json and the files it names (see README.md)."""
