"""The benchmark of cocircom_tpu_torch: one cell a run, driven by BENCHMARK.json."""
