"""The benchmark of hipims_tpu_torch: see BENCHMARK.json and PERF.md."""
