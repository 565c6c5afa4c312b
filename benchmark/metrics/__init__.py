"""Per-layer readers: one file a metric, named as in BENCHMARK.json."""
