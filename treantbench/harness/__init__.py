"""The benchmark's general code: it finds a cell's configuration, traffic
mix and metric readers by the names in ``BENCHMARK.json`` and runs them."""
