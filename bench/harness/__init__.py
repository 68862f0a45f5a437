"""The benchmark's general code: the manifest, the traffic generator,
the weights made from the seed, the serving and training windows, the
trace reduction and the result line. Nothing here names a
configuration, a traffic mix or a per-layer metric: those are files
found by the names in ``BENCHMARK.json``."""
