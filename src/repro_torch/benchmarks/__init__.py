"""The port's benchmark suites: counterparts of the JAX package's
``benchmarks/`` that report through ``telemetry.Ledger``."""
