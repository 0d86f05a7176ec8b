"""Per-layer metrics, one reader a file, found by the metric's name in
`BENCHMARK.json`.  Each module has `read(r)`, where `r` is the traced run's
`harness.Readings`; it returns the metric's value, or None where it finds
nothing to read (the harness then leaves the metric out)."""
