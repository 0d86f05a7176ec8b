"""The benchmark of `halo2_tpu_torch` on one NVIDIA H100: steady proof time,
peak device memory and set-up time of a closed loop of proofs, per cell of
`BENCHMARK.json`, with per-layer metrics from a traced run and a plain
verifier that decides whether the proofs are correct.  See README.md."""
