"""Circuits of the benchmark's configurations, one folder each: `plain.py`
(the witness rule, the fixed columns and the copies as plain data, which
the reference reads; it imports nothing of the program) and `program.py`
(the same circuit on the port's public frontend API, which the prover
runs)."""
