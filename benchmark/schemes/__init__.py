"""Commitment schemes, one file each, found by a configuration's "scheme":
the program's parameters and prover classes for it, and the plain
reference's verifying key and verifier."""
