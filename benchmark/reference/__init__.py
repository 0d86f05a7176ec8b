"""The plain reference that decides `correct`: a halo2 verifier written on
python ints and `hashlib`, independent of the prover under test.  It
imports nothing of the program (neither the PyTorch port nor the JAX
package) and works out the verifying key again from the configuration's
plain data and the parameters' seed."""
