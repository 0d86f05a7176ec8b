from .keygen import (ConstraintSystemBack, PermutationAssembly, ProvingKey,
                     VerifyingKey, keygen)
from .prover import Evaluator, Prover
from .verifier import verify_proof

__all__ = [
    "ConstraintSystemBack", "PermutationAssembly", "ProvingKey",
    "VerifyingKey", "keygen", "Evaluator", "Prover",
    "verify_proof",
]
