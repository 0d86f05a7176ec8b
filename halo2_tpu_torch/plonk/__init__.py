from .keygen import (ConstraintSystemBack, PermutationAssembly, ProvingKey,
                     VerifyingKey, keygen, keygen_vk)
from .prover import Evaluator, Prover
from .verifier import VerifyError, verify_proof, verify_proof_single
from .evaluation import evaluate_expression
from .batch import BatchVerifier

__all__ = [
    "ConstraintSystemBack", "PermutationAssembly", "ProvingKey",
    "VerifyingKey", "keygen", "keygen_vk", "Evaluator", "Prover",
    "verify_proof", "verify_proof_single", "VerifyError",
    "evaluate_expression", "BatchVerifier",
]
