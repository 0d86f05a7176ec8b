from .base import Blind, PolyRef, ProverQuery, VerifierQuery, new_rng
from .gwc import ProverGWC, VerifierGWC
from .ipa import (MSMIPA, Accumulator, AccumulatorStrategyIPA, GuardIPA,
                  ParamsIPA, SingleStrategyIPA, create_opening_proof,
                  verify_opening_proof)
from .ipa_multiopen import ProverIPA, VerifierIPA
from .kzg import (AccumulatorStrategyKZG, DualMSM, GuardKZG, MSMKZG,
                  ParamsKZG, PreMSM, SingleStrategyKZG)
from .shplonk import ProverSHPLONK, VerifierSHPLONK

__all__ = [
    "Blind", "PolyRef", "ProverQuery", "VerifierQuery", "new_rng",
    "MSMIPA", "Accumulator", "AccumulatorStrategyIPA", "GuardIPA",
    "ParamsIPA", "SingleStrategyIPA", "create_opening_proof",
    "verify_opening_proof", "ProverIPA", "VerifierIPA",
    "AccumulatorStrategyKZG", "DualMSM", "GuardKZG", "MSMKZG", "ParamsKZG",
    "PreMSM", "SingleStrategyKZG", "ProverGWC", "VerifierGWC",
    "ProverSHPLONK", "VerifierSHPLONK",
]
