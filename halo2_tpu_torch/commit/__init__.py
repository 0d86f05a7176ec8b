from .base import Blind, PolyRef, ProverQuery, VerifierQuery, new_rng
from .ipa import (MSMIPA, AccumulatorStrategyIPA, GuardIPA, ParamsIPA,
                  SingleStrategyIPA)
from .ipa_multiopen import ProverIPA, VerifierIPA
from .kzg import (DualMSM, GuardKZG, MSMKZG, ParamsKZG, PreMSM,
                  SingleStrategyKZG)
from .shplonk import ProverSHPLONK, VerifierSHPLONK

__all__ = [
    "Blind", "PolyRef", "ProverQuery", "VerifierQuery", "new_rng",
    "MSMIPA", "AccumulatorStrategyIPA", "GuardIPA", "ParamsIPA",
    "SingleStrategyIPA", "ProverIPA", "VerifierIPA",
    "DualMSM", "GuardKZG", "MSMKZG", "ParamsKZG", "PreMSM",
    "SingleStrategyKZG", "ProverSHPLONK", "VerifierSHPLONK",
]
