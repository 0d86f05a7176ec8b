from .base import Blind, PolyRef, ProverQuery, VerifierQuery, new_rng
from .kzg import (DualMSM, GuardKZG, MSMKZG, ParamsKZG, PreMSM,
                  SingleStrategyKZG)
from .shplonk import ProverSHPLONK, VerifierSHPLONK

__all__ = [
    "Blind", "PolyRef", "ProverQuery", "VerifierQuery", "new_rng",
    "DualMSM", "GuardKZG", "MSMKZG", "ParamsKZG", "PreMSM",
    "SingleStrategyKZG", "ProverSHPLONK", "VerifierSHPLONK",
]
