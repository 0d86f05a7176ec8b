from .field import Field, NWORDS
from .constants import BN254_FR, BN254_FQ

__all__ = ["Field", "NWORDS", "BN254_FR", "BN254_FQ"]
