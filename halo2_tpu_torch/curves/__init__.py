from .curve import Curve
from .constants import BN254_G1

__all__ = ["Curve", "BN254_G1"]
