"""BN254 G1 (halo2curves bn256): y^2 = x^3 + 3, generator (1, 2)."""

from ..fields import BN254_FQ, BN254_FR
from .curve import Curve

BN254_G1 = Curve("bn254::G1", Fq=BN254_FQ, Fr=BN254_FR, b=3, gen_xy=(1, 2))
