"""BN254 field instances (the reference's fields/constants.py, BN254 only).

ZETA values are the reference's pinned cube roots of unity (they fix the
extended-domain coset generator, so both packages must agree)."""

from .field import Field

BN254_FR = Field(
    "bn254::Fr",
    0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
    7,
    zeta=0x30644E72E131A029048B6E193FD84104CC37A73FEC2BC5E9B8CA0B2D36636F23,
    kernel_id=0,
)

BN254_FQ = Field(
    "bn254::Fq",
    0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
    3,
    zeta=0x30644E72E131A0295E6DD9E7E0ACCCB0C28F069FBB966E3DE4BD44E5607CFD48,
    kernel_id=1,
)
