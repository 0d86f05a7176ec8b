"""Field instances (the JAX reference's fields/constants.py): BN254 Fr / Fq
and the Pasta fields Fp (Pallas base, Vesta scalar) / Fq (Vesta base,
Pallas scalar).

ZETA values are the reference's pinned cube roots of unity (they fix the
extended-domain coset generator, so both packages must agree).  kernel_id is
the field's id in the CUDA sources (csrc/arith.cuh, with_field)."""

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

PASTA_FP = Field(
    "pasta::Fp",
    0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001,
    5,
    zeta=0x12CCCA834ACDBA712CAAD5DC57AAB1B01D1F8BD237AD31491DAD5EBDFDFE4AB9,
    kernel_id=2,
)

PASTA_FQ = Field(
    "pasta::Fq",
    0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001,
    5,
    zeta=0x06819A58283E528E511DB4D81CF70F5A0FED467D47C033AF2AA9D2E050AA0E4F,
    kernel_id=3,
)
