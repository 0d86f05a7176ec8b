"""Curve instances (the JAX reference's curves/constants.py).

- BN254 G1 (halo2curves bn256): y^2 = x^3 + 3, generator (1, 2).
- Pallas / Vesta (pasta_curves): y^2 = x^3 + 5, generator (-1, 2).
  halo2's `EqAffine` is Vesta (scalar field Fp), the IPA test curve.

kernel_id is the curve's id in the CUDA sources (csrc/arith.cuh,
with_curve)."""

from ..fields import BN254_FQ, BN254_FR, PASTA_FP, PASTA_FQ
from .curve import Curve

BN254_G1 = Curve("bn254::G1", Fq=BN254_FQ, Fr=BN254_FR, b=3, gen_xy=(1, 2),
                 kernel_id=0)

PALLAS = Curve("pasta::Pallas", Fq=PASTA_FP, Fr=PASTA_FQ, b=5,
               gen_xy=(PASTA_FP.p - 1, 2), kernel_id=1)

VESTA = Curve("pasta::Vesta", Fq=PASTA_FQ, Fr=PASTA_FP, b=5,
              gen_xy=(PASTA_FQ.p - 1, 2), kernel_id=2)
