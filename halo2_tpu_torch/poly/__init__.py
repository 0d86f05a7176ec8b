from .poly import COEFF, EXTENDED, LAGRANGE, Poly, take, unwrap
from .domain import EvaluationDomain, Rotation
from .arith import (eval_polynomial_int, eval_polys_at_points,
                    kate_division, lagrange_interpolate_int, prefix_product,
                    tree_sum)

__all__ = [
    "COEFF", "EXTENDED", "LAGRANGE", "Poly", "take", "unwrap",
    "EvaluationDomain", "Rotation",
    "eval_polynomial_int", "eval_polys_at_points",
    "kate_division", "lagrange_interpolate_int", "prefix_product",
    "tree_sum",
]
