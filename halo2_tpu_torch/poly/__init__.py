from .poly import COEFF, EXTENDED, LAGRANGE, Poly, take, unwrap
from .domain import EvaluationDomain, Rotation
from .arith import (compute_inner_product, eval_polynomial,
                    eval_polynomial_int, eval_polys_at_points, kate_division,
                    lagrange_interpolate_int, prefix_product, tree_sum)

__all__ = [
    "COEFF", "EXTENDED", "LAGRANGE", "Poly", "take", "unwrap",
    "EvaluationDomain", "Rotation",
    "compute_inner_product", "eval_polynomial", "eval_polynomial_int",
    "eval_polys_at_points", "kate_division", "lagrange_interpolate_int",
    "prefix_product", "tree_sum",
]
