"""The argument (plonk/prover.py): lookup permutation T5-6, grand products
T9-11 and the vanishing argument's random polynomial T12, seconds a
proof."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["lookup_permute [T5-6]", "grand_products [T9-11]",
                       "vanishing_random [T12]"])
