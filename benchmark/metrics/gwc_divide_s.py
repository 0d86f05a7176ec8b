"""GWC's opening on the prover (commit/gwc.py): the v-fold of the
polynomials at each point and the Kate division by (X - z), the
`gwc_fold` and `gwc_divide` parts of `multiopen [T24+]`, seconds a
proof."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["gwc_fold [T24+]", "gwc_divide [T24+]"])
