"""The witness's encoding for the device (the prover's commit_phase): the
reduction of every value mod p with the blinding draws, the encode into
Montgomery words, and the write into the advice columns: the `blind`,
`encode` and `set` parts of step T3-4, seconds a proof."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["blind [T3-4]", "encode [T3-4]", "set [T3-4]"])
