"""The column encoder's share of elements sent to the device as 64-bit
words, in percent: the program's `encode_narrow` over `encode_narrow` +
`encode_wide` (`Field.encode_ints_cols`: columns of values in [0, 2^64)
against those reduced and serialized value by value, blinding rows
among them)."""

from ._steps import mean_of


def read(r):
    narrow = mean_of(r, ["encode_narrow"])
    wide = mean_of(r, ["encode_wide"])
    if narrow is None or wide is None or not narrow + wide:
        return None
    return 100.0 * narrow / (narrow + wide)
