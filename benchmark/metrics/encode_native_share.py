"""The share of the column encoder's 32-byte elements written by the
program's native pass, in percent: `encode_native` over `encode_wide`
(`Field.encode_ints_cols`: columns with a value outside [0, 2^64) and the
blinding rows, in one native pass where each value is an int in
[0, 2^256), else value by value through `int.to_bytes`)."""

from ._steps import mean_of


def read(r):
    native = mean_of(r, ["encode_native"])
    wide = mean_of(r, ["encode_wide"])
    if native is None or not wide:
        return None
    return 100.0 * native / wide
