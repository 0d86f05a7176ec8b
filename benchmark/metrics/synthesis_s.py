"""Witness synthesis (frontend/): the circuit's configure, the witness
calculators and every phase's `calc`, the `synthesis [T3-4]` part of step
T3-4 in the program's record, seconds a proof."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["synthesis [T3-4]"])
