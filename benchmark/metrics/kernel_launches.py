"""Launches of the port's own kernels a proof (`_build.Kernel`, the
program's `kernel_launches` counter); PyTorch's own operations are not
counted."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["kernel_launches"])
